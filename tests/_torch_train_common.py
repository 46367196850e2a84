"""What the trainer tests share (tests/test_torch_train.py,
test_torch_train_cli.py, test_torch_train_zoo.py,
test_torch_train_population.py, and the files that import them): the
small LM's sizes, the replays of the reference trainer's draws
(``ReplayTrainDraws``, ``ReplaySweepTrainDraws``,
``ReplayPopulationDraws``), ``SplitDraws``, the small runs and CLI
arguments, and the reference-and-port runner ``_ref_and_port``."""

from __future__ import annotations

import jax
import numpy as np
import torch

from repro.configs.base import FedConfig as RefFedConfig
from repro.core import compress as ref_compress
from repro.data.federated_lm import make_federated_lm as ref_make_data
from repro.launch import train as ref_train
from repro.models import build_model as ref_build_model
from repro.sharding import MeshAxes as RefMeshAxes
from repro.sharding import n_agents_for as ref_n_agents_for
from repro_torch.configs.base import FedConfig
from repro_torch.core import flat as flat_lib
from repro_torch.core.draws import Draws
from repro_torch.launch import train as port_train
from repro_torch.tree import leaves

D_MODEL, LAYERS, VOCAB, SEQ, BATCH, N, H, K = 64, 2, 256, 16, 2, 4, 2, 2


class ReplayTrainDraws(Draws):
    """The reference trainer's draws (repro/launch/train.py:269-327,
    repro/core/flat.py:441-442) through the port's Draws interface."""

    def __init__(self, seed: int, data):
        super().__init__(seed, "cpu")
        self.data = data
        self.key = jax.random.key(seed + 1)
        self.step_key = jax.random.key(seed + 2)

    def tokens(self, data, per_agent_batch, steps):
        self.key, kd = jax.random.split(self.key)
        if steps is None:
            toks = self.data.sample(kd, per_agent_batch)
        else:
            toks = jax.vmap(lambda k: self.data.sample(k, per_agent_batch))(
                jax.random.split(kd, steps))
        return torch.from_numpy(np.asarray(toks).astype(np.int64))

    def _keys(self, t):
        return jax.random.split(jax.random.fold_in(self.step_key, t), 3)

    def link_uniforms(self, t, n):
        return torch.from_numpy(np.array(
            jax.random.uniform(self._keys(t)[0], (n, n))))

    def participants(self, t, n, k):
        idx = jax.random.randint(self._keys(t)[2], (k,), 0, n)
        return torch.from_numpy(np.array(idx).astype(np.int64))

    def codec_noise(self, t, n, d, leaf=None):
        """``_row_noise(split(key_c, n), d)``, the reference's int8 noise at
        step t, with key_c = fold_in(key_w, 1) (repro/core/flat.py:450-451)
        or, for leaf ``leaf`` of the tree engine, fold_in(key_c, leaf)
        (repro/core/compress.py:304-314)."""
        key_c = jax.random.fold_in(self._keys(t)[0], 1)
        if leaf is not None:
            key_c = jax.random.fold_in(key_c, leaf)
        keys = jax.random.split(key_c, n)
        return torch.from_numpy(np.array(ref_compress._row_noise(keys, d)))


class ReplaySweepTrainDraws(ReplayTrainDraws):
    """The reference sweep trainer's draws (repro/launch/train.py:274-280,
    repro/core/sweep.py:330-333): run r keys its step t by
    ``split(fold_in(key_r, t), 3)``, with key_r = fold_in(step_key, r) on
    the seed axis and step_key itself on the h and topology axes."""

    def __init__(self, seed: int, data, r_runs: int, axis: str):
        super().__init__(seed, data)
        self.run_keys = [jax.random.fold_in(self.step_key, r)
                         if axis == "seed" else self.step_key
                         for r in range(r_runs)]

    def _run_key(self, r, t, which):
        return jax.random.split(
            jax.random.fold_in(self.run_keys[r], int(t[r])), 3)[which]

    def link_uniforms(self, t, n):
        return torch.from_numpy(np.stack([np.asarray(jax.random.uniform(
            self._run_key(r, t, 0), (n, n))) for r in range(len(t))]))

    def participants(self, t, n, k):
        return torch.from_numpy(np.stack([np.asarray(jax.random.randint(
            self._run_key(r, t, 2), (k,), 0, n))
            for r in range(len(t))]).astype(np.int64))


def _small_run(**kw):
    return port_train.train_loop(
        port_train.tiny_lm_config(64, 1, vocab=64),
        FedConfig(n_agents=3, h=2, k=2, graph="ring2",
                  gossip_impl=kw.pop("impl", "sparse")),
        steps=4, per_agent_batch=1, seq_len=8, log_every=0, device="cpu",
        **kw)


class SplitDraws(Draws):
    """Tokens from a second generator: a round's batches then come out the
    same whether they are drawn per step or H at a time."""

    def __init__(self, seed: int):
        super().__init__(seed, "cpu")
        self.data_draws = Draws(seed + 1, "cpu")

    def tokens(self, data, per_agent_batch, steps):
        return self.data_draws.tokens(data, per_agent_batch, steps)


def _flat(state) -> torch.Tensor:
    """A FedState's parameters as the (n, D) buffer, in FlatSpec order."""
    return flat_lib.make_flat_spec_from_stacked(state.params).flatten(
        state.params)


SMALL_CLI = ["--device", "cpu", "--steps", "3", "--agents", "3", "--batch",
             "1", "--seq", "8", "--d-model", "64", "--layers", "1",
             "--vocab", "64", "--h", "2"]


def _cli_lines(capsys, argv):
    port_train.main(SMALL_CLI + argv)
    return capsys.readouterr().out.splitlines()


def _ref_and_port(fed: dict, seed: int, ref_cfg=None, port_cfg=None,
                  seq=SEQ, **kw):
    """(reference (state, losses), port (state, losses)) of train_loop on
    the same initial parameters under the replayed draws."""
    ref_cfg = ref_cfg or ref_train.tiny_lm_config(D_MODEL, LAYERS,
                                                  vocab=VOCAB)
    port_cfg = port_cfg or port_train.tiny_lm_config(D_MODEL, LAYERS,
                                                     vocab=VOCAB)
    kw = dict(per_agent_batch=BATCH, seq_len=seq, log_every=0, seed=seed,
              **kw)
    ref = ref_train.train_loop(ref_cfg, RefFedConfig(**fed), **kw)
    params0 = jax.jit(ref_build_model(ref_cfg).init)(jax.random.key(seed))
    # the agents the reference trained: its layout's count (n_agents_for)
    n = ref_n_agents_for(ref_cfg, RefMeshAxes(
        ("data",), "model", {"data": fed["n_agents"], "model": 1}))
    draws = ReplayTrainDraws(seed, ref_make_data(
        ref_cfg.vocab_size, n, seq, alpha=0.3, seed=seed))
    port = port_train.train_loop(
        port_cfg, FedConfig(**fed), device="cpu", draws=draws,
        params0=flat_lib.params_from_numpy(jax.tree.map(np.asarray,
                                                        params0)), **kw)
    return ref, port


def _assert_params_close(port_state, ref_state, tol):
    ref_leaves = jax.tree.leaves(ref_state.params)
    port_leaves = leaves(port_state.params)
    assert len(port_leaves) == len(ref_leaves)
    atol = tol * max(float(np.abs(np.asarray(r)).max()) for r in ref_leaves)
    for p, r in zip(port_leaves, ref_leaves):
        np.testing.assert_allclose(p.numpy(), np.asarray(r), rtol=0,
                                   atol=atol)


def _ref_smoke(arch: str, **kw):
    """The reference's smoke config of ``arch``, its agent layout kept:
    Mistral-Large-123B and DeepSeek-V3-671B train their replicated
    layout's 4 and 1 agents in both trainers, whatever ``fed.n_agents``
    says (sharding.n_agents_for)."""
    import dataclasses

    from repro.configs import get_config as ref_get_config
    return dataclasses.replace(ref_get_config(arch).smoke(), **kw)


class ReplayPopulationDraws(Draws):
    """The reference's population_loop draws (repro/launch/train.py:
    408-429): a cohort's tokens from ``fold_in(key(seed + 1), round)``
    split over the H steps and the cohort's agents, the server's K draws
    from ``split(fold_in(key(seed + 2), t), 3)[2]``."""

    def __init__(self, seed: int, data):
        super().__init__(seed, "cpu")
        self.data = data
        self.data_key = jax.random.key(seed + 1)
        self.step_key = jax.random.key(seed + 2)

    def cohort_tokens(self, data, ids, per_agent_batch, steps, round_idx):
        kd = jax.random.fold_in(self.data_key, round_idx)
        ids_j = jax.numpy.asarray(ids, dtype=jax.numpy.int32)

        def per_step(k):
            ks = jax.random.split(k, ids_j.shape[0])
            return jax.vmap(self.data.sample_agent, in_axes=(0, 0, None))(
                ks, ids_j, per_agent_batch)

        toks = jax.vmap(per_step)(jax.random.split(kd, steps))
        return torch.from_numpy(np.asarray(toks).astype(np.int64))

    def participants(self, t, n, k):
        key = jax.random.split(jax.random.fold_in(self.step_key, t), 3)[2]
        return torch.from_numpy(np.array(jax.random.randint(
            key, (k,), 0, n)).astype(np.int64))


POP = dict(n_total=16, cohort_size=4, steps=4, per_agent_batch=1, seq_len=8)


POP_ARGV = ["--device", "cpu", "--n-total", "16", "--cohort-size", "4",
            "--steps", "4", "--h", "2", "--batch", "1", "--seq", "8",
            "--d-model", "64", "--layers", "1", "--vocab", "64"]
