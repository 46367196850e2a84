"""The whole slice: the port's train_loop against the JAX package's.

Both trainers run the small LM (d_model 64, 2 layers, vocab 256, seq 16)
on 4 agents for 4 steps with H = 2, ``--gossip-impl pallas
--fuse-update-mix``.  The port gets the reference's initial parameters
(carried as numpy) and a replay of the reference's draws: the tokens
rebuilt as repro/launch/train.py draws them, and the server's K draws
from ``split(fold_in(step_key, t), 3)``.  Per-step losses agree to 1e-5
relative.  The same holds for the sweep lattice (``sweep_runs=2`` on the
seed and h axes), whose draws replay the reference's per-run keys, and
for compressed gossip (``--gossip-compress int8``, whose noise replays
the reference's codec key; 1e-4 relative, since the two packages may
round a borderline element differently, tests/test_torch_compress.py;
the compressed lattice's trainer is held to the reference's in
tests/test_torch_sweep_compress.py).  The CLI's codec paths, its
compressed lattice, rejections, sweep errors and device default are
checked too.  The tree engine through the trainer: ``--per-step``
without ``--state-layout`` runs both packages' tree engines (losses 1e-5
relative, parameters 1e-5·max|x|; 1e-4 relative losses under int8, its
per-leaf noise replayed), every run returns a ``FedState``, adamw runs
on both engines, the two zoo smoke configs match the reference's losses
to 1e-4 relative, and the CLI runs ``--state-layout tree``, ``--optimizer
adamw`` and ``--arch ... --smoke``.  Population mode (``--n-total``):
``population_loop`` against the reference's on 16 agents, cohorts of 4,
under its replayed cohort tokens and server draws (losses 1e-5 relative,
the store 1e-5·max|x|, the staleness counters equal), the CLI on the CPU
(overlap and sync, the stale sampler with two clusters, ``--delta full``,
the store saved by ``--ckpt-dir``), and its refusals with the
reference's messages.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import FedConfig as RefFedConfig
from repro.core import compress as ref_compress
from repro.core import feddec as ref_feddec
from repro.data.federated_lm import make_federated_lm as ref_make_data
from repro.launch import train as ref_train
from repro.models import build_model as ref_build_model
from repro.sharding import MeshAxes as RefMeshAxes
from repro.sharding import n_agents_for as ref_n_agents_for
from repro_torch.configs.base import FedConfig
from repro_torch.core import feddec, flat as flat_lib
from repro_torch.core.draws import Draws
from repro_torch.launch import serve as port_serve
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


@pytest.mark.parametrize("axis,impl,fuse,opt,p_fail", [
    ("seed", "pallas", True, "momentum", 0.3),
    ("h", "sparse", False, "sgd", 0.0)])
def test_sweep_train_loop_matches_reference_losses(axis, impl, fuse, opt,
                                                   p_fail):
    seed = 1
    ref_cfg = ref_train.tiny_lm_config(D_MODEL, LAYERS, vocab=VOCAB)
    fed = dict(n_agents=N, h=H, k=K, graph="ring2", p_fail=p_fail,
               gossip_impl=impl)
    kw = dict(steps=4, per_agent_batch=BATCH, seq_len=SEQ, fused=True,
              fuse_update_mix=fuse, optimizer=opt, log_every=0, seed=seed,
              sweep_runs=2, sweep_axis=axis)
    _, ref_losses = ref_train.train_loop(ref_cfg, RefFedConfig(**fed),
                                         state_layout="flat", **kw)

    params0 = jax.jit(ref_build_model(ref_cfg).init)(jax.random.key(seed))
    draws = ReplaySweepTrainDraws(
        seed, ref_make_data(VOCAB, N, SEQ, alpha=0.3, seed=seed), 2, axis)
    state, losses = port_train.train_loop(
        port_train.tiny_lm_config(D_MODEL, LAYERS, vocab=VOCAB),
        FedConfig(**fed), device="cpu", draws=draws,
        params0=flat_lib.params_from_numpy(jax.tree.map(np.asarray,
                                                        params0)), **kw)
    assert len(losses) == len(ref_losses) == 4
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-5)
    assert state.step == 5
    assert all(leaf.shape[0] == N and torch.isfinite(leaf).all()
               for leaf in leaves(state.params))


def test_train_loop_matches_reference_losses():
    seed = 0
    ref_cfg = ref_train.tiny_lm_config(D_MODEL, LAYERS, vocab=VOCAB)
    _, ref_losses = ref_train.train_loop(
        ref_cfg, RefFedConfig(n_agents=N, h=H, k=K, graph="ring2",
                              gossip_impl="pallas"),
        steps=4, per_agent_batch=BATCH, seq_len=SEQ, fused=True,
        state_layout="flat", fuse_update_mix=True, log_every=0, seed=seed)

    params0 = jax.jit(ref_build_model(ref_cfg).init)(jax.random.key(seed))
    draws = ReplayTrainDraws(seed, ref_make_data(VOCAB, N, SEQ, alpha=0.3,
                                                 seed=seed))
    state, losses = port_train.train_loop(
        port_train.tiny_lm_config(D_MODEL, LAYERS, vocab=VOCAB),
        FedConfig(n_agents=N, h=H, k=K, graph="ring2",
                  gossip_impl="pallas"),
        steps=4, per_agent_batch=BATCH, seq_len=SEQ, fused=True,
        fuse_update_mix=True, log_every=0, seed=seed, device="cpu",
        draws=draws,
        params0=flat_lib.params_from_numpy(jax.tree.map(np.asarray,
                                                        params0)))
    assert len(losses) == len(ref_losses) == 4
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-5)
    assert state.step == 5
    assert all(torch.isfinite(leaf).all() for leaf in leaves(state.params))


@pytest.mark.parametrize("impl,fuse,opt", [("pallas", False, "sgd"),
                                            ("pallas", True, "momentum"),
                                            ("sparse", True, "sgd")])
def test_compressed_train_loop_matches_reference_losses(impl, fuse, opt):
    """The int8 paths of the chip check ((i) #14, (j) #9, (k) #11) on the
    small LM against the reference trainer, the codec noise replayed."""
    seed = 2
    ref_cfg = ref_train.tiny_lm_config(D_MODEL, LAYERS, vocab=VOCAB)
    fed = dict(n_agents=N, h=H, k=K, graph="ring2", gossip_impl=impl,
               gossip_compress="int8")
    kw = dict(steps=4, per_agent_batch=BATCH, seq_len=SEQ, fused=True,
              fuse_update_mix=fuse, optimizer=opt, log_every=0, seed=seed)
    _, ref_losses = ref_train.train_loop(ref_cfg, RefFedConfig(**fed),
                                         state_layout="flat", **kw)
    params0 = jax.jit(ref_build_model(ref_cfg).init)(jax.random.key(seed))
    draws = ReplayTrainDraws(seed, ref_make_data(VOCAB, N, SEQ, alpha=0.3,
                                                 seed=seed))
    state, losses = port_train.train_loop(
        port_train.tiny_lm_config(D_MODEL, LAYERS, vocab=VOCAB),
        FedConfig(**fed), device="cpu", draws=draws,
        params0=flat_lib.params_from_numpy(jax.tree.map(np.asarray,
                                                        params0)), **kw)
    assert len(losses) == len(ref_losses) == 4
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-4)
    assert state.step == 5
    assert [r.shape for r in leaves(state.residual)] == \
        [p.shape for p in leaves(state.params)]
    assert max(r.abs().max() for r in leaves(state.residual)) > 0


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


def test_per_step_and_fused_executors_agree():
    """On one engine (the flat one: --fuse-update-mix needs it, and
    --per-step alone now picks the tree engine)."""
    kw = dict(optimizer="momentum", fuse_update_mix=True,
              state_layout="flat")
    a, la = _small_run(fused=True, draws=SplitDraws(3), **kw)
    b, lb = _small_run(fused=False, draws=SplitDraws(3), **kw)
    assert la == lb
    assert torch.equal(_flat(a), _flat(b))


def test_gossip_impls_agree_on_the_port():
    """dense (plain matmul) and pallas (kernel #1 / its plain version) mix
    the same buffer: same draws, same trajectory within f32 noise."""
    a, la = _small_run(impl="dense")
    b, lb = _small_run(impl="pallas")
    np.testing.assert_allclose(la, lb, rtol=1e-6)
    torch.testing.assert_close(_flat(a), _flat(b), atol=1e-6, rtol=0)


def test_cli_runs_on_cpu_and_prints_the_reference_lines(capsys):
    port_train.main(["--device", "cpu", "--steps", "2", "--agents", "3",
                     "--batch", "1", "--seq", "8", "--d-model", "64",
                     "--layers", "1", "--vocab", "64", "--h", "2",
                     "--gossip-impl", "pallas", "--fuse-update-mix"])
    out = capsys.readouterr().out
    assert "[train] tiny-lm: " in out and "gossip=pallas" in out
    assert "fused-update-mix" in out and "[train] done: loss " in out


SMALL_CLI = ["--device", "cpu", "--steps", "3", "--agents", "3", "--batch",
             "1", "--seq", "8", "--d-model", "64", "--layers", "1",
             "--vocab", "64", "--h", "2"]


def _cli_lines(capsys, argv):
    port_train.main(SMALL_CLI + argv)
    return capsys.readouterr().out.splitlines()


@pytest.mark.parametrize("codec", ["identity", "bf16", "int8", "topk:0.25"])
@pytest.mark.parametrize("impl", ["dense", "pallas", "sparse"])
@pytest.mark.parametrize("executor", [["--fuse-update-mix"], ["--per-step"]],
                         ids=["fused-update-mix", "per-step"])
def test_cli_runs_every_codec_path_on_cpu(capsys, codec, impl, executor):
    out = _cli_lines(capsys, ["--gossip-impl", impl, "--gossip-compress",
                              codec, *executor])
    header = next(line for line in out if line.startswith("[train] tiny"))
    assert f"gossip={impl}" in header
    assert f", compress={codec}, device=cpu" in header
    assert out[-1].startswith("[train] done: loss ")


@pytest.mark.parametrize("impl", ["dense", "pallas", "sparse"])
def test_cli_identity_prints_the_uncompressed_done_line(capsys, impl):
    plain = _cli_lines(capsys, ["--gossip-impl", impl])
    ident = _cli_lines(capsys, ["--gossip-impl", impl, "--gossip-compress",
                                "identity"])
    assert ident[-1] == plain[-1] and ident[-1].startswith("[train] done:")


@pytest.mark.parametrize("argv", [["--fedavg"], ["--gossip-impl", "none"]])
def test_cli_no_exchange_means_no_codec(capsys, argv):
    """--fedavg and --gossip-impl none exchange nothing: no codec runs and
    the header names none (repro/launch/train.py:171-172)."""
    out = _cli_lines(capsys, [*argv, "--gossip-compress", "int8"])
    assert not any("compress=" in line for line in out)
    assert out[-1].startswith("[train] done: loss ")


def test_cli_runs_a_sweep_lattice_on_cpu(capsys):
    port_train.main(["--device", "cpu", "--steps", "2", "--agents", "3",
                     "--batch", "1", "--seq", "8", "--d-model", "64",
                     "--layers", "1", "--vocab", "64", "--h", "1",
                     "--gossip-impl", "pallas", "--sweep-runs", "2",
                     "--sweep-axis", "h"])
    out = capsys.readouterr().out
    assert "(sweep lattice R=2 axis=h)" in out
    assert "[train] sweep finals (last-step loss per run): r0=" in out
    assert ", r1=" in out and "[train] done: loss " in out


@pytest.mark.parametrize("codec,impl,argv", [
    ("int8", "pallas", ["--sweep-axis", "seed", "--fuse-update-mix",
                        "--optimizer", "momentum"]),
    ("topk:0.25", "sparse", ["--sweep-axis", "h"]),
    ("bf16", "dense", ["--sweep-axis", "h", "--fuse-update-mix"]),
    ("int8", "sparse", ["--sweep-axis", "seed", "--fedavg"])])
def test_cli_trains_a_compressed_sweep_lattice_on_cpu(capsys, codec, impl,
                                                      argv):
    """--sweep-runs with --gossip-compress: the header names the lattice
    and the codec (none under --fedavg: nothing is exchanged), and the
    per-run finals are printed."""
    out = _cli_lines(capsys, ["--gossip-impl", impl, "--sweep-runs", "2",
                              "--gossip-compress", codec, *argv])
    header = next(line for line in out if line.startswith("[train] tiny"))
    assert "(sweep lattice R=2 axis=" in header
    if "--fedavg" in argv:
        assert "compress=" not in header
    else:
        assert f", compress={codec}, device=cpu" in header
    finals = next(line for line in out if line.startswith(
        "[train] sweep finals (last-step loss per run): r0="))
    assert ", r1=" in finals and out[-1].startswith("[train] done: loss ")


def test_cli_identity_lattice_prints_the_uncompressed_lines(capsys):
    sweep_argv = ["--gossip-impl", "pallas", "--sweep-runs", "2",
                  "--sweep-axis", "h"]
    plain = _cli_lines(capsys, sweep_argv)
    ident = _cli_lines(capsys, sweep_argv + ["--gossip-compress",
                                             "identity"])
    assert ident[-2:] == plain[-2:]
    assert ident[-2].startswith("[train] sweep finals")


def test_train_loop_keeps_the_lattice_on_request():
    state, _ = _small_run(sweep_runs=3, sweep_axis="seed", keep_lattice=True)
    assert state.flat.shape[:2] == (3, 3) and list(state.step) == [5] * 3


@pytest.mark.parametrize("case", ["per-step", "topology-ring2", "tree"])
def test_cli_sweep_errors_are_the_reference_messages(case):
    small = ["--steps", "1", "--agents", "3", "--batch", "1", "--seq", "8",
             "--d-model", "64", "--layers", "1", "--vocab", "64",
             "--sweep-runs", "2"]
    extra, ref_kw = {
        "per-step": (["--per-step"], dict(fused=False)),
        "topology-ring2": (["--sweep-axis", "topology"],
                           dict(sweep_axis="topology")),
        "tree": (["--state-layout", "tree"], dict(state_layout="tree")),
    }[case]
    ref_kw = {"state_layout": "flat", "fused": True, **ref_kw}
    with pytest.raises(ValueError) as ref_err:
        ref_train.train_loop(ref_train.tiny_lm_config(64, 1, vocab=64),
                             RefFedConfig(n_agents=3, h=10, k=2,
                                          graph="ring2"),
                             steps=1, per_agent_batch=1, seq_len=8,
                             log_every=0, sweep_runs=2, **ref_kw)
    with pytest.raises(ValueError) as err:
        port_train.main(["--device", "cpu", *small, *extra])
    assert str(err.value) == str(ref_err.value)


@pytest.mark.parametrize("argv", [
    ["--mesh-agents", "2"], ["--mesh-model", "2"],
    ["--n-total", "64", "--ckpt-dir", "c", "--mesh-agents", "2"],
    ["--delta", "topk:4", "--n-total", "64", "--mesh-model", "2"]])
def test_cli_rejects_what_is_not_ported(argv, capsys):
    """--delta, --ckpt-dir and --n-total are ported; with them,
    --mesh-model, which is not, is still rejected before population mode
    starts.  --mesh-agents is ported: without torchrun its world is one
    rank, which it refuses for N = 2, and population mode does not compose
    with it (repro/launch/train.py:568-579)."""
    with pytest.raises(SystemExit) as err:
        port_train.main(["--device", "cpu", *argv])
    if "--mesh-model" in argv:
        assert err.value.code == 2
        assert "not ported to repro_torch yet" in capsys.readouterr().err
    elif "--n-total" in argv:
        assert err.value.code == ("population mode (--n-total) does not "
                                  "compose with --mesh-agents")
    else:
        assert err.value.code == 2
        assert "--mesh-agents 2 needs 2 ranks, one process a rank, but " \
            "this world has 1" in capsys.readouterr().err


@pytest.mark.parametrize("cli,argv", [
    (port_train, ["--n-total", "64", "--arch", "llama-9"]),
    (port_train, ["--arch", "mistral-large"]),
    (port_serve, ["--arch", "deepseek-v3"])])
def test_clis_refuse_an_unknown_arch(cli, argv, capsys):
    """Every id of the reference's registry is ported (Mistral-Large-123B
    and DeepSeek-V3-671B last): an unknown id exits 2 before anything
    runs, naming the ids there are, and nothing as not ported yet."""
    with pytest.raises(SystemExit) as err:
        cli.main(["--device", "cpu", *argv])
    assert err.value.code == 2
    err = capsys.readouterr().err
    assert f"unknown --arch {argv[-1]!r}; choose from tiny, " in err
    assert "mistral-large-123b, deepseek-v3-671b" in err
    assert "not yet" not in err


@pytest.mark.parametrize("argv", [
    ["--arch", "qwen2-vl-2b"], ["--arch", "seamless-m4t-large-v2", "--smoke"],
    ["--arch", "qwen2-vl-2b", "--smoke", "--n-total", "64"]])
def test_cli_refuses_the_models_the_reference_cli_cannot_train(argv,
                                                                capsys):
    """The reference's train_loop fails on Qwen2-VL-2B and
    SeamlessM4T-Large-v2 at its first step: its batches carry only tokens
    and positions (no mrope_positions, repro/models/attention.py:219; no
    enc_embeds, repro/models/transformer.py:353).  The port's CLI refuses
    them with exit 2 and says why, before it allocates anything; both
    train through the engine API (tests/test_torch_multimodal.py)."""
    with pytest.raises(SystemExit) as err:
        port_train.main(["--device", "cpu", *argv])
    assert err.value.code == 2
    err = capsys.readouterr().err
    arch = argv[1]
    assert f"--arch {arch} is not trained by this CLI" in err
    assert "train_loop fails on it at its first step" in err
    assert ("mrope_positions" if arch == "qwen2-vl-2b"
            else "enc_embeds") in err


def test_runs_on_cuda_by_default_and_fails_without_a_card():
    if torch.cuda.is_available():
        assert port_train.resolve_device("cuda").type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            port_train.resolve_device("cuda")
    assert port_train.resolve_device("cpu").type == "cpu"


def test_fedavg_control_is_the_run_without_gossip():
    """--fedavg swaps in 𝒲 = {I}: the same trajectory as gossip 'none'."""
    a, la = _small_run(fedavg_control=True, draws=Draws(4, "cpu"))
    b, lb = _small_run(impl="none", draws=Draws(4, "cpu"))
    assert la == lb and torch.equal(_flat(a), _flat(b))


# ---------------------------------------------------------------------------
# The tree engine through the trainer: the --per-step default, FedState
# returns, adamw, the zoo's smoke configs and the CLI's --arch/--smoke
# ---------------------------------------------------------------------------


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


@pytest.mark.parametrize("impl,opt,codec", [
    ("pallas", "sgd", "none"), ("sparse", "momentum", "none"),
    ("dense", "adamw", "none"), ("pallas", "sgd", "int8")])
def test_per_step_runs_the_tree_engine_as_the_reference_does(impl, opt,
                                                              codec):
    """No --state-layout with --per-step: both trainers run their tree
    engines (repro/launch/train.py:122-123) and return a FedState; losses
    within 1e-5 relative (1e-4 under the lossy int8 codec, its per-leaf
    noise replayed), sgd and momentum parameters within 1e-5·max|x|.
    adamw's and int8's parameters are held on the engine's quadratic in
    tests/test_torch_feddec.py: on the LM, adamw's m̂/(√v̂ + ε) turns the
    two frameworks' gradient rounding on near-zero gradients into a share
    of η, and int8 may round a borderline element one quantum apart."""
    fed = dict(n_agents=N, h=H, k=K, graph="ring2", gossip_impl=impl,
               gossip_compress=codec)
    (ref_state, ref_losses), (state, losses) = _ref_and_port(
        fed, 5, steps=4, fused=False, optimizer=opt)
    assert isinstance(ref_state, ref_feddec.FedState)
    assert isinstance(state, feddec.FedState) and state.step == 5
    np.testing.assert_allclose(losses, ref_losses,
                               rtol=1e-5 if codec == "none" else 1e-4)
    if codec == "none" and opt != "adamw":
        _assert_params_close(state, ref_state, 1e-5)
    if opt == "adamw":
        assert state.opt_state["count"].tolist() == [4] * N


@pytest.mark.parametrize("fuse", [False, True])
def test_flat_adamw_train_loop_returns_the_reference_fedstate(fuse):
    """adamw on the flat engine (under --fuse-update-mix it keeps the
    unfused path, as the reference's does): losses within 1e-5 relative;
    the FedState returned carries the per-agent count, as the reference's
    unflatten_fedstate gives it."""
    fed = dict(n_agents=N, h=H, k=K, graph="ring2", gossip_impl="pallas")
    (ref_state, ref_losses), (state, losses) = _ref_and_port(
        fed, 6, steps=4, fused=True, optimizer="adamw", state_layout="flat",
        fuse_update_mix=fuse)
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-5)
    assert isinstance(state, feddec.FedState)
    assert [p.shape for p in leaves(state.params)] == \
        [r.shape for r in jax.tree.leaves(ref_state.params)]
    np.testing.assert_array_equal(state.opt_state["count"].numpy(),
                                  np.asarray(ref_state.opt_state["count"]))


def _ref_smoke(arch: str, **kw):
    """The reference's smoke config of ``arch``, its agent layout kept:
    Mistral-Large-123B and DeepSeek-V3-671B train their replicated
    layout's 4 and 1 agents in both trainers, whatever ``fed.n_agents``
    says (sharding.n_agents_for)."""
    import dataclasses

    from repro.configs import get_config as ref_get_config
    return dataclasses.replace(ref_get_config(arch).smoke(), **kw)


@pytest.mark.parametrize("arch,layout,fused", [
    ("recurrentgemma-9b", "tree", False), ("mamba2-2.7b", "flat", True),
    ("deepseek-v2-lite-16b", "flat", True),
    ("mistral-large-123b", "flat", True), ("deepseek-v3-671b", "tree",
                                           False)])
def test_zoo_smoke_train_loop_matches_reference_losses(arch, layout, fused):
    """The zoo configs' smoke variants train through both trainers (impl
    'xla'), on the tree and the flat engine: 2 steps, losses within 1e-4
    relative (DeepSeek-V2-Lite's and DeepSeek-V3's with the MoE aux term,
    their MoE under the engine's vmap over the agents)."""
    from repro_torch.configs import get_config
    fed = dict(n_agents=2, h=2, k=2, graph="ring2", gossip_impl="pallas")
    (_, ref_losses), (state, losses) = _ref_and_port(
        fed, 7, ref_cfg=_ref_smoke(arch),
        port_cfg=get_config(arch).smoke(), steps=2, fused=fused,
        state_layout=layout)
    assert len(losses) == len(ref_losses) == 2
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-4)
    assert isinstance(state, feddec.FedState) and state.step == 3


@pytest.mark.parametrize("arch,agents", [
    (a, n) for a in ("tiny", "recurrentgemma-9b", "mamba2-2.7b",
                     "qwen1.5-4b", "gemma3-12b", "nemotron-4-15b",
                     "deepseek-v2-lite-16b", "qwen2-vl-2b",
                     "seamless-m4t-large-v2", "mistral-large-123b",
                     "deepseek-v3-671b") for n in (2, 8)])
def test_build_fed_setup_counts_the_reference_agents(arch, agents):
    """The trainers' agent-count rule (repro/launch/steps.py:56-84): given
    the same --agents, both build the same federation: the layout's agent
    count (--agents for 'sharded', 4 for Mistral-Large-123B and 1 for
    DeepSeek-V3-671B, 'replicated'), the same graph and the same K."""
    from repro.configs import get_config as ref_get_config
    from repro.launch.steps import build_fed_setup as ref_build_fed_setup
    from repro_torch.configs import get_config
    if arch == "tiny":
        ref_cfg = ref_train.tiny_lm_config()
        cfg = port_train.tiny_lm_config()
    else:
        ref_cfg, cfg = ref_get_config(arch), get_config(arch)
    assert (cfg.fed_agent_layout, cfg.fed_n_agents_replicated) == \
        (ref_cfg.fed_agent_layout, ref_cfg.fed_n_agents_replicated)
    fed = dict(n_agents=agents, h=2, k=2, graph="ring2")
    ref_fcfg, ref_n = ref_build_fed_setup(
        ref_cfg, RefMeshAxes(("data",), "model", {"data": agents,
                                                  "model": 1}),
        RefFedConfig(**fed))
    port_fed = FedConfig(**fed)
    fcfg, n = port_train.build_fed_setup(cfg, port_train.fed_axes(port_fed),
                                         port_fed)
    assert n == ref_n == {"mistral-large-123b": 4,
                          "deepseek-v3-671b": 1}.get(arch, agents)
    assert fcfg.k == ref_fcfg.k
    np.testing.assert_array_equal(fcfg.mixing.graph.adjacency,
                                  np.asarray(ref_fcfg.mixing.graph.adjacency))


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "mamba2-2.7b",
                                  "deepseek-v2-lite-16b", "gemma3-12b",
                                  "nemotron-4-15b", "mistral-large-123b",
                                  "deepseek-v3-671b"])
def test_cli_trains_a_zoo_smoke_config_on_cpu(capsys, arch):
    port_train.main(["--device", "cpu", "--steps", "2", "--agents", "2",
                     "--batch", "1", "--seq", "16", "--h", "2", "--arch",
                     arch, "--smoke", "--per-step"])
    out = capsys.readouterr().out
    assert f"[train] {arch}-smoke: " in out and "layout=tree" in out
    assert "[train] done: loss " in out


@pytest.mark.parametrize("argv,header", [
    (["--state-layout", "tree"], "executor=fused, layout=tree"),
    (["--optimizer", "adamw"], "opt=adamw"),
    (["--gossip-compress", "int8", "--state-layout", "tree"],
     "layout=tree, gossip=dense, compress=int8"),
    (["--per-step"], "executor=per-step, layout=tree"),
    (["--per-step", "--state-layout", "flat"], "per-step, layout=flat")])
def test_cli_runs_the_tree_layout_and_adamw(capsys, argv, header):
    """What the CLI rejected before the tree engine and adamw were ported
    now trains; --per-step alone picks the tree engine."""
    out = _cli_lines(capsys, argv)
    assert header in next(line for line in out
                          if line.startswith("[train] tiny"))
    assert out[-1].startswith("[train] done: loss ")


def test_cli_tree_layout_rejects_the_fused_update_mix():
    with pytest.raises(ValueError, match="requires --state-layout flat"):
        port_train.main(SMALL_CLI + ["--per-step", "--fuse-update-mix"])
    with pytest.raises(ValueError, match="requires --state-layout flat"):
        ref_train.train_loop(ref_train.tiny_lm_config(64, 1, vocab=64),
                             RefFedConfig(n_agents=3, h=2, k=2),
                             steps=1, per_agent_batch=1, seq_len=8,
                             log_every=0, fused=False, fuse_update_mix=True)


# ---------------------------------------------------------------------------
# Population mode (--n-total): population_loop against the reference's, the
# CLI on the CPU and its refusals
# ---------------------------------------------------------------------------


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


@pytest.mark.parametrize("extra", [
    dict(),
    dict(sampling="stale", staleness=0.5, n_clusters=2)])
def test_population_loop_matches_the_reference(extra):
    seed = 0
    fed = dict(n_agents=N, h=H, k=K, graph="ring2")
    ref_cfg = ref_train.tiny_lm_config(D_MODEL, 1, vocab=64)
    ref_store, ref_losses = ref_train.population_loop(
        ref_cfg, RefFedConfig(**fed), seed=seed, **POP, **extra)
    params0 = jax.jit(ref_build_model(ref_cfg).init)(jax.random.key(seed))
    draws = ReplayPopulationDraws(
        seed, ref_make_data(64, POP["n_total"], POP["seq_len"], alpha=0.3,
                            seed=seed))
    store, losses = port_train.population_loop(
        port_train.tiny_lm_config(D_MODEL, 1, vocab=64), FedConfig(**fed),
        seed=seed, device="cpu", draws=draws,
        params0=flat_lib.params_from_numpy(jax.tree.map(np.asarray,
                                                        params0)),
        **POP, **extra)
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-5)
    got = store.gather(np.arange(POP["n_total"]))
    want = ref_store.gather(np.arange(POP["n_total"]))
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    np.testing.assert_array_equal(store.last_round, ref_store.last_round)


POP_ARGV = ["--device", "cpu", "--n-total", "16", "--cohort-size", "4",
            "--steps", "4", "--h", "2", "--batch", "1", "--seq", "8",
            "--d-model", "64", "--layers", "1", "--vocab", "64"]


@pytest.mark.parametrize("extra", [[], ["--no-overlap"],
                                   ["--sampling", "stale", "--staleness",
                                    "0.5", "--n-clusters", "2"],
                                   ["--delta", "full"]])
def test_cli_population_runs_on_cpu(capsys, extra, tmp_path):
    from repro_torch.core.population import PopulationStore
    port_train.main([*POP_ARGV, *extra, "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "[train] population: " in out and "n_total=16 (cohort 4" in out
    assert "[train] population: 4 steps in 2 rounds" in out
    assert "[train] done: loss" in out
    if extra == ["--delta", "full"]:
        assert "delta=full" in out
        assert any(p.startswith("deltapop_") for p in
                   (x.name for x in tmp_path.iterdir()))
    else:
        back = PopulationStore.restore(str(tmp_path))
        assert back.rows.shape[0] == 16 and np.isfinite(back.rows).all()
        assert (back.last_round >= 0).sum() >= 4


def test_cli_population_overlap_and_sync_print_the_same_losses(capsys):
    lines = []
    for extra in ([], ["--no-overlap"]):
        port_train.main([*POP_ARGV, *extra])
        lines.append([line for line in capsys.readouterr().out.splitlines()
                      if line.startswith("[train] done:")])
    assert lines[0] == lines[1] and lines[0]


@pytest.mark.parametrize("extra", [
    ["--sweep-runs", "2"], ["--fuse-update-mix"], ["--optimizer", "momentum"],
    ["--fedavg"], ["--per-step"]])
def test_cli_population_refusals_are_the_reference_messages(extra,
                                                             monkeypatch):
    argv = POP_ARGV[2:] + extra       # the reference's CLI has no --device
    monkeypatch.setattr("sys.argv", ["train", *argv])
    with pytest.raises(SystemExit) as ref_err:
        ref_train.main()
    with pytest.raises(SystemExit) as err:
        port_train.main(["--device", "cpu", *argv])
    assert str(err.value) == str(ref_err.value)
    assert str(err.value).startswith("population mode (--n-total) does "
                                     "not compose with")


@pytest.mark.parametrize("kw", [dict(steps=3), dict(gossip_compress="int8"),
                                dict(graph="geo0.5")])
def test_population_loop_errors_are_the_reference_messages(kw):
    fed = dict(n_agents=N, h=H, k=K, graph=kw.pop("graph", "ring2"),
               gossip_compress=kw.pop("gossip_compress", "none"))
    pop_kw = {**POP, **kw}
    with pytest.raises(ValueError) as ref_err:
        ref_train.population_loop(ref_train.tiny_lm_config(D_MODEL, 1,
                                                           vocab=64),
                                  RefFedConfig(**fed), **pop_kw)
    with pytest.raises(ValueError) as err:
        port_train.population_loop(port_train.tiny_lm_config(D_MODEL, 1,
                                                             vocab=64),
                                   FedConfig(**fed), device="cpu", **pop_kw)
    assert str(err.value) == str(ref_err.value)
