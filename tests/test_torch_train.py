"""The whole slice: the port's train_loop against the JAX package's.

Both trainers run the small LM (d_model 64, 2 layers, vocab 256, seq 16)
on 4 agents for 4 steps with H = 2, ``--gossip-impl pallas
--fuse-update-mix``.  The port gets the reference's initial parameters
(carried as numpy) and a replay of the reference's draws: the tokens
rebuilt as repro/launch/train.py draws them, and the server's K draws
from ``split(fold_in(step_key, t), 3)`` (tests/_torch_train_common.py).
Per-step losses agree to 1e-5 relative.  The same holds for the sweep
lattice (``sweep_runs=2`` on the seed and h axes), whose draws replay the
reference's per-run keys, and for compressed gossip (``--gossip-compress
int8``, whose noise replays the reference's codec key; 1e-4 relative,
since the two packages may round a borderline element differently,
tests/test_torch_compress.py; the compressed lattice's trainer is held to
the reference's in tests/test_torch_sweep_compress.py).  The executors,
the impls, the FedAvg control, the lattice kept on request and the device
default are checked on the port.  The tree engine through the trainer is
in tests/test_torch_train_tree.py, the CLI in test_torch_train_cli.py,
the zoo configs in test_torch_train_zoo.py and population mode in
test_torch_train_population.py.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import FedConfig as RefFedConfig
from repro.data.federated_lm import make_federated_lm as ref_make_data
from repro.launch import train as ref_train
from repro.models import build_model as ref_build_model
from repro_torch.configs.base import FedConfig
from repro_torch.core import flat as flat_lib
from repro_torch.core.draws import Draws
from repro_torch.launch import train as port_train
from repro_torch.tree import leaves
from _torch_train_common import (BATCH, D_MODEL, H, K, LAYERS, N, SEQ, VOCAB,
                                 ReplaySweepTrainDraws, ReplayTrainDraws,
                                 SplitDraws, _flat, _small_run)
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)


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




def test_train_loop_keeps_the_lattice_on_request():
    state, _ = _small_run(sweep_runs=3, sweep_axis="seed", keep_lattice=True)
    assert state.flat.shape[:2] == (3, 3) and list(state.step) == [5] * 3




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
