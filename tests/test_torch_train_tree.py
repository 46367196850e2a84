"""The tree engine through the trainers: ``--per-step`` without
``--state-layout`` runs both packages' tree engines (losses 1e-5
relative, parameters 1e-5·max|x|; 1e-4 relative losses under int8, its
per-leaf noise replayed) and returns a ``FedState``; adamw runs on both
engines; and the CLI runs ``--state-layout tree``, ``--optimizer adamw``
and ``--arch ... --smoke`` (the helpers in tests/_torch_train_common.py).
"""

from __future__ import annotations

import jax
import numpy as np
import pytest

from repro.configs.base import FedConfig as RefFedConfig
from repro.core import feddec as ref_feddec
from repro.launch import train as ref_train
from repro_torch.core import feddec
from repro_torch.launch import train as port_train
from repro_torch.tree import leaves
from _torch_train_common import (H, K, N, SMALL_CLI, _assert_params_close,
                                 _cli_lines, _ref_and_port)
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)


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
