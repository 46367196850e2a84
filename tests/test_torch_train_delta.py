"""The delta parameterization through the trainer (``--delta``): the
port's train_loop against the JAX package's, and the CLI.

The chip check's delta paths ((x) ``full`` → #1, (y) top-k fused
momentum → #9, (z) low-rank sparse fused → #11) run on the small LM of
tests/test_torch_train.py (d_model 64, 2 layers, vocab 256, seq 16, 4
agents, 4 steps, H = 2) against the reference trainer under its replayed
draws, the delta's base the initial row (repro/launch/train.py:229-238):
losses within 1e-5 relative (1e-4 under the low-rank codec: two
LAPACKs' f32 SVDs of the LM's deltas), parameters within 1e-5·max|x|.
The CLI: ``--delta full`` prints the ``[train] done:`` line of the run
without it, the lossy codecs run on every gossip impl, ``--fedavg`` and
``--gossip-impl none`` exchange no delta, and the tree layout,
``--sweep-runs`` and ``--gossip-compress`` fail with the reference's
messages.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from repro.configs.base import FedConfig as RefFedConfig
from repro.launch import train as ref_train
from repro_torch.launch import train as port_train
from repro_torch.tree import leaves
from _torch_train_common import (H, K, N, _assert_params_close, _cli_lines,
                                _ref_and_port)
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)


@pytest.fixture
def one_thread():
    """One intra-op thread for the low-rank codec's CPU SVDs: beside the
    other test workers, MKL's threads oversubscribe the cores and one
    small SVD then takes seconds, not milliseconds."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("delta,impl,fuse,opt,rtol", [
    ("full", "pallas", False, "sgd", 1e-5),
    ("topk:2048", "pallas", True, "momentum", 1e-5),
    ("lowrank:4", "sparse", True, "sgd", 1e-4)])
def test_delta_train_loop_matches_reference_losses(delta, impl, fuse, opt,
                                                   rtol, one_thread):
    """The chip check's delta paths ((x) full → #1, (y) top-k fused
    momentum → #9, (z) low-rank sparse fused → #11) on the small LM
    against the reference trainer, whose delta base is the initial row
    (repro/launch/train.py:229-238): losses within 1e-5 relative, 1e-4
    under the low-rank codec (two LAPACKs' f32 SVDs of the LM's
    deltas)."""
    fed = dict(n_agents=N, h=H, k=K, graph="ring2", gossip_impl=impl,
               delta=delta)
    (ref_state, ref_losses), (state, losses) = _ref_and_port(
        fed, 3, steps=4, fused=True, state_layout="flat",
        fuse_update_mix=fuse, optimizer=opt)
    assert len(losses) == len(ref_losses) == 4
    np.testing.assert_allclose(losses, ref_losses, rtol=rtol)
    res = max(r.abs().max() for r in leaves(state.residual))
    assert res == 0 if delta == "full" else res > 0
    if delta != "lowrank:4":
        _assert_params_close(state, ref_state, 1e-5)


@pytest.mark.parametrize("impl", ["dense", "pallas", "sparse"])
@pytest.mark.parametrize("executor", [[], ["--fuse-update-mix"],
                                      ["--state-layout", "flat",
                                       "--per-step"]],
                         ids=["fused", "fused-update-mix", "per-step"])
def test_cli_delta_full_prints_the_done_line_of_none(capsys, impl,
                                                     executor):
    """--delta full is lossless: the same [train] done: line as the run
    without it (the reference's bit-identity anchor), and the header
    names it."""
    plain = _cli_lines(capsys, ["--gossip-impl", impl, *executor])
    full = _cli_lines(capsys, ["--gossip-impl", impl, "--delta", "full",
                               *executor])
    header = next(line for line in full if line.startswith("[train] tiny"))
    assert ", delta=full, device=cpu" in header
    assert full[-1] == plain[-1] and full[-1].startswith("[train] done:")


@pytest.mark.parametrize("delta", ["topk:64", "lowrank:2"])
@pytest.mark.parametrize("impl", ["dense", "pallas", "sparse"])
@pytest.mark.parametrize("executor", [[], ["--fuse-update-mix"]],
                         ids=["fused", "fused-update-mix"])
def test_cli_runs_every_lossy_delta_path_on_cpu(capsys, delta, impl,
                                                executor, one_thread):
    out = _cli_lines(capsys, ["--gossip-impl", impl, "--delta", delta,
                              *executor])
    header = next(line for line in out if line.startswith("[train] tiny"))
    assert f", delta={delta}, device=cpu" in header
    assert out[-1].startswith("[train] done: loss ")


@pytest.mark.parametrize("argv", [["--fedavg"], ["--gossip-impl", "none"]])
def test_cli_no_exchange_means_no_delta(capsys, argv):
    """--fedavg and --gossip-impl none exchange nothing: the delta becomes
    'none' (repro/launch/train.py:173), no residual, no header entry."""
    out = _cli_lines(capsys, [*argv, "--delta", "topk:8"])
    assert not any("delta=" in line for line in out)
    assert out[-1].startswith("[train] done: loss ")


@pytest.mark.parametrize("case", ["tree", "per-step", "sweep", "compress"])
def test_cli_delta_errors_are_the_reference_messages(case):
    """--delta on the tree layout (or --per-step's default), on a
    --sweep-runs lattice and with --gossip-compress: the reference's
    messages (core/engine.py:494-503, core/feddec.py:114-119)."""
    small = ["--steps", "1", "--agents", "3", "--batch", "1", "--seq", "8",
             "--d-model", "64", "--layers", "1", "--vocab", "64",
             "--delta", "full"]
    extra, ref_kw, ref_fed = {
        "tree": (["--state-layout", "tree"], dict(state_layout="tree"),
                 {}),
        "per-step": (["--per-step"], dict(fused=False), {}),
        "sweep": (["--sweep-runs", "2"], dict(sweep_runs=2), {}),
        "compress": (["--gossip-compress", "int8"], {},
                     dict(gossip_compress="int8")),
    }[case]
    with pytest.raises(ValueError) as ref_err:
        ref_train.train_loop(ref_train.tiny_lm_config(64, 1, vocab=64),
                             RefFedConfig(n_agents=3, h=10, k=2,
                                          graph="ring2", delta="full",
                                          **ref_fed),
                             steps=1, per_agent_batch=1, seq_len=8,
                             log_every=0, **ref_kw)
    with pytest.raises(ValueError) as err:
        port_train.main(["--device", "cpu", *small, *extra])
    assert str(err.value) == str(ref_err.value)
