"""The port's compressed sweep lattice against the JAX package's on
every cell and lattice variant of tests/test_torch_sweep_compress.py
(whose module docstring sets out the problem, the draws and the
tolerances, and whose helpers run both packages): gossip impl {dense,
pallas, sparse} × fused update+mix × {sgd, momentum} × codec {identity,
bf16, int8, topk:0.25} on three graphs, and the lattices that vary H per
run, hold a FedAvg member, mix per-run topologies and fail links in one
run.
"""

from __future__ import annotations

import pytest

from test_torch_sweep import H, MATRIX_GRAPHS
from test_torch_sweep_compress import (CODECS, LATTICES, _assert_matches,
                                       _cfg, _pairs, _run_both)
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)


CELLS = [(impl, fused, opt, codec) for codec in CODECS
         for impl in ("dense", "pallas", "sparse")
         for fused in (False, True) for opt in ("sgd", "momentum")]


@pytest.mark.parametrize(
    "impl,fused,opt,codec", CELLS,
    ids=[f"{c}-{i}-{'fused' if f else 'unfused'}-{o}"
         for i, f, o, c in CELLS])
def test_compressed_lattice_matches_reference(impl, fused, opt, codec):
    states, state, ref_losses, losses = _run_both(
        [_cfg(g, impl, codec) for g in MATRIX_GRAPHS], opt=opt,
        fused=fused)
    assert losses.shape == (2 * H, 3)
    assert list(state.step) == [1 + 3 * H] * 3
    _assert_matches(states, state, ref_losses, losses, codec)


@pytest.mark.parametrize("name", list(LATTICES))
def test_compressed_lattice_variants_match_reference(name):
    runs, codec, opt, fused, shared = LATTICES[name]
    states, state, ref_losses, losses = _run_both(
        _pairs(runs, codec), opt=opt, fused=fused, shared_keys=shared)
    _assert_matches(states, state, ref_losses, losses, codec)
