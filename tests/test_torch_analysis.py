"""The port's analytic cost models (repro_torch/launch/analysis.py)
against the reference's (repro/launch/analysis.py): every ported function
returns the reference's dict or value exactly, ``pred_us`` included, on a
grid of arguments; the 2-D mesh model's contract cases of
tests/test_mesh.py:110-160 are mirrored on the port's model.
"""

from __future__ import annotations

import dataclasses
import itertools

import pytest

from repro.launch import analysis as ref
from repro_torch.launch import analysis as port


def _same(fn: str, **kw):
    got, want = getattr(port, fn)(**kw), getattr(ref, fn)(**kw)
    assert got == want
    return got


def test_constants_and_dtype_bytes_are_the_reference_s():
    assert (port.PEAK_FLOPS, port.HBM_BW, port.ICI_BW, port.H2D_BW) == \
        (ref.PEAK_FLOPS, ref.HBM_BW, ref.ICI_BW, ref.H2D_BW)
    assert port.COMPRESS_SCHEMES == ref.COMPRESS_SCHEMES
    for name in ("pred", "s8", "bf16", "f16", "s32", "f32", "f64", "c128",
                 "bogus"):
        assert port.dtype_bytes(name) == ref.dtype_bytes(name)


@pytest.mark.parametrize("n,d,b", [(8, 156_519_168, 4), (20, 25, 8),
                                   (256, 4097, 2)])
def test_gossip_cost_model(n, d, b):
    for leaves, edges in ((12, 2 * n), (1, n * (n - 1))):
        _same("gossip_cost_model", n_agents=n, d=d, num_leaves=leaves,
              num_directed_edges=edges, param_bytes=b)


@pytest.mark.parametrize("n,s", [(8, 1), (8, 2), (8, 4), (32, 8)])
def test_sharded_gossip_cost_model(n, s):
    for d, b, rounds in ((220, 4, 2), (156_519_168, 2, 1)):
        got = _same("sharded_gossip_cost_model", n_agents=n, d=d,
                    n_shards=s, num_cut_edges=4 * s, num_halo_rounds=rounds,
                    param_bytes=b, dispatch_us=3.0)
        assert set(got) == {"dense", "sparse", "pallas", "none"}


@pytest.mark.parametrize("a,m", [(1, 1), (4, 2), (2, 4), (8, 8), (4, 1)])
def test_mesh2d_cost_model(a, m):
    _same("mesh2d_cost_model", n_agents=64, d=4096, n_agent_shards=a,
          n_model_shards=m, num_halo_rounds=3)


class TestMesh2dCostModel:
    """tests/test_mesh.py:110-160 on the port's model."""

    N, D = 64, 4096

    def model(self, a, m, halo=2):
        return port.mesh2d_cost_model(n_agents=self.N, d=self.D,
                                      n_agent_shards=a, n_model_shards=m,
                                      num_halo_rounds=halo)

    def test_state_bytes_exact(self):
        for a, m in [(1, 1), (4, 2), (2, 4), (8, 8)]:
            rec = self.model(a, m)
            for impl in ("dense", "sparse", "pallas", "none"):
                assert rec[impl]["state_bytes_per_device"] \
                    == self.N // a * (self.D // m) * 4

    def test_am_way_scaling(self):
        base = self.model(1, 1)["dense"]["state_bytes_per_device"]
        for a, m in [(2, 2), (4, 2), (8, 8)]:
            got = self.model(a, m)["dense"]["state_bytes_per_device"]
            assert got * a * m == base

    def test_dense_gossip_bytes(self):
        a, m = 4, 2
        rec = self.model(a, m)["dense"]
        assert rec["gossip_collective_bytes"] == pytest.approx(
            (a - 1) / a * self.N * (self.D // m) * 4)

    def test_halo_gossip_bytes(self):
        a, m, halo = 4, 2, 3
        rec = self.model(a, m, halo)["sparse"]
        assert rec["gossip_collective_bytes"] == pytest.approx(
            halo * (self.N // a) * (self.D // m) * 4)
        assert rec == self.model(a, m, halo)["pallas"]

    def test_model_axis_collective_bytes(self):
        a, m = 2, 4
        rec = self.model(a, m)["dense"]
        assert rec["model_collective_bytes"] == pytest.approx(
            2.0 * (m - 1) / m * (self.N // a) * 4)
        assert self.model(4, 1)["dense"]["model_collective_bytes"] == 0.0

    def test_server_bytes(self):
        a, m = 4, 2
        rec = self.model(a, m)["dense"]
        assert rec["server_bytes_per_round"] == pytest.approx(
            2.0 * (a - 1) / a * (self.D // m) * 4)
        assert self.model(1, 4)["dense"]["server_bytes_per_round"] == 0.0

    def test_impl_none_has_no_gossip_traffic(self):
        assert self.model(4, 2)["none"]["gossip_collective_bytes"] == 0.0


@pytest.mark.parametrize("r,t,h", [(1, None, None), (10, 1000, 10),
                                   (80, 5000, 7)])
def test_sweep_cost_models(r, t, h):
    for slots, res in itertools.product((0, 1, 2), (False, True)):
        _same("sweep_cost_model", r_runs=r, n_agents=20, d=25, t_steps=t,
              h=h, param_bytes=8, opt_slots=slots, residual=res)
        for s in (1, 2, 4):
            _same("sharded_sweep_cost_model", r_runs=r, n_agents=8,
                  d=156_519_168, n_shards=s, num_halo_rounds=2, t_steps=t,
                  h=h, opt_slots=slots, residual=res)


def test_sharded_sweep_cost_model_refuses_indivisible_shards():
    kw = dict(r_runs=2, n_agents=8, d=10, n_shards=3, num_halo_rounds=1)
    with pytest.raises(ValueError) as want:
        ref.sharded_sweep_cost_model(**kw)
    with pytest.raises(ValueError) as got:
        port.sharded_sweep_cost_model(**kw)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("n_total", [10**4, 10**6])
def test_population_and_delta_cost_models(n_total):
    _same("population_cost_model", n_total=n_total, cohort_size=256, d=25,
          max_degree=4, h=10)
    for delta in ("none", "full", "topk:128", "topk:99999", "lowrank:2",
                  "lowrank:8"):
        for d in (25, 18_744_576, 156_519_168):
            assert port.delta_row_bytes(delta, d) == \
                ref.delta_row_bytes(delta, d)
        _same("delta_cost_model", n_total=n_total, d=4096, delta=delta)
    with pytest.raises(ValueError, match="unknown delta scheme"):
        port.delta_row_bytes("svd:3", 10)


@pytest.mark.parametrize("opt,codec,r", [("sgd", False, 1),
                                         ("momentum", True, 2),
                                         ("sgd", True, 4)])
def test_roundfuse_cost_model(opt, codec, r):
    _same("roundfuse_cost_model", n_agents=8, d=156_519_168, optimizer=opt,
          codec=codec, r_runs=r)
    for s, b_rows in ((2, 2), (4, 1), (8, 0)):
        _same("roundfuse_cost_model", n_agents=8, d=4096, optimizer=opt,
              codec=codec, r_runs=r, n_shards=s,
              boundary_rows_per_shard=b_rows, num_halo_rounds=2)
    for kw in (dict(optimizer="adamw"), dict(n_shards=3)):
        args = dict(n_agents=8, d=16, optimizer=opt) | kw
        with pytest.raises(ValueError) as want:
            ref.roundfuse_cost_model(**args)
        with pytest.raises(ValueError) as got:
            port.roundfuse_cost_model(**args)
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize("d", [25, 4097, 156_519_168])
def test_compress_models(d):
    for codec in ("none", "identity", "bf16", "int8", "topk:0.1",
                  "topk:0.25", "topk:1e-9"):
        assert port.compress_row_bytes(codec, d) == \
            ref.compress_row_bytes(codec, d)
    with pytest.raises(ValueError, match="unknown compress scheme"):
        port.compress_row_bytes("fp8", d)
    for s, rounds in ((1, 0), (2, 1), (4, 2)):
        _same("compressed_halo_cost_model", n_agents=8, d=d, n_shards=s,
              num_halo_rounds=rounds)
        _same("compressed_halo_cost_model", n_agents=8, d=d, n_shards=s,
              num_halo_rounds=rounds, param_bytes=2,
              schemes=("bf16", "topk:0.5"))


def test_roofline_terms():
    kw = dict(name="x", chips=4, per_device_flops=3e12,
              per_device_bytes=8e9, collective_bytes=2e8, model_flops=1e13)
    got, want = port.roofline_terms(**kw), ref.roofline_terms(**kw)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.row() == want.row()
    assert (got.dominant, got.useful_flops_ratio) == \
        (want.dominant, want.useful_flops_ratio)
