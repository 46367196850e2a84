"""The port's trace analyser (repro_torch/launch/trace_analysis.py), the
counterpart of the reference's loop-aware HLO analysis.

The tally (a TorchDispatchMode) on a known matmul chain gives its FLOPs
and bytes exactly; view and metadata ops move nothing; a one-rank gloo
world's collectives and a fake world's halo sends and receives are
counted by the reference's kinds; a synthetic Chrome trace gives its
groups, busy share, idle gaps and NCCL bytes; and the tally on meta
tensors equals the same tally of a real CPU step of the tiny LM at smoke
width, op for op, FLOP for FLOP, byte for byte and in its peak.
"""

from __future__ import annotations

import json

import pytest
import torch
import torch.distributed as dist

from repro_torch.configs.base import FedConfig
from repro_torch.configs.shapes import ShapeConfig
from repro_torch.launch import steps, train
from repro_torch.launch.trace_analysis import (OpCosts, analyze_trace,
                                               kernel_group, tally)
from repro_torch.sharding import MeshAxes
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)


def test_matmul_chain_flops_and_bytes():
    a, b, c = torch.ones(4, 8), torch.ones(8, 16), torch.ones(16, 2)
    out, costs = tally(lambda: (a @ b) @ c)
    assert out.shape == (4, 2)
    assert costs.flops == 2 * 4 * 8 * 16 + 2 * 4 * 16 * 2
    # each op reads its inputs and writes its output once
    assert costs.traffic_bytes == 4 * ((4 * 8 + 8 * 16 + 4 * 16)
                                       + (4 * 16 + 16 * 2 + 4 * 2))
    assert costs.ops == 2 and costs.op_counts == {"aten::mm": 2}
    assert costs.top_traffic[0][1] == "aten::mm"
    assert "TOTAL flops=" in costs.profile(2) and "ops=2" in costs.summary()


def test_views_are_free_and_memory_is_tracked():
    x = torch.ones(64, 64)

    def f(x):
        v = x.view(4096).t() if x.ndim == 1 else x.t()[:, :32]
        y = v * 2.0                      # 64·32 read, 64·32 written
        return y.unsqueeze(0).expand(3, 64, 32), x

    _, costs = tally(f, x)
    assert costs.op_counts["aten::mul"] == 1
    assert costs.traffic_bytes == 2 * 64 * 32 * 4
    assert costs.argument_bytes == 64 * 64 * 4
    assert costs.peak_bytes == 64 * 64 * 4 + 64 * 32 * 4
    assert costs.temp_bytes == 64 * 32 * 4
    # the output aliases its argument through x
    assert costs.alias_bytes == 64 * 64 * 4
    assert costs.output_bytes == 64 * 64 * 4 + 64 * 32 * 4


def test_a_freed_temporary_leaves_the_live_bytes():
    def f():
        big = torch.ones(1000)           # 4000 B
        small = big.sum()                # kept
        del big
        return small + torch.ones(10)    # 40 B at the end
    _, costs = tally(f)
    # the peak is the temporary and its sum together; the end holds 84 B
    assert costs.peak_bytes == 4000 + 4


def test_one_rank_gloo_collectives_by_kind(tmp_path):
    store = dist.FileStore(str(tmp_path / "store"), 1)
    dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    try:
        x = torch.ones(8, 4)

        def f():
            dist.all_reduce(x)
            out = torch.empty(8, 4)
            dist.all_gather_into_tensor(out, x)
            dist.all_to_all_single(torch.empty(8, 4), x)
            return out
        _, costs = tally(f)
    finally:
        dist.destroy_process_group()
    assert costs.collective_counts == {
        "all-gather": 1, "all-reduce": 1, "reduce-scatter": 0,
        "all-to-all": 1, "collective-permute": 0}
    assert costs.collective_bytes_by_kind["all-reduce"] == 8 * 4 * 4
    assert costs.collective_bytes == 3 * 8 * 4 * 4
    assert costs.top_collectives


def test_fake_world_halo_counts_collective_permutes():
    """The sharded engine's halo (batch_isend_irecv) in a fake world of 4
    ranks, on meta tensors: each send and receive is a permute."""
    with steps._fake_world(4):
        x = torch.empty(2, 16, device="meta")

        def f():
            recv = torch.empty_like(x)
            ops = [dist.P2POp(dist.isend, x, 1),
                   dist.P2POp(dist.irecv, recv, 3)]
            for w in dist.batch_isend_irecv(ops):
                w.wait()
            dist.reduce_scatter_tensor(torch.empty(1, 16, device="meta"),
                                       torch.empty(4, 16, device="meta"))
            return recv
        _, costs = tally(f)
    assert not dist.is_initialized()
    assert costs.collective_counts["collective-permute"] == 2
    assert costs.collective_counts["reduce-scatter"] == 1
    assert costs.collective_bytes_by_kind["collective-permute"] == \
        2 * 2 * 16 * 4


def _event(name, ts, dur, cat="kernel"):
    return {"name": name, "cat": cat, "ph": "X", "ts": ts, "dur": dur}


def test_synthetic_chrome_trace(tmp_path):
    events = [
        _event("ampere_sgemm_128x64_nn", 0, 100),
        _event("feddec::update_mix_dense_kernel", 100, 50),
        _event("void at::native::vectorized_elementwise_kernel", 200, 20),
        _event("ncclDevKernel_AllReduce_Sum_f32", 400, 30),
        _event("Memcpy HtoD", 430, 10, "gpu_memcpy"),
        _event("reduce_kernel", 1000, 40),
        _event("void (anonymous namespace)::tc::kernel<128>(bf16)", 1040,
               10),
        _event("nvjet_tst_320x128_64x3_1x2_h_bz_coopB_NNT", 1050, 10),
        _event("a host op", 0, 5000, "cpu_op"),
        {"name": "record_param_comms", "cat": "cpu_op", "ph": "X", "ts": 0,
         "dur": 1, "args": {"Collective name": "allreduce",
                            "Out msg nelems": 1024, "dtype": "Float"}},
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    for source in (path, {"traceEvents": events}, events):
        got = analyze_trace(source, gaps=2)
        assert got.events == 8
        assert got.device_ms == pytest.approx(0.27)
        assert got.span_ms == pytest.approx(1.06)
        assert got.busy_share == pytest.approx(0.27 / 1.06)
        assert got.idle_gaps_ms == pytest.approx([0.56, 0.18])
        assert got.groups_ms == pytest.approx({
            "matmul (cuBLAS)": 0.11, "mix kernel (csrc)": 0.05,
            "elementwise": 0.02, "nccl": 0.03, "copies and sets": 0.01,
            "reductions": 0.04, "zoo kernel (csrc)": 0.01})
        assert got.nccl == {"ncclDevKernel_AllReduce_Sum_f32": [0.03, 1]}
        assert got.comm_bytes == {"allreduce": 4096}
        assert got.names["ampere_sgemm_128x64_nn"] == [0.1, 1]
    assert kernel_group({"name": "x", "cat": "gpu_memset"}) == \
        "copies and sets"


def _tiny_train(layout: str, **kw):
    cfg = train.tiny_lm_config(d_model=64, layers=2, vocab=256)
    axes = MeshAxes(("data",), "model", {"data": 4, "model": 1})
    return steps.build_train_lowerable(
        cfg, ShapeConfig("t", 16, 8, "train"), axes,
        fed=FedConfig(n_agents=4, h=2, k=2, gossip_impl="dense"),
        state_layout=layout, **kw)


@pytest.mark.parametrize("layout,kw", [
    ("flat", {}), ("flat", dict(optimizer="momentum", fused_steps=2)),
    ("tree", {}), ("flat", dict(microbatches=2))],
    ids=["flat", "flat-momentum-fused2", "tree", "flat-micro2"])
def test_fake_tally_equals_a_real_cpu_step(layout, kw):
    """The tiny LM's step at smoke width traced on meta tensors and run on
    the CPU under the same tally: the same ops, FLOPs, bytes, peak and
    memory (dense gossip: no kernel, so the CPU runs the same ops)."""
    low = _tiny_train(layout, **kw)
    fake = low.lower().costs
    fn = low.make_fn(torch.device("cpu"))
    _, real = tally(fn, *low.make_args("cpu", 0))
    assert isinstance(real, OpCosts)
    assert (real.ops, real.op_counts, real.flops, real.traffic_bytes) == \
        (fake.ops, fake.op_counts, fake.flops, fake.traffic_bytes)
    assert real.memory() == fake.memory()


def test_parse_collectives_reads_the_tally(tmp_path):
    """analysis.parse_collectives on a tally: the reference's
    CollectiveStats fields, total and summary; _shape_bytes as the
    reference's."""
    from repro.launch import analysis as ref
    from repro_torch.launch import analysis
    with steps._fake_world(4):
        x = torch.empty(8, 16, device="meta")

        def f():
            dist.all_reduce(x)
            dist.reduce_scatter_tensor(torch.empty(2, 16, device="meta"), x)
        _, costs = tally(f)
    got = analysis.parse_collectives(costs)
    assert got.counts["all-reduce"] == 1 == got.counts["reduce-scatter"]
    assert got.bytes_by_kind["all-reduce"] == 8 * 16 * 4
    assert got.bytes_by_kind["reduce-scatter"] == 2 * 16 * 4
    assert got.total_bytes == costs.collective_bytes
    want = ref.CollectiveStats(counts=got.counts,
                               bytes_by_kind=got.bytes_by_kind)
    assert got.summary() == want.summary()
    for dtype, dims in (("bf16", "4,1024,512"), ("f32", ""), ("s8", "7"),
                        ("pred", "3,3"), ("u4", "10")):
        assert analysis._shape_bytes(dtype, dims) == \
            ref._shape_bytes(dtype, dims)
