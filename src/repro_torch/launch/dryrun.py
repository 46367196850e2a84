"""Dry run: trace every (architecture × input shape) of the port on meta
tensors (repro/launch/dryrun.py).

    PYTHONPATH=src python -m repro_torch.launch.dryrun [--arch A]
        [--shape S] [--mesh single|multi|both] [--jobs N]

For every combination this script:
  1. builds the step (FedDec train / prefill / decode, launch/steps.py)
     and its argument structs; nothing is allocated;
  2. traces it once on the meta device under launch/trace_analysis.py's
     tally (its kernels as their ops' fakes): shape errors and unsupported
     options fail here;
  3. records the peak of live bytes against the card's 80 GB (``fits``),
     the loop-weighted FLOPs, bytes and collectives, the kernel launches,
     and the roofline at the H100's figures (launch/analysis.py), as JSON
     under results/dryrun_torch/.

The reference's two first lines (512 XLA host devices) have no
counterpart: the records name the reference's meshes (16×16, 2×16×16),
agent counts and partition specs, and trace the program the port runs
(launch/steps.py): for the tree layout of the ``sharded`` agent layout's
models (the tiny LM, Qwen1.5-4B, Gemma3-12B, Nemotron-4-15B,
DeepSeek-V2-Lite-16B, Mamba2-2.7B, RecurrentGemma-9B, Qwen2-VL-2B,
SeamlessM4T-Large-v2) rank 0 of the partitioned world of data × model
ranks (16 × 16: one agent a mesh row, each leaf its ``param_pspecs``
block, the model's compute tensor-parallel over the 16 model ranks;
Mamba2's and SeamlessM4T's tables and heads cut on d, since 16 does not
divide their vocabularies), and for the ``replicated`` layout's tree
(whose tensor-parallel compute is not ported: ``tensor_parallel`` gives
the reason) and the flat layout all agents on one card; rank 0 of a fake world for the sharded layout; one serving
replica for prefill and decode.  The reference's record keys map so:

  * ``lower_s`` → ``trace_s``; ``compile_s`` and ``cost_analysis_raw``
    have none (no compiler; the tally is loop-weighted already);
  * ``hlo`` → ``ops``, with the same subkeys (``flops_per_device``,
    ``traffic_bytes_per_device``, ``collective_bytes``,
    ``collective_counts``, ``collective_bytes_by_kind``) and ``op_count``;
  * ``memory``: ``argument_bytes``, ``output_bytes``, ``alias_bytes``,
    ``temp_bytes`` and ``peak_bytes`` from the tally's live storages;
  * ``chips`` is the cards the port's program uses (the reference's
    device count is ``mesh_devices``): the world's size for a
    partitioned program;

and records add ``fits`` (peak ≤ the card's 80 GB), ``launches`` (kernel
ops by name), ``specs`` (the arguments' partition specs), for prefill
and decode ``batch_per_card``, and for the 2-D sharded program
(``--state-layout sharded --mesh-model M``) ``axis_separation``: the
traced collectives by mesh axis (launch/trace_analysis.py), beside the
``mesh2d`` byte model that ``--mesh-agents A`` adds.  A failing combination is
recorded with its reason and the sweep goes on.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import dataclasses
import json
import multiprocessing
import os
import time
import traceback

from repro_torch import sharding as shd
from repro_torch.configs import ARCH_NAMES, SHAPES, get_config
from repro_torch.configs.base import FedConfig
from repro_torch.launch import analysis, trace_analysis
from repro_torch.sharding import tp as tp_lib
from repro_torch.launch.steps import (adapt_for_mesh, build_fed_setup,
                                      build_lowerable)

__all__ = ["RESULTS_DIR", "CARD_BYTES", "production_axes", "card_shape",
           "run_one", "main"]

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "results", "dryrun_torch")
CARD_BYTES = 80e9    # NVIDIA H100 80GB HBM3


def production_axes(multi_pod: bool = False) -> shd.MeshAxes:
    """The reference's production mesh roles (repro/launch/mesh.py:20-23):
    16×16 ('data', 'model'), or 2×16×16 with 'pod'."""
    if multi_pod:
        return shd.MeshAxes(("pod", "data"), "model",
                            {"pod": 2, "data": 16, "model": 16})
    return shd.MeshAxes(("data",), "model", {"data": 16, "model": 16})


def _model_flops(cfg, shape) -> float:
    """Analytic MODEL_FLOPS: 6·N·D train, 2·N_active·D per decoded token."""
    n_active = cfg.num_active_params()
    if shape.kind == "train":
        return 6.0 * n_active * shape.seq_len * shape.global_batch
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.seq_len * shape.global_batch
    return 2.0 * n_active * 1 * shape.global_batch  # one token per request


def card_shape(shape, low):
    """The shape of the program traced: a serving step's batch is one
    card's replica's (``global_batch / data_size`` where that divides)."""
    if shape.kind == "train":
        return shape
    return dataclasses.replace(
        shape, global_batch=low.args_struct[1]["tokens"].shape[0])


def _gossip_model(cfg, axes, state_layout: str,
                  mesh_agents: int | None = None,
                  mesh_model: int | None = None) -> dict:
    """The per-impl gossip cost of this (arch × mesh) at the card's
    figures (repro/launch/dryrun.py:53-143): the tree and flat mixes, the
    compressed payload per row of every scheme, and with ``mesh_agents``
    the agent-sharded engine's and the compressed halo's collective
    bytes; with ``mesh_model`` the 2-D mesh's byte model."""
    from repro_torch.core import sharded as sharded_lib
    from repro_torch.models import build_model
    from repro_torch.tree import leaves as tree_leaves
    acfg = adapt_for_mesh(cfg, axes)
    fcfg, n_agents = build_fed_setup(acfg, axes)
    leaves = tree_leaves(build_model(acfg).init_shapes())
    d = int(sum(leaf.numel() for leaf in leaves))
    pbytes = leaves[0].element_size()
    model = analysis.gossip_cost_model(
        n_agents=n_agents, d=d, num_leaves=len(leaves),
        num_directed_edges=2 * fcfg.mixing.graph.num_edges,
        param_bytes=pbytes)
    rec = {"n_agents": n_agents, "d": d, "num_leaves": len(leaves),
           "param_bytes": int(pbytes),
           "state_layout": state_layout, "impls": model,
           "compress_payload_bytes_per_row": {
               scheme: analysis.compress_row_bytes(scheme, d, pbytes)
               for scheme in analysis.COMPRESS_SCHEMES}}
    if mesh_agents:
        if n_agents % mesh_agents:
            rec["sharded"] = {"skipped": f"mesh_agents={mesh_agents} does "
                              f"not divide n_agents={n_agents}"}
        else:
            cut = sharded_lib.cut_edge_stats(fcfg.mixing.graph, mesh_agents)
            split = sharded_lib.boundary_row_split(fcfg.mixing.graph,
                                                   mesh_agents)
            rec["sharded"] = {
                **cut,
                "boundary_rows_max": split["b_max"],
                "interior_rows_min": split["interior_min"],
                "roundfuse": analysis.roundfuse_cost_model(
                    n_agents=n_agents, d=d, n_shards=mesh_agents,
                    boundary_rows_per_shard=split["b_max"],
                    num_halo_rounds=cut["num_halo_rounds"],
                    param_bytes=pbytes),
                "impls": analysis.sharded_gossip_cost_model(
                    n_agents=n_agents, d=d, n_shards=mesh_agents,
                    num_cut_edges=cut["num_cut_edges"],
                    num_halo_rounds=cut["num_halo_rounds"],
                    param_bytes=pbytes),
                "compress": analysis.compressed_halo_cost_model(
                    n_agents=n_agents, d=d, n_shards=mesh_agents,
                    num_halo_rounds=cut["num_halo_rounds"],
                    param_bytes=pbytes)}
            if mesh_model and mesh_model > 1:
                if d % mesh_model:
                    rec["mesh2d"] = {"skipped": f"mesh_model={mesh_model} "
                                     f"does not divide d={d}"}
                else:
                    rec["mesh2d"] = {
                        "n_agent_shards": mesh_agents,
                        "n_model_shards": mesh_model,
                        "impls": analysis.mesh2d_cost_model(
                            n_agents=n_agents, d=d,
                            n_agent_shards=mesh_agents,
                            n_model_shards=mesh_model,
                            num_halo_rounds=cut["num_halo_rounds"],
                            param_bytes=pbytes)}
    return rec


def _spec_json(tree):
    """Partition specs as JSON lists (None for an unsharded dim)."""
    if isinstance(tree, dict):
        return {k: _spec_json(v) for k, v in tree.items()}
    if dataclasses.is_dataclass(tree):
        return {f.name: _spec_json(getattr(tree, f.name))
                for f in dataclasses.fields(tree)}
    if isinstance(tree, tuple):
        if all(a is None or isinstance(a, (str, tuple)) for a in tree):
            return [list(a) if isinstance(a, tuple) else a for a in tree]
        return [_spec_json(a) for a in tree]   # the arguments' trees
    return tree


def run_one(arch: str, shape_name: str, multi_pod: bool,
            out_dir: str | None = RESULTS_DIR,
            fused_steps: int | None = None,
            state_layout: str = "tree",
            mesh_agents: int | None = None,
            mesh_model: int | None = None,
            gossip_compress: str = "none",
            sweep_runs: int | None = None,
            sweep_axis: str = "seed",
            n_total: int | None = None,
            cohort_size: int = 256,
            sampling: str = "uniform",
            staleness: float = 0.0,
            fuse_update_mix: bool = False,
            impl: str = "xla") -> dict:
    """Trace one combination and write its record (the reference's
    ``run_one``; ``impl`` picks the prefill's path, 'pallas' its
    kernels)."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    axes = production_axes(multi_pod)
    train = shape.kind == "train"
    tag = f"{arch}__{shape_name}__{'multi' if multi_pod else 'single'}"
    if fused_steps and train:
        tag += f"__fused{fused_steps}"
    if state_layout in ("flat", "sharded") and train:
        tag += f"__{state_layout}"
        if state_layout == "sharded" and mesh_model and mesh_model > 1:
            tag += f"__m{mesh_model}"
    if fuse_update_mix and train:
        tag += "__updmix"
    if sweep_runs and train:
        tag += f"__sweep{sweep_runs}-{sweep_axis}"
    if n_total and train:
        tag += f"__pop{n_total}"
    if impl != "xla" and shape.kind == "prefill":
        tag += f"__{impl}"
    rec: dict = {"arch": arch, "shape": shape_name,
                 "mesh": "2x16x16" if multi_pod else "16x16",
                 "mesh_devices": 512 if multi_pod else 256,
                 "fused_steps": fused_steps if train else None,
                 "state_layout": state_layout if train else None}
    if gossip_compress != "none" and train:
        rec["gossip_compress"] = gossip_compress
    if sweep_runs and train:
        rec["sweep_runs"] = sweep_runs
        rec["sweep_axis"] = sweep_axis
    if n_total and train:
        rec["population"] = {"n_total": n_total, "cohort_size": cohort_size,
                             "sampling": sampling, "staleness": staleness}
    if shape.kind == "prefill":
        rec["impl"] = impl
    t0 = time.time()
    try:
        fed = FedConfig(gossip_compress=gossip_compress) \
            if gossip_compress != "none" else None
        mesh = axes
        if train and state_layout == "tree":
            # the tree engine's partitioned program (tensor-parallel over
            # the model axis) for the families whose compute is ported;
            # the others keep the one-card program, and say why
            try:
                tp_lib.check_family(cfg)
                rec["tensor_parallel"] = True
            except NotImplementedError as e:
                rec["tensor_parallel"] = str(e)
                mesh = None
        low = build_lowerable(cfg, shape, axes, fed=fed,
                              fused_steps=fused_steps,
                              state_layout=state_layout, mesh=mesh,
                              mesh_model=mesh_model,
                              sweep_runs=sweep_runs if train else None,
                              sweep_axis=sweep_axis,
                              fuse_update_mix=fuse_update_mix and train,
                              impl=impl)
        rec["specs"] = _spec_json(low.in_specs)
        lowered = low.lower()
        costs = lowered.costs
        chips = low.world
        steps_per_call = fused_steps if fused_steps and train else 1
        model_shape = card_shape(shape, low)
        if not train:
            rec["batch_per_card"] = model_shape.global_batch
        report = analysis.roofline_terms(
            name=tag, chips=chips, per_device_flops=costs.flops,
            per_device_bytes=costs.traffic_bytes,
            collective_bytes=costs.collective_bytes,
            model_flops=_model_flops(cfg, model_shape) * steps_per_call,
            compute_dtype=cfg.compute_dtype)
        rec.update({
            "status": "ok",
            "name": low.name,
            "chips": chips,
            "trace_s": round(lowered.trace_s, 1),
            "memory": costs.memory(),
            "fits": costs.peak_bytes <= CARD_BYTES,
            "ops": {"flops_per_device": costs.flops,
                    "traffic_bytes_per_device": costs.traffic_bytes,
                    "collective_bytes": costs.collective_bytes,
                    "collective_counts": costs.collective_counts,
                    "collective_bytes_by_kind":
                        costs.collective_bytes_by_kind,
                    "op_count": costs.ops},
            "launches": costs.launches,
            "roofline": report.row(),
        })
        if train and state_layout == "sharded" and low.world > axes.data_size:
            # the 2-D program: rank 0's collectives by axis of the traced
            # (data_size, M) mesh
            rec["axis_separation"] = trace_analysis.axis_separation(
                costs, axes.data_size, low.world // axes.data_size)
        if train:
            rec["gossip_cost_model"] = _gossip_model(cfg, axes, state_layout,
                                                     mesh_agents, mesh_model)
            gm = rec["gossip_cost_model"]
            if state_layout == "flat":
                rec["roundfuse_cost_model"] = analysis.roundfuse_cost_model(
                    n_agents=gm["n_agents"], d=gm["d"], optimizer="sgd",
                    codec=gossip_compress != "none",
                    param_bytes=gm["param_bytes"])
            if sweep_runs:
                rec["sweep_cost_model"] = analysis.sweep_cost_model(
                    r_runs=sweep_runs, n_agents=gm["n_agents"], d=gm["d"],
                    param_bytes=gm["param_bytes"],
                    residual=gossip_compress != "none")
                sh = gm.get("sharded", {})
                if mesh_agents and "num_halo_rounds" in sh:
                    rec["sharded_sweep_cost_model"] = \
                        analysis.sharded_sweep_cost_model(
                            r_runs=sweep_runs, n_agents=gm["n_agents"],
                            d=gm["d"], n_shards=mesh_agents,
                            num_halo_rounds=sh["num_halo_rounds"],
                            param_bytes=gm["param_bytes"],
                            residual=gossip_compress != "none")
            if n_total:
                rec["population_cost_model"] = analysis.population_cost_model(
                    n_total=n_total, cohort_size=cohort_size, d=gm["d"],
                    max_degree=8, h=fused_steps or 1,
                    param_bytes=gm["param_bytes"])
        mem = rec["memory"]
        print(f"[ok]   {tag}: trace {lowered.trace_s:.1f}s, {chips} "
              f"card{'s' if chips > 1 else ''}")
        print(f"       memory: peak {mem['peak_bytes'] / 1e9:.2f} GB "
              f"(args {mem['argument_bytes'] / 1e9:.2f} + temp "
              f"{mem['temp_bytes'] / 1e9:.2f}) "
              f"{'fits' if rec['fits'] else 'does not fit'} 80 GB")
        print(f"       ops(loop-weighted): {costs.summary()}")
        if costs.launches:
            print(f"       launches: {costs.launches}")
        print(f"       roofline (H100 SXM, 700 W, "
              f"{str(cfg.compute_dtype).removeprefix('torch.')}): compute "
              f"{report.compute_s * 1e3:.2f}ms memory "
              f"{report.memory_s * 1e3:.2f}ms collective "
              f"{report.collective_s * 1e3:.2f}ms → {report.dominant}; "
              f"useful-flops ratio {report.useful_flops_ratio:.2f}")
        if train and state_layout == "flat":
            gm = rec["gossip_cost_model"]
            pred = ", ".join(
                f"{k} {v['pred_us']:.0f}µs" for k, v in gm["impls"].items())
            print(f"       gossip/step (n={gm['n_agents']}, "
                  f"D={gm['d']:.2e}, {gm['num_leaves']} leaves): {pred}")
            rf = rec["roundfuse_cost_model"]
            print(f"       fused round: {rf['passes_unfused']}→"
                  f"{rf['passes_fused']} buffer passes/step "
                  f"({rf['pass_ratio']:.2f}x bytes)"
                  + (" [--fuse-update-mix traced]"
                     if fuse_update_mix else ""))
        if train and sweep_runs:
            sm = rec["sweep_cost_model"]
            print(f"       sweep lattice R={sweep_runs} ({sweep_axis}): "
                  f"state {sm['state_bytes'] / 1e9:.2f} GB "
                  f"(R× flat buffer), step stream "
                  f"{sm['step_stream_bytes'] / 1e9:.2f} GB")
        if train and n_total:
            pm = rec["population_cost_model"]
            print(f"       population n_total={n_total} "
                  f"(cohort {cohort_size}, sampling={sampling}): host store "
                  f"{pm['host_store_bytes'] / 1e9:.2f} GB, "
                  f"h2d+d2h {pm['hostdev_bytes_round'] / 1e6:.2f} MB/round, "
                  f"peak device {pm['peak_device_bytes'] / 1e6:.2f} MB "
                  f"(n_total-free)")
        if "axis_separation" in rec:
            print(f"       2-D mesh {axes.data_size}x"
                  f"{low.world // axes.data_size}: collectives by axis "
                  f"{rec['axis_separation']}")
        sh = rec.get("gossip_cost_model", {}).get("sharded", {})
        if train and mesh_agents and "impls" in sh:
            coll = ", ".join(f"{k} {v['collective_bytes'] / 1e6:.1f}MB"
                             for k, v in sh["impls"].items())
            print(f"       sharded over {mesh_agents}: cut edges "
                  f"{sh['num_cut_edges']}/{sh['num_directed_edges']}, "
                  f"{sh['num_halo_rounds']} halo rounds; "
                  f"collective/device: {coll}")
    except Exception as e:  # noqa: BLE001 — record and continue the sweep
        rec.update({"status": "fail", "error": f"{type(e).__name__}: {e}",
                    "traceback": traceback.format_exc()})
        print(f"[FAIL] {tag}: {type(e).__name__}: {e}")
    rec["wall_s"] = round(time.time() - t0, 1)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, tag + ".json"), "w") as f:
            json.dump(rec, f, indent=2, default=str)
    return rec


def _run_status(args: tuple) -> tuple:
    arch, shape, multi, out, kw = args
    rec = run_one(arch, shape, multi, out, **kw)
    return rec["status"], rec.get("error")


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--arch", action="append",
                   help="arch id or 'all' (the default); repeat for several")
    p.add_argument("--shape", default="all",
                   choices=["all"] + list(SHAPES))
    p.add_argument("--mesh", default="single",
                   choices=["single", "multi", "both"])
    p.add_argument("--fused", type=int, default=0, metavar="H",
                   help="trace train steps as the fused H-step round "
                        "(0 = per-step; non-train shapes unaffected)")
    p.add_argument("--state-layout", default="tree",
                   choices=["tree", "flat", "sharded"],
                   help="train-state engine: 'flat' the (n_agents, D) "
                        "buffer with the per-impl gossip cost model; "
                        "'sharded' the agent-sharded engine, rank 0 of a "
                        "world of the data axes' size over the fake "
                        "backend (sharded-layout archs only)")
    p.add_argument("--mesh-agents", type=int, default=None, metavar="N",
                   help="add the agent-sharded engine's cost model to "
                        "train-shape records")
    p.add_argument("--mesh-model", type=int, default=None, metavar="M",
                   help="with --mesh-agents A, record the 2-D (A, M) mesh "
                        "byte model; with --state-layout sharded and M > 1, "
                        "trace the 2-D engine (rank 0 of the data axes' "
                        "size × M ranks) and record its collectives by axis")
    p.add_argument("--fuse-update-mix", action="store_true",
                   help="trace train steps with Algorithm 1 lines 5-6 "
                        "fused (kernels #3/#4; --state-layout flat)")
    p.add_argument("--gossip-compress", default="none", metavar="SPEC",
                   help="trace train steps with compressed gossip (none | "
                        "identity | bf16 | int8 | topk:R)")
    p.add_argument("--sweep-runs", type=int, default=None, metavar="R",
                   help="trace train steps as the R-run sweep lattice "
                        "(--state-layout flat or sharded, and --fused H)")
    p.add_argument("--sweep-axis", default="seed",
                   choices=["seed", "h", "topology"])
    p.add_argument("--n-total", type=int, default=None, metavar="N",
                   help="record the population engine's cost model")
    p.add_argument("--cohort-size", type=int, default=256, metavar="C")
    p.add_argument("--sampling", default="uniform",
                   choices=["uniform", "weighted", "stale"])
    p.add_argument("--staleness", type=float, default=0.0, metavar="BETA")
    p.add_argument("--impl", default="xla", choices=["xla", "pallas"],
                   help="the prefill's path: 'pallas' traces the kernels "
                        "#15-#17 (their ops' fakes)")
    p.add_argument("--jobs", type=int, default=1, metavar="N",
                   help="trace N combinations at once, one process each")
    p.add_argument("--out", default=RESULTS_DIR)
    args = p.parse_args(argv)

    archs = list(ARCH_NAMES) if not args.arch or "all" in args.arch \
        else args.arch
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    kw = dict(fused_steps=args.fused or None,
              state_layout=args.state_layout,
              mesh_agents=args.mesh_agents, mesh_model=args.mesh_model,
              gossip_compress=args.gossip_compress,
              sweep_runs=args.sweep_runs, sweep_axis=args.sweep_axis,
              n_total=args.n_total, cohort_size=args.cohort_size,
              sampling=args.sampling, staleness=args.staleness,
              fuse_update_mix=args.fuse_update_mix, impl=args.impl)
    combos = [(a, s, m, args.out, kw) for a in archs for s in shapes
              for m in meshes]
    if args.jobs > 1:
        ctx = multiprocessing.get_context("spawn")
        with concurrent.futures.ProcessPoolExecutor(args.jobs,
                                                    mp_context=ctx) as pool:
            statuses = list(pool.map(_run_status, combos))
    else:
        statuses = [_run_status(c) for c in combos]
    failures = [s for s in statuses if s[0] != "ok"]
    print(f"\n{len(failures)} failures / {len(combos)} combos")
    if failures:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
