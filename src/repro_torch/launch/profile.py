"""Profilers of the port (repro/launch/profile.py).

* :func:`profile_one`, the dry-run profiler: traces one (arch × shape ×
  mesh) step on meta tensors (launch/steps.py) and prints its peak, its
  roofline at the H100's figures and the heaviest ops by traffic and the
  collectives, so that an optimisation can be checked against the op it
  targets before a card run::

      PYTHONPATH=src python -m repro_torch.launch.profile \\
          --arch gemma3-12b --shape train_4k [--multi] [--top N]

* :func:`trace_step`, the card's profiler: runs a program under
  ``torch.profiler`` twice, at 0 steps (its set-up: weights, data,
  buffers) and at ``steps``, and takes the set-up's device work out of
  the second run, giving per step the device time by kernel group
  (launch/trace_analysis.py ``kernel_group``), the top kernels, the
  device ops, the busy share and the longest idle gaps.
"""

from __future__ import annotations

import argparse
import tempfile
from pathlib import Path

from repro_torch.configs import SHAPES, get_config
from repro_torch.launch.analysis import roofline_terms
from repro_torch.launch.dryrun import (_model_flops, card_shape,
                                       production_axes)
from repro_torch.launch.steps import build_lowerable
from repro_torch.launch.trace_analysis import analyze_trace, device_events

__all__ = ["profile_one", "trace_step", "traced_events"]


def profile_one(arch: str, shape_name: str, multi_pod: bool = False,
                top: int = 14, **build_kw):
    """Trace one step and print its hot ops; returns (RooflineReport,
    OpCosts, memory dict)."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    axes = production_axes(multi_pod)
    if shape.kind == "train":
        build_kw.setdefault("mesh", axes)
    low = build_lowerable(cfg, shape, axes, **build_kw)
    costs = low.lower().costs
    mem = costs.memory()
    rep = roofline_terms(
        name=f"{arch}:{shape_name}", chips=low.world,
        per_device_flops=costs.flops, per_device_bytes=costs.traffic_bytes,
        collective_bytes=costs.collective_bytes,
        model_flops=_model_flops(cfg, card_shape(shape, low)),
        compute_dtype=cfg.compute_dtype)
    print(f"=== {arch} × {shape_name} × "
          f"{'2x16x16' if multi_pod else '16x16'} (the port's program: "
          f"{low.world} card{'s' if low.world > 1 else ''}) ===")
    print(f"peak memory/card: {mem['peak_bytes'] / 1e9:.1f}GB "
          f"(args {mem['argument_bytes'] / 1e9:.1f} + temp "
          f"{mem['temp_bytes'] / 1e9:.1f})")
    print(f"roofline (H100 SXM, 700 W): compute {rep.compute_s:.3f}s | "
          f"memory {rep.memory_s:.3f}s | collective {rep.collective_s:.3f}s "
          f"→ {rep.dominant} | useful {rep.useful_flops_ratio:.2f}")
    if costs.launches:
        print(f"kernel launches: {costs.launches}")
    print(costs.profile(top))
    return rep, costs, mem


def traced_events(run, steps: int, trace_dir=None) -> list:
    """The device events (kernels, copies, sets) of ``run(steps)`` under
    torch.profiler (device activity only), through a Chrome trace written
    to ``trace_dir`` (a temporary directory by default) and removed."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run(steps)
    with tempfile.TemporaryDirectory(dir=trace_dir) as tmp:
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        return device_events(path)


def trace_step(run, steps: int, step_ms: float | None = None,
               trace_dir=None, top: int = 10) -> dict:
    """Where a step's device time goes: ``run(n)`` runs the program for n
    steps; it is traced at 0 steps (the set-up alone) and at ``steps``,
    and the set-up's device work is taken out of the second trace.  The
    busy share is the steps' device time over ``step_ms`` (an unprofiled
    step's time, since the profiler slows the host), where given, and
    over the traced span (``busy_share_traced``).  Launches made here do
    not count for a main path."""
    setup = traced_events(run, 0, trace_dir)
    events = traced_events(run, steps, trace_dir)
    if not events:
        return {"traced": False}
    s, r = analyze_trace(setup), analyze_trace(events)
    groups = {g: (ms - s.groups_ms.get(g, 0.0)) / steps
              for g, ms in r.groups_ms.items()}
    names = {}
    for name, (ms, count) in r.names.items():
        base_ms, base_count = s.names.get(name, (0.0, 0))
        if count > base_count:
            names[name] = ((ms - base_ms) / steps,
                           (count - base_count) / steps)
    device_ms = sum(groups.values())
    out = {"traced": True, "steps": steps, "setup_ops": s.events,
           "setup_device_ms": s.device_ms,
           "launches_per_step": (r.events - s.events) / steps,
           "device_ms_per_step": device_ms,
           "groups_ms_per_step": groups,
           "top_ms_per_step": [[n, ms, c] for n, (ms, c) in sorted(
               names.items(), key=lambda kv: -kv[1][0])[:top]],
           "busy_share_traced": r.busy_share,
           "idle_gaps_ms": r.idle_gaps_ms,
           "nccl": r.nccl, "comm_bytes": r.comm_bytes}
    if step_ms:
        out["step_ms_unprofiled"] = step_ms
        out["device_busy_share"] = device_ms / step_ms
    return out


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--arch", required=True)
    p.add_argument("--shape", required=True, choices=list(SHAPES))
    p.add_argument("--multi", action="store_true")
    p.add_argument("--top", type=int, default=14)
    p.add_argument("--impl", default="xla", choices=["xla", "pallas"],
                   help="the prefill's path ('pallas': kernels #15-#17)")
    args = p.parse_args(argv)
    profile_one(args.arch, args.shape, args.multi, args.top, impl=args.impl)


if __name__ == "__main__":
    main()
