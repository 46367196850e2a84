#!/usr/bin/env python3
"""Time the dense small-path mix kernels of a checkout on f32 and f64.

    python3 scripts/time_small_mix.py [ROOT] [--label NAME]

builds the kernels of the checkout at ROOT (default: this one) and times
#1 (gossip_mix), #3 (update_mix: sgd, momentum, nesterov), #5
(gossip_mix_batched) and #7 (update_mix_batched) at chip_smoke.py's
phase-3 shape: n 8 and D 156,519,168 in f32, R 2 runs for #5 and #7; in
f64 the same at D 78,259,584, the same bytes.  Each kernel is checked
against its plain version first (within 1e-5·max|y|) and then timed with
CUDA events (chip_smoke.time_ms).  It prints one JSON line
{"label", "root", "device", "rows": [{"kernel", "variant", "dtype", "ms",
"bound_ms", "share_of_bound"}, ...]}.  To compare two versions of
kernels/csrc/, run both checkouts in one call, in the order parent,
change, change, parent: each process builds its own checkout's kernels.
Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
KERNELS = {"gossip_mix": ["gossip"],
           "update_mix": ["sgd", "momentum", "nesterov"],
           "gossip_mix_batched": ["gossip"],
           "update_mix_batched": ["sgd", "momentum", "nesterov"]}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("root", nargs="?", default=str(HERE))
    ap.add_argument("--label", default=None)
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root / "src"))
    import torch
    if not torch.cuda.is_available():
        print("time_small_mix: no CUDA card", file=sys.stderr)
        return 1
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from repro_torch.kernels import ops
    rows = []
    for dtype, itemsize, d in ((torch.float32, 4, cs.D_FULL),
                               (torch.float64, 8, cs.D_FULL // 2)):
        for kernel, variants in KERNELS.items():
            batched = kernel.endswith("_batched")
            r = cs.R_FULL if batched else 1
            if batched:
                graphs = cs.lattice_graphs(r, cs.N_AGENTS)
                t = cs.make_lattice_inputs(torch, r, cs.N_AGENTS, d, seed=8,
                                           graphs=graphs)
            else:
                t = cs.make_inputs(torch, cs.N_AGENTS, d, seed=7)
            t = {k: v.to(dtype) if k in ("x", "g", "w") else v
                 for k, v in t.items()}
            for variant in variants:
                if batched:  # held run by run: one run's plain temporaries
                    run, plain, _, _ = cs.batched_calls(kernel, variant, t)
                    wants = [lambda i=i: plain(slice(i, i + 1))
                             for i in range(r)]
                else:
                    run, plain, _ = cs.calls(kernel, variant, t)
                    wants = [plain]
                got = run()
                torch.cuda.synchronize()
                for i, want in enumerate(wants):
                    part = (tuple(a[i:i + 1] for a in cs.as_tuple(got))
                            if batched else got)
                    err, scale = cs.max_err(torch, part, want())
                    if err > cs.TOL * scale:
                        print(f"{kernel}[{variant}] {dtype}: max_abs_err "
                              f"{err:.3e} > {cs.TOL}·{scale:.3e}",
                              file=sys.stderr)
                        return 1
                del got, part
                torch.cuda.empty_cache()
                ms = cs.time_ms(torch, run)
                bound_ms, _ = cs.bound(kernel, variant, cs.N_AGENTS, d, 1,
                                       r=r, itemsize=itemsize)
                rows.append({"kernel": kernel, "variant": variant,
                             "dtype": str(dtype).removeprefix("torch."),
                             "d": d, "r": r, "ms": ms, "bound_ms": bound_ms,
                             "share_of_bound": bound_ms / ms,
                             "launches": ops.launch_counts()[kernel]})
                torch.cuda.empty_cache()
            del t
            torch.cuda.empty_cache()
    print(json.dumps({"label": args.label, "root": str(root),
                      "device": torch.cuda.get_device_name(0),
                      "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
