#!/usr/bin/env python3
"""chip_smoke.py's tensor-parallel pieces alone, on one H100: phase 3's
#15 rows at the TP forwards' shapes (ZOO_FULL's "tp2" entries) and
phase 4i's paths named on the command line (default: all of TP_PATHS),
each in its gloo world with its one-device twin and checks.

    python3 scripts/chip_tp_paths.py [p7 p8 ...]

Prints chip_smoke's own lines and the host memory the paths took,
writes chiprun_out/chip_tp_paths.json, and exits non-zero where a check
fails.  It builds the kernels as
chip_smoke.py does and needs the card.
"""

import json
import subprocess
import sys
import time
from pathlib import Path

if __name__ == "__main__":     # the gloo ranks re-import this module
    root = Path(__file__).resolve().parent.parent
    sys.path.insert(0, str(root))
    sys.path.insert(0, str(root / "src"))
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import build
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    cs.log(f"[device] {smi}")
    t0 = time.perf_counter()
    build.load()
    cs.log(f"[build] {time.perf_counter() - t0:.1f} s")
    out = {"nvidia_smi": smi}
    cs.ZOO_FULL = {"flash_attention": {
        k: v for k, v in cs.ZOO_FULL["flash_attention"].items()
        if k.endswith("tp2")}}
    cs.FLASH_EDGE, cs.SSD_EDGE, cs.RGLRU_EDGE = [], [], []
    cs.split_p_check = lambda torch: {}
    cs.ssd_accuracy_check = lambda torch: {}
    out["flash_attention"] = cs.zoo_kernel_phase(torch)["flash_attention"]
    names = sys.argv[1:] or list(cs.TP_PATHS)
    cs.TP_PATHS = {k: cs.TP_PATHS[k] for k in names}
    cs.MESH2D_PATHS = {}
    cs.mesh2d_twins = lambda torch, work: ({}, {})
    t0 = time.perf_counter()
    host = cs.HostMemory()
    _, out["tp_paths"] = cs.gloo_phase(torch)
    out["host_memory"] = host.take()
    host.close()
    cs.log(f"[tp] paths {', '.join(names)}: "
           f"{time.perf_counter() - t0:.1f} s; the processes' resident sets "
           f"at most {out['host_memory']['peak_rss_bytes'] / 1e9:.2f} GB, "
           f"MemAvailable at least "
           f"{out['host_memory']['least_available_bytes'] / 1e9:.2f} of "
           f"{host.total / 1e9:.2f} GB")
    (root / "chiprun_out").mkdir(exist_ok=True)
    (root / "chiprun_out" / "chip_tp_paths.json").write_text(
        json.dumps(out, indent=1, default=str))
