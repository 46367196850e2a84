#!/usr/bin/env python3
"""Predicted peaks of chip_smoke.py phase 4i's programs (the dry run's
tally on meta tensors, nothing allocated).

    PYTHONPATH=src python3 scripts/tp_peaks.py [p1 p7 ...]

For each tensor-parallel path of ``chip_smoke.TP_PATHS`` (or those
named): its
one-device twin's step (core/feddec.make_feddec_step, all n agents)
and rank 0's step in a fake world of A·M ranks (chip_smoke.tp_program),
each traced once: the arguments' bytes, the bytes above them (temp) and
the peak of live bytes, and rank 0's collectives a step.
"""

from __future__ import annotations

import importlib.util
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> None:
    sys.path.insert(0, str(ROOT / "src"))
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = cs
    spec.loader.exec_module(cs)
    import torch
    from repro_torch.core import feddec
    from repro_torch.core.draws import ShapeDraws
    from repro_torch.launch.mesh import make_fed_mesh
    from repro_torch.launch.steps import _fake_world
    from repro_torch.launch.trace_analysis import tally
    from repro_torch.models import build_model
    names = sys.argv[1:] or list(cs.TP_PATHS)
    for name in names:
        arch, a, m, n, layers, _ = cs.TP_PATHS[name]
        cfg, fcfg = cs.tp_fed(name)
        model = build_model(cfg)
        state = feddec.init_state(model.init_shapes(), n)
        eta = torch.full((1,), cs.TP_LR, device="meta")
        step = feddec.make_feddec_step(fcfg, model.grad_fn(),
                                       lambda t: eta, device="meta")
        batch = cs.tp_meta_batch(name, n)
        _, twin = tally(step, state, batch, ShapeDraws("meta"))
        with _fake_world(a * m):
            prog = cs.tp_program(torch, name, "meta",
                                 make_fed_mesh(a, m, device="meta"))
            _, rank0 = tally(prog["step"], prog["state"],
                             prog["batches"][0], prog["draws"])
        print(f"{name} {arch} {layers} layers, {n} agents, {a} x {m}: twin "
              f"args {twin.memory()['argument_bytes'] / 1e9:.2f} GB, temp "
              f"{twin.temp_bytes / 1e9:.2f} GB, peak "
              f"{twin.peak_bytes / 1e9:.2f} GB; rank 0 state "
              f"{cs.tp_expected_bytes(prog) / 1e9:.2f} GB, temp "
              f"{rank0.temp_bytes / 1e9:.2f} GB, peak "
              f"{rank0.peak_bytes / 1e9:.2f} GB, collectives "
              f"{rank0.collective_bytes / 1e9:.2f} GB a step "
              f"{rank0.collective_counts}")


if __name__ == "__main__":
    main()
