#!/usr/bin/env python3
"""Print a markdown table of dry-run records (launch/dryrun.py's JSON).

    python3 scripts/dryrun_table.py [DIR] [--long]
                                       # DIR: default results/dryrun_torch

One row per arch, one column per shape; each cell gives the peak of live
bytes a card (GB), whether it fits the card's 80 GB (yes/no), the
dominant roofline term at the H100's figures and the useful-FLOPs ratio
(the analytic model FLOPs over the traced FLOPs).  ``--long`` prints one
row per record with the dominant term's milliseconds, the traced FLOPs
and the kernel launches.  A failed record gives its error instead.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

SHAPE_ORDER = ("train_4k", "prefill_32k", "decode_32k", "long_500k")


def _records(directory: Path) -> list[dict]:
    return [json.loads(p.read_text()) for p in sorted(directory.glob(
        "*.json"))]


def compact(directory: Path) -> list[str]:
    cells: dict = {}
    for r in _records(directory):
        if r["status"] != "ok":
            cell = f"fail: {r['error'][:40]}"
        else:
            roof = r["roofline"]
            cell = (f"{r['memory']['peak_bytes'] / 1e9:.1f}, "
                    f"{'yes' if r['fits'] else 'no'}, {roof['dominant']}, "
                    f"{roof['useful_ratio']:.2f}")
        cells.setdefault(r["arch"], {})[r["shape"]] = cell
    out = ["| arch | " + " | ".join(SHAPE_ORDER) + " |",
           "|---" * (len(SHAPE_ORDER) + 1) + "|"]
    for arch in sorted(cells):
        out.append(f"| {arch} | " + " | ".join(
            cells[arch].get(s, "—") for s in SHAPE_ORDER) + " |")
    return out


def rows(directory: Path) -> list[str]:
    recs = _records(directory)
    recs.sort(key=lambda r: (r["arch"], SHAPE_ORDER.index(r["shape"])
                             if r["shape"] in SHAPE_ORDER else 9))
    out = ["| arch | shape | status | peak GB / card | fits 80 GB | "
           "dominant (ms) | useful FLOPs | traced FLOPs | launches |",
           "|---|---|---|---|---|---|---|---|---|"]
    for r in recs:
        if r["status"] != "ok":
            out.append(f"| {r['arch']} | {r['shape']} | fail: "
                       f"{r['error'][:80]} | | | | | | |")
            continue
        roof = r["roofline"]
        dom = roof["dominant"]
        ms = roof[f"{dom}_s"] * 1e3
        launches = ", ".join(f"{k} × {v}" for k, v in r["launches"].items())
        out.append(
            f"| {r['arch']} | {r['shape']} | ok | "
            f"{r['memory']['peak_bytes'] / 1e9:.2f} | "
            f"{'yes' if r['fits'] else 'no'} | {dom} ({ms:.1f}) | "
            f"{roof['useful_ratio']:.2f} | "
            f"{r['ops']['flops_per_device']:.3e} | {launches or '—'} |")
    return out


def main() -> None:
    args = [a for a in sys.argv[1:] if a != "--long"]
    directory = Path(args[0] if args else "results/dryrun_torch")
    table = rows if "--long" in sys.argv[1:] else compact
    print("\n".join(table(directory)))


if __name__ == "__main__":
    main()
