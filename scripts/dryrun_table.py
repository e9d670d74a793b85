#!/usr/bin/env python3
"""Print the dry-run's records (``python -m repro_torch.launch.dryrun``'s
``<out>/*.json``) as a Markdown table: one row per (cell, tag), its 16x16
and 2x16x16 records side by side (``a / b``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes \\
        --analysis --jobs 8 --out experiments/dryrun
    python scripts/dryrun_table.py experiments/dryrun
"""

from __future__ import annotations

import glob
import json
import os
import sys

GIB = 2 ** 30
CARD_GIB = 80     # an H100's memory: ``**no**`` where a rank's does not fit


def _pair(recs: list[dict], fn, fmt: str = "{:.3g}") -> str:
    return " / ".join(fmt.format(fn(r)) for r in recs)


def table(out: str) -> str:
    """Per-rank operations, bytes and collective bytes by kind, the
    roofline's terms, and argument + temp memory against the card's."""
    cells: dict[tuple, dict] = {}
    for path in sorted(glob.glob(os.path.join(out, "*.json"))):
        with open(path) as fh:
            rec = json.load(fh)
        cells.setdefault((rec["arch"], rec["shape"], rec["tag"]), {})[rec["multi_pod"]] = rec
    rows = ["| arch | shape | tag | parts | ops / rank | bytes / rank | all-gather B "
            "| reduce-scatter B | all-reduce B | compute s | memory s | collective s "
            "| dominant | useful | roofline | arg + temp GiB |",
            "| " + " | ".join(["---"] * 16) + " |"]
    for (arch, shape, tag), by_mesh in sorted(cells.items(), key=lambda kv: (kv[0][2], *kv[0][:2])):
        recs = [by_mesh[mp] for mp in (False, True) if mp in by_mesh]

        def mem(r):
            gib = (r["memory"]["argument_bytes"] + r["memory"]["temp_bytes"]) / GIB
            return f"{gib:.1f}" + ("" if gib <= CARD_GIB else " **no**")

        def roof(key, fmt="{:.3g}"):
            return _pair(recs, lambda r: r["roofline"][key], fmt)

        def coll(kind):
            return _pair(recs, lambda r: r["roofline"]["coll_bytes"].get(kind, 0))
        rows.append(
            f"| {arch} | {shape} | {tag} | {'+'.join(recs[0]['parts'])} "
            f"| {_pair(recs, lambda r: r['roofline']['flops'] / r['chips'])} "
            f"| {_pair(recs, lambda r: r['roofline']['bytes_accessed'] / r['chips'])} "
            f"| {coll('all-gather')} | {coll('reduce-scatter')} | {coll('all-reduce')} "
            f"| {roof('compute_s')} | {roof('memory_s')} | {roof('collective_s')} "
            f"| {roof('dominant', '{}')} | {roof('useful_ratio')} "
            f"| {roof('roofline_fraction')} | {' / '.join(mem(r) for r in recs)} |")
    return "\n".join(rows)


if __name__ == "__main__":
    print(table(sys.argv[1] if len(sys.argv) > 1 else "experiments/dryrun"))
