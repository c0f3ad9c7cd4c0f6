"""Render the port's dry-run records as markdown tables (port of
`repro/launch/report.py`).

    PYTHONPATH=src python -m repro_torch.launch.report --dir build/dryrun

A cell fits when its peak a rank lies within the card's memory: the
`total_memory` torch reports for one NVIDIA H100 80GB HBM3
(`CARD_MEMORY_BYTES`, read on the card by `chip_smoke.py`'s `dryrun_path`
phase), not the JAX package's 16 GiB a TPU chip.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import sys

# torch.cuda.get_device_properties(0).total_memory of an NVIDIA H100 80GB
# HBM3 at 700.00 W, as chip_smoke.py's dryrun_path phase reads it
CARD_MEMORY_BYTES = 85_017_493_504
CARD_MEMORY_GIB = CARD_MEMORY_BYTES / 2 ** 30


def load(dir_: str) -> list:
    out = []
    for path in sorted(glob.glob(os.path.join(dir_, "*.json"))):
        with open(path) as f:
            rec = json.load(f)
        if isinstance(rec, dict) and "ok" in rec:
            out.append(rec)
    return out


def fmt_s(x: float) -> str:
    if x == 0:
        return "0"
    if x < 1e-4:
        return f"{x:.2e}"
    return f"{x:.4f}" if x < 10 else f"{x:.2f}"


def dryrun_table(records: list) -> str:
    lines = ["| arch | shape | mesh | device | trace s | peak GiB/rank | "
             f"args GiB | temp GiB | fits {CARD_MEMORY_GIB:.1f}G |",
             "|---|---|---|---|---|---|---|---|---|"]
    for r in records:
        if "memory" not in r:
            lines.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
                         f"{r.get('traced_device', '—')} | FAIL | — | — | "
                         "— | — |")
            continue
        m = r["memory"]
        fits = "✓" if m["peak_gib"] <= CARD_MEMORY_GIB \
            else f"✗ ({m['peak_gib']:.0f}G)"
        status = "" if r.get("ok") else " (not ok)"
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
            f"{r.get('traced_device', '—')} | {r['compile_s']}{status} | "
            f"{m['peak_gib']:.4f} | {m['args_gib']:.4f} | "
            f"{m['temp_gib']:.4f} | {fits} |")
    return "\n".join(lines)


def args_table(records: list) -> str:
    """The LM cells' argument bytes a rank by part (`args_bytes_by_kind`:
    params, opt, inputs, state), in GiB, with the traced depth."""
    kinds = ("params", "opt", "inputs", "state")
    lines = ["| arch | shape | mesh | layers | "
             + " | ".join(f"{k} GiB" for k in kinds) + " |",
             "|---|---|---|---|" + "---|" * len(kinds)]
    for r in records:
        by = r.get("args_bytes_by_kind")
        if not by:
            continue
        lines.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
                     f"{r.get('layers', '—')} | " + " | ".join(
                         f"{by[k] / 2 ** 30:.4f}" if k in by else "—"
                         for k in kinds) + " |")
    return "\n".join(lines)


def roofline_table(records: list) -> str:
    lines = ["| arch | shape | compute s | memory s | collective s | "
             "dominant | MODEL_FLOPS | useful | operations by type |",
             "|---|---|---|---|---|---|---|---|---|"]
    for r in records:
        if "roofline" not in r or r.get("mesh") != "16x16":
            continue
        roof = r["roofline"]
        ops = ", ".join(f"{k} {v:.2e}"
                        for k, v in sorted(roof.get("ops_by_type",
                                                    {}).items()))
        lines.append(
            f"| {r['arch']} | {r['shape']} | {fmt_s(roof['compute_s'])} | "
            f"{fmt_s(roof['memory_s'])} | {fmt_s(roof['collective_s'])} | "
            f"{roof['dominant']} | {roof['model_flops']:.2e} | "
            f"{roof['useful_ratio']:.2f} | {ops} |")
    return "\n".join(lines)


def collective_summary(records: list) -> str:
    lines = ["| arch | shape | collective | count | group | operand MB | "
             "link MB |",
             "|---|---|---|---|---|---|---|"]
    for r in records:
        if "roofline" not in r or r.get("mesh") != "16x16":
            continue
        for kind, d in sorted(r["roofline"]["collectives_by_kind"].items()):
            lines.append(
                f"| {r['arch']} | {r['shape']} | {kind} | "
                f"{int(d['count'])} | {d.get('group_size', '—')} | "
                f"{d['operand_bytes'] / 1e6:.3f} | "
                f"{d['link_bytes'] / 1e6:.3f} |")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="build/dryrun")
    ap.add_argument("--section", choices=["dryrun", "roofline", "collective",
                                          "all"], default="all")
    args = ap.parse_args(argv)
    records = load(args.dir)
    if not records:
        print(f"no records in {args.dir}")
        return 1
    if args.section in ("dryrun", "all"):
        print("### Dry-run (traced) results\n")
        print(dryrun_table(records))
        print()
    if args.section in ("dryrun", "all") and any(
            "args_bytes_by_kind" in r for r in records):
        print("### LM arguments a rank by part\n")
        print(args_table(records))
        print()
    if args.section in ("roofline", "all"):
        print("### Roofline terms (single-pod 16×16, per rank)\n")
        print(roofline_table(records))
        print()
    if args.section in ("collective", "all"):
        print("### Collective breakdown (single-pod)\n")
        print(collective_summary(records))
    return 0


if __name__ == "__main__":
    sys.exit(main())
