"""Standalone lint entry: check the six ULEEN cells' programs.

    PYTHONPATH=src python -m repro_torch.analysis.cli [--json ANALYSIS.json]

Traces each cell as rank 0 of a fake world of 8 ranks meshed (data 2,
model 4) — the mesh the JAX package's CI lints on from 8 forced host
devices — at a reduced batch (`LINT_BATCH`: rule verdicts do not depend
on it), on the card's program by default (`--device cpu` for the plain
one). No card and no process beyond this one. `launch/dryrun.py
--analyze` runs the same rules on the production meshes. Exit 1 on any
error-severity finding.
"""
from __future__ import annotations

import argparse
import json
import sys

from repro_torch.analysis import cells, registry

LINT_BATCH = 8192   # divisible by every (pod, data) split the rules pick
LINT_MESH = ((2, 4), ("data", "model"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--shape", action="append",
                    choices=list(cells.ULEEN_CELLS),
                    help="cell shape(s) to lint (default: all)")
    ap.add_argument("--backend", default="auto",
                    choices=["fused", "gather", "packed", "auto"])
    ap.add_argument("--batch", type=int, default=LINT_BATCH)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="trace the card's program (default) or the CPU's")
    ap.add_argument("--json", default=None,
                    help="write the ANALYSIS.json document here")
    ap.add_argument("--verbose", action="store_true",
                    help="also print info-severity findings")
    args = ap.parse_args(argv)

    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.launch import mesh as mesh_mod
    shapes = args.shape or list(cells.ULEEN_CELLS)
    per_cell = {}
    shape, axes = LINT_MESH
    with mesh_mod.fake_world(8, 0):
        mesh = init_device_mesh(args.device, shape, mesh_dim_names=axes)
        for cell in shapes:
            prog = cells.uleen_cell_program(cell, mesh,
                                            global_batch=args.batch,
                                            backend=args.backend,
                                            device=args.device)
            per_cell[prog.name] = registry.analyze_program(prog)

    print(registry.render_findings(per_cell, verbose=args.verbose))
    if args.json:
        doc = registry.report_json(
            {tag: registry.summarize(fs) for tag, fs in per_cell.items()})
        with open(args.json, "w") as f:
            json.dump(doc, f, indent=1)
        print(f"[wnnlint] wrote {args.json}")
    errors = sum(registry.count(fs, "error") for fs in per_cell.values())
    return 1 if errors else 0


if __name__ == "__main__":
    sys.exit(main())
