"""Run the LM dry-run sweep, one subprocess per cell (port of
`repro/launch/sweep.py`): each cell traces in a fresh process with its own
fake world, so a crash or a memory blow-up in one cell cannot take the
sweep down.

    PYTHONPATH=src python -m repro_torch.launch.sweep --out build/dryrun

By default it covers every arch of the zoo (`launch.dryrun.PLACED_ARCHS`:
the dense, MoE, SSM, hybrid, encoder-decoder and patch families), every
shape of each (`configs.shapes_for`) on both production meshes; `--archs`
names a few. `--jobs` runs that many cells at
once (the traces are single-threaded host work); `--layers N` cuts every
arch to its first N layers (as `launch.dryrun --layers` does: whole
repeats of a block pattern, so RecurrentGemma's (rec, rec, local) takes
3 for 2); `--device cpu` traces the CPU program.
Records go to `--out` as `launch.dryrun --analyze` writes them, the
wnnlint rules folded in.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor


def cells_for(archs) -> list:
    """(arch, shape name) of every cell of `archs`."""
    from repro_torch.configs import get_config, shapes_for
    return [(a, s.name) for a in archs for s in shapes_for(get_config(a))]


def run_one(arch: str, shape: str, mesh: str, args) -> tuple:
    """(ok, message, seconds) of one cell's subprocess."""
    tag = f"{arch}.{shape}.{'pod2' if mesh == 'multi' else 'pod1'}"
    path = os.path.join(args.out, tag + ".json")
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
           "--shape", shape, "--mesh", mesh, "--out", args.out,
           "--device", args.device, "--analyze",
           "--metrics-out", os.path.join(args.out, f"METRICS.{tag}.json")]
    if args.layers:
        cmd += ["--layers", str(args.layers)]
    t0 = time.time()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=args.timeout)
        ok = proc.returncode == 0
        tail = [ln for ln in (proc.stdout + proc.stderr).splitlines()
                if ln.startswith(f"[dryrun] {tag}:")]
        msg = tail[-1][:300] if tail else \
            (proc.stdout + proc.stderr).strip()[-300:]
    except subprocess.TimeoutExpired:
        ok, msg = False, f"TIMEOUT {args.timeout}s"
        with open(path, "w") as f:
            json.dump({"arch": arch, "shape": shape, "mesh": tag,
                       "ok": False, "error": msg}, f)
    return ok, msg, time.time() - t0


def main(argv=None) -> int:
    from repro_torch.configs import ARCH_IDS
    from repro_torch.launch import dryrun
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="build/dryrun")
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="both")
    ap.add_argument("--timeout", type=int, default=3600)
    ap.add_argument("--skip-done", action="store_true")
    ap.add_argument("--archs", nargs="*", default=None,
                    choices=ARCH_IDS)
    ap.add_argument("--jobs", type=int, default=1)
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = ap.parse_args(argv)

    archs = args.archs or list(dryrun.PLACED_ARCHS)
    meshes = {"single": ["single"], "multi": ["multi"],
              "both": ["single", "multi"]}[args.mesh]
    todo = []
    for arch, shp in cells_for(archs):
        for mesh in meshes:
            tag = f"{arch}.{shp}.{'pod2' if mesh == 'multi' else 'pod1'}"
            path = os.path.join(args.out, tag + ".json")
            if args.skip_done and os.path.exists(path):
                try:
                    with open(path) as f:
                        if json.load(f).get("ok"):
                            continue
                except (OSError, ValueError):
                    pass
            todo.append((tag, arch, shp, mesh))
    # the training cells first: they trace longest, and started last they
    # would set the sweep's wall time
    todo.sort(key=lambda c: c[2] != "train_4k")
    os.makedirs(args.out, exist_ok=True)
    t_start = time.time()
    fails = []
    with ThreadPoolExecutor(max_workers=max(1, args.jobs)) as pool:
        futures = {tag: pool.submit(run_one, arch, shp, mesh, args)
                   for tag, arch, shp, mesh in todo}
        for i, (tag, fut) in enumerate(futures.items()):
            ok, msg, secs = fut.result()
            if not ok:
                fails.append(tag)
            print(f"[sweep {i + 1}/{len(todo)} {tag}] "
                  f"{'OK' if ok else 'FAIL'} {secs:.0f}s  {msg}", flush=True)
    print(f"[sweep] finished in {(time.time() - t_start) / 60:.1f} min; "
          f"{len(fails)} failures: {fails}")
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
