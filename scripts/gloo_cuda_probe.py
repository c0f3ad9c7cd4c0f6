#!/usr/bin/env python3
"""Which collectives gloo runs on CUDA tensors, for rank processes that
share one card, and what the port's host-staged all-gather costs beside
gloo's own CUDA path.

    python3 scripts/gloo_cuda_probe.py [--out build/gloo_cuda_probe.json]

Four gloo ranks on card 0 (`launch.mesh.spawn_ranks`) try each call of
three families on CUDA tensors and check its result: `torch.distributed`
itself, the functional collectives that DTensor issues
(`torch.distributed._functional_collectives`), and DTensor
redistributions on a "cuda" DeviceMesh. A call that ends its process (a
segmentation fault is no exception) would take the others' results with
it, so the functional all-gather and DTensor's Shard -> Replicate (an
all-gather) each run in a spawn of their own, first as torch has them
and then with the port's route installed
(`dist.collectives.stage_cuda_gathers_on_host`). That last spawn also
times, at TIMED_MIB of float32 a rank, the all-gather, all-reduce and
reduce-scatter on the CUDA tensors themselves (gloo's CUDA path) against
the same call on a host copy (`x.cpu()`, the call, `.to(card)`), and
the functional all-gather through the route.

Prints one JSON line a spawn, the JSON object written to `--out`, and
the card's name and power limit. `--device cpu` rehearses the calls on
CPU tensors (no timing claim).
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
WORLD = 4
TIMED_MIB = 64
TIMED_REPS = 5
TIMEOUT_S = 120
# the calls that ended the process under gloo on CUDA tensors (torch
# 2.11): each runs in a spawn of its own
ALONE = ("funcol.all_gather_tensor", "dtensor.shard_to_replicate")


def _cases(dev):
    """name -> fn(mesh) -> (ok, what): every call on this rank's tensor
    (rank + 1 everywhere), checked against its known result."""
    import torch.distributed as dist
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.tensor import (DTensor, Partial, Replicate,
                                          Shard)
    rank = dist.get_rank()

    def mine(*shape):
        return torch.full(shape, float(rank + 1), device=dev)

    def ranks_col(n):        # (WORLD * n,) rows: rank r's block holds r + 1
        return torch.arange(1, WORLD + 1, device=dev).float(
            ).repeat_interleave(n)

    def dist_all_reduce(mesh):
        x = mine(4)
        dist.all_reduce(x)
        return bool((x == 10).all()), x[0].item()

    def dist_all_gather_into_tensor(mesh):
        out = torch.empty(WORLD * 3, device=dev)
        dist.all_gather_into_tensor(out, mine(3))
        return bool(torch.equal(out, ranks_col(3))), out.sum().item()

    def dist_reduce_scatter_tensor(mesh):
        out = torch.empty(2, device=dev)
        dist.reduce_scatter_tensor(out, mine(WORLD * 2))
        return bool((out == 10).all()), out[0].item()

    def dist_all_to_all_single(mesh):
        out = torch.empty(WORLD * 2, device=dev)
        dist.all_to_all_single(out, mine(WORLD * 2))
        return bool(torch.equal(out, ranks_col(2))), out.sum().item()

    def dist_broadcast(mesh):
        x = mine(3)
        dist.broadcast(x, src=0)
        return bool((x == 1).all()), x[0].item()

    def dist_all_gather(mesh):
        outs = [torch.empty(2, device=dev) for _ in range(WORLD)]
        dist.all_gather(outs, mine(2))
        return bool(torch.equal(torch.cat(outs), ranks_col(2))), None

    def dist_barrier(mesh):
        dist.barrier()
        return True, None

    def funcol_all_reduce(mesh):
        x = funcol.all_reduce(mine(4), "sum", mesh)
        x = funcol.wait_tensor(x)
        return bool((x == 10).all()), x[0].item()

    def funcol_all_gather_tensor(mesh):
        x = funcol.wait_tensor(funcol.all_gather_tensor(mine(3), 0, mesh))
        return bool(torch.equal(x, ranks_col(3))), x.sum().item()

    def funcol_reduce_scatter_tensor(mesh):
        x = funcol.reduce_scatter_tensor(mine(WORLD * 2), "sum", 0, mesh)
        x = funcol.wait_tensor(x)
        return bool((x == 10).all()), x[0].item()

    def funcol_all_to_all_single(mesh):
        x = funcol.all_to_all_single(mine(WORLD * 2), None, None, mesh)
        x = funcol.wait_tensor(x)
        return bool(torch.equal(x, ranks_col(2))), x.sum().item()

    def dtensor_shard_to_replicate(mesh):
        d = DTensor.from_local(mine(2, 3), mesh, [Shard(0)])
        x = d.redistribute(mesh, [Replicate()]).to_local()
        return (bool(torch.equal(x[:, 0], ranks_col(2))),
                tuple(x.shape))

    def dtensor_shard0_to_shard1(mesh):
        d = DTensor.from_local(mine(2, WORLD * 2), mesh, [Shard(0)])
        x = d.redistribute(mesh, [Shard(1)]).to_local()
        return (bool(torch.equal(x[:, 0], ranks_col(2))),
                tuple(x.shape))

    def dtensor_partial_to_replicate(mesh):
        d = DTensor.from_local(mine(4), mesh, [Partial()])
        x = d.redistribute(mesh, [Replicate()]).to_local()
        return bool((x == 10).all()), x[0].item()

    def dtensor_partial_to_shard(mesh):
        d = DTensor.from_local(mine(WORLD * 2), mesh, [Partial()])
        x = d.redistribute(mesh, [Shard(0)]).to_local()
        return bool((x == 10).all()), tuple(x.shape)

    return {name.replace("_", ".", 1): fn for name, fn in locals().items()
            if name.startswith(("dist_", "funcol_", "dtensor_"))}


def _timed(fn, dev, reps=TIMED_REPS) -> float:
    """Median seconds of `fn()` after one warm-up call, the card
    synchronised around each."""
    fn()
    times = []
    for _ in range(reps):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        fn()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def _timings(mesh, dev) -> dict:
    """Seconds a call at TIMED_MIB of float32 a rank: each collective on
    the card's tensors (gloo's CUDA path) and on a host copy, and the
    functional all-gather (the route, where it is installed)."""
    import torch.distributed as dist
    import torch.distributed._functional_collectives as funcol
    n = TIMED_MIB * 2 ** 20 // 4
    x = torch.ones(n, device=dev)
    gathered = torch.empty(WORLD * n, device=dev)
    part = torch.empty(n // WORLD, device=dev)

    def host(call, out, inp):
        h_out = torch.empty(out.shape, dtype=out.dtype)
        call(h_out, inp.cpu())
        out.copy_(h_out)

    def all_reduce(out, inp):
        out.copy_(inp)
        dist.all_reduce(out)

    def all_reduce_host():
        y = x.cpu()
        dist.all_reduce(y)
        return y.to(dev)
    return {
        "mib_a_rank": TIMED_MIB,
        "all_gather": {
            "gloo_cuda_s": _timed(lambda: dist.all_gather_into_tensor(
                gathered, x), dev),
            "host_copy_s": _timed(lambda: host(
                dist.all_gather_into_tensor, gathered, x), dev),
            "functional_s": _timed(lambda: funcol.wait_tensor(
                funcol.all_gather_tensor(x, 0, mesh)), dev)},
        "all_reduce": {
            "gloo_cuda_s": _timed(lambda: all_reduce(gathered[:n], x), dev),
            "host_copy_s": _timed(all_reduce_host, dev)},
        "reduce_scatter": {
            "gloo_cuda_s": _timed(lambda: dist.reduce_scatter_tensor(
                part, x), dev),
            "host_copy_s": _timed(lambda: host(
                dist.reduce_scatter_tensor, part, x), dev)}}


def probe_rank(rank, world, plan) -> dict:
    """One rank: the named cases in order on a 1-D mesh of `world`
    ranks (a "cuda" mesh on the card), then the timings if asked."""
    del world
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.launch import mesh as mesh_mod
    dev = mesh_mod.rank_device(plan["device"])
    if plan["route"]:
        from repro_torch.dist.collectives import stage_cuda_gathers_on_host
        stage_cuda_gathers_on_host()
    from torch.distributed.device_mesh import init_device_mesh
    mesh = init_device_mesh(dev.type, (WORLD,), mesh_dim_names=("x",))
    cases = _cases(dev)
    out = {"rank": rank, "device": str(dev), "results": {}}
    for name in plan["cases"]:
        try:
            ok, what = cases[name](mesh)
            out["results"][name] = {"ran": True, "correct": ok,
                                    "value": repr(what)}
        except Exception as e:       # a refusal is a result here
            out["results"][name] = {"ran": False,
                                    "error": f"{type(e).__name__}: {e}"[:300]}
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    if plan["time"]:
        out["timings"] = _timings(mesh, dev)
    return out


def run_spawn(tag: str, plan: dict) -> dict:
    from repro_torch.launch.mesh import spawn_ranks
    t0 = time.perf_counter()
    try:
        outs = spawn_ranks(probe_rank, WORLD, plan, backend="gloo",
                           timeout_s=TIMEOUT_S)
        res = {"spawn": tag, "route": plan["route"], "ended": "returned",
               "results": outs[0]["results"],
               "ranks_agree": all(o["results"] == outs[0]["results"]
                                  for o in outs)}
        if plan["time"]:
            res["timings_rank0"] = outs[0]["timings"]
    except RuntimeError as e:        # a rank died: the message says how
        res = {"spawn": tag, "route": plan["route"], "ended": "rank died",
               "cases": plan["cases"], "error": str(e)[-600:]}
    res["seconds"] = time.perf_counter() - t0
    print(json.dumps(res), flush=True)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--out", default=str(ROOT / "build" /
                                         "gloo_cuda_probe.json"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    if args.device == "cuda" and not torch.cuda.is_available():
        print("gloo_cuda_probe: no CUDA device", file=sys.stderr)
        return 1
    names = ["dist.all_reduce", "dist.all_gather_into_tensor",
             "dist.reduce_scatter_tensor", "dist.all_to_all_single",
             "dist.broadcast", "dist.all_gather", "dist.barrier",
             "funcol.all_reduce", "funcol.all_gather_tensor",
             "funcol.reduce_scatter_tensor", "funcol.all_to_all_single",
             "dtensor.shard_to_replicate", "dtensor.shard0_to_shard1",
             "dtensor.partial_to_replicate", "dtensor.partial_to_shard"]
    base = dict(device=args.device, time=False)
    spawns = [run_spawn("together", dict(base, route=False, cases=[
        n for n in names if n not in ALONE]))]
    spawns += [run_spawn(name, dict(base, route=False, cases=[name]))
               for name in ALONE]
    spawns.append(run_spawn("route", dict(base, route=True,
                                          cases=list(ALONE),
                                          time=args.device == "cuda")))
    smi = (subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
           if args.device == "cuda" else "cpu")
    doc = {"torch": torch.__version__, "device": smi, "world": WORLD,
           "spawns": spawns}
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(doc, indent=1))
    print(json.dumps(doc), flush=True)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
