"""Rank functions of the port's distributed-training tests, run by
`repro_torch.launch.mesh.spawn_ranks` in gloo processes on the CPU.

It holds no tests itself. A spawned rank starts from a fresh interpreter
and imports its function by module name, so this module imports only
torch, numpy, pytest and the port: the test files that drive it
(`test_torch_compression.py`, `test_torch_dist_train.py`) import JAX for
the oracle. Each function runs every check of one world size in one
process group and returns numpy results.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import convert  # noqa: E402
from repro_torch.dist import collectives  # noqa: E402
from repro_torch.launch import mesh as mesh_mod  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.launch import train as train_mod  # noqa: E402
from repro_torch.launch import uleen_cell  # noqa: E402
from repro_torch.train import checkpoint, compression, fault  # noqa: E402
from repro_torch.train import optimizer as opt  # noqa: E402

CPU = "cpu"


def np_params(params) -> list:
    """The trainable leaves (tables..., bias) as numpy copies."""
    return [t.detach().cpu().numpy().copy()
            for t in (*params.tables, params.bias)]


# ---------------------------------------------------------------------------
# compression
# ---------------------------------------------------------------------------

def compression_checks(rank, world, cases):
    """`compressed_psum` over a `pod` mesh of `world` ranks for each case:
    rank r reduces row r of each (pods, ...) stacked leaf, `rounds` times
    with the residual carried. Returns per case the mean and residual
    tuples of every round, and the dtypes that crossed the wire."""
    torch.set_num_threads(1)
    mesh = mesh_mod.make_mesh((world,), ("pod",))
    wire = []
    real = torch.distributed.all_gather_into_tensor

    def recording(out, x, *a, **k):
        wire.append(str(x.dtype))
        return real(out, x, *a, **k)

    torch.distributed.all_gather_into_tensor = recording
    try:
        out = {}
        for name, case in cases.items():
            leaves = [torch.from_numpy(np.ascontiguousarray(s[rank]))
                      for s in case["stacked"]]
            err = None
            rounds = []
            for _ in range(case.get("rounds", 1)):
                mean, err = compression.compressed_psum(leaves, mesh, "pod",
                                                        err)
                rounds.append(([m.numpy() for m in mean],
                               [e.numpy() for e in err]))
            out[name] = rounds
    finally:
        torch.distributed.all_gather_into_tensor = real
    return {"cases": out, "wire": sorted(set(wire))}


# ---------------------------------------------------------------------------
# the distributed ULEEN trainer
# ---------------------------------------------------------------------------

def _problem(arrays):
    """The port's (spec, statics, bits, labels) from the JAX smoke
    problem's numpy arrays."""
    return (uleen_cell.ULEEN_EXEC_SPEC,
            convert.statics_from_numpy(arrays["statics"], device=CPU),
            torch.from_numpy(arrays["bits"]).to(torch.int8),
            torch.from_numpy(arrays["labels"]).to(torch.int64))


def _run(problem, mesh, steps_total, **kw):
    spec, statics, bits, labels = problem
    snaps = []
    out = train_mod.train_uleen(
        spec, statics, bits, labels, steps_total=steps_total,
        global_batch=kw.pop("global_batch", 256), lr=1e-3, grad_blocks=8,
        mesh=mesh, verbose=False, device=CPU,
        on_step=kw.pop("on_step", None) or (
            lambda s, p: snaps.append(np_params(p))), **kw)
    out["snaps"] = snaps
    return out


def _summary(out, rank: int) -> dict:
    """A run's results; only rank 0 sends its per-step snapshots."""
    return {"snaps": out["snaps"] if rank == 0 else None,
            "final": np_params(out["params"]),
            "losses": [h["loss"] for h in out["history"]],
            "preempted": out["preempted"],
            "resumed_from": out["resumed_from"]}


def uleen_checks(rank, world, plan):
    """Every distributed-trainer check of one world size, in the order of
    `plan["runs"]`: each run is (name, mesh shape, axes, options).
    Options: steps, compress, ckpt (a directory), preempt_rank and
    preempt_at (that rank's guard fires after that step), probe (run
    `uleen_parity_probe` instead). Returns {name: summary}."""
    torch.set_num_threads(1)
    problem = _problem(plan["problem"])
    out = {}
    for name, shape, axes, o in plan["runs"]:
        mesh = mesh_mod.make_mesh(shape, axes)
        if o.get("probe"):
            out[name] = train_mod.uleen_parity_probe(mesh, device=CPU)
            continue
        guard = fault.PreemptionGuard()
        kw = {}
        if "preempt_at" in o:
            at, who = o["preempt_at"], o.get("preempt_rank", 0)
            snaps = []

            def hook(s, p, at=at, who=who, snaps=snaps):
                snaps.append(np_params(p))
                if s == at and rank == who:
                    guard.request()
            kw = {"on_step": hook, "guard": guard}
        res = _run(problem, mesh, o["steps"], compress=o.get("compress",
                                                             False),
                   ckpt_dir=o.get("ckpt"), **kw)
        if "preempt_at" in o:
            res["snaps"] = snaps
        out[name] = _summary(res, rank)
        out[name]["ckpt_latest"] = (checkpoint.latest_step(o["ckpt"])
                                    if o.get("ckpt") else None)
    return out


# ---------------------------------------------------------------------------
# the LM step's compressed cross-pod reduction
# ---------------------------------------------------------------------------

def dist_train_checks(rank, world, plan):
    """`uleen_checks` of `plan["uleen"]`, `lm_cross_pod_checks` of
    `plan["lm"]` and `float_sum_checks` of `plan["sums"]`, where given:
    one process group for a world's checks."""
    out = {}
    if plan.get("uleen"):
        out["uleen"] = uleen_checks(rank, world, plan["uleen"])
    if plan.get("lm"):
        out["lm"] = lm_cross_pod_checks(rank, world, plan["lm"])
    if plan.get("sums"):
        out["sums"] = float_sum_checks(rank, world, plan["sums"])
    return out


def float_sum_checks(rank, world, plan):
    """`collectives.all_reduce_sum` over every axis of each mesh of
    `plan["meshes"]`, of float32 tensors of `plan["shapes"]`: rank r's
    draws come from a generator seeded r, their magnitudes spread over
    12 decades. Returns {mesh tag: {"sum", "inputs" (every rank's, which
    any rank can draw)}}."""
    torch.set_num_threads(1)

    def draw(r):
        gen = torch.Generator().manual_seed(r)
        return [torch.randn(s, generator=gen) * torch.pow(
            10.0, torch.randint(-6, 6, s, generator=gen).float())
            for s in plan["shapes"]]
    out = {}
    for shape, axes in plan["meshes"]:
        mesh = mesh_mod.make_mesh(shape, axes)
        mine = draw(rank)
        out["x".join(f"{a}{n}" for a, n in zip(axes, shape))] = {
            "sum": [collectives.all_reduce_sum(x, mesh, axes).numpy()
                    for x in mine],
            "inputs": [[d.numpy() for d in leaf]
                       for leaf in zip(*map(draw, range(world)))]}
    return out


def lm_cross_pod_checks(rank, world, plan):
    """`steps.make_train_step(cross_pod_mesh=)` on each mesh of
    `plan["meshes"]`, every rank on its rows of the same batch: one
    SGD(1.0) step without clipping (its update is minus the reduced
    gradient) and `plan["steps"]` AdamW steps. Returns {mesh tag:
    {"sgd_update", "adam" (params after each step; ranks other than 0
    only after the last), "losses"}}."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer
    torch.set_num_threads(1)
    cfg = get_config(plan["arch"], smoke=True)
    batch = {k: torch.from_numpy(v) for k, v in plan["batch"].items()}
    out = {}

    def leaves(params):
        return [p.numpy().copy() for p in steps.tree_leaves(params)]

    for shape, axes in plan["meshes"]:
        mesh = mesh_mod.make_mesh(shape, axes)
        rows = collectives.row_slice(batch["tokens"].shape[0], mesh, axes)
        local = {k: v[rows] for k, v in batch.items()}
        params = transformer.init_params(
            cfg, torch.Generator().manual_seed(0), device=CPU)
        sgd = opt.sgd(1.0)
        step = steps.make_train_step(cfg, sgd, compute_dtype=None,
                                     clip_norm=0.0, cross_pod_mesh=mesh)
        new, _, _ = step(params, sgd.init(steps.tree_leaves(params)), local)
        update = [a - b for a, b in zip(leaves(new), leaves(params))]
        optimizer = opt.chain_clip(opt.adamw(plan["lr"]), 1.0)
        step = steps.make_train_step(cfg, optimizer, compute_dtype=None,
                                     cross_pod_mesh=mesh)
        state = optimizer.init(steps.tree_leaves(params))
        snaps, losses = [], []
        for i in range(plan["steps"]):
            params, state, m = step(params, state, local)
            if rank == 0 or i == plan["steps"] - 1:
                snaps.append(leaves(params))
            losses.append(float(m["loss"]))
        out["x".join(f"{a}{n}" for a, n in zip(axes, shape))] = {
            "sgd_update": update, "adam": snaps, "losses": losses}
    return out


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def cuda_exact_step(rank, world):
    """One exact distributed step of the smoke problem on (data = world),
    the ranks sharing the card under gloo; returns the trainable leaves."""
    dev = mesh_mod.rank_device("cuda")
    spec, statics, bits, labels = train_mod.uleen_smoke_problem(
        0, 1024, device=dev)
    out = train_mod.train_uleen(
        spec, statics, bits, labels, steps_total=1, verbose=False,
        mesh=mesh_mod.make_mesh((world,), ("data",)), device=dev)
    return np_params(out["params"])
