"""Rank functions of `tests/test_torch_dryrun.py`, run by
`repro_torch.launch.mesh.spawn_ranks` in gloo processes on the CPU.

It holds no tests itself: a spawned rank imports its function by module
name, so this module imports only torch, pytest and the port.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import multi_shot  # noqa: E402
from repro_torch.core.model import SubmodelStatic, UleenParams  # noqa: E402
from repro_torch.launch import mesh as mesh_mod  # noqa: E402
from repro_torch.launch import uleen_cell  # noqa: E402
from repro_torch.train import optimizer as opt_lib  # noqa: E402


def problem_tensors(plan, rows=slice(None)):
    """(params, statics, bits, labels, keep) of the numpy problem in
    `plan`, rows `rows` of the batch."""
    t = torch.from_numpy
    params = UleenParams(tables=tuple(t(x.copy()) for x in plan["tables"]),
                         bias=t(plan["bias"].copy()),
                         masks=tuple(t(x.copy()) for x in plan["masks"]))
    statics = [SubmodelStatic(t(p), t(h))
               for p, h in zip(plan["perms"], plan["h3s"])]
    keep = [t(k[rows]) for k in plan["keep"]]
    return (params, statics, t(plan["bits"][rows]), t(plan["labels"][rows]),
            keep)


def run_step(params, statics, bits, labels, keep, mesh=None) -> dict:
    """One `make_uleen_train_step` (SPMD on `mesh`) with Adam; numpy out."""
    spec = uleen_cell.ULEEN_EXEC_SPEC
    optimizer = opt_lib.adam(1e-3)
    state = optimizer.init([*params.tables, params.bias])
    step = uleen_cell.make_uleen_train_step(spec, optimizer, mesh=mesh)
    with multi_shot.deterministic("cpu"):     # a fixed scatter-add order
        p, s, loss = step(params, state, statics, bits, labels, None,
                          keep=keep)
    return {"params": [x.numpy().copy() for x in (*p.tables, p.bias)],
            "mu": [m.numpy().copy() for m in s.mu], "loss": float(loss)}


def spmd_train_step(rank, world, plan) -> dict:
    """Rank `rank` of a (data world) mesh: its rows and keep masks."""
    mesh = mesh_mod.make_mesh((world,), ("data",))
    b = plan["bits"].shape[0] // world
    return run_step(*problem_tensors(plan, slice(rank * b, (rank + 1) * b)),
                    mesh=mesh)
