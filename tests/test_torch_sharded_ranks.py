"""Rank functions of the port's sharded-serving tests, run by
`repro_torch.launch.mesh.spawn_ranks` in gloo processes on the CPU.

It holds no tests itself. A spawned rank starts from a fresh interpreter
and imports its function by module name, so this module imports only
torch, numpy, pytest and the port:
the test file that drives it (`test_torch_sharded_serving.py`) imports
JAX for the oracle. Each function runs every check of one world size in
one process group and returns numpy results; the parent compares them
with the unsharded JAX path.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import convert  # noqa: E402
from repro_torch.core import export  # noqa: E402
from repro_torch.launch import mesh as mesh_mod  # noqa: E402
from repro_torch.launch.scheduler import WnnBatcher, WnnTenantBatcher  # noqa: E402
from repro_torch.packed import runtime  # noqa: E402

CPU = "cpu"
BACKENDS = ("auto", "packed", "gather", "fused")


def class_checks(rank, world, case):
    """Class-sharded `predict_from_prep` on every mesh of `case["meshes"]`
    for each artifact and backend, and `WnnBatcher(mesh=)` on a request
    stream. Returns {key: numpy result}."""
    torch.set_num_threads(1)
    out = {}
    arts = {m: convert.artifact_from_numpy(a)
            for m, a in case["artifacts"].items()}
    bits = case["bits"]
    for shape, axes in case["meshes"]:
        mesh = mesh_mod.make_mesh(shape, axes)
        tag = "x".join(f"{a}{n}" for a, n in zip(axes, shape))
        for m, art in arts.items():
            for be in BACKENDS:
                prep = export.prepare_artifact(art, backend=be, mesh=mesh,
                                               device=CPU)
                scores, preds = export.predict_from_prep(prep, bits,
                                                         backend=be)
                out[(tag, m, be)] = (scores.numpy(), preds.numpy())
                if isinstance(prep, runtime.ClassShardedTables):
                    out[(tag, m, be, "local_classes")] = int(
                        prep.local.bias.shape[0])
                    out[(tag, m, be, "lo")] = prep.lo
                    # memoized per representation: the same object again
                    again = export.prepare_artifact(
                        art, backend=be, mesh=mesh, device=CPU)
                    out[(tag, m, be, "memo")] = again is prep
        m = case["batcher_m"]
        eng = WnnBatcher(arts[m], slots=case["slots"],
                         backend=case["batcher_backend"], mesh=mesh,
                         device=CPU)
        for row in case["stream"]:
            eng.submit(row)
        res = eng.drain()
        st = eng.stats()
        out[(tag, "batcher")] = (np.stack([r.scores for r in res]),
                                 [r.pred for r in res], st["class_shards"],
                                 st["traces"])
    return out


def tenant_checks(rank, world, case):
    """`prepare_tenants(mesh=)`, `make_tenant_sharded_predict` and
    `WnnTenantBatcher(mesh=)` (with evictions) on every mesh of
    `case["meshes"]`."""
    torch.set_num_threads(1)
    out = {}
    arts = [convert.artifact_from_numpy(a) for a in case["artifacts"]]
    bits, tids = case["bits"], case["tids"]
    for shape, axes in case["meshes"]:
        mesh = mesh_mod.make_mesh(shape, axes)
        tag = "x".join(f"{a}{n}" for a, n in zip(axes, shape))
        st = export.prepare_tenants(arts, mesh=mesh, device=CPU)
        out[(tag, "local_tenants")] = st.local.num_tenants
        out[(tag, "local_table_bytes")] = st.local.table_bytes()
        out[(tag, "memo")] = export.prepare_tenants(
            arts, mesh=mesh, device=CPU) is st
        predict = runtime.make_tenant_sharded_predict(
            st, mesh, None, int(bits.shape[0]), device=CPU)
        scores, preds = predict(st, bits, tids)
        out[(tag, "predict")] = (scores.numpy(), preds.numpy())
        tb = WnnTenantBatcher(capacity=case["capacity"], slots=case["slots"],
                              mesh=mesh, device=CPU)
        for a in arts:
            tb.add_tenant(a)
        for tid, row in zip(case["req_tids"], case["req_rows"]):
            tb.submit(int(tid), row)
        res = tb.drain()
        bst = tb.stats()
        out[(tag, "batcher")] = (
            np.stack([r.scores for r in res]), [r.pred for r in res],
            {k: bst[k] for k in ("admissions", "evictions", "hits", "misses",
                                 "batches", "traces")})
    return out


def serving_checks(rank, world, class_case, tenant_case):
    """Every check of one world size in one process group: the class
    checks, then the tenant checks (when `tenant_case` is given)."""
    out = {"class": class_checks(rank, world, class_case)}
    if tenant_case is not None:
        out["tenant"] = tenant_checks(rank, world, tenant_case)
    return out


def failing_rank(rank, world):
    """Rank 1 raises; the others wait in a collective that never
    completes, until the process group's timeout or the launcher stops
    them."""
    import torch.distributed as dist
    if rank == 1:
        raise ValueError("rank 1 fails on purpose")
    dist.barrier()
    return rank
