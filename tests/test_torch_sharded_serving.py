"""The port's class- and tenant-sharded ULEEN serving, on the CPU, in gloo
process groups of 2, 4 and 8 ranks (`launch.mesh.spawn_ranks`).

The JAX package's own sharded paths do not run in every JAX this repo
meets (`Explicit` mesh axes refuse `with_sharding_constraint`), so the
oracle is its *unsharded* path: `artifact_scores`, `WnnBatcher(mesh=None)`,
`stacked_predict` and `WnnTenantBatcher(mesh=None)`. That is exact, since
sharding changes where an int32 score is computed, never its value.

Every check of one world size runs in one spawn (`test_torch_sharded_ranks`,
which imports no JAX, so the children import it cleanly), bounded by the
launcher's collective timeout and deadline; the parent compares every
rank's results with JAX.
"""
import functools
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import export as jexport  # noqa: E402
from repro.dist import sharding as jsh  # noqa: E402
from repro.launch.scheduler import WnnBatcher as JWnnBatcher  # noqa: E402
from repro.launch.scheduler import WnnTenantBatcher as JTenantBatcher  # noqa: E402
from repro.packed import runtime as jruntime  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import export  # noqa: E402
from repro_torch.dist import sharding as sh  # noqa: E402
from repro_torch.launch import mesh as mesh_mod  # noqa: E402
from repro_torch.packed import runtime  # noqa: E402
from test_torch_multitenant import (artifact_arrays, jax_artifact,  # noqa: E402
                                    zipf_stream)
import test_torch_sharded_ranks as ranks  # noqa: E402

CPU = "cpu"
TOTAL_BITS = 80
CLASS_MS = (8, 12)
BACKENDS = ranks.BACKENDS
TENANTS, TENANT_ROWS = 8, 24
SPAWN_TIMEOUT_S = 120
# (shape, axes) of every mesh a world size runs
CLASS_MESHES = {2: [((2,), ("model",))],
                4: [((4,), ("model",)), ((2, 2), ("data", "model"))],
                8: [((8,), ("model",))]}
TENANT_MESHES = {2: [((2,), ("model",))],
                 4: [((4,), ("model",)), ((2, 2), ("data", "model"))]}


def tag(shape, axes):
    return "x".join(f"{a}{n}" for a, n in zip(axes, shape))


def class_case(world):
    rng = np.random.default_rng(100 + world)
    return {"artifacts": {m: artifact_arrays(200 + m, m=m) for m in CLASS_MS},
            "bits": rng.integers(0, 2, (16, TOTAL_BITS)).astype(np.uint8),
            "meshes": CLASS_MESHES[world],
            # 8 ranks: M = 12 does not divide model=8 and replicates
            "batcher_m": 12 if world == 8 else 8, "slots": 4,
            "batcher_backend": "fused" if world == 4 else "auto",
            "stream": rng.integers(0, 2, (11, TOTAL_BITS)).astype(np.uint8)}


def tenant_case(world):
    if world not in TENANT_MESHES:
        return None
    rng = np.random.default_rng(300 + world)
    tids = rng.integers(0, TENANTS, TENANT_ROWS).astype(np.int32)
    tids[:3] = (-1, TENANTS, TENANTS + 5)       # owned by no rank
    stream = zipf_stream(world, 40, TENANTS)
    return {"artifacts": [artifact_arrays(400 + t) for t in range(TENANTS)],
            "bits": rng.integers(0, 2, (TENANT_ROWS, TOTAL_BITS)).astype(
                np.uint8),
            "tids": tids, "meshes": TENANT_MESHES[world],
            "capacity": 3, "slots": 4,
            "req_tids": [t for t, _ in stream],
            "req_rows": [row for _, row in stream]}


@functools.lru_cache(maxsize=None)
def spawn(world: int):
    """(world, class case, tenant case, every rank's results) of the one
    spawn of `world` gloo ranks this module makes."""
    cc, tc = class_case(world), tenant_case(world)
    t0 = time.monotonic()
    outs = mesh_mod.spawn_ranks(ranks.serving_checks, world, cc, tc,
                                backend=mesh_mod.collective_backend(CPU,
                                                                    world),
                                timeout_s=SPAWN_TIMEOUT_S)
    assert time.monotonic() - t0 < SPAWN_TIMEOUT_S
    return world, cc, tc, outs


@pytest.fixture(params=sorted(CLASS_MESHES), ids=lambda w: f"world{w}")
def spawned(request):
    return spawn(request.param)


@pytest.fixture(params=sorted(TENANT_MESHES), ids=lambda w: f"world{w}")
def spawned_tenants(request):
    return spawn(request.param)


def test_collective_backend_follows_the_device():
    assert mesh_mod.collective_backend("cpu", 4) == "gloo"
    assert mesh_mod.collective_backend("cpu", 1) == "gloo"
    # more ranks than cards (none here) share a card under gloo
    assert mesh_mod.collective_backend("cuda", 4) == "gloo"


def test_class_sharded_predict_is_bit_equal_to_unsharded_jax(spawned):
    world, cc, _, outs = spawned
    bits = cc["bits"]
    for m in CLASS_MS:
        jart = jax_artifact(cc["artifacts"][m])
        for be in BACKENDS:
            want = np.asarray(jexport.artifact_scores(jart, bits,
                                                      backend=be))
            for shape, axes in cc["meshes"]:
                for r, out in enumerate(outs):
                    scores, preds = out["class"][(tag(shape, axes), m, be)]
                    np.testing.assert_array_equal(scores, want,
                                                  err_msg=f"rank {r} {be}")
                    np.testing.assert_array_equal(
                        preds, np.argmax(want, -1).astype(np.int32))


def test_class_shards_hold_their_slice_or_replicate(spawned):
    world, cc, _, outs = spawned
    for shape, axes in cc["meshes"]:
        sizes = dict(zip(axes, shape))
        for m in CLASS_MS:
            degree = sizes["model"] if m % sizes["model"] == 0 else 1
            for r, out in enumerate(outs):
                res = out["class"]
                key = (tag(shape, axes), m, "auto", "local_classes")
                if degree == 1:          # replicated: no sharded prep
                    assert key not in res
                    continue
                model_idx = r % sizes["model"]
                for be in BACKENDS:
                    k = (tag(shape, axes), m, be)
                    assert res[k + ("local_classes",)] == m // degree
                    assert res[k + ("lo",)] == model_idx * (m // degree)
                    assert res[k + ("memo",)]
    if world == 8:               # 12 over model=8 falls back to replication
        assert all((tag(*CLASS_MESHES[8][0]), 12, "auto", "local_classes")
                   not in out["class"] for out in outs)


def test_class_sharded_batcher_equals_the_jax_batcher(spawned):
    world, cc, _, outs = spawned
    m = cc["batcher_m"]
    jeng = JWnnBatcher(jax_artifact(cc["artifacts"][m]), slots=cc["slots"],
                       backend=cc["batcher_backend"])
    for row in cc["stream"]:
        jeng.submit(row)
    jres = jeng.drain()
    want = np.stack([r.scores for r in jres])
    for shape, axes in cc["meshes"]:
        sizes = dict(zip(axes, shape))
        degree = sizes["model"] if m % sizes["model"] == 0 else 1
        for out in outs:
            scores, preds, shards, traces = out["class"][
                (tag(shape, axes), "batcher")]
            np.testing.assert_array_equal(scores, want)
            assert preds == [r.pred for r in jres]
            assert shards == degree and traces == 1
    if world == 8:
        assert outs[0]["class"][(tag(*CLASS_MESHES[8][0]), "batcher")][2] \
            == 1


def test_tenant_sharded_predict_equals_jax_stacked_predict(spawned_tenants):
    world, _, tc, outs = spawned_tenants
    jst = jexport.prepare_tenants([jax_artifact(a)
                                   for a in tc["artifacts"]])
    tids = tc["tids"]
    owned = (tids >= 0) & (tids < TENANTS)
    jscores, jpreds = jruntime.stacked_predict(
        jst, tc["bits"], np.clip(tids, 0, TENANTS - 1))
    want = np.where(owned[:, None], np.asarray(jscores), 0)
    want_p = np.where(owned, np.asarray(jpreds), 0)
    for shape, axes in tc["meshes"]:
        for out in outs:
            scores, preds = out["tenant"][(tag(shape, axes), "predict")]
            np.testing.assert_array_equal(scores, want)
            np.testing.assert_array_equal(preds, want_p)
    # rows no rank owns score 0 and predict class 0, as in JAX
    assert not owned[:3].any() and (want[:3] == 0).all()


def test_prepare_tenants_keeps_t_over_s_tenants_a_rank(spawned_tenants):
    world, _, tc, outs = spawned_tenants
    full = export.prepare_tenants(
        [convert.artifact_from_numpy(a) for a in tc["artifacts"]],
        device=CPU)
    for shape, axes in tc["meshes"]:
        s = dict(zip(axes, shape))["model"]
        for out in outs:
            res = out["tenant"]
            assert res[(tag(shape, axes), "local_tenants")] == TENANTS // s
            assert res[(tag(shape, axes), "local_table_bytes")] * s == \
                full.table_bytes()
            assert res[(tag(shape, axes), "memo")]


def test_tenant_batcher_on_a_mesh_equals_jax_under_eviction(spawned_tenants):
    world, _, tc, outs = spawned_tenants
    jtb = JTenantBatcher(capacity=tc["capacity"], slots=tc["slots"])
    for a in tc["artifacts"]:
        jtb.add_tenant(jax_artifact(a))
    for tid, row in zip(tc["req_tids"], tc["req_rows"]):
        jtb.submit(int(tid), row)
    jres = jtb.drain()
    jst = jtb.stats()
    assert jst["evictions"] > 0
    for shape, axes in tc["meshes"]:
        for out in outs:
            scores, preds, counts = out["tenant"][(tag(shape, axes),
                                                   "batcher")]
            np.testing.assert_array_equal(
                scores, np.stack([r.scores for r in jres]))
            assert preds == [r.pred for r in jres]
            assert counts == {k: jst[k] for k in counts}


@pytest.mark.parametrize("m,lo,hi", [(8, 0, 4), (8, 4, 8), (12, 3, 9),
                                     (12, 11, 12)])
@pytest.mark.parametrize("backend", BACKENDS)
def test_class_slice_columns_equal_jax_class_slice(m, lo, hi, backend):
    arrs = artifact_arrays(500 + m, m=m)
    bits = np.random.default_rng(m).integers(0, 2, (9, TOTAL_BITS)).astype(
        np.uint8)
    jprep = jexport.prepare_artifact(jax_artifact(arrs), backend=backend)
    want = np.asarray(jexport.scores_from_prep(
        jexport.prep_class_slice(jprep, lo, hi), bits, backend=backend))
    art = convert.artifact_from_numpy(arrs)
    prep = export.prepare_artifact(art, backend=backend, device=CPU)
    part = export.prep_class_slice(prep, lo, hi)
    got = export.scores_from_prep(part, bits, backend=backend).numpy()
    np.testing.assert_array_equal(got, want)
    full = export.artifact_scores(art, bits, backend=backend, device=CPU)
    np.testing.assert_array_equal(got, full.numpy()[:, lo:hi])
    # the numpy slice of the artifact prepares the same columns
    sub = export.prepare_artifact(export.artifact_class_slice(art, lo, hi),
                                  backend=backend, device=CPU)
    np.testing.assert_array_equal(
        export.scores_from_prep(sub, bits, backend=backend).numpy(), want)
    with pytest.raises(ValueError, match="outside"):
        export.prep_class_slice(prep, 0, m + 1)


@pytest.mark.parametrize("shape,axes", [((2, 4), ("data", "model")),
                                        ((1, 3), ("data", "model")),
                                        ((2, 2, 2), ("pod", "data", "model"))])
@pytest.mark.parametrize("backend", ["auto", "fused"])
def test_prep_shardings_resolve_every_leaf_as_jax(shape, axes, backend):
    import types
    arrs = artifact_arrays(600, m=8)
    jprep = jexport.prepare_artifact(jax_artifact(arrs), backend=backend)
    prep = export.prepare_artifact(convert.artifact_from_numpy(arrs),
                                   backend=backend, device=CPU)
    jm = types.SimpleNamespace(axis_names=axes,
                               devices=np.empty(shape, dtype=object))
    pm = mesh_mod.HostMesh(axes, shape)
    entries, degree = export.prep_shardings(prep, pm)
    if backend == "auto":
        jaxes = jprep.logical_axes()
        leaves = {"words": (jaxes.words, jprep.words),
                  "masks": (jaxes.masks, jprep.masks),
                  "perms": (jaxes.perms, jprep.perms),
                  "h3s": (jaxes.h3s, jprep.h3s)}
    else:
        n = len(jprep.tables)
        leaves = {"tables": ((("classes", None, None),) * n, jprep.tables),
                  "masks": ((("classes", None),) * n, jprep.masks),
                  "perms": (((None, None),) * n, jprep.perms),
                  "h3s": (((None, None),) * n, jprep.h3s)}
    for name, (logs, xs) in leaves.items():
        want = tuple(tuple(jsh.SERVE_RULES.resolve(a, jm, shape=x.shape))
                     for a, x in zip(logs, xs))
        assert entries[name] == want, name
    assert entries["bias"] == tuple(jsh.SERVE_RULES.resolve(
        ("classes",), jm, shape=jprep.bias.shape))
    assert degree == jsh.class_partition(jm, 8)[1]


def test_one_process_mesh_serves_unsharded():
    arrs = artifact_arrays(700, m=8)
    art = convert.artifact_from_numpy(arrs)
    host = mesh_mod.make_host_mesh()
    prep = export.prepare_artifact(art, mesh=host, device=CPU)
    assert prep is export.prepare_artifact(art, device=CPU)
    bits = np.random.default_rng(0).integers(0, 2, (5, TOTAL_BITS))
    st = export.prepare_tenants([art, art], mesh=host, device=CPU)
    assert isinstance(st, runtime.TenantShardedTables)
    assert st.local.num_tenants == st.num_tenants == 2
    predict = runtime.make_tenant_sharded_predict(st, host, sh.SERVE_RULES,
                                                  5, device=CPU)
    tids = np.array([0, 1, 0, 1, 1])
    scores, _ = predict(st, bits, tids)
    want, _ = runtime.stacked_predict(st.local, bits, tids, device=CPU)
    assert torch.equal(scores, want)
    with pytest.raises(RuntimeError, match="process group"):
        mesh_mod.make_mesh((2,), ("model",))


def test_spawn_ranks_raises_with_the_failing_ranks_traceback():
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 fails on purpose"):
        mesh_mod.spawn_ranks(ranks.failing_rank, 2, backend="gloo",
                             timeout_s=30)
    assert time.monotonic() - t0 < 60


@pytest.mark.parametrize("lo,hi", [(0, 2), (2, 5), (4, 5)])
def test_tenant_shard_and_logical_axes_equal_jax(lo, hi):
    arrs = [artifact_arrays(800 + t) for t in range(5)]
    jst = jexport.prepare_tenants([jax_artifact(a) for a in arrs])
    st = export.prepare_tenants([convert.artifact_from_numpy(a)
                                 for a in arrs], device=CPU)
    got, want = st.tenant_shard(lo, hi), jst.tenant_shard(lo, hi)
    assert got.num_tenants == want.num_tenants == hi - lo
    for leaves, jleaves in ((got.words, want.words), (got.masks, want.masks),
                            (got.perms, want.perms), (got.h3s, want.h3s)):
        for x, y in zip(leaves, jleaves, strict=True):
            np.testing.assert_array_equal(
                x.numpy().view(np.uint32) if x.dtype == torch.int32
                and y.dtype == np.uint32 else x.numpy(), np.asarray(y))
    np.testing.assert_array_equal(got.bias.numpy(), np.asarray(want.bias))
    with pytest.raises(ValueError, match="outside"):
        st.tenant_shard(3, 6)
    jaxes, axes = jst.logical_axes(), st.logical_axes()
    for name in ("words", "masks", "perms", "h3s"):
        assert axes[name] == tuple(getattr(jaxes, name))
    assert axes["bias"] == jaxes.bias
    jpt = jst.tenant_slice(0)
    jpaxes, paxes = jpt.logical_axes(), st.tenant_slice(0).logical_axes()
    for name in ("words", "masks", "perms", "h3s"):
        assert paxes[name] == tuple(getattr(jpaxes, name))
    assert paxes["bias"] == jpaxes.bias
