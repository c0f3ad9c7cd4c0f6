"""The port's multi-tenant serving against the JAX package's, on the CPU:
the tenant-stacked layout, the tenant-indexed scores, `prepare_tenants`
and the LRU `WnnTenantBatcher` (the JAX one run with `mesh=None`).

Artifacts are drawn with numpy from seeds and built in both packages;
every output here is integer, so every comparison is exact, and so are
the batcher's admission, eviction, hit and miss counts (LRU is
deterministic).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import export as jexport  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.launch.scheduler import WnnTenantBatcher as JTenantBatcher  # noqa: E402
from repro.packed import layout as jlayout  # noqa: E402
from repro.packed import runtime as jruntime  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import export  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.launch import mesh as mesh_mod  # noqa: E402
from repro_torch.launch.scheduler import WnnBatcher, WnnTenantBatcher  # noqa: E402
from repro_torch.obs import torchhooks  # noqa: E402
from repro_torch.packed import layout, runtime  # noqa: E402

CPU = "cpu"
M, TOTAL_BITS = 10, 80
SUBS = ((6, 5, 2), (8, 6, 3), (10, 4, 1))     # (n, log2 E, k)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def artifact_arrays(seed, subs=SUBS, m=M, total_bits=TOTAL_BITS):
    """A seeded artifact as the npz-keyed arrays both packages read:
    tables ~0.3 full, masks ~0.8, perms wrapped past total_bits."""
    rng = np.random.default_rng(seed)
    arrs = {"bias": rng.integers(-3, 4, m).astype(np.int32),
            "meta": np.array([m, total_bits, 1, len(subs)])}
    for i, (n, log2e, k) in enumerate(subs):
        e, n_f = 2 ** log2e, -(-total_bits // n)
        perm = np.concatenate([rng.permutation(total_bits),
                               rng.integers(0, total_bits, n_f * n)])
        arrs[f"sm{i}_packed"] = jexport.pack_table(rng.random((m, n_f, e))
                                                   < 0.3)
        arrs[f"sm{i}_mask"] = rng.random((m, n_f)) < 0.8
        arrs[f"sm{i}_perm"] = perm[:n_f * n].reshape(n_f, n).astype(np.int32)
        arrs[f"sm{i}_h3"] = rng.integers(0, e, (k, n)).astype(np.uint32)
        arrs[f"sm{i}_cfg"] = np.array([e, n, k])
    return arrs


def jax_artifact(arrs):
    subs = []
    for i in range(int(arrs["meta"][3])):
        e, n, k = arrs[f"sm{i}_cfg"]
        subs.append(jexport.SubmodelArtifact(
            packed=arrs[f"sm{i}_packed"], mask=arrs[f"sm{i}_mask"],
            perm=arrs[f"sm{i}_perm"], h3=arrs[f"sm{i}_h3"], entries=int(e),
            inputs_per_filter=int(n), num_hashes=int(k)))
    m, total, bpi, _ = arrs["meta"]
    return jexport.InferenceArtifact(submodels=subs, bias=arrs["bias"],
                                     num_classes=int(m),
                                     total_bits=int(total),
                                     bits_per_input=int(bpi))


def fleet(n, seed0=0, **kw):
    """(JAX artifacts, port artifacts) of n tenants."""
    arrs = [artifact_arrays(seed0 + i, **kw) for i in range(n)]
    return ([jax_artifact(a) for a in arrs],
            [convert.artifact_from_numpy(a) for a in arrs])


def rows(seed, b, total_bits=TOTAL_BITS, tenants=None):
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, (b, total_bits)).astype(np.uint8)
    tids = None if tenants is None else rng.integers(0, tenants, b).astype(
        np.int32)
    return bits, tids


def test_stack_tenants_roundtrip_and_geometry_gate():
    jarts, arts = fleet(3)
    preps = [export.prepare_artifact(a, device=CPU) for a in arts]
    st = layout.stack_tenants(preps)
    assert st.num_tenants == 3 and st.num_classes == M
    assert st.num_submodels == 3
    st.validate()
    jst = jlayout.stack_tenants(jexport.prepare_artifact(a) for a in jarts)
    for got, want in zip(st.words, jst.words):
        np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                      np.asarray(want))
    for leaves, jleaves in ((st.masks, jst.masks), (st.perms, jst.perms),
                            (st.h3s, jst.h3s)):
        for got, want in zip(leaves, jleaves):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(st.bias.numpy(), np.asarray(jst.bias))
    assert st.table_bytes() == jst.table_bytes()
    for t, prep in enumerate(preps):
        sl = st.tenant_slice(t)
        for a, b in zip((*sl.words, *sl.perms, *sl.h3s, *sl.masks),
                        (*prep.words, *prep.perms, *prep.h3s, *prep.masks)):
            assert torch.equal(a, b)
        assert torch.equal(sl.bias, prep.bias)
    with pytest.raises(ValueError, match="outside"):
        st.tenant_slice(3)
    # another geometry is rejected when stacked, naming the tenant
    other = export.prepare_artifact(convert.artifact_from_numpy(
        artifact_arrays(99, m=8)), device=CPU)
    with pytest.raises(ValueError, match="tenant 1"):
        layout.stack_tenants([preps[0], other])
    wide = export.prepare_artifact(convert.artifact_from_numpy(
        artifact_arrays(98, subs=((6, 6, 2), (8, 6, 3), (10, 4, 1)))),
        device=CPU)
    with pytest.raises(ValueError, match="geometry"):
        layout.stack_tenants([preps[0], wide])
    with pytest.raises(ValueError, match="at least one"):
        layout.stack_tenants([])


def test_stacked_leaves_must_share_the_tenant_axis():
    _, arts = fleet(2)
    st = layout.stack_tenants(export.prepare_artifact(a, device=CPU)
                              for a in arts)
    bad = layout.StackedPackedTables(
        words=st.words, masks=st.masks, perms=(st.perms[0][:1],
                                               *st.perms[1:]),
        h3s=st.h3s, bias=st.bias, entries=st.entries,
        num_classes=st.num_classes, num_tenants=2)
    with pytest.raises(ValueError, match="leading tenant dim"):
        bad.validate()
    with pytest.raises(ValueError, match="per-submodel"):
        layout.StackedPackedTables(words=st.words, masks=st.masks[:1],
                                   perms=st.perms, h3s=st.h3s, bias=st.bias,
                                   entries=st.entries)


def test_stacked_zeros_scores_zero_everywhere():
    _, arts = fleet(1)
    st = layout.stacked_zeros(export.prepare_artifact(arts[0], device=CPU), 4)
    assert st.num_tenants == 4
    assert [w.dtype for w in st.words] == [torch.int32] * 3
    bits = np.ones((5, TOTAL_BITS), np.uint8)
    tids = np.arange(5, dtype=np.int32) % 4
    scores = runtime.stacked_scores(st, bits, tids, device=CPU)
    assert scores.dtype == torch.int32
    assert int(scores.abs().max()) == 0
    with pytest.raises(ValueError, match="capacity"):
        layout.stacked_zeros(export.prepare_artifact(arts[0], device=CPU), 0)


@pytest.mark.parametrize("seed", [10, 40])
def test_stacked_scores_equal_jax_and_each_tenant_alone(seed):
    jarts, arts = fleet(4, seed0=seed)
    st = export.prepare_tenants(arts, device=CPU)
    jst = jexport.prepare_tenants(jarts)
    bits, tids = rows(seed, 31, tenants=4)
    scores, preds = runtime.stacked_predict(st, bits, tids, device=CPU)
    jscores, jpreds = jruntime.stacked_predict(jst, jnp.asarray(bits),
                                               jnp.asarray(tids))
    np.testing.assert_array_equal(scores.numpy(), np.asarray(jscores))
    np.testing.assert_array_equal(preds.numpy(), np.asarray(jpreds))
    assert preds.dtype == torch.int32
    for t in range(4):
        sel = tids == t
        solo = export.artifact_scores(arts[t], bits[sel], device=CPU)
        np.testing.assert_array_equal(scores.numpy()[sel], solo.numpy())
    # the ownership mask zeroes foreign rows exactly, bias included
    valid = tids < 2
    masked = runtime.stacked_scores(st, bits, tids, valid=valid, device=CPU)
    jmasked = jruntime.stacked_scores(jst, jnp.asarray(bits),
                                      jnp.asarray(tids),
                                      valid=jnp.asarray(valid))
    np.testing.assert_array_equal(masked.numpy(), np.asarray(jmasked))
    assert int(masked[torch.from_numpy(~valid)].abs().max()) == 0


def test_packed_wnn_tenant_ref_equals_jax():
    jarts, arts = fleet(3, seed0=5)
    st = export.prepare_tenants(arts, device=CPU)
    bits, tids = rows(2, 17, tenants=3)
    for i in range(st.num_submodels):
        got = ref.packed_wnn_tenant_ref(
            torch.from_numpy(bits), torch.from_numpy(tids), st.perms[i],
            st.h3s[i], st.words[i], st.masks[i])
        want = jref.packed_wnn_tenant_ref(
            jnp.asarray(bits), jnp.asarray(tids),
            jnp.asarray(st.perms[i].numpy().astype(np.int32)),
            jnp.asarray(st.h3s[i].numpy()),
            jnp.asarray(st.words[i].numpy().view(np.uint32)),
            jnp.asarray(st.masks[i].numpy()))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _bad_tenant_args(st, bits, tids):
    """Malformed calls of the tenant entry: (name, args, kwargs)."""
    args = [bits, tids, st.perms[0], st.h3s[0], st.words[0], st.masks[0]]

    def with_(i, x):
        out = list(args)
        out[i] = x
        return out

    return [
        ("bits_1d", with_(0, bits[0]), {}),
        ("tids_float", with_(1, tids.astype(np.float32)), {}),
        ("tids_short", with_(1, tids[:-1]), {}),
        ("words_no_tenant_axis", with_(4, st.words[0][0]), {}),
        ("perm_other_t", with_(2, st.perms[0][:1]), {}),
        ("mask_other_t", with_(5, st.masks[0][:1]), {}),
        ("params_other_n", with_(3, st.h3s[1]), {}),
        ("entries_wrong", args, {"entries": 64}),
        ("backend_fused", args, {"backend": "fused"}),
    ]


@pytest.mark.parametrize("case", range(9))
def test_wnn_scores_tenant_rejects_bad_geometry_as_jax_does(case):
    jarts, arts = fleet(2)
    st = export.prepare_tenants(arts, device=CPU)
    bits, tids = rows(0, 4, tenants=2)
    name, args, kw = _bad_tenant_args(st, bits, tids)[case]
    kw = {"entries": st.entries[0], **kw}
    with pytest.raises(ValueError) as got:
        ops.wnn_scores_tenant(*[torch.as_tensor(a) for a in args],
                              device=CPU, **kw)
    jargs = [jnp.asarray(a.numpy().view(np.uint32) if i == 4 else a.numpy())
             if isinstance(a, torch.Tensor) else jnp.asarray(a)
             for i, a in enumerate(args)]
    with pytest.raises(ValueError) as want:
        jops.wnn_scores_tenant(*jargs, **kw)
    if name not in ("tids_float",):       # dtype names print otherwise
        assert str(got.value) == str(want.value), name


def test_stacked_scores_rejects_int8_backends():
    _, arts = fleet(2)
    st = export.prepare_tenants(arts, device=CPU)
    bits, tids = rows(0, 4, tenants=2)
    for be in ("fused", "gather"):
        with pytest.raises(ValueError, match="backend"):
            runtime.stacked_scores(st, bits, tids, backend=be, device=CPU)


def test_prepare_tenants_memoizes_and_stacks_lazily():
    _, arts = fleet(3, seed0=20)
    st = export.prepare_tenants(arts, device=CPU)
    assert st is export.prepare_tenants(arts, device=CPU)
    assert st is not export.prepare_tenants(list(reversed(arts)), device=CPU)
    assert st.num_tenants == 3
    for t, a in enumerate(arts):
        prep = export.prepare_artifact(a, device=CPU)
        for x, y in zip(st.tenant_slice(t).words, prep.words):
            assert torch.equal(x, y)
        # stacked only: the kernel's class slices were never built
        assert prep._kernel_args is None
    with pytest.raises(ValueError, match="at least one"):
        export.prepare_tenants([], device=CPU)
    with pytest.raises(ValueError, match="packed domain"):
        export.prepare_tenants(arts, backend="fused", device=CPU)
    # a one-process mesh resolves `tenants` to replication: every tenant
    # in the one shard, stacked from the same preparations
    sharded = export.prepare_tenants(arts, mesh=mesh_mod.make_host_mesh(),
                                     device=CPU)
    assert isinstance(sharded, runtime.TenantShardedTables)
    assert (sharded.num_tenants, sharded.lo) == (3, 0)
    for x, y in zip(sharded.local.words, st.words):
        assert torch.equal(x, y)


def serve_both(capacity, slots, n_tenants, stream, seed0):
    """The same request stream through the port's and JAX's batchers:
    (port results, port stats, JAX results, JAX stats)."""
    jarts, arts = fleet(n_tenants, seed0=seed0)
    tb = WnnTenantBatcher(capacity=capacity, slots=slots, device=CPU)
    jtb = JTenantBatcher(capacity=capacity, slots=slots, backend="auto")
    assert [tb.add_tenant(a) for a in arts] == list(range(n_tenants))
    assert [jtb.add_tenant(a) for a in jarts] == list(range(n_tenants))
    for tid, row in stream:
        assert tb.submit(tid, row) == jtb.submit(tid, row)
    return tb.drain(), tb.stats(), jtb.drain(), jtb.stats()


def zipf_stream(seed, n, tenants, s=1.1):
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, tenants + 1) ** s
    tids = rng.choice(tenants, size=n, p=p / p.sum())
    return [(int(t), rng.integers(0, 2, TOTAL_BITS).astype(np.uint8))
            for t in tids]


@pytest.mark.parametrize("capacity,slots,tenants,n", [
    (2, 4, 5, 40), (3, 8, 9, 97), (1, 4, 3, 23)])
def test_tenant_batcher_equals_jax_with_evictions(capacity, slots, tenants,
                                                  n):
    stream = zipf_stream(capacity, n, tenants)
    got, st, want, jst = serve_both(capacity, slots, tenants, stream,
                                    seed0=60 + capacity)
    assert [r.rid for r in got] == [r.rid for r in want]
    for g, w in zip(got, want):
        assert g.tid == w.tid
        np.testing.assert_array_equal(g.scores, np.asarray(w.scores))
        assert g.pred == w.pred
    for key in ("admissions", "evictions", "hits", "misses", "batches",
                "served", "resident", "requests"):
        assert st[key] == jst[key], key
    assert st["evictions"] > 0
    assert st["traces"] == 1, "tenant churn must not add scores shapes"
    assert st["install_traces"] == 1, "slot installs share one shape"
    assert st["hits"] + st["misses"] == st["served"] == n
    assert st["misses"] == st["admissions"]
    assert st["resident"] <= st["capacity"] == capacity
    assert {k: v["requests"] for k, v in st["per_tenant"].items()} == \
        {k: v["requests"] for k, v in jst["per_tenant"].items()}


def test_tenant_batcher_equals_each_tenant_alone():
    _, arts = fleet(4, seed0=80)
    tb = WnnTenantBatcher(capacity=2, slots=4, device=CPU)
    for a in arts:
        tb.add_tenant(a)
    solos = [WnnBatcher(a, slots=4, device=CPU) for a in arts]
    pairs = []
    for tid, row in zipf_stream(1, 30, 4):
        pairs.append((tb.submit(tid, row), tid, solos[tid].submit(row)))
    got = {r.rid: r for r in tb.drain()}
    ref_ = [{r.rid: r for r in s.drain()} for s in solos]
    for rid, tid, srid in pairs:
        np.testing.assert_array_equal(got[rid].scores, ref_[tid][srid].scores)
        assert got[rid].pred == ref_[tid][srid].pred


def test_tenant_batcher_interleaving_stress_per_tenant_stats():
    """Random submit/step/drain interleavings: nothing lost, duplicated or
    routed to another tenant; per-tenant stats reconcile."""
    _, arts = fleet(4, seed0=90)
    tb = WnnTenantBatcher(capacity=3, slots=4, device=CPU)
    for a in arts:
        tb.add_tenant(a)
    rng = np.random.default_rng(3)
    submitted = {}
    for _ in range(120):
        op = rng.choice(["submit", "submit", "step", "drain"])
        if op == "submit":
            tid = int(rng.integers(0, 4))
            row = rng.integers(0, 2, TOTAL_BITS).astype(np.uint8)
            submitted[tb.submit(tid, row)] = (tid, row)
        elif op == "step":
            tb.step()
        else:
            tb.drain()
            assert not tb.queue
    results = tb.drain()
    assert [r.rid for r in results] == sorted(submitted)
    for r in results:
        tid, row = submitted[r.rid]
        assert r.tid == tid
        solo = export.artifact_scores(arts[tid], row[None], device=CPU)
        np.testing.assert_array_equal(r.scores, solo.numpy()[0])
    st = tb.stats()
    for tid in range(4):
        n = sum(1 for t, _ in submitted.values() if t == tid)
        assert st["per_tenant"][tid]["requests"] == n
    assert st["traces"] == 1 and st["install_traces"] == 1


def test_tenant_batcher_rejects_what_jax_rejects():
    _, arts = fleet(1)
    other = convert.artifact_from_numpy(artifact_arrays(7, m=8))
    tb = WnnTenantBatcher(capacity=2, slots=2, device=CPU)
    tb.add_tenant(arts[0])
    with pytest.raises(ValueError, match="geometry"):
        tb.add_tenant(other)
    with pytest.raises(ValueError, match="unknown tenant"):
        tb.submit(1, np.zeros(TOTAL_BITS, np.uint8))
    with pytest.raises(ValueError, match="bits"):
        tb.submit(0, np.zeros(TOTAL_BITS + 1, np.uint8))
    for kw in ({"capacity": 0}, {"slots": 0}, {"backend": "fused"}):
        with pytest.raises(ValueError):
            WnnTenantBatcher(device=CPU, **kw)
    assert tb.stats()["latency_p50_s"] is None
    # a mesh is no longer refused: on a one-process mesh the batch is not
    # split and the batcher serves as without one
    on_mesh = WnnTenantBatcher(capacity=2, slots=2,
                               mesh=mesh_mod.make_host_mesh(), device=CPU)
    on_mesh.add_tenant(arts[0])
    on_mesh.submit(0, np.ones(TOTAL_BITS, np.uint8))
    tb.submit(0, np.ones(TOTAL_BITS, np.uint8))
    np.testing.assert_array_equal(on_mesh.drain()[0].scores,
                                  tb.drain()[0].scores)


def test_counted_walks_dataclass_fields():
    """A fleet passed as a dataclass counts its leaves' shapes."""
    counts = {"f": 0}

    def f(st):
        return st

    g = torchhooks.counted(f, counts, "f")
    _, arts = fleet(1)
    prep = export.prepare_artifact(arts[0], device=CPU)
    g(layout.stacked_zeros(prep, 2))
    g(layout.stacked_zeros(prep, 2))
    assert counts["f"] == 1
    g(layout.stacked_zeros(prep, 3))
    assert counts["f"] == 2
