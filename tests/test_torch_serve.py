"""The port's serve path against the JAX package, on the CPU.

Inputs and model state are drawn once with numpy from a seed and handed
to both packages; integer outputs (hashes, bits, int32 scores,
predictions) must be exactly equal. Float thresholds from the Gaussian
fit agree to rtol 1e-6 (float32 sums in another order); the bits are then
compared on thresholds carried across, never refit.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import encoding as jencoding  # noqa: E402
from repro.core import export as jexport  # noqa: E402
from repro.core import model as jmodel  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.launch.scheduler import WnnBatcher as JWnnBatcher  # noqa: E402
from repro.obs import registry as jregistry  # noqa: E402
from repro.packed import layout as jlayout  # noqa: E402
from repro.packed import runtime as jruntime  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import bloom, encoding, export, hashing, model  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.launch.scheduler import WnnBatcher  # noqa: E402
from repro_torch.obs import registry, torchhooks  # noqa: E402
from repro_torch.packed import layout, runtime  # noqa: E402

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")
CPU = "cpu"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def golden():
    z = np.load(os.path.join(GOLDEN_DIR, "uln_s_golden.npz"))
    return z["bits"], z["scores"], z["labels"]


def golden_artifact():
    """A fresh port artifact per test: `prepare_artifact` memoizes on it."""
    return export.load(os.path.join(GOLDEN_DIR, "uln_s_artifact.npz"))


# a small model: 96 input bits, three submodels (E = 8 exercises the single
# padded word, n = 20 leaves a ragged wrap-around filter)
SPEC = dict(m=5, total_bits=96, submodels=((12, 5, 2), (20, 3, 1), (16, 6, 4)))


def random_model(seed):
    """numpy state of a binarized model: (statics as (perm, h3) pairs,
    bool tables, float masks with values > 1, float bias with halves)."""
    rng = np.random.default_rng(seed)
    m, total = SPEC["m"], SPEC["total_bits"]
    statics, tables, masks = [], [], []
    for n, log2e, k in SPEC["submodels"]:
        n_f = -(-total // n)
        perm = np.concatenate([rng.permutation(total),
                               rng.integers(0, total, n_f * n)])[:n_f * n]
        statics.append((perm.reshape(n_f, n).astype(np.int32),
                        rng.integers(0, 2 ** log2e, (k, n)).astype(np.uint32)))
        tables.append(rng.random((m, n_f, 2 ** log2e)) < 0.4)
        masks.append(rng.integers(0, 3, (m, n_f)).astype(np.float32))
    bias = np.array([-2.5, -0.5, 0.5, 1.5, 3.0], np.float32)[:m]
    return statics, tables, masks, bias


def jax_artifact(seed):
    statics, tables, masks, bias = random_model(seed)
    subs = [jexport.SubmodelArtifact(
        packed=jexport.pack_table(t), mask=msk > 0, perm=perm, h3=h3,
        entries=t.shape[-1], inputs_per_filter=perm.shape[1],
        num_hashes=h3.shape[0])
        for (perm, h3), t, msk in zip(statics, tables, masks)]
    return jexport.InferenceArtifact(
        submodels=subs, bias=np.round(bias).astype(np.int32),
        num_classes=SPEC["m"], total_bits=SPEC["total_bits"],
        bits_per_input=1)


def random_bits(seed, b):
    rng = np.random.default_rng(seed)
    return (rng.random((b, SPEC["total_bits"])) < 0.5).astype(np.uint8)


def jax_spec():
    return jmodel.UleenSpec(
        num_classes=SPEC["m"], total_bits=SPEC["total_bits"],
        submodels=tuple(jmodel.SubmodelSpec(n, log2e, k)
                        for n, log2e, k in SPEC["submodels"]))


def port_spec():
    return model.UleenSpec(
        num_classes=SPEC["m"], total_bits=SPEC["total_bits"],
        submodels=tuple(model.SubmodelSpec(n, log2e, k)
                        for n, log2e, k in SPEC["submodels"]))


def port_statics(statics):
    return [model.SubmodelStatic(perm=torch.from_numpy(p),
                                 h3=torch.from_numpy(h.astype(np.int32)))
            for p, h in statics]


# ---------------------------------------------------------------------------
# Golden artifact
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["gather", "fused", "packed", "auto"])
def test_golden_scores_every_backend(golden, backend):
    bits, scores, labels = golden
    got = export.artifact_scores(golden_artifact(), bits, backend=backend,
                                 device=CPU)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), scores)
    assert float(np.mean(got.argmax(-1).numpy() == labels)) > 0.5


def test_golden_packed_runtime_keeps_words_verbatim(golden):
    bits, scores, _ = golden
    art = golden_artifact()
    pt = layout.from_artifact(art, device=CPU)
    for sm, words in zip(art.submodels, pt.words):
        np.testing.assert_array_equal(words.numpy().view(np.uint32),
                                      sm.packed)
    for backend in ("packed", "auto"):
        s, p = runtime.packed_predict(pt, bits, backend=backend, device=CPU)
        np.testing.assert_array_equal(s.numpy(), scores)
        np.testing.assert_array_equal(p.numpy(), np.argmax(scores, -1))


def test_artifact_size_properties_match_jax():
    jart = jexport.load(os.path.join(GOLDEN_DIR, "uln_s_artifact.npz"))
    art = golden_artifact()
    for prop in ("size_kib", "packed_size_kib", "hash_ops_per_inference",
                 "lookups_per_inference"):
        assert getattr(art, prop) == getattr(jart, prop), prop


# ---------------------------------------------------------------------------
# save / load both ways
# ---------------------------------------------------------------------------

def test_jax_saved_artifact_serves_in_port(tmp_path):
    jart = jax_artifact(1)
    path = str(tmp_path / "jax.npz")
    jexport.save(jart, path)
    art = export.load(path)
    bits = random_bits(2, 23)
    expect = jexport.artifact_scores(jart, jnp.asarray(bits), backend="auto")
    for backend in ("auto", "gather"):
        got = export.artifact_scores(art, bits, backend=backend, device=CPU)
        np.testing.assert_array_equal(got.numpy(), np.asarray(expect))


def test_port_saved_artifact_serves_in_jax(tmp_path):
    art = convert.artifact_from_numpy(export.to_arrays(jax_artifact(3)))
    path = str(tmp_path / "port.npz")
    export.save(art, path)
    jart = jexport.load(path)
    bits = random_bits(4, 17)
    expect = export.artifact_scores(art, bits, backend="auto", device=CPU)
    got = jexport.artifact_scores(jart, jnp.asarray(bits), backend="gather")
    np.testing.assert_array_equal(np.asarray(got), expect.numpy())


def test_save_writes_the_same_arrays_as_jax(tmp_path):
    jart = jax_artifact(5)
    jexport.save(jart, str(tmp_path / "jax.npz"))
    export.save(convert.artifact_from_numpy(export.to_arrays(jart)),
                str(tmp_path / "port.npz"))
    with np.load(tmp_path / "jax.npz") as a, \
            np.load(tmp_path / "port.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for key in a.files:
            assert a[key].dtype == b[key].dtype, key
            np.testing.assert_array_equal(a[key], b[key])


# ---------------------------------------------------------------------------
# packed runtime, forward paths, ops dispatch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["packed", "auto"])
def test_packed_scores_and_predict_match_jax(backend):
    statics, tables, masks, bias = random_model(6)
    entries = [t.shape[-1] for t in tables]
    jpt = jlayout.from_binary_model(
        [jmodel.SubmodelStatic(perm=jnp.asarray(p), h3=jnp.asarray(h))
         for p, h in statics], [jnp.asarray(t) for t in tables],
        [jnp.asarray(m) for m in masks], jnp.asarray(bias), entries,
        SPEC["m"])
    pt = convert.packed_tables_from_binary(statics, tables, masks, bias,
                                           entries, SPEC["m"], device=CPU)
    for a, b in zip(jpt.words, pt.words):
        np.testing.assert_array_equal(np.asarray(a), b.numpy().view(np.uint32))
    assert pt.table_bytes() == jpt.table_bytes()
    bits = random_bits(7, 13)
    js, jp = jruntime.packed_predict(jpt, jnp.asarray(bits), backend=backend)
    s, p = runtime.packed_predict(pt, bits, backend=backend, device=CPU)
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(p.numpy(), np.asarray(jp))


@pytest.mark.parametrize("backend", ["gather", "fused", "packed", "auto"])
def test_forward_binary_fused_matches_jax(backend):
    """Half-integer float biases round half to even on both sides."""
    statics, tables, masks, bias = random_model(8)
    bits = random_bits(9, 11)
    expect = jmodel.forward_binary_fused(
        jax_spec(), [jmodel.SubmodelStatic(perm=jnp.asarray(p),
                                           h3=jnp.asarray(h))
                     for p, h in statics],
        [jnp.asarray(t) for t in tables], [jnp.asarray(m) for m in masks],
        jnp.asarray(bias), jnp.asarray(bits), backend=backend)
    got = model.forward_binary_fused(
        port_spec(), port_statics(statics),
        [torch.from_numpy(t) for t in tables],
        [torch.from_numpy(m) for m in masks], torch.from_numpy(bias),
        torch.from_numpy(bits), backend=backend, device=CPU)
    np.testing.assert_array_equal(got.numpy(), np.asarray(expect))


def test_forward_binary_and_hashing_match_jax():
    statics, tables, masks, bias = random_model(10)
    bits = random_bits(11, 9).astype(bool)
    jhashes = jmodel.compute_hashes(
        jax_spec(), [jmodel.SubmodelStatic(perm=jnp.asarray(p),
                                           h3=jnp.asarray(h))
                     for p, h in statics], jnp.asarray(bits))
    hashes = [hashing.h3_hash(torch.from_numpy(bits)[:, torch.from_numpy(p)
                                                     .long()],
                              torch.from_numpy(h.astype(np.int32)))
              for p, h in statics]
    for a, b in zip(jhashes, hashes):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    expect = jmodel.forward_binary(
        jax_spec(), [jnp.asarray(t) for t in tables],
        [jnp.asarray(m) for m in masks], jnp.asarray(bias), jhashes)
    got = model.forward_binary(
        port_spec(), [torch.from_numpy(t) for t in tables],
        [torch.from_numpy(m) for m in masks], torch.from_numpy(bias), hashes)
    np.testing.assert_array_equal(got.numpy(), np.asarray(expect))
    np.testing.assert_array_equal(model.predict(got).numpy(),
                                  np.asarray(jmodel.predict(expect)))


def test_bloom_primitives_match_jax():
    from repro.core import bloom as jbloom
    rng = np.random.default_rng(12)
    table = rng.random((4, 9, 16)) < 0.5
    hashes = rng.integers(0, 16, (3, 9, 2)).astype(np.int32)
    mask = rng.integers(0, 3, (4, 9)).astype(np.float32)
    jt, jh = jnp.asarray(table), jnp.asarray(hashes)
    tt, th = torch.from_numpy(table), torch.from_numpy(hashes)
    np.testing.assert_array_equal(
        bloom.gather_filter_values(tt, th).numpy(),
        np.asarray(jbloom.gather_filter_values(jt, jh)))
    resp = bloom.binary_filter_response(tt, th)
    jresp = jbloom.binary_filter_response(jt, jh)
    np.testing.assert_array_equal(resp.numpy(), np.asarray(jresp))
    np.testing.assert_array_equal(
        bloom.apply_mask(resp, torch.from_numpy(mask)).numpy(),
        np.asarray(jbloom.apply_mask(jresp, jnp.asarray(mask))))
    iresp = resp.to(torch.int32)
    np.testing.assert_array_equal(
        bloom.apply_mask(iresp, torch.from_numpy(mask)).numpy(),
        np.asarray(jbloom.apply_mask(jresp.astype(jnp.int32),
                                     jnp.asarray(mask))))


@pytest.mark.parametrize("backend", ["gather", "fused", "packed", "auto"])
@pytest.mark.parametrize("packed_in", [False, True])
def test_wnn_scores_matches_jax(backend, packed_in):
    rng = np.random.default_rng(13)
    b, n_f, n, m, e, k = 6, 19, 10, 4, 32, 2
    tuples = (rng.random((b, n_f, n)) < 0.5).astype(np.int8)
    params = rng.integers(0, e, (k, n)).astype(np.int32)
    table = rng.random((m, n_f, e)) < 0.3
    mask = rng.integers(0, 3, (m, n_f)).astype(np.int8)
    bias = rng.integers(-3, 4, m).astype(np.int32)
    jtab = jnp.asarray(jexport.pack_table(table)) if packed_in else \
        jnp.asarray(table, jnp.int8)
    ttab = torch.from_numpy(jexport.pack_table(table).view(np.int32)) \
        if packed_in else torch.from_numpy(table.astype(np.int8))
    entries = e if packed_in else None
    if packed_in and backend in ("gather", "fused"):
        # the int8 backends refuse packed tables, in both packages
        for fn, args in ((jops.wnn_scores, (jnp.asarray(tuples),
                                            jnp.asarray(params), jtab,
                                            jnp.asarray(mask),
                                            jnp.asarray(bias))),
                         (ops.wnn_scores, (torch.from_numpy(tuples),
                                           torch.from_numpy(params), ttab,
                                           torch.from_numpy(mask),
                                           torch.from_numpy(bias)))):
            kw = {"device": CPU} if fn is ops.wnn_scores else {}
            with pytest.raises(ValueError, match="uint32 bitplanes"):
                fn(*args, backend=backend, entries=entries, **kw)
        return
    expect = jops.wnn_scores(jnp.asarray(tuples), jnp.asarray(params), jtab,
                             jnp.asarray(mask), jnp.asarray(bias),
                             backend=backend, entries=entries)
    got = ops.wnn_scores(torch.from_numpy(tuples), torch.from_numpy(params),
                         ttab, torch.from_numpy(mask), torch.from_numpy(bias),
                         backend=backend, entries=entries, device=CPU)
    np.testing.assert_array_equal(got.numpy(), np.asarray(expect))


def _geometry_inputs():
    z8 = np.zeros
    return dict(tuples=z8((3, 9, 12), np.int8), params=z8((2, 12), np.int32),
                table=z8((5, 9, 16), np.int8), mask=z8((5, 9), np.int8),
                bias=z8((5,), np.int32), entries=None)


BAD_GEOMETRY = [
    ("tuples", np.zeros((3, 9), np.int8), "tuples must be"),
    ("table", np.zeros((5, 9, 12), np.int8), "power of two"),
    ("params", np.zeros((2, 7), np.int32), "params n"),
    ("mask", np.zeros((5, 4), np.int8), "mask"),
    ("bias", np.zeros((4,), np.int32), "bias"),
    ("table", np.zeros((5, 8, 16), np.int8), "table N_f"),
    ("params", np.zeros((9, 12), np.int32), "k=9"),
    ("entries", 32, "entries=32"),
    ("table", np.zeros((5, 9, 1), np.uint32), "declare entries"),
]


@pytest.mark.parametrize("name,value,match", BAD_GEOMETRY)
def test_bad_geometry_raises_the_same_valueerror(name, value, match):
    args = _geometry_inputs()
    args[name] = value
    entries = args.pop("entries")
    with pytest.raises(ValueError, match=match):
        jops.validate_wnn_geometry(
            *(jnp.asarray(v) for v in args.values()), entries=entries)
    with pytest.raises(ValueError, match=match):
        ops.wnn_scores(*(torch.from_numpy(v) for v in args.values()),
                       entries=entries, device=CPU)


def test_spec_sizes_match_jax():
    statics, tables, masks, bias = random_model(18)
    jspec, spec = jax_spec(), port_spec()
    assert [spec.num_filters(sm) for sm in spec.submodels] == \
        [jspec.num_filters(sm) for sm in jspec.submodels]
    assert [sm.entries for sm in spec.submodels] == \
        [sm.entries for sm in jspec.submodels]
    assert spec.size_kib() == jspec.size_kib()
    assert spec.size_kib([torch.from_numpy(m) for m in masks]) == \
        jspec.size_kib([jnp.asarray(m != 0) for m in masks])


@pytest.mark.parametrize("field,match", [
    ("masks", "mask"), ("perms", "perm"), ("h3s", "h3"), ("bias", "bias")])
def test_packed_tables_validate_like_jax(field, match):
    statics, tables, masks, bias = random_model(19)
    entries = [t.shape[-1] for t in tables]
    jpt = jlayout.from_binary_model(
        [jmodel.SubmodelStatic(perm=jnp.asarray(p), h3=jnp.asarray(h))
         for p, h in statics], [jnp.asarray(t) for t in tables],
        [jnp.asarray(m) for m in masks], jnp.asarray(bias), entries,
        SPEC["m"])
    pt = convert.packed_tables_from_binary(statics, tables, masks, bias,
                                           entries, SPEC["m"], device=CPU)
    def drop(x):                 # one filter or one class too few
        return x[:, :-1] if x.ndim == 2 else x[:-1]

    for tab in (jpt, pt):
        val = getattr(tab, field)
        setattr(tab, field, drop(val) if field == "bias"
                else (drop(val[0]),) + tuple(val[1:]))
        with pytest.raises(ValueError, match=match):
            tab.validate()


def test_packed_words_with_wrong_width_raise_like_jax():
    words = np.zeros((5, 9, 3), np.uint32)
    with pytest.raises(ValueError, match="word count"):
        jlayout.validate_packed_geometry(jnp.asarray(words), 64)
    with pytest.raises(ValueError, match="word count"):
        layout.validate_packed_geometry(torch.from_numpy(words), 64)


def test_unpacked_backends_refuse_packed_tables(golden):
    bits, _, _ = golden
    pt = layout.from_artifact(golden_artifact(), device=CPU)
    with pytest.raises(ValueError, match="packed"):
        runtime.packed_scores(pt, bits, backend="fused", device=CPU)
    with pytest.raises(ValueError, match="uint32 bitplanes"):
        ops.wnn_scores(torch.zeros((2, 43, 12), dtype=torch.int8),
                       pt.h3s[0], pt.words[0], pt.masks[0],
                       torch.zeros(10, dtype=torch.int32), backend="gather",
                       entries=64, device=CPU)


def test_prepare_artifact_caches_per_representation():
    art = golden_artifact()
    p1 = export.prepare_artifact(art, backend="auto", device=CPU)
    assert p1 is export.prepare_artifact(art, backend="packed", device=CPU)
    assert isinstance(p1, layout.PackedTables)
    pf = export.prepare_artifact(art, backend="fused", device=CPU)
    assert isinstance(pf, export.UnpackedTables)
    assert pf is export.prepare_artifact(art, backend="gather", device=CPU)
    with pytest.raises(ValueError, match="backend"):
        export.prepare_artifact(art, backend="mosaic", device=CPU)


@pytest.mark.parametrize("backend", ["auto", "fused"])
def test_prepare_artifact_refuses_bad_geometry(backend):
    """Both representations check their geometry when they are built."""
    art = golden_artifact()
    art.submodels[0].mask = art.submodels[0].mask[:, :-1]
    with pytest.raises(ValueError, match="mask"):
        export.prepare_artifact(art, backend=backend, device=CPU)


@pytest.mark.parametrize("backend", ["auto", "fused", "gather"])
def test_batches_run_no_geometry_check(golden, monkeypatch, backend):
    """Tables are checked once, when prepared: a served batch repeats no
    geometry check, and its scores are still the golden ones."""
    bits, scores, _ = golden
    eng = WnnBatcher(golden_artifact(), slots=4, backend=backend, device=CPU)
    checks = []
    monkeypatch.setattr(layout.PackedTables, "validate",
                        lambda self: checks.append("packed"))
    monkeypatch.setattr(ops, "validate_wnn_geometry",
                        lambda *a, **kw: checks.append("wnn"))
    for row in bits[:10]:
        eng.submit(row)
    got = np.stack([r.scores for r in eng.drain()])
    assert checks == []
    np.testing.assert_array_equal(got, scores[:10])


def test_ensemble_predict_breaks_ties_to_the_first_class():
    scores = np.array([[3, 3, 1], [0, 2, 2], [5, 5, 5]], np.int32)
    _, preds = ops.ensemble_predict(torch.from_numpy(scores))
    _, jpreds = jops.ensemble_predict(jnp.asarray(scores))
    np.testing.assert_array_equal(preds.numpy(), np.asarray(jpreds))
    assert preds.dtype == torch.int32


# ---------------------------------------------------------------------------
# WnnBatcher
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["auto", "packed", "gather"])
def test_wnn_batcher_matches_jax(golden, backend):
    bits, scores, _ = golden
    jart = jexport.load(os.path.join(GOLDEN_DIR, "uln_s_artifact.npz"))
    jeng = JWnnBatcher(jart, slots=12, backend=backend)
    eng = WnnBatcher(golden_artifact(), slots=12, backend=backend, device=CPU)
    for i in range(30):                      # 2 full batches + a partial
        jeng.submit(bits[i])
        eng.submit(bits[i])
    jres, res = jeng.drain(), eng.drain()
    np.testing.assert_array_equal(np.stack([r.scores for r in res]),
                                  np.stack([r.scores for r in jres]))
    np.testing.assert_array_equal(np.stack([r.scores for r in res]),
                                  scores[:30])
    assert [r.pred for r in res] == [r.pred for r in jres]
    st, jst = eng.stats(), jeng.stats()
    assert set(st) == set(jst)
    for key in ("requests", "batches", "submitted", "served", "queued",
                "class_shards", "occupancy", "traces"):
        assert st[key] == jst[key], key
    assert st["traces"] == 1


def test_wnn_batcher_fused_serves_golden(golden):
    bits, scores, _ = golden
    eng = WnnBatcher(golden_artifact(), slots=16, backend="fused",
                     device=CPU)
    for row in bits[:20]:
        eng.submit(row)
    got = np.stack([r.scores for r in eng.drain()])
    np.testing.assert_array_equal(got, scores[:20])
    assert eng.stats()["traces"] == 1


def test_wnn_batcher_empty_stats_and_wrong_width(golden):
    eng = WnnBatcher(golden_artifact(), slots=4, device=CPU)
    jeng = JWnnBatcher(
        jexport.load(os.path.join(GOLDEN_DIR, "uln_s_artifact.npz")), slots=4)
    assert eng.stats() == jeng.stats()       # nothing served: same values
    with pytest.raises(ValueError, match="bits"):
        eng.submit(np.zeros(7, np.uint8))
    assert eng.step() == 0                   # idle engine is a no-op


def test_batcher_snapshot_keeps_the_obsmetrics_schema(golden):
    """The port's snapshots pass the JAX package's schema check, so
    `scripts/diff_metrics.py` reads them."""
    bits, _, _ = golden
    with registry.recording() as rec:
        eng = WnnBatcher(golden_artifact(), slots=8, device=CPU)
        for row in bits[:10]:
            eng.submit(row)
        eng.drain()
        doc = rec.snapshot()
    jregistry.validate_snapshot(doc)
    assert doc["counters"]["torch.shape.batch_scores"] == 1
    assert doc["counters"]["prep.cache_miss"] == 1
    assert doc["histograms"]["serve.wnn.latency_s"]["count"] == 10
    assert [s["name"] for s in doc["spans"]].count("wnn.batch") == 2


def test_counted_bumps_once_per_distinct_shape():
    import collections
    counts = collections.Counter()
    fn = torchhooks.counted(lambda a, b: a, counts, "k")
    for shape in ((2, 3), (2, 3), (4, 3), (2, 3)):
        fn(torch.zeros(shape), b=torch.zeros(1))
    assert counts["k"] == 2


# ---------------------------------------------------------------------------
# Thermometer front end and the whole slice
# ---------------------------------------------------------------------------

def features(seed, b, f):
    rng = np.random.default_rng(seed)
    centre = rng.uniform(0.5, 2.0, f)
    return (centre + rng.standard_normal((b, f)) * 0.3).astype(np.float32)


def test_gaussian_fit_matches_jax():
    x = features(14, 300, 24)
    jenc = jencoding.fit_gaussian_thermometer(jnp.asarray(x), 7)
    enc = encoding.fit_gaussian_thermometer(torch.from_numpy(x), 7,
                                            device=CPU)
    assert enc.thresholds.dtype == torch.float32
    np.testing.assert_allclose(enc.thresholds.numpy(),
                               np.asarray(jenc.thresholds), rtol=1e-6)


def test_encoder_methods_match_jax():
    x = features(15, 40, 12)
    x[3, 4] = np.nan
    jenc = jencoding.fit_gaussian_thermometer(jnp.asarray(x[5:]), 5)
    enc = convert.encoder_from_numpy(np.asarray(jenc.thresholds), device=CPU)
    tx = torch.from_numpy(x)
    np.testing.assert_array_equal(enc.encode(tx).numpy(),
                                  np.asarray(jenc.encode(jnp.asarray(x))))
    counts = enc.encode_counts(tx)
    jcounts = jenc.encode_counts(jnp.asarray(x))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))
    np.testing.assert_array_equal(enc.decompress(counts).numpy(),
                                  np.asarray(jenc.decompress(jcounts)))
    np.testing.assert_array_equal(
        ops.decompress(counts, 5, device=CPU).reshape(40, -1).numpy(),
        np.asarray(jenc.encode(jnp.asarray(x))).astype(np.int8))


def test_whole_slice_matches_jax(golden):
    """raw features -> thermometer -> artifact_scores -> argmax, against
    the JAX package's encoder.encode -> artifact_scores."""
    art = golden_artifact()
    jart = jexport.load(os.path.join(GOLDEN_DIR, "uln_s_artifact.npz"))
    f = art.total_bits // art.bits_per_input
    x_train, x = features(16, 200, f), features(17, 21, f)
    jenc = jencoding.fit_gaussian_thermometer(jnp.asarray(x_train),
                                              art.bits_per_input)
    jbits = jenc.encode(jnp.asarray(x))
    jscores = jexport.artifact_scores(jart, jbits, backend="auto")
    enc = convert.encoder_from_numpy(np.asarray(jenc.thresholds), device=CPU)
    bits = ops.thermometer(torch.from_numpy(x), enc.thresholds, device=CPU)
    bits = bits.reshape(x.shape[0], -1)
    np.testing.assert_array_equal(bits.numpy(),
                                  np.asarray(jbits).astype(np.int8))
    for backend in ("auto", "fused", "gather"):
        scores, preds = export.predict_from_prep(
            export.prepare_artifact(art, backend=backend, device=CPU), bits,
            backend=backend)
        np.testing.assert_array_equal(scores.numpy(), np.asarray(jscores))
        np.testing.assert_array_equal(
            preds.numpy(), np.asarray(jnp.argmax(jscores, -1)))


# ---------------------------------------------------------------------------
# The class-sliced ensemble: what one launch a batch computes on the card
# ---------------------------------------------------------------------------

def random_artifact(seed, m, subs, total_bits, mask_kind="random"):
    """A JAX artifact drawn with numpy; `subs` as (n, log2 E, k). Where
    N_f·n passes total_bits the perm wraps with repeated indices."""
    rng = np.random.default_rng(seed)
    out = []
    for n, log2e, k in subs:
        e, n_f = 2 ** log2e, -(-total_bits // n)
        perm = np.concatenate([rng.permutation(total_bits),
                               rng.integers(0, total_bits, n_f * n)])
        mask = (np.zeros((m, n_f), bool) if mask_kind == "zeros"
                else rng.random((m, n_f)) < 0.8)
        out.append(jexport.SubmodelArtifact(
            packed=jexport.pack_table(rng.random((m, n_f, e)) < 0.3),
            mask=mask, perm=perm[:n_f * n].reshape(n_f, n).astype(np.int32),
            h3=rng.integers(0, e, (k, n)).astype(np.uint32), entries=e,
            inputs_per_filter=n, num_hashes=k))
    return jexport.InferenceArtifact(
        submodels=out, bias=rng.integers(-5, 6, m).astype(np.int32),
        num_classes=m, total_bits=total_bits, bits_per_input=1)


# M, submodels (n, log2 E, k), total bits, B, mask: M = 1, 8, 10, 33, 40;
# k = 1..8; n off multiples of 4 and n = 64; N_f off multiples of 32;
# wrapped perms; an all-zero mask; B = 1
ENSEMBLE_CASES = {
    "m1": (1, ((7, 3, 1),), 50, 6, "random"),
    "m8_k1_to_4": (8, ((5, 4, 1), (12, 6, 2), (9, 5, 3), (16, 7, 4)), 100, 9,
                   "random"),
    "m10_three_submodels": (10, ((12, 6, 2), (16, 7, 2), (20, 7, 2)), 300, 7,
                            "random"),
    "m33_n64_k8": (33, ((64, 10, 8), (6, 3, 5)), 200, 5, "random"),
    "m40_k6_k7": (40, ((13, 8, 6), (11, 5, 7)), 150, 4, "random"),
    "zero_mask": (10, ((10, 5, 2),), 80, 5, "zeros"),
    "b1": (10, ((7, 4, 2), (30, 9, 2)), 333, 1, "random"),
}


@pytest.mark.parametrize("case", sorted(ENSEMBLE_CASES))
def test_ensemble_plain_version_matches_jax(case):
    """`wnn_ensemble_ref` on the class slices both prepared
    representations derive equals the JAX `artifact_scores` and
    `packed.runtime.packed_scores`, exactly."""
    m, subs, total_bits, b, mask_kind = ENSEMBLE_CASES[case]
    jart = random_artifact(len(case), m, subs, total_bits, mask_kind)
    bits = (np.random.default_rng(b).random((b, total_bits)) < 0.5
            ).astype(np.uint8)
    expect = np.asarray(jexport.artifact_scores(jart, jnp.asarray(bits),
                                                backend="packed"))
    np.testing.assert_array_equal(
        np.asarray(jruntime.packed_scores(jlayout.from_artifact(jart),
                                          jnp.asarray(bits))), expect)
    art = convert.artifact_from_numpy(export.to_arrays(jart))
    t_bits = torch.from_numpy(bits)
    for backend, entry in (("auto", kernels.packed_wnn_ensemble),
                           ("fused", kernels.fused_wnn_ensemble)):
        prep = export.prepare_artifact(art, backend=backend, device=CPU)
        got = entry(t_bits, prep)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), expect)
        np.testing.assert_array_equal(
            ref.wnn_ensemble_ref(t_bits, prep.perms, prep.h3s, prep.slices,
                                 prep.class_masks, prep.bias).numpy(), expect)


def test_ensemble_plain_version_serves_golden(golden):
    bits, scores, _ = golden
    art = golden_artifact()
    for backend, entry in (("auto", kernels.packed_wnn_ensemble),
                           ("fused", kernels.fused_wnn_ensemble)):
        prep = export.prepare_artifact(art, backend=backend, device=CPU)
        np.testing.assert_array_equal(
            entry(torch.from_numpy(bits), prep).numpy(), scores)


@pytest.mark.parametrize("backend", ["auto", "fused"])
def test_prepared_tables_carry_the_class_slices(backend):
    """Both representations derive the class slices, mask words and the
    flat launch arguments once, when prepared: one `prep.build` span, the
    same slices from words and from int8 tables, the words verbatim."""
    with registry.recording() as rec:
        art = golden_artifact()
        prep = export.prepare_artifact(art, backend=backend, device=CPU)
        export.prepare_artifact(art, backend=backend, device=CPU)
        spans = [e for e in rec.snapshot()["spans"]
                 if e["name"] == "prep.build"]
    assert len(spans) == 1
    for sm, sl, cm, perm in zip(art.submodels, prep.slices,
                                prep.class_masks, prep.perms):
        table = jexport.unpack_table(sm.packed, sm.entries)
        assert sl.dtype == torch.int16           # M = 10
        np.testing.assert_array_equal(
            layout.table_from_class_slices(sl, 10).numpy(), table)
        np.testing.assert_array_equal(
            layout.table_from_class_slices(cm[:, None], 10)[:, :, 0].numpy(),
            sm.mask.astype(np.int8))
        assert sl.shape[0] == perm.shape[0]
    args = prep.kernel_args
    assert args.desc.shape == (len(art.submodels), 9)
    assert args.perms.dtype == torch.int16
    assert args.slices.numel() == sum(s.numel() for s in prep.slices)
    # the per-submodel slices are views of the one launch copy
    base = args.slices.untyped_storage().data_ptr()
    assert all(s.untyped_storage().data_ptr() == base for s in prep.slices)


def test_gather_prep_builds_no_class_slices(golden):
    """`gather` never launches the kernel, so its preparation carries no
    class slices; `fused` on the same artifact adds them once to the same
    int8 tables."""
    with registry.recording() as rec:
        art = golden_artifact()
        gather = export.prepare_artifact(art, backend="gather", device=CPU)
        fused = export.prepare_artifact(art, backend="fused", device=CPU)
        export.prepare_artifact(art, backend="fused", device=CPU)
        spans = [e["attrs"]["backend"] for e in rec.snapshot()["spans"]
                 if e["name"] == "prep.build"]
    assert gather.kernel_args is None
    assert fused.kernel_args is not None
    assert spans == ["gather", "fused"]
    assert all(a is b for a, b in zip(gather.tables, fused.tables))
    bits = torch.from_numpy(golden[0][:16])
    np.testing.assert_array_equal(
        export.scores_from_prep(gather, bits, backend="gather").numpy(),
        kernels.fused_wnn_ensemble(bits, fused).numpy())
