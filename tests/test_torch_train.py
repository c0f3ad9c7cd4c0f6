"""The port's training path against the JAX package, on the CPU.

Inputs are drawn once (numpy, or the JAX package's own `make_mnist_like`
data and `init_static`/`init_params` state handed over as numpy through
`repro_torch.convert`) and given to both packages. Each test states its
tolerance:

* exact — everything integer (hashes, counting tables, bleach, masks,
  rounded biases, exported arrays, int32 scores, accuracies counted over
  the same predictions);
* allclose — float paths whose sums PyTorch and XLA order differently:
  `rtol=1e-6` (`atol` as stated) for one-pass float32 values, and for
  trained tables the step of the sign test away from entries within 1e-4
  of 0, where two float32 orders may legitimately disagree.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import bloom as jbloom  # noqa: E402
from repro.core import encoding as jencoding  # noqa: E402
from repro.core import export as jexport  # noqa: E402
from repro.core import hashing as jhashing  # noqa: E402
from repro.core import model as jmodel  # noqa: E402
from repro.core import multi_shot as jms  # noqa: E402
from repro.core import one_shot as jone_shot  # noqa: E402
from repro.core import pruning as jpruning  # noqa: E402
from repro.kernels.h3_hash import h3_hash_tiled  # noqa: E402
from repro.packed import layout as jlayout  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro_torch import convert, kernels  # noqa: E402
from repro_torch.core import (bloom, encoding, export, hashing, model,  # noqa: E402
                              multi_shot, one_shot, pruning)
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.train import optimizer  # noqa: E402

CPU = "cpu"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def port_spec(jspec, **overrides):
    """The port's `UleenSpec` with the JAX spec's fields."""
    fields = dict(
        num_classes=jspec.num_classes, total_bits=jspec.total_bits,
        submodels=tuple(model.SubmodelSpec(s.inputs_per_filter,
                                           s.log2_entries, s.num_hashes)
                        for s in jspec.submodels),
        bits_per_input=jspec.bits_per_input, dropout=jspec.dropout,
        dropout_shared_classes=jspec.dropout_shared_classes,
        bf16_tables=jspec.bf16_tables)
    fields.update(overrides)
    return model.UleenSpec(**fields)


def np_tree(params):
    """A JAX `UleenParams` as the (tables, bias, masks) numpy triple."""
    return (tuple(np.asarray(t) for t in params.tables),
            np.asarray(params.bias), tuple(np.asarray(m) for m in params.masks))


def jax_params(triple):
    tables, bias, masks = triple
    return jmodel.UleenParams(tables=tuple(jnp.asarray(t) for t in tables),
                              bias=jnp.asarray(bias),
                              masks=tuple(jnp.asarray(m) for m in masks))


def pinned_params(jspec, seed):
    """JAX-initialised params with ~30 % of entries pinned at exactly +-1,
    as `clip_table=1.0` leaves them: the k lookups of a filter then tie
    often, which is where the min's gradient split matters."""
    params = jmodel.init_params(jax.random.PRNGKey(seed), jspec,
                                init_scale=0.1)
    rng = np.random.default_rng(seed)
    tables = []
    for t in params.tables:
        t = np.array(t)
        pin = rng.random(t.shape) < 0.3
        t[pin] = np.where(rng.random(int(pin.sum())) < 0.5, -1.0, 1.0)
        tables.append(t)
    return jax_params((tables, np.asarray(params.bias),
                       [np.asarray(m) for m in params.masks]))


@pytest.fixture(scope="module")
def pstatics(tiny_statics):
    return convert.statics_from_numpy(tiny_statics, device=CPU)


def correct(accuracy: float, n: int) -> int:
    """The count of correct predictions behind a float32 accuracy: the two
    packages divide by n in float32 differently (x / n against x * (1/n)),
    so accuracies are compared as counts, exactly."""
    return int(round(accuracy * n))


def np_encoded(encoded, n_train=None, n_val=None):
    bits_tr, y_tr, bits_te, y_te = (np.asarray(a) for a in encoded)
    return bits_tr[:n_train], y_tr[:n_train], bits_te[:n_val], y_te[:n_val]


# ---------------------------------------------------------------------------
# Hashing and the h3_hash kernel's plain version (exact)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,n_f,n,k", [
    (8, 16, 10, 2), (33, 7, 28, 1), (5, 100, 16, 4), (6, 11, 20, 9),
    (4, 5, 1, 3)])
def test_h3_hash_op_matches_pallas_interpret_and_jnp(b, n_f, n, k):
    """exact: `ops.h3_hash` on the CPU against the Pallas kernel in
    interpret mode and the jnp `core.hashing.h3_hash`; k = 9 and n = 1
    included (the JAX kernel bounds neither)."""
    rng = np.random.default_rng(b * 100 + n_f + k)
    tuples = (rng.random((b, n_f, n)) < 0.5).astype(np.int8)
    params = rng.integers(0, 2 ** 9, (k, n)).astype(np.int32)
    got = ops.h3_hash(torch.from_numpy(tuples), torch.from_numpy(params),
                      device=CPU)
    assert got.dtype == torch.int32 and tuple(got.shape) == (b, n_f, k)
    tiled = h3_hash_tiled(jnp.asarray(tuples), jnp.asarray(params),
                          interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(tiled))
    jnp_hash = jhashing.h3_hash(jnp.asarray(tuples, bool),
                                jnp.asarray(params, jnp.uint32))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jnp_hash))
    np.testing.assert_array_equal(
        hashing.h3_hash(torch.from_numpy(tuples), torch.from_numpy(params))
        .numpy(), np.asarray(jnp_hash))


def test_make_h3_params_range_and_dtype():
    gen = torch.Generator().manual_seed(3)
    p = hashing.make_h3_params(gen, 3, 17, 6)
    assert p.dtype == torch.int32 and tuple(p.shape) == (3, 17)
    assert int(p.min()) >= 0 and int(p.max()) < 64
    again = hashing.make_h3_params(torch.Generator().manual_seed(3), 3, 17, 6)
    assert torch.equal(p, again)


@pytest.mark.parametrize("n", [1, 31, 32, 33, 70])
def test_pack_bits_u32_matches_jax(n):
    """exact: the uint32 words (as int64 values in [0, 2^32))."""
    bits = np.random.default_rng(n).random((3, 4, n)) < 0.5
    want = np.asarray(jhashing.pack_bits_u32(jnp.asarray(bits)))
    got = hashing.pack_bits_u32(torch.from_numpy(bits))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("n,k,entries", [(12, 2, 64), (33, 3, 128),
                                         (64, 4, 2 ** 15), (5, 1, 8)])
def test_murmur_double_hash_matches_jax(n, k, entries):
    """exact: uint32 multiplies wrap in JAX; the port reduces them mod 2^32
    in int64 halves."""
    bits = np.random.default_rng(n * k).random((7, 9, n)) < 0.5
    bits[0, 0] = True                     # an all-ones tuple
    want = jhashing.murmur_double_hash(jnp.asarray(bits), k, entries)
    got = hashing.murmur_double_hash(torch.from_numpy(bits), k, entries)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


IDENTITY_SPEC = jmodel.UleenSpec(
    num_classes=4, total_bits=40,
    submodels=(jmodel.SubmodelSpec(6, 6, 1), jmodel.SubmodelSpec(4, 4, 1)))


@pytest.mark.parametrize("family", ["h3", "murmur", "identity"])
def test_compute_hashes_matches_jax(family, tiny_spec, tiny_statics,
                                    pstatics):
    """exact, for every hash family (identity needs E = 2^n, k = 1)."""
    if family == "identity":
        jspec = IDENTITY_SPEC
        jst = jmodel.init_static(jax.random.PRNGKey(5), jspec)
        pst = convert.statics_from_numpy(jst, device=CPU)
    else:
        jspec, jst, pst = tiny_spec, tiny_statics, pstatics
    bits = np.random.default_rng(9).random((21, jspec.total_bits)) < 0.5
    want = jmodel.compute_hashes(jspec, jst, jnp.asarray(bits),
                                 hash_family=family)
    got = model.compute_hashes(port_spec(jspec), pst, bits,
                               hash_family=family, device=CPU)
    for w, g in zip(want, got):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_compute_hashes_h3_goes_through_the_hash_wrapper(tiny_spec,
                                                         pstatics,
                                                         monkeypatch):
    calls = []
    real = ops.h3_hash_kernel

    def spy(tuples, params):
        calls.append(tuple(tuples.shape))
        return real(tuples, params)

    monkeypatch.setattr(ops, "h3_hash_kernel", spy)
    bits = np.zeros((3, tiny_spec.total_bits), np.uint8)
    model.compute_hashes(port_spec(tiny_spec), pstatics, bits, device=CPU)
    assert calls == [(3, tiny_spec.num_filters(sm), sm.inputs_per_filter)
                     for sm in tiny_spec.submodels]


# ---------------------------------------------------------------------------
# Bloom primitives
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("duplicates", [False, True])
def test_counting_increment_matches_jax(duplicates):
    """exact, including a filter whose k hashes hit one entry twice: both
    increments land, as JAX's `.at[].add` does."""
    rng = np.random.default_rng(int(duplicates))
    table = rng.integers(0, 4, (5, 13, 16)).astype(np.int32)
    hashes = rng.integers(0, 16, (13, 3)).astype(np.int32)
    if duplicates:
        hashes[::2, 1] = hashes[::2, 0]
        hashes[1, :] = hashes[1, 0]
    for label in (0, 3):
        want = jbloom.counting_increment(jnp.asarray(table),
                                         jnp.asarray(hashes), label)
        got = bloom.counting_increment(torch.from_numpy(table),
                                       torch.from_numpy(hashes), label)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if duplicates:
        got = bloom.counting_increment(torch.from_numpy(table),
                                       torch.from_numpy(hashes), 2)
        h = hashes[1, 0]
        assert int(got[2, 1, h]) == table[2, 1, h] + 3


def test_counting_increment_of_distinct_labels_equals_one_by_one():
    """exact: a batch of samples of distinct classes (a one-shot class
    round) updates as the same samples do one after another in JAX."""
    rng = np.random.default_rng(12)
    table = rng.integers(0, 3, (6, 9, 8)).astype(np.int32)
    hashes = rng.integers(0, 8, (4, 9, 2)).astype(np.int32)
    hashes[2, 3, 1] = hashes[2, 3, 0]                  # a duplicate too
    labels = np.array([5, 0, 3, 1])
    want = jnp.asarray(table)
    for h, y in zip(hashes, labels):
        want = jbloom.counting_increment(want, jnp.asarray(h), int(y))
    got = bloom.counting_increment(torch.from_numpy(table),
                                   torch.from_numpy(hashes),
                                   torch.from_numpy(labels))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_counting_and_binary_primitives_match_jax():
    """exact: min counters, both binarisations; the Bloom FPR estimate."""
    rng = np.random.default_rng(4)
    counting = rng.integers(0, 6, (4, 9, 32)).astype(np.int32)
    cont = rng.uniform(-1, 1, (4, 9, 32)).astype(np.float32)
    cont[:, :, :4] = 0.0                          # the step at exactly 0
    hashes = rng.integers(0, 32, (11, 9, 2)).astype(np.int32)
    np.testing.assert_array_equal(
        bloom.counting_min_values(torch.from_numpy(counting),
                                  torch.from_numpy(hashes)).numpy(),
        np.asarray(jbloom.counting_min_values(jnp.asarray(counting),
                                              jnp.asarray(hashes))))
    np.testing.assert_array_equal(
        bloom.binarize_counting(torch.from_numpy(counting), 3).numpy(),
        np.asarray(jbloom.binarize_counting(jnp.asarray(counting), 3)))
    np.testing.assert_array_equal(
        bloom.binarize_continuous(torch.from_numpy(cont)).numpy(),
        np.asarray(jbloom.binarize_continuous(jnp.asarray(cont))))
    assert bloom.false_positive_rate(30, 64, 2) == \
        jbloom.false_positive_rate(30, 64, 2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_continuous_filter_response_value_and_gradient(dtype):
    """Value exact ({0,1}); gradient allclose (rtol 1e-6, atol 1e-9) with
    entries pinned at exactly +-1 so the k lookups tie: both split the
    gradient evenly among tied minima."""
    rng = np.random.default_rng(7)
    table = rng.uniform(-1, 1, (3, 6, 8)).astype(np.float32)
    table[rng.random(table.shape) < 0.5] = 1.0
    table[rng.random(table.shape) < 0.3] = -1.0
    hashes = rng.integers(0, 8, (10, 6, 2)).astype(np.int32)
    w = rng.standard_normal((10, 3, 6)).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32

    def jloss(t):
        resp = jbloom.continuous_filter_response(t.astype(jdt),
                                                 jnp.asarray(hashes))
        return jnp.sum(resp.astype(jnp.float32) * w), resp

    (_, jresp), jgrad = jax.value_and_grad(jloss, has_aux=True)(
        jnp.asarray(table))
    t = torch.from_numpy(table).requires_grad_(True)
    resp = bloom.continuous_filter_response(t.to(tdt),
                                            torch.from_numpy(hashes))
    (resp.float() * torch.from_numpy(w)).sum().backward()
    np.testing.assert_array_equal(resp.detach().float().numpy(),
                                  np.asarray(jresp, np.float32))
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(jgrad),
                               rtol=1e-6, atol=1e-9)
    # a tie really occurred and split its gradient
    vals = table[:, np.arange(6)[None, :, None], hashes].transpose(1, 0, 2, 3)
    assert (vals[..., 0] == vals[..., 1]).any()


# ---------------------------------------------------------------------------
# Encoding fits (allclose, rtol 1e-6: float32 reductions in another order)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fit", ["gaussian", "linear", "mean"])
def test_fits_match_jax(fit, tiny_data):
    x = np.asarray(tiny_data.x_train[:300])
    if fit == "mean":
        want = jencoding.fit_mean_binarizer(jnp.asarray(x))
        got = encoding.fit_mean_binarizer(x, device=CPU)
    else:
        jfit = getattr(jencoding, f"fit_{fit}_thermometer")
        want = jfit(jnp.asarray(x), 3)
        got = getattr(encoding, f"fit_{fit}_thermometer")(x, 3, device=CPU)
    assert got.thresholds.dtype == torch.float32
    assert got.thresholds.device.type == "cpu"
    np.testing.assert_allclose(got.thresholds.numpy(),
                               np.asarray(want.thresholds), rtol=1e-6,
                               atol=1e-6)


# ---------------------------------------------------------------------------
# Model: init, forward, binarisation
# ---------------------------------------------------------------------------

def test_init_static_pads_by_resampling_and_init_params_range(tiny_spec):
    spec = port_spec(tiny_spec)
    gen = torch.Generator().manual_seed(11)
    statics = model.init_static(gen, spec, device=CPU)
    for sm, st in zip(spec.submodels, statics):
        n_f = spec.num_filters(sm)
        assert tuple(st.perm.shape) == (n_f, sm.inputs_per_filter)
        assert st.perm.dtype == torch.int32 and st.h3.dtype == torch.int32
        flat = st.perm.reshape(-1)
        # a permutation of every input bit, then resampled padding
        assert torch.equal(torch.sort(flat[:spec.total_bits]).values,
                           torch.arange(spec.total_bits, dtype=torch.int32))
        assert int(flat.max()) < spec.total_bits
        assert int(st.h3.max()) < sm.entries
    params = model.init_params(torch.Generator().manual_seed(12), spec,
                               init_scale=0.1, device=CPU)
    for sm, t, m in zip(spec.submodels, params.tables, params.masks):
        assert tuple(t.shape) == (10, spec.num_filters(sm), sm.entries)
        assert float(t.min()) >= -0.1 and float(t.max()) < 0.01 + 1e-7
        assert 0.85 < float((t < 0).float().mean()) < 0.95   # not symmetric
        assert torch.equal(m, torch.ones_like(m))
    assert torch.equal(params.bias, torch.zeros(10))


def test_forward_eval_and_binarized_match_jax(tiny_spec, tiny_statics,
                                              pstatics, encoded):
    """Eval scores allclose (rtol 1e-6: float32 sums over filters); the
    binarized model's int32 scores exact."""
    jparams = pinned_params(tiny_spec, 21)
    bits = np_encoded(encoded, 64)[0]
    jh = jmodel.compute_hashes(tiny_spec, tiny_statics, jnp.asarray(bits))
    spec = port_spec(tiny_spec)
    params = convert.params_from_numpy(np_tree(jparams), device=CPU)
    ph = model.compute_hashes(spec, pstatics, bits, device=CPU)
    np.testing.assert_allclose(
        model.forward(spec, params, ph).numpy(),
        np.asarray(jmodel.forward(tiny_spec, jparams, jh)), rtol=1e-6)
    jtb, jm, jb = jmodel.binarize_params(jparams)
    tb, m, b = model.binarize_params(params)
    for x, y in zip(tb, jtb):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    np.testing.assert_array_equal(
        model.forward_binary(spec, tb, m, b, ph).numpy(),
        np.asarray(jmodel.forward_binary(tiny_spec, jtb, jm, jb, jh)))
    jpacked = jmodel.binarize_to_packed(tiny_spec, tiny_statics, jparams)
    packed = model.binarize_to_packed(spec, pstatics, params, device=CPU)
    for x, y in zip(packed.words, jpacked.words):
        np.testing.assert_array_equal(x.numpy().view(np.uint32),
                                      np.asarray(y))


def test_dropout_only_in_train_mode(tiny_spec, pstatics, encoded):
    spec = port_spec(tiny_spec)
    params = model.init_params(torch.Generator().manual_seed(2), spec,
                               init_scale=0.1, device=CPU)
    h = model.compute_hashes(spec, pstatics, np_encoded(encoded, 16)[0],
                             device=CPU)
    a = model.forward(spec, params, h)
    assert torch.equal(a, model.forward(spec, params, h))
    c = model.forward(spec, params, h, train=True,
                      generator=torch.Generator().manual_seed(0))
    assert not torch.allclose(a, c)
    with pytest.raises(ValueError, match="generator"):
        model.forward(spec, params, h, train=True)


# ---------------------------------------------------------------------------
# Optimizer and multi-shot
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_cross_entropy_matches_jax(smoothing):
    """allclose, rtol 1e-6: log-softmax sums in another order."""
    rng = np.random.default_rng(int(smoothing * 10))
    scores = (rng.standard_normal((37, 10)) * 20).astype(np.float32)
    labels = rng.integers(0, 10, 37)
    want = jms.cross_entropy(jnp.asarray(scores), jnp.asarray(labels),
                             smoothing)
    got = multi_shot.cross_entropy(torch.from_numpy(scores),
                                   torch.from_numpy(labels), smoothing)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_adam_five_steps_match_jax():
    """allclose over 5 steps (rtol 1e-6, atol 1e-10): the float32 bias
    corrections and update in the JAX package's order."""
    rng = np.random.default_rng(5)
    params = [rng.standard_normal((4, 7)).astype(np.float32),
              rng.standard_normal((3,)).astype(np.float32)]
    grads = [[(rng.standard_normal(p.shape) * 10.0 ** -s).astype(np.float32)
              for p in params] for s in range(5)]
    jo = jopt.adam(1e-3)
    jp = [jnp.asarray(p) for p in params]
    js = jo.init(jp)
    po = optimizer.adam(1e-3)
    pp = tuple(torch.from_numpy(p) for p in params)
    ps = po.init(pp)
    for g in grads:
        ju, js = jo.update([jnp.asarray(x) for x in g], js, jp)
        jp = jopt.apply_updates(jp, ju)
        pu, ps = po.update([torch.from_numpy(x) for x in g], ps)
        pp = optimizer.apply_updates(pp, pu)
    assert int(ps.step) == int(js.step) == 5
    for a, b in zip(pp, jp):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-10)
    for a, b in zip(ps.nu, js.nu):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-14)


def jax_keep_masks(jspec, rng, batch, grad_blocks):
    """The dropout keep-masks JAX's train step draws from `rng`, rebuilt
    by the same split sequence (`model.forward`, per block
    `multi_shot.block_rng`), stacked over the whole batch."""
    rows = batch // grad_blocks
    keeps = [[] for _ in jspec.submodels]
    for blk in range(grad_blocks):
        r = jms.block_rng(rng, blk) if grad_blocks > 1 else rng
        for i, sm in enumerate(jspec.submodels):
            r, sub = jax.random.split(r)
            n_f = jspec.num_filters(sm)
            shape = (rows, 1, n_f) if jspec.dropout_shared_classes else \
                (rows, jspec.num_classes, n_f)
            keeps[i].append(np.asarray(
                jax.random.bernoulli(sub, 1.0 - jspec.dropout, shape)))
    return [torch.from_numpy(np.concatenate(k)) for k in keeps]


@pytest.mark.parametrize("grad_blocks", [1, 4])
@pytest.mark.parametrize("shared", [False, True], ids=["per_class",
                                                       "shared_classes"])
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_train_step_matches_jax(tiny_spec, tiny_statics, pstatics, encoded,
                                grad_blocks, shared, bf16):
    """One `make_train_step` from the same params with JAX's dropout masks
    passed through `keep=`. Loss allclose (rtol 1e-6, atol 1e-6), accuracy
    exact, tables and bias allclose (atol 1e-7: one Adam step from float32
    gradients summed in another order), Adam's first moments (atol 1e-8)."""
    jspec = jmodel.UleenSpec(
        num_classes=tiny_spec.num_classes, total_bits=tiny_spec.total_bits,
        submodels=tiny_spec.submodels, bits_per_input=2,
        dropout_shared_classes=shared, bf16_tables=bf16)
    spec = port_spec(jspec)
    jparams = pinned_params(jspec, 31)
    bits, labels = np_encoded(encoded, 64)[:2]
    jh = jmodel.compute_hashes(jspec, tiny_statics, jnp.asarray(bits))
    rng = jax.random.PRNGKey(7)
    jo = jopt.adam(1e-3)
    jstep = jms.make_train_step(jspec, jo, 1.0, 0.0, grad_blocks=grad_blocks)
    jp, jstate, jloss, jacc = jstep(jparams, jo.init(jparams), jh,
                                    jnp.asarray(labels), rng)

    params = convert.params_from_numpy(np_tree(jparams), device=CPU)
    po = optimizer.adam(1e-3)
    state = po.init([*params.tables, params.bias])
    step = multi_shot.make_train_step(spec, po, 1.0, 0.0,
                                      grad_blocks=grad_blocks)
    h = model.compute_hashes(spec, pstatics, bits, device=CPU)
    p, state, loss, acc = step(params, state, h, torch.from_numpy(labels),
                               keep=jax_keep_masks(jspec, rng, 64,
                                                   grad_blocks))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-6,
                               atol=1e-6)
    assert float(acc) == float(jacc)
    for a, b in zip(p.tables, jp.tables):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-7)
    np.testing.assert_allclose(p.bias.numpy(), np.asarray(jp.bias), rtol=0,
                               atol=1e-7)
    for a, b in zip(state.mu, [*jstate.mu.tables, jstate.mu.bias]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-8)
    # masks are never trained
    for a, b in zip(p.masks, params.masks):
        assert torch.equal(a, b)


def test_train_multi_shot_without_dropout_matches_jax(tiny_spec, tiny_statics,
                                                      pstatics, encoded):
    """dropout=0 over 2 epochs (no random draws, the same numpy batch
    order): the loss history allclose (rtol 1e-5), the binarized tables
    exact away from entries within 1e-4 of 0, validation accuracy exact."""
    jspec = jmodel.UleenSpec(
        num_classes=tiny_spec.num_classes, total_bits=tiny_spec.total_bits,
        submodels=tiny_spec.submodels, bits_per_input=2, dropout=0.0)
    spec = port_spec(jspec)
    bits_tr, y_tr, bits_te, y_te = np_encoded(encoded, 512, 200)
    jparams = jmodel.init_params(jax.random.PRNGKey(2), jspec, init_scale=0.1)
    cfg = dict(epochs=2, batch_size=128, learning_rate=1e-2)
    want = jms.train_multi_shot(jspec, tiny_statics, jparams,
                                jnp.asarray(bits_tr), jnp.asarray(y_tr),
                                jnp.asarray(bits_te), jnp.asarray(y_te),
                                jms.MultiShotConfig(**cfg))
    got = multi_shot.train_multi_shot(
        spec, pstatics, convert.params_from_numpy(np_tree(jparams),
                                                  device=CPU),
        bits_tr, y_tr, bits_te, y_te, multi_shot.MultiShotConfig(**cfg),
        device=CPU)
    assert len(got.history) == len(want.history) == 2
    np.testing.assert_allclose([h["loss"] for h in got.history],
                               [h["loss"] for h in want.history], rtol=1e-5)
    n_val = len(y_te)
    assert [correct(h["val_acc"], n_val) for h in got.history] == \
        [correct(h["val_acc"], n_val) for h in want.history]
    assert correct(got.val_accuracy, n_val) == \
        correct(want.val_accuracy, n_val)
    for a, b in zip(got.params.tables, want.params.tables):
        b = np.asarray(b)
        away = np.abs(b) > 1e-4
        assert away.mean() > 0.99
        np.testing.assert_array_equal((a.numpy() >= 0)[away], (b >= 0)[away])
    jacc = jms.evaluate(jspec, tiny_statics, want.params, jnp.asarray(bits_te),
                        jnp.asarray(y_te))
    assert correct(multi_shot.evaluate(spec, pstatics, got.params, bits_te,
                                       y_te, device=CPU), n_val) == \
        correct(jacc, n_val)


def test_best_params_are_a_snapshot_not_the_last_epoch(tiny_spec, pstatics,
                                                       encoded):
    """`best_params` is a clone: later epochs do not write into it."""
    spec = port_spec(tiny_spec)
    bits_tr, y_tr, bits_te, y_te = np_encoded(encoded, 256, 100)
    params = model.init_params(torch.Generator().manual_seed(2), spec,
                               init_scale=0.1, device=CPU)
    res = multi_shot.train_multi_shot(
        spec, pstatics, params, bits_tr, y_tr, bits_te, y_te,
        multi_shot.MultiShotConfig(epochs=3, batch_size=64,
                                   learning_rate=1e-2), device=CPU)
    acc = multi_shot.evaluate(spec, pstatics, res.params, bits_te, y_te,
                              device=CPU)
    assert acc == res.val_accuracy == max(h["val_acc"] for h in res.history)


# ---------------------------------------------------------------------------
# One-shot, pruning, export
# ---------------------------------------------------------------------------

def test_one_shot_matches_jax(tiny_spec, tiny_statics, pstatics, encoded):
    """exact: counting tables (the per-class sample order kept), the
    bleach threshold and the accuracy."""
    bits_tr, y_tr, bits_te, y_te = np_encoded(encoded, 600, 200)
    want = jone_shot.train_one_shot(tiny_spec, tiny_statics,
                                    jnp.asarray(bits_tr), jnp.asarray(y_tr),
                                    jnp.asarray(bits_te), jnp.asarray(y_te))
    spec = port_spec(tiny_spec)
    got = one_shot.train_one_shot(spec, pstatics, bits_tr, y_tr, bits_te,
                                  y_te, device=CPU)
    for a, b in zip(got.counting, want.counting):
        assert a.dtype == torch.int32
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert int(got.bleach) == int(want.bleach)
    for a, b in zip(one_shot.binarize(got), jone_shot.binarize(want)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    jacc = jone_shot.evaluate_one_shot(tiny_spec, tiny_statics, want,
                                       jnp.asarray(bits_te),
                                       jnp.asarray(y_te))
    n_val = len(y_te)
    assert correct(one_shot.evaluate_one_shot(spec, pstatics, got, bits_te,
                                              y_te, device=CPU), n_val) == \
        correct(jacc, n_val)
    carried = convert.one_shot_from_numpy(
        [[np.asarray(c) for c in want.counting], np.asarray(want.bleach),
         np.asarray(want.bias)], device=CPU)
    assert correct(one_shot.evaluate_one_shot(spec, pstatics, carried,
                                              bits_te, y_te, device=CPU),
                   n_val) == correct(jacc, n_val)


def test_filter_correlations_match_jax(tiny_spec, tiny_statics, pstatics,
                                       encoded):
    """allclose (rtol 1e-5, atol 1e-6): float32 means and population
    standard deviations in another order."""
    jparams = pinned_params(tiny_spec, 41)
    bits, labels = np_encoded(encoded, 256)[:2]
    jh = jmodel.compute_hashes(tiny_spec, tiny_statics, jnp.asarray(bits))
    want = jpruning.filter_correlations(tiny_spec, jparams, jh,
                                        jnp.asarray(labels))
    spec = port_spec(tiny_spec)
    got = pruning.filter_correlations(
        spec, convert.params_from_numpy(np_tree(jparams), device=CPU),
        model.compute_hashes(spec, pstatics, bits, device=CPU), labels)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("ratio", [0.0, 0.3, 0.5])
def test_prune_masks_and_init_bias_match_jax(tiny_spec, tiny_statics,
                                             pstatics, encoded, ratio):
    """exact on the same correlations (ties included: stable argsort) and
    the same params: masks, then the rounded bias."""
    jparams = pinned_params(tiny_spec, 51)
    bits, labels = np_encoded(encoded, 256)[:2]
    jh = jmodel.compute_hashes(tiny_spec, tiny_statics, jnp.asarray(bits))
    corr = [np.round(np.asarray(c), 2) for c in jpruning.filter_correlations(
        tiny_spec, jparams, jh, jnp.asarray(labels))]      # rounded: ties
    want = jpruning.prune_masks(tiny_spec, [jnp.asarray(c) for c in corr],
                                ratio)
    spec = port_spec(tiny_spec)
    got = pruning.prune_masks(spec, [torch.from_numpy(c) for c in corr],
                              ratio)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    params = convert.params_from_numpy(np_tree(jparams), device=CPU)
    ph = model.compute_hashes(spec, pstatics, bits, device=CPU)
    np.testing.assert_array_equal(
        pruning.init_bias(spec, params, got, ph).numpy(),
        np.asarray(jpruning.init_bias(tiny_spec, jparams, want, jh)))


def test_prune_and_finetune_without_epochs_matches_jax(
        tiny_spec, tiny_statics, pstatics, encoded):
    """finetune.epochs=0 prunes and evaluates: masks and bias exact,
    accuracy exact (the JAX correlations round-trip within 1e-5, far from
    the order ties of this data)."""
    jparams = pinned_params(tiny_spec, 61)
    bits_tr, y_tr, bits_te, y_te = np_encoded(encoded, 256, 100)
    want = jpruning.prune_and_finetune(
        tiny_spec, tiny_statics, jparams, jnp.asarray(bits_tr),
        jnp.asarray(y_tr), jnp.asarray(bits_te), jnp.asarray(y_te),
        ratio=0.3, finetune=jms.MultiShotConfig(epochs=0))
    spec = port_spec(tiny_spec)
    got = pruning.prune_and_finetune(
        spec, pstatics, convert.params_from_numpy(np_tree(jparams),
                                                  device=CPU),
        bits_tr, y_tr, bits_te, y_te, ratio=0.3,
        finetune=multi_shot.MultiShotConfig(epochs=0), device=CPU)
    for a, b in zip(got.params.masks, want.params.masks):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(got.params.bias.numpy(),
                                  np.asarray(want.params.bias))
    assert correct(got.val_accuracy, len(y_te)) == \
        correct(want.val_accuracy, len(y_te))
    assert got.history == []


def test_export_model_arrays_match_jax(tiny_spec, tiny_statics, pstatics,
                                       tmp_path):
    """exact: every array `save` writes, with the JAX package's dtypes;
    the port's npz loads in the JAX package unchanged."""
    jparams = pinned_params(tiny_spec, 71)
    masks = [np.asarray(m).copy() for m in jparams.masks]
    masks[0][:, ::3] = 0.0
    jparams = jparams._replace(masks=tuple(jnp.asarray(m) for m in masks),
                               bias=jnp.asarray(
                                   np.linspace(-2.5, 2.5, 10, dtype=np.float32)))
    want = jexport.export_model(tiny_spec, tiny_statics, jparams)
    got = export.export_model(
        port_spec(tiny_spec), pstatics,
        convert.params_from_numpy(np_tree(jparams), device=CPU))
    jpath, ppath = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    jexport.save(want, jpath)
    export.save(got, ppath)
    with np.load(jpath) as zj, np.load(ppath) as zp:
        assert sorted(zj.files) == sorted(zp.files)
        for key in zj.files:
            assert zp[key].dtype == zj[key].dtype, key
            np.testing.assert_array_equal(zp[key], zj[key], err_msg=key)
    assert got.size_kib == want.size_kib
    assert got.packed_size_kib == want.packed_size_kib


def test_params_round_trip_through_numpy(tiny_spec):
    jparams = pinned_params(tiny_spec, 81)
    tree = np_tree(jparams)
    back = convert.params_to_numpy(convert.params_from_numpy(tree,
                                                             device=CPU))
    for a, b in zip([*back[0], back[1], *back[2]],
                    [*tree[0], tree[1], *tree[2]]):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# The whole slice: the port trains, the JAX package serves what it exports
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def port_trained(tiny_data, tiny_spec, pstatics, tmp_path_factory):
    """fit -> one-shot -> multi-shot -> prune -> export, all in the port on
    the CPU, on the JAX package's `make_mnist_like` data."""
    spec = port_spec(tiny_spec)
    x_tr, y_tr = np.asarray(tiny_data.x_train), np.asarray(tiny_data.y_train)
    x_te, y_te = np.asarray(tiny_data.x_test), np.asarray(tiny_data.y_test)
    enc = encoding.fit_gaussian_thermometer(x_tr, 2, device=CPU)
    bits_tr = ops.thermometer(x_tr, enc.thresholds, device=CPU).reshape(
        len(x_tr), -1)
    bits_te = ops.thermometer(x_te, enc.thresholds, device=CPU).reshape(
        len(x_te), -1)
    osm = one_shot.train_one_shot(spec, pstatics, bits_tr, y_tr, bits_te,
                                  y_te, device=CPU)
    os_acc = one_shot.evaluate_one_shot(spec, pstatics, osm, bits_te, y_te,
                                        device=CPU)
    params = model.init_params(torch.Generator().manual_seed(2), spec,
                               init_scale=0.1, device=CPU)
    ms = multi_shot.train_multi_shot(
        spec, pstatics, params, bits_tr, y_tr, bits_te, y_te,
        multi_shot.MultiShotConfig(epochs=8, batch_size=128,
                                   learning_rate=1e-2), device=CPU)
    pruned = pruning.prune_and_finetune(
        spec, pstatics, ms.params, bits_tr, y_tr, bits_te, y_te, ratio=0.3,
        finetune=multi_shot.MultiShotConfig(epochs=2, batch_size=128,
                                            learning_rate=5e-3), device=CPU)
    art = export.export_model(spec, pstatics, pruned.params)
    path = str(tmp_path_factory.mktemp("port_artifact") / "uleen.npz")
    export.save(art, path)
    return dict(spec=spec, bits_te=bits_te, y_te=y_te, os_acc=os_acc, ms=ms,
                pruned=pruned, path=path)


def test_whole_slice_accuracy_bands(port_trained, tiny_spec):
    """The bands of tests/test_training.py: one-shot > 0.4; pruning 30 %
    costs at most 0.05 after fine-tuning and shrinks the model ~30 %."""
    assert port_trained["os_acc"] > 0.4
    assert port_trained["pruned"].val_accuracy >= \
        port_trained["ms"].val_accuracy - 0.05
    spec = port_trained["spec"]
    assert spec.size_kib(port_trained["pruned"].params.masks) == \
        pytest.approx(spec.size_kib() * 0.7, rel=0.05)


def test_port_trained_artifact_scores_bit_equal_in_jax(port_trained,
                                                       pstatics):
    """The JAX package loads the port's artifact and scores it bit-equal
    to the port's `artifact_scores`, which equals `forward_binary` on the
    binarized trained params."""
    bits = port_trained["bits_te"][:128]
    art = export.load(port_trained["path"])
    got = export.artifact_scores(art, bits, device=CPU)
    jart = jexport.load(port_trained["path"])
    want = jexport.artifact_scores(jart, jnp.asarray(bits.numpy()))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    spec = port_trained["spec"]
    tb, masks, bias = model.binarize_params(port_trained["pruned"].params)
    h = model.compute_hashes(spec, pstatics, bits, device=CPU)
    np.testing.assert_array_equal(
        model.forward_binary(spec, tb, masks, bias, h).numpy(), got.numpy())
    jpt = jlayout.from_artifact(jart)
    assert [int(np.asarray(w).size) for w in jpt.words] == \
        [int(sm.packed.size) for sm in art.submodels]


def test_cpu_training_counts_no_kernel_launches(tiny_spec, pstatics, encoded):
    kernels.reset_launch_counts()
    spec = port_spec(tiny_spec)
    bits_tr, y_tr, bits_te, y_te = np_encoded(encoded, 128, 64)
    one_shot.train_one_shot(spec, pstatics, bits_tr, y_tr, bits_te, y_te,
                            device=CPU)
    assert kernels.launch_counts()["h3_hash"] == 0
