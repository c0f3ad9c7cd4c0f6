"""The port's synthetic data generators against the JAX package, on the CPU.

The two packages draw from different generators (Philox, threefry), so
the datasets themselves are compared by shape, dtype, range and class
structure, the JAX package's own statistics run on the port's output.
The deterministic arithmetic between the draws (bilinear upsampling,
per-sample rolls, the sigmoid squash, the skew probabilities, the
tabular mixture) is held to JAX's on the same numpy inputs within 1e-6;
`make_lm_tokens` is numpy once it has its seed, so it is bit-equal given
the integer JAX derives from its key.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.data import synth as jsynth  # noqa: E402
from repro_torch.data import synth  # noqa: E402

CPU = "cpu"
TOL = 1e-6


def gen(seed):
    return torch.Generator().manual_seed(seed)


@pytest.mark.parametrize("shape,hw", [((3,), 28), ((2, 2), 16), ((1,), 8),
                                      ((4,), 5)])
def test_resize_bilinear_matches_jax_image_resize(shape, hw):
    coarse = np.random.default_rng(hw).standard_normal(
        (*shape, 4, 4)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(coarse), (*shape, hw, hw),
                                       method="bilinear"))
    got = synth.resize_bilinear(torch.from_numpy(coarse), hw).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def test_roll_rows_matches_jnp_roll_per_sample():
    rng = np.random.default_rng(0)
    img = rng.standard_normal((12, 7, 7)).astype(np.float32)
    sh = rng.integers(-1, 2, (12, 2)).astype(np.int32)
    want = np.asarray(jax.vmap(lambda im, s: jnp.roll(im, s, axis=(0, 1)))(
        jnp.asarray(img), jnp.asarray(sh)))
    got = synth.roll_rows(torch.from_numpy(img), torch.from_numpy(sh))
    np.testing.assert_array_equal(got.numpy(), want)


def jax_compose_images(protos, styles, labels, mix, pixel, sh, noise):
    """`repro.data.synth.make_mnist_like` after its draws, line for line."""
    base = protos[labels]
    styl = jnp.einsum("ns,nsij->nij", mix, styles[labels])
    img = base + styl + noise * pixel
    img = jax.vmap(lambda im, s: jnp.roll(im, s, axis=(0, 1)))(img, sh)
    img = jax.nn.sigmoid(2.0 * img)
    return img.reshape(img.shape[0], -1)


def test_compose_images_matches_jax():
    rng = np.random.default_rng(1)
    m, n, hw = 10, 64, 16
    protos = rng.standard_normal((m, hw, hw)).astype(np.float32)
    styles = rng.standard_normal((m, 2, hw, hw)).astype(np.float32)
    labels = rng.integers(0, m, n).astype(np.int32)
    mix = (0.35 * rng.standard_normal((n, 2))).astype(np.float32)
    pixel = rng.standard_normal((n, hw, hw)).astype(np.float32)
    sh = rng.integers(-1, 2, (n, 2)).astype(np.int32)
    want = np.asarray(jax_compose_images(*map(jnp.asarray, (
        protos, styles, labels, mix, pixel, sh)), 0.45))
    got = synth.compose_images(*map(torch.from_numpy, (
        protos, styles, labels.astype(np.int64), mix, pixel, sh)), 0.45)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)


@pytest.mark.parametrize("m,skew", [(7, 0.8), (3, 0.5), (10, 0.99)])
def test_skew_probs_match_jax(m, skew):
    p0 = skew * (m - 1) / max(1e-6, 1.0 - skew)
    want = jnp.ones(m).at[0].set(p0)
    want = np.asarray(want / jnp.sum(want))
    np.testing.assert_allclose(synth.skew_probs(m, skew).numpy(), want,
                               rtol=0, atol=TOL)


def test_compose_tabular_matches_jax():
    rng = np.random.default_rng(2)
    m, c, f, n = 5, 2, 9, 40
    mus = (2.2 * rng.standard_normal((m, c, f))).astype(np.float32)
    labels = rng.integers(0, m, n)
    clu = rng.integers(0, c, n)
    g = rng.standard_normal(f).astype(np.float32)
    z = rng.standard_normal((n, f)).astype(np.float32)
    scale = jnp.exp(0.3 * jnp.asarray(g))
    want = np.asarray(jnp.asarray(mus)[labels, clu]
                      + 1.0 * scale * jnp.asarray(z))
    got = synth.compose_tabular(*map(torch.from_numpy, (mus, labels, clu, g,
                                                        z)), 1.0)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)


def test_uci_suite_equals_jax():
    assert synth.UCI_SUITE == jsynth.UCI_SUITE


@pytest.mark.parametrize("seed", [4, 11])
def test_lm_tokens_bit_equal_given_jax_seed(seed):
    key = jax.random.PRNGKey(seed)
    want = jsynth.make_lm_tokens(key, 1000, 20_000)
    derived = int(jax.random.randint(key, (), 0, 2 ** 31 - 1))
    got = synth.make_lm_tokens(derived, 1000, 20_000, device=CPU)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_lm_tokens_zipf_and_copy_structure():
    toks = synth.make_lm_tokens(4, 1000, 50_000, device=CPU).numpy()
    assert toks.min() >= 0 and toks.max() < 1000
    counts = np.bincount(toks, minlength=1000)
    top = counts.argsort()[::-1]
    assert counts[top[0]] > 10 * max(1, counts[top[500]])
    # copy structure: 30 % of tokens copy one 1..63 back, so summed over
    # those lags matches exceed a shuffle of the same stream by ~0.3
    def matches(t):
        return sum(np.mean(t[lag:] == t[:-lag]) for lag in range(1, 64))

    shuffled = np.random.default_rng(0).permutation(toks)
    assert matches(toks) > matches(shuffled) + 0.15


def test_mnist_like_shapes_dtypes_and_range():
    ds = synth.make_mnist_like(gen(0), 200, 50, hw=16, device=CPU)
    assert ds.x_train.shape == (200, 256) and ds.x_test.shape == (50, 256)
    assert ds.x_train.dtype == torch.float32
    assert ds.y_train.dtype == torch.int64
    x = ds.x_train.numpy()
    assert (x >= 0).all() and (x <= 1).all()
    assert ds.num_classes == 10 and ds.num_features == 256
    assert set(ds.y_train.tolist()) == set(range(10))
    assert ds.name == "mnist-like"


def test_mnist_like_deterministic_per_seed():
    a = synth.make_mnist_like(gen(7), 64, 16, hw=8, device=CPU)
    b = synth.make_mnist_like(gen(7), 64, 16, hw=8, device=CPU)
    c = synth.make_mnist_like(gen(8), 64, 16, hw=8, device=CPU)
    assert torch.equal(a.x_train, b.x_train)
    assert not torch.equal(a.x_train, c.x_train)


@pytest.mark.parametrize("hw", [16, 28])
def test_mnist_like_is_learnable(hw):
    """The JAX test's nearest-mean classifier clears chance by far."""
    ds = synth.make_mnist_like(gen(1), 1000, 300, hw=hw, device=CPU)
    xtr, ytr = ds.x_train.numpy(), ds.y_train.numpy()
    means = np.stack([xtr[ytr == c].mean(0) for c in range(10)])
    xte = ds.x_test.numpy()
    pred = np.argmin(((xte[:, None] - means[None]) ** 2).sum(-1), axis=1)
    assert (pred == ds.y_test.numpy()).mean() > 0.5


def test_shift_augment():
    ds = synth.make_mnist_like(gen(2), 20, 4, hw=8, device=CPU)
    xa, ya = synth.shift_augment(gen(0), ds.x_train, ds.y_train, hw=8,
                                 copies=9)
    assert xa.shape == (180, 64) and ya.shape == (180,)
    assert torch.equal(xa[80:100], ds.x_train)        # the (0, 0) copy
    want = jsynth.shift_augment(jax.random.PRNGKey(0),
                                jnp.asarray(ds.x_train.numpy()),
                                jnp.asarray(ds.y_train.numpy()), hw=8)
    np.testing.assert_array_equal(xa.numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(ya.numpy(), np.asarray(want[1]))


@pytest.mark.parametrize("name", sorted(synth.UCI_SUITE))
def test_uci_like_signatures(name):
    f, m, n_tr, n_te, skew = synth.UCI_SUITE[name]
    ds = synth.make_uci_like(gen(3), name, device=CPU)
    assert ds.x_train.shape == (n_tr, f) and ds.x_test.shape == (n_te, f)
    assert ds.x_train.dtype == torch.float32
    assert bool(torch.isfinite(ds.x_train).all())
    assert ds.num_classes <= m
    assert int(ds.y_train.min()) >= 0
    if skew > 0:
        assert float((ds.y_train == 0).float().mean()) > 0.5
    else:
        # every class drawn at these sizes (the smallest: 100 rows, M = 3)
        assert ds.num_classes == m


def test_tabular_is_learnable():
    ds = synth.make_tabular(gen(5), 12, 4, 800, 200, device=CPU)
    xtr, ytr = ds.x_train.numpy(), ds.y_train.numpy()
    means = np.stack([xtr[ytr == c].mean(0) for c in range(4)])
    pred = np.argmin(((ds.x_test.numpy()[:, None] - means[None]) ** 2
                      ).sum(-1), axis=1)
    assert (pred == ds.y_test.numpy()).mean() > 0.5
