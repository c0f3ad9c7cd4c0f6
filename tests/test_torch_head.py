"""The port's UleenHead against the JAX package's, on the CPU.

The head crosses through `convert.head_state_from_numpy`; inputs are drawn
with numpy and given to both packages. Tolerances: thresholds 1e-7;
encoded bits, hashes and int32 deployed scores exact; continuous scores,
the loss and its gradient on the tables 1e-5 (float32 sums ordered
otherwise), with JAX's own dropout masks passed through `keep=`.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import head as jhead  # noqa: E402
from repro.core import model as jmodel  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import head, model  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.train import optimizer  # noqa: E402

CPU = "cpu"
TOL = 1e-5
BACKENDS = ("fused", "gather", "packed", "auto")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def configs(backbone_grad=False):
    jcfg = jhead.UleenHeadConfig(
        num_classes=4, hidden_dim=32, bits_per_feature=4,
        submodels=(jmodel.SubmodelSpec(8, 6), jmodel.SubmodelSpec(16, 6)),
        backbone_grad=backbone_grad)
    cfg = head.UleenHeadConfig(
        num_classes=4, hidden_dim=32, bits_per_feature=4,
        submodels=(model.SubmodelSpec(8, 6), model.SubmodelSpec(16, 6)),
        backbone_grad=backbone_grad)
    return jcfg, cfg


def states(jcfg, seed=0):
    """JAX's `init_head` state with numpy-drawn tables (about half
    positive) and masks (about a fifth pruned), and the port's copy."""
    rng = np.random.default_rng(seed)
    js = jhead.init_head(jax.random.PRNGKey(seed), jcfg)
    tables = tuple(jnp.asarray(rng.uniform(-1, 1, t.shape).astype(np.float32))
                   for t in js.params.tables)
    masks = tuple(jnp.asarray((rng.random(m.shape) < 0.8).astype(np.float32))
                  for m in js.params.masks)
    js = js._replace(params=js.params._replace(tables=tables, masks=masks))
    return js, convert.head_state_from_numpy(js, device=CPU)


def hidden(seed, rows=6, dim=32, thresholds=None):
    """(rows, dim) float32 pooled states whose normalised features all lie
    at least 1e-5 from every threshold (asserted), so the two packages'
    float rounding cannot flip a bit."""
    h = np.random.default_rng(seed).standard_normal((rows, dim)).astype(
        np.float32) * 3 + 1
    if thresholds is not None:
        z = (h - h.mean(-1, keepdims=True)) / (h.std(-1, keepdims=True)
                                               + 1e-6)
        assert np.abs(z[..., None] - thresholds).min() >= 1e-5
    return h


def jax_thresholds(t):
    """`repro.core.head.init_head`'s thresholds for T bits."""
    return np.asarray(jhead.ndtri(jnp.arange(1, t + 1, dtype=jnp.float32)
                                  / (t + 1)))


def test_init_head_thresholds_equal_jax():
    jcfg, cfg = configs()
    want = np.asarray(jhead.init_head(jax.random.PRNGKey(0), jcfg).thresholds)
    got = head.init_head(torch.Generator(), cfg, device=CPU).thresholds
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-7)


@pytest.mark.parametrize("t", [1, 2, 3, 4, 5, 6, 8])
def test_thresholds_within_1e7_of_jax(t):
    got = head.gaussian_thresholds(t, device=CPU)
    np.testing.assert_allclose(got.numpy(), jax_thresholds(t), rtol=0,
                               atol=1e-7)


@pytest.mark.parametrize("t", range(1, 17))
def test_thresholds_within_two_ulps_of_jax_at_every_width(t):
    """torch's and XLA's float32 ndtri are different approximations: at
    T = 7, 9, 10, 13 and 15 some quantile past |z| = 1 rounds one or two
    float32 ulps apart (at most 2.4e-7), at the other widths they agree."""
    got = head.gaussian_thresholds(t, device=CPU).numpy()
    np.testing.assert_array_max_ulp(got, jax_thresholds(t), maxulp=2)


def test_init_head_shapes_and_devices():
    _, cfg = configs()
    st = head.init_head(torch.Generator().manual_seed(0), cfg, device=CPU)
    assert [t.shape for t in st.params.tables] == [(4, 16, 64), (4, 8, 64)]
    assert [s.perm.shape for s in st.statics] == [(16, 8), (8, 16)]
    assert st.thresholds.shape == (4,)


def test_encode_hidden_bits_equal_jax():
    jcfg, cfg = configs()
    js, st = states(jcfg)
    h = hidden(1, thresholds=np.asarray(js.thresholds))
    want = np.asarray(jhead.encode_hidden(jcfg, js, jnp.asarray(h)))
    got = head.encode_hidden(cfg, st, torch.from_numpy(h))
    assert got.dtype == torch.bool and got.shape == (6, 128)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", [0, 3])
def test_continuous_scores_match_jax(seed):
    jcfg, cfg = configs()
    js, st = states(jcfg, seed)
    h = hidden(seed + 10, thresholds=np.asarray(js.thresholds))
    want = np.asarray(jhead.apply_head(jcfg, js, jnp.asarray(h)))
    got = head.apply_head(cfg, st, torch.from_numpy(h), device=CPU)
    assert got.shape == (6, 4) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)


def jax_keep_masks(jcfg, rng, rows):
    """The keep-masks JAX's train forward draws from `rng`
    (`model.forward`: one split per submodel)."""
    spec = jcfg.spec()
    out = []
    for sm in spec.submodels:
        rng, sub = jax.random.split(rng)
        shape = (rows, spec.num_classes, spec.num_filters(sm))
        out.append(torch.from_numpy(np.array(
            jax.random.bernoulli(sub, 1.0 - spec.dropout, shape))))
    return out


@pytest.mark.parametrize("train", [False, True], ids=["eval", "dropout"])
def test_head_loss_and_table_gradients_match_jax(train):
    jcfg, cfg = configs()
    js, st = states(jcfg, 5)
    h = hidden(6, rows=12, thresholds=np.asarray(js.thresholds))
    y = np.arange(12) % 4
    rng = jax.random.PRNGKey(9) if train else None

    def jloss(params):
        return jhead.head_loss(jcfg, js._replace(params=params),
                               jnp.asarray(h), jnp.asarray(y), rng=rng)

    want_loss, want_grads = jax.value_and_grad(jloss)(js.params)
    tables = [t.clone().requires_grad_(True) for t in st.params.tables]
    bias = st.params.bias.clone().requires_grad_(True)
    params = st.params._replace(tables=tuple(tables), bias=bias)
    keep = jax_keep_masks(jcfg, rng, 12) if train else None
    loss = head.head_loss(cfg, st._replace(params=params),
                          torch.from_numpy(h), torch.from_numpy(y),
                          keep=keep, device=CPU)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=0,
                               atol=TOL)
    for got, want in zip(tables, want_grads.tables):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(want),
                                   rtol=0, atol=TOL)
    np.testing.assert_allclose(bias.grad.numpy(), np.asarray(want_grads.bias),
                               rtol=0, atol=TOL)


@pytest.mark.parametrize("backbone_grad", [False, True])
def test_no_gradient_reaches_the_backbone_through_the_loss(backbone_grad):
    """The hashes read the bits' signs, so in both packages no gradient
    reaches h through the loss, with or without backbone_grad."""
    jcfg, cfg = configs(backbone_grad)
    js, st = states(jcfg, 2)
    h = hidden(4, thresholds=np.asarray(js.thresholds))
    y = np.arange(6) % 4
    want = jax.grad(lambda hh: jhead.head_loss(jcfg, js, hh,
                                               jnp.asarray(y)))(
        jnp.asarray(h))
    assert float(jnp.max(jnp.abs(want))) == 0.0
    ht = torch.from_numpy(h).requires_grad_(True)
    tables = [t.clone().requires_grad_(True) for t in st.params.tables]
    st = st._replace(params=st.params._replace(tables=tuple(tables)))
    head.head_loss(cfg, st, ht, torch.from_numpy(y), device=CPU).backward()
    assert ht.grad is None or float(ht.grad.abs().max()) == 0.0
    assert all(t.grad is not None for t in tables)


def test_backbone_grad_encode_passes_the_ste_gradient():
    """With backbone_grad the thermometer is STE: encode_hidden's gradient
    into h equals JAX's (and is not zero)."""
    jcfg, cfg = configs(backbone_grad=True)
    js, st = states(jcfg, 3)
    h = hidden(8, thresholds=np.asarray(js.thresholds))
    w = np.random.default_rng(1).standard_normal((6, 128)).astype(np.float32)
    want = jax.grad(lambda hh: jnp.sum(
        jhead.encode_hidden(jcfg, js, hh) * w))(jnp.asarray(h))
    ht = torch.from_numpy(h).requires_grad_(True)
    bits = head.encode_hidden(cfg, st, ht)
    assert bits.dtype == torch.float32
    np.testing.assert_array_equal(bits.detach().numpy() > 0, np.asarray(
        jhead.encode_hidden(jcfg, js, jnp.asarray(h))) > 0)
    torch.sum(bits * torch.from_numpy(w)).backward()
    assert float(ht.grad.abs().max()) > 0
    np.testing.assert_allclose(ht.grad.numpy(), np.asarray(want), rtol=0,
                               atol=TOL)


@pytest.mark.parametrize("seed", [0, 7])
def test_deployed_scores_equal_across_backends_and_jax(seed):
    jcfg, cfg = configs()
    js, st = states(jcfg, seed)
    h = hidden(seed + 20, rows=9, thresholds=np.asarray(js.thresholds))
    want = np.asarray(jhead.apply_head(jcfg, js, jnp.asarray(h),
                                       backend="gather"))
    for be in BACKENDS:
        got = head.apply_head(cfg, st, torch.from_numpy(h), backend=be,
                              device=CPU)
        assert got.dtype == torch.int32, be
        np.testing.assert_array_equal(got.numpy(), want, err_msg=be)
    # integral bias: the continuous eval forward is the deployed score
    cont = head.apply_head(cfg, st, torch.from_numpy(h), device=CPU)
    np.testing.assert_array_equal(cont.numpy(), want.astype(np.float32))
    with pytest.raises(ValueError, match="backend"):
        head.apply_head(cfg, st, torch.from_numpy(h), train=True,
                        backend="packed", device=CPU)


def test_head_trains_on_separable_features():
    """Pooled states with class structure: the head learns them (the JAX
    package's slow test, at its size)."""
    _, cfg = configs()
    g = torch.Generator().manual_seed(2)
    protos = torch.randn((4, 32), generator=g) * 2.0
    y = torch.randint(0, 4, (256,), generator=g)
    h = protos[y] + 0.5 * torch.randn((256, 32), generator=g)
    st = head.init_head(g, cfg, device=CPU)
    params = st.params._replace(tables=tuple(t * 0.1
                                             for t in st.params.tables))
    opt = optimizer.adam(1e-2)
    ost = opt.init([*params.tables, params.bias])
    losses = []
    for _ in range(60):
        leaves = [t.detach().requires_grad_(True)
                  for t in (*params.tables, params.bias)]
        params = params._replace(tables=tuple(leaves[:-1]), bias=leaves[-1])
        loss = head.head_loss(cfg, st._replace(params=params), h, y,
                              generator=g, device=CPU)
        grads = torch.autograd.grad(loss, leaves)
        upd, ost = opt.update(grads, ost)
        new = optimizer.apply_updates([x.detach() for x in leaves], upd)
        params = params._replace(tables=tuple(new[:-1]), bias=new[-1])
        losses.append(float(loss))
    scores = head.apply_head(cfg, st._replace(params=params), h, device=CPU)
    acc = float((torch.argmax(scores, -1) == y).float().mean())
    assert losses[-1] < losses[0]
    assert acc > 0.5, acc


@pytest.mark.parametrize("use_kernel", [False, True])
def test_wnn_infer_equals_jax(use_kernel):
    rng = np.random.default_rng(use_kernel)
    b, n_f, n, m, e, k = 13, 21, 9, 5, 32, 2
    tuples = rng.integers(0, 2, (b, n_f, n)).astype(np.int8)
    params = rng.integers(0, e, (k, n)).astype(np.int32)
    table = (rng.random((m, n_f, e)) < 0.4).astype(np.int8)
    mask = rng.integers(0, 2, (m, n_f)).astype(np.int8)
    bias = rng.integers(-3, 4, m).astype(np.int32)
    want = np.asarray(jops.wnn_infer(*map(jnp.asarray, (
        tuples, params, table, mask, bias)), use_kernel=use_kernel))
    got = ops.wnn_infer(*map(torch.from_numpy, (tuples, params, table, mask,
                                                bias)),
                        use_kernel=use_kernel, device=CPU)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
