"""The port's MoE block (`repro_torch.models.moe`) against the JAX package's
(`repro.models.moe`), on the CPU.

The same numpy-drawn activations and the JAX package's own initial
parameters (carried across as numpy) go through both sides, for the
Mixtral and DeepSeek smoke configs, both dispatches, with and without a
token mask, and at a capacity small enough to drop entries.

Tolerances, with their reasons:
- routing (expert ids, queue positions, keep) is compared exactly, except
  where a token's k-th and (k+1)-th router probabilities lie within 1e-6:
  router logits differ in the last ulp between XLA and PyTorch, and
  `torch.topk` and `jax.lax.top_k` may order such near-ties differently,
  so either choice is accepted there. A flipped choice moves the queue
  positions of every later entry of its group, so positions are compared
  up to a group's first near-tie token;
- outputs atol = rtol = 1e-4 (float32 products summed in another order);
  groups with a near-tie are excluded from the output comparison, since a
  flipped expert changes a row by far more than that;
- the aux loss 1e-5; the two dispatches of the port against each other
  1e-5.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as jcfgs  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro_torch.configs import base as cfgs  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.transformer import ParamTree  # noqa: E402

TIE_GAP = 1e-6
OUT_TOL = 1e-4
ARCHS = ("mixtral_8x7b", "deepseek_v2_lite_16b")


def _np(x):
    return x.detach().float().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


@pytest.fixture(scope="module", params=ARCHS)
def ffn(request):
    """(port cfg, JAX cfg, port ffn params, JAX ffn params) of the first
    MoE layer of the arch's smoke model, drawn by the JAX package."""
    arch = request.param
    jc = jcfgs.get_config(arch, smoke=True)
    cfg = cfgs.get_config(arch, smoke=True)
    jp = jt.init_params(jc, jax.random.PRNGKey(1))
    seg = jp["segments"][-1]["l0"]["ffn"]
    tree = {k: np.asarray(v)[0] for k, v in seg.items()}
    return (cfg, jc, ParamTree({k: torch.from_numpy(v.copy())
                                for k, v in tree.items()}),
            {k: jnp.asarray(v) for k, v in tree.items()})


def _inputs(cfg, seed, b=4, s=256, live=0.7):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    mask = rng.random((b, s)) < live
    return x, mask


def _near_ties(cfg, p, xg):
    """(G, T) bool: tokens whose k-th and (k+1)-th probabilities lie
    within TIE_GAP (float64 router, from the same float32 weights)."""
    logits = xg.astype(np.float64) @ np.asarray(p["router"], np.float64)
    e = np.exp(logits - logits.max(-1, keepdims=True))
    probs = np.sort(e / e.sum(-1, keepdims=True), -1)[..., ::-1]
    k = cfg.top_k
    if k >= probs.shape[-1]:
        return np.zeros(probs.shape[:2], bool)
    return probs[..., k - 1] - probs[..., k] < TIE_GAP


def _configs(cfg, jc, dispatch, capacity):
    kw = {"moe_dispatch": dispatch}
    if capacity is not None:
        kw["capacity_factor"] = capacity
    return dataclasses.replace(cfg, **kw), dataclasses.replace(jc, **kw)


@pytest.mark.parametrize("capacity", [None, 0.25])
@pytest.mark.parametrize("masked", [False, True])
def test_route_matches_jax_outside_near_ties(ffn, masked, capacity):
    cfg, jc, p, jp = ffn
    cfg, jc = _configs(cfg, jc, "sorted", capacity)
    x, mask = _inputs(cfg, 11)
    xg = x.reshape(2, 512, cfg.d_model)
    mg = mask.reshape(2, 512) if masked else None
    got = moe._route(cfg, p, torch.from_numpy(xg),
                     None if mg is None else torch.from_numpy(mg))
    want = jmoe._route(jc, jp, jnp.asarray(xg),
                       None if mg is None else jnp.asarray(mg))
    gv, gi, pos, keep, cap, aux, oh = got
    jgv, jgi, jpos, jkeep, jcap, jaux, joh = want
    assert cap == jcap
    ties = _near_ties(cfg, jp, xg)
    ok = ~ties
    np.testing.assert_array_equal(gi.numpy()[ok], np.asarray(jgi)[ok])
    np.testing.assert_allclose(_np(gv)[ok], _np(jgv)[ok], atol=1e-6,
                               rtol=1e-6)
    for g in range(xg.shape[0]):
        # positions depend on every earlier (token, choice) entry of the
        # group: compare up to the group's first near-tie
        first = int(np.argmax(ties[g])) if ties[g].any() else xg.shape[1]
        np.testing.assert_array_equal(pos.numpy()[g, :first],
                                      np.asarray(jpos)[g, :first])
        np.testing.assert_array_equal(keep.numpy()[g, :first],
                                      np.asarray(jkeep)[g, :first])
    if masked:
        # masked tokens claim no slot
        assert not keep.numpy()[~mg].any()
        assert float(oh.sum()) == pytest.approx(mg.sum() * cfg.top_k)
    if capacity is not None:
        assert not keep.numpy().all()          # entries were dropped
    assert float(aux) == pytest.approx(float(jaux), abs=1e-5, rel=1e-5)


@pytest.mark.parametrize("capacity", [None, 0.25])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("dispatch", ["sorted", "einsum"])
def test_moe_block_matches_jax(ffn, dispatch, masked, capacity):
    cfg, jc, p, jp = ffn
    cfg, jc = _configs(cfg, jc, dispatch, capacity)
    x, mask = _inputs(cfg, 12)
    m = mask if masked else None
    y, aux = moe.moe_block(cfg, p, torch.from_numpy(x),
                           None if m is None else torch.from_numpy(m))
    jy, jaux = jmoe.moe_block(jc, jp, jnp.asarray(x),
                              None if m is None else jnp.asarray(m))
    assert y.shape == x.shape and y.dtype == torch.float32
    # groups of 512 tokens: (4, 256) -> two groups of two rows each
    ties = _near_ties(cfg, jp, x.reshape(2, 512, cfg.d_model))
    clean = ~ties.any(axis=1).repeat(2)                     # per batch row
    assert clean.any()
    np.testing.assert_allclose(_np(y)[clean], _np(jy)[clean], atol=OUT_TOL,
                               rtol=OUT_TOL)
    assert float(aux) == pytest.approx(float(jaux), abs=1e-5, rel=1e-5)
    if masked and not cfg.num_shared_experts:
        # a masked token combines to zero (no shared expert adds to it)
        assert float(y[torch.from_numpy(~mask)].abs().max()) == 0.0


@pytest.mark.parametrize("capacity", [None, 0.25])
@pytest.mark.parametrize("masked", [False, True])
def test_sorted_and_einsum_dispatches_agree(ffn, masked, capacity):
    """The two dispatches of the port agree, as `tests/test_moe.py` holds
    the JAX package's."""
    cfg, jc, p, _ = ffn
    x, mask = _inputs(cfg, 13)
    m = torch.from_numpy(mask) if masked else None
    outs = []
    for dispatch in ("sorted", "einsum"):
        c, _ = _configs(cfg, jc, dispatch, capacity)
        outs.append(moe.moe_block(c, p, torch.from_numpy(x), m))
    torch.testing.assert_close(outs[0][0], outs[1][0], atol=1e-5, rtol=1e-5)
    assert float(outs[0][1]) == float(outs[1][1])


def test_masked_tokens_never_move_live_rows(ffn):
    """With the mask, live rows are a function of live rows only: dead
    rows' activations change, live outputs stay bit-equal. Without it,
    capacity is shared and they may move (they do here)."""
    cfg, jc, p, _ = ffn
    cfg, _ = _configs(cfg, jc, "sorted", 0.25)
    x, mask = _inputs(cfg, 14)
    x2 = x.copy()
    x2[~mask] = np.random.default_rng(15).standard_normal(
        x2[~mask].shape).astype(np.float32)
    m = torch.from_numpy(mask)
    a, _ = moe.moe_block(cfg, p, torch.from_numpy(x), m)
    b, _ = moe.moe_block(cfg, p, torch.from_numpy(x2), m)
    assert torch.equal(a[m], b[m])
    a0, _ = moe.moe_block(cfg, p, torch.from_numpy(x))
    b0, _ = moe.moe_block(cfg, p, torch.from_numpy(x2))
    assert not torch.equal(a0[m], b0[m])


def test_decode_shapes_route_one_group_with_jax_capacity(ffn):
    """A decode step is one group of B tokens: at full width Mixtral's 4
    slots and DeepSeek's 8 both get cap = max(1, int(1.25 k B / E)) = 1
    (the JAX formula, not an idealised one), so batched decode drops
    choices that a batch-1 `serve()` keeps."""
    cfg, jc, p, jp = ffn
    for slots in (4, 8):
        x, mask = _inputs(cfg, 16, b=slots, s=1)
        got = moe._route(cfg, p, torch.from_numpy(x.reshape(1, slots, -1)))
        want = jmoe._route(jc, jp, jnp.asarray(x.reshape(1, slots, -1)))
        assert got[4] == want[4] == max(1, int(
            cfg.capacity_factor * cfg.top_k * slots / cfg.num_experts))
    full = {a: cfgs.get_config(a) for a in ARCHS}
    cap = {a: max(1, int(c.capacity_factor * c.top_k * s / c.num_experts))
           for (a, c), s in zip(full.items(), (4, 8))}
    assert cap == {"mixtral_8x7b": 1, "deepseek_v2_lite_16b": 1}


def test_tokens_that_do_not_split_into_groups_raise_as_in_jax(ffn):
    cfg, jc, p, jp = ffn
    x = np.zeros((1, 1537, cfg.d_model), np.float32)   # 3 groups of 512.33
    with pytest.raises(ValueError, match="groups"):
        moe.moe_block(cfg, p, torch.from_numpy(x))
    with pytest.raises(TypeError):
        jmoe.moe_block(jc, jp, jnp.asarray(x))


def test_shared_experts_add_to_the_routed_output():
    """DeepSeek's shared experts contribute even with the routed experts
    silenced (a zero router sends every token to the first top-k ids,
    whose capacity then drops most of them)."""
    cfg = cfgs.get_config("deepseek_v2_lite_16b", smoke=True)
    gen = torch.Generator().manual_seed(0)
    from repro_torch.models import transformer
    p = transformer.init_params(cfg, gen, device="cpu").segments[1].l0[0].ffn
    x = torch.randn((2, 16, cfg.d_model), generator=gen)
    y, _ = moe.moe_block(cfg, p, x)
    assert torch.isfinite(y).all() and y.shape == x.shape
    p.router.data.zero_()
    y0, aux0 = moe.moe_block(cfg, p, x)
    assert float(y0.abs().max()) > 0
    assert float(aux0) == pytest.approx(cfg.top_k, abs=1e-5)
