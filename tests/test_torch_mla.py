"""The port's MoE models against the JAX package, on the CPU: DeepSeek's
multi-head latent attention (`mla_mixer`, the contiguous and paged latent
caches), Mixtral's banded sliding-window attention, `serve()` on both
smoke configs, and the masked-decode and paged steps against the JAX
steps jitted without a mesh.

Inputs are drawn with numpy, parameters by the JAX package's
`init_params` and carried across as numpy
(`repro_torch.convert.lm_params_from_numpy`). Tolerances, with their
reasons:
- attention 2e-5 (a running softmax rounds otherwise than one softmax);
- mixer outputs, logits: atol = rtol = 1e-4 (float32 products summed in
  another order);
- float32 latents 1e-5; bf16 rotary keys one bf16 step (rtol 2^-7);
- greedy tokens are compared where JAX's top-2 logit margin is at least
  1e-3 (PERF.md §2's rule): a smaller margin can flip under the 1e-4
  logit tolerance, and once a token differs the sequences part;
- an MoE decode step over a state both sides share: 1e-4; from each
  side's own prefilled state 1e-3, since a float32 rotary key that
  differs in its last bits can round to the neighbouring bf16 value in
  the cache (as `tests/test_torch_lm.py` finds for GQA). The JAX
  `Engine` does not run here, and a batched MoE `Engine` is not
  token-equal to a batch-1 `serve()` (decode capacity is shared by the
  live rows), so the engine is held to its own contiguous run.
"""
import dataclasses
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as jcfgs  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import kvcache as jkv  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro_torch import convert, kernels  # noqa: E402
from repro_torch.configs import base as cfgs  # noqa: E402
from repro_torch.launch import scheduler, serve, steps  # noqa: E402
from repro_torch.models import kvcache, layers, transformer  # noqa: E402

fa = importlib.import_module("repro_torch.kernels.flash_attention")
ARCHS = ("mixtral_8x7b", "deepseek_v2_lite_16b")
MAX_LEN = 48
LOGIT_TOL = 1e-4
OWN_STATE_TOL = 1e-3
MARGIN = 1e-3
BF16_STEP = 2.0 ** -7


def _np(x):
    return x.detach().float().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _bf16(a):
    """The same bf16 values on both sides, from float32 numpy."""
    return jnp.asarray(a, jnp.bfloat16), _t(a).to(torch.bfloat16)


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    arch = request.param
    jc = jcfgs.get_config(arch, smoke=True)
    cfg = cfgs.get_config(arch, smoke=True)
    jp = jt.init_params(jc, jax.random.PRNGKey(0))
    p = convert.lm_params_from_numpy(cfg, jax.tree.map(np.asarray, jp),
                                     device="cpu")
    return {"arch": arch, "cfg": cfg, "jc": jc, "jp": jp, "p": p}


def _wide_mla(cfg):
    """The smoke config with DeepSeek's full MLA head dims (128 + 64 over
    128): the (192, 128) attention of the full model, at d_model 64."""
    return dataclasses.replace(cfg, qk_nope_dim=128, qk_rope_dim=64,
                               v_head_dim=128)


def _state_from_jax(cfg, jstate):
    """A port ServeState from a JAX one: every cache leaf stacked on a
    layer axis (the JAX package leaves a one-layer segment unstacked),
    bf16 leaves carried through float32."""
    def leaf(x, repeat):
        t = _t(np.asarray(x, np.float32)).to(
            torch.bfloat16 if x.dtype == jnp.bfloat16 else torch.float32)
        return t if repeat > 1 else t[None]

    caches = []
    for seg, jseg in zip(transformer.arch_segments(cfg), jstate.caches):
        out = {}
        for name, c in jseg.items():
            if isinstance(c, (jkv.MLACache, jkv.PagedMLACache)):
                kind = (kvcache.MLACache if isinstance(c, jkv.MLACache)
                        else kvcache.PagedMLACache)
                out[name] = kind(leaf(c.ckv, seg.repeat),
                                 leaf(c.krope, seg.repeat))
            else:
                kind = (kvcache.AttnCache if isinstance(c, jkv.AttnCache)
                        else kvcache.PagedAttnCache)
                out[name] = kind(leaf(c.k, seg.repeat),
                                 leaf(c.v, seg.repeat))
        caches.append(out)
    return transformer.ServeState(caches=caches, cross=[None] * len(caches),
                                  pos=_t(np.asarray(jstate.pos)))


def _assert_caches_close(cfg, pstate, jstate, rows=slice(None)):
    """Latents within 1e-5, bf16 leaves within one bf16 step, on the
    given batch rows of each cache (paged pools: every block)."""
    got = _state_from_jax(cfg, jstate)
    for seg_p, seg_j in zip(pstate.caches, got.caches):
        for name in seg_p:
            for a, b in zip(seg_p[name], seg_j[name]):
                if a is None:
                    continue
                pa, pb = _np(a), _np(b)
                if not isinstance(seg_p[name], (kvcache.PagedAttnCache,
                                                kvcache.PagedMLACache)):
                    pa, pb = pa[:, rows], pb[:, rows]
                if a.dtype == torch.float32:
                    np.testing.assert_allclose(pa, pb, atol=1e-5, rtol=1e-5)
                else:
                    np.testing.assert_allclose(pa, pb, atol=2 ** -6,
                                               rtol=BF16_STEP)


# ---------------------------------------------------------------------------
# The flash kernel's plan at MLA's head dims
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,h,sq", [(4, 16, 1024), (1, 16, 128),
                                    (1, 16, 6), (8, 16, 4096)])
def test_mla_plan_fits_its_budget(b, h, sq):
    """The float32 route at (D_qk, D_v) = (192, 128): 32-key tiles, Q and
    the K and V ring in a block's shared memory, the tiles the C side
    instantiates."""
    p = fa.plan(torch.float32, 192, batch=b, heads=h, sq=sq, dv=128)
    assert (p.route, p.d, p.dv, p.block_k) == ("mma_3xtf32", 192, 128, 32)
    assert fa.f32_tiles(192, 128) == (32, 8, 1)
    assert p.smem_bytes == (p.block_q * 196 + 2 * 32 * (196 + 132)) * 4
    assert p.smem_bytes <= fa.SMEM_PER_BLOCK and p.blocks_per_sm >= 1
    assert p.block_q % 16 == 0 and p.grid == (h, b, -(-sq // p.block_q))
    # the square plans are unchanged by the new argument
    assert fa.plan(torch.float32, 128, batch=b, heads=h, sq=sq) == \
        fa.plan(torch.float32, 128, batch=b, heads=h, sq=sq, dv=128)


@pytest.mark.parametrize("b,h,sq", [(4, 16, 1024), (1, 16, 128),
                                    (1, 16, 6), (8, 16, 4096)])
def test_bf16_mla_plan_fits_its_budget(b, h, sq):
    """The bf16 route at (D_qk, D_v) = (192, 128): 64-key tiles, Q and two
    stages of K (192 wide) and V (128 wide) in a block's shared memory
    (128 KB at 128 query rows), two consumers where the grid fills the
    card, one below it; the tiles the C side instantiates."""
    p = fa.plan(torch.bfloat16, 192, batch=b, heads=h, sq=sq, dv=128)
    assert (p.route, p.d, p.dv, p.block_k) == ("wgmma_bf16", 192, 128, 64)
    assert fa.bf16_tiles(192, 128) == (64, 2)
    assert p.smem_bytes == (1024 + p.block_q * 192 * 2
                            + 2 * 64 * (192 + 128) * 2 + 8 * 5)
    assert p.smem_bytes <= fa.SMEM_PER_BLOCK and p.blocks_per_sm >= 1
    assert p.block_q == (128 if b * h * -(-sq // 128) >= fa.H100_SMS
                         else 64)
    assert p.threads == 128 * (p.block_q // 64 + 1)
    assert p.grid == (h, b, -(-sq // p.block_q))
    # the square bf16 plans are unchanged by the new pair
    assert fa.bf16_tiles(128) == (128, 2) and fa.bf16_tiles(256) == (64, 1)


@pytest.mark.parametrize("dtype,d,dv,ok", [
    (torch.float32, 192, 128, True), (torch.bfloat16, 192, 128, True),
    (torch.float32, 128, 192, False), (torch.float32, 192, 192, False),
    (torch.bfloat16, 128, 192, False), (torch.bfloat16, 192, 64, False),
    (torch.float32, 64, 64, True), (torch.bfloat16, 256, 256, True)])
def test_head_dim_pairs_each_route_takes(dtype, d, dv, ok):
    if ok:
        fa.check_head_dims(dtype, d, dv)
        fa.plan(dtype, d, batch=1, heads=1, sq=8, dv=dv)
    else:
        with pytest.raises(ValueError, match=f"{d}"):
            fa.plan(dtype, d, batch=1, heads=1, sq=8, dv=dv)


def test_plain_attention_takes_a_narrower_value():
    """`ref.attention_ref` (the CPU path of the flash wrapper) with
    D_v < D_qk against JAX's `chunked_attention`."""
    rng = np.random.default_rng(0)
    q, k = (rng.standard_normal((2, 4, 40, 24)).astype(np.float32)
            for _ in range(2))
    v = rng.standard_normal((2, 4, 40, 16)).astype(np.float32)
    want = jlayers.chunked_attention(*map(jnp.asarray, (q, k, v)),
                                     causal=True, chunk=16, scale=0.3)
    got = layers.chunked_attention(_t(q), _t(k), _t(v), causal=True,
                                   scale=0.3)
    assert tuple(got.shape) == (2, 4, 40, 16)
    np.testing.assert_allclose(_np(got), _np(want), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("s,window", [(40, 16), (70, 16), (33, 8)])
def test_banded_attention_matches_jax(s, window):
    """Prompts longer than the window (the smoke window is 16): GQA 4/2."""
    rng = np.random.default_rng(s)
    q = rng.standard_normal((2, 4, s, 16)).astype(np.float32)
    k, v = (rng.standard_normal((2, 2, s, 16)).astype(np.float32)
            for _ in range(2))
    want = jlayers.banded_attention(*map(jnp.asarray, (q, k, v)),
                                    window=window, q_block=16)
    before = kernels.flash_attention.launches
    got = layers.banded_attention(_t(q), _t(k), _t(v), window=window,
                                  q_block=16)
    assert kernels.flash_attention.launches == before    # plain on the CPU
    np.testing.assert_allclose(_np(got), _np(want), atol=2e-5, rtol=2e-5)


# ---------------------------------------------------------------------------
# MLA caches
# ---------------------------------------------------------------------------

def _mla_pair(shape_c, shape_r, seed):
    rng = np.random.default_rng(seed)
    c = rng.standard_normal(shape_c).astype(np.float32)
    r = rng.standard_normal(shape_r).astype(np.float32)
    jr, pr = _bf16(r)
    return (jkv.MLACache(jnp.asarray(c), jr), kvcache.MLACache(_t(c), pr))


def test_mla_cache_layout_and_writes_match_jax():
    c = kvcache.init_mla_cache(3, 10, 32, 8, layers=2, device="cpu")
    assert tuple(c.ckv.shape) == (2, 3, 10, 32) and c.ckv.dtype == \
        torch.float32
    assert tuple(c.krope.shape) == (2, 3, 10, 8)
    assert c.krope.dtype == torch.bfloat16
    j = jkv.init_mla_cache(3, 10, 32, 8)
    assert (j.ckv.dtype, j.krope.dtype) == (jnp.float32, jnp.bfloat16)
    jc, pc = _mla_pair((3, 10, 32), (3, 10, 8), 1)
    rng = np.random.default_rng(2)
    cn = rng.standard_normal((3, 1, 32)).astype(np.float32)
    rn = rng.standard_normal((3, 1, 8)).astype(np.float32)
    slot = np.array([0, 9, 4], np.int32)
    jc = jkv.mla_cache_write_at(jc, jnp.asarray(cn), jnp.asarray(rn),
                                jnp.asarray(slot))
    out = kvcache.mla_cache_write_at(pc, _t(cn), _t(rn), _t(slot))
    assert out is pc                               # in place
    np.testing.assert_array_equal(_np(pc.ckv), _np(jc.ckv))
    np.testing.assert_array_equal(_np(pc.krope), _np(jc.krope))
    # the prefill write: the last T entries at batch-shared slots
    cp = rng.standard_normal((3, 4, 32)).astype(np.float32)
    rp = rng.standard_normal((3, 4, 8)).astype(np.float32)
    slots = np.array([6, 7, 8, 9])
    kvcache.mla_cache_write(pc, _t(cp), _t(rp), _t(slots))
    np.testing.assert_array_equal(_np(pc.ckv)[:, 6:], cp)
    np.testing.assert_array_equal(_np(pc.krope)[:, 6:],
                                  _np(_t(rp).to(torch.bfloat16)))


@pytest.mark.parametrize("seed", [0, 1])
def test_paged_mla_write_and_gather_are_bit_equal_to_jax(seed):
    nb, bs, b, mb = 9, 4, 5, 3
    jc_, pc_ = _mla_pair((nb, bs, 32), (nb, bs, 8), seed)
    jc = jkv.PagedMLACache(jc_.ckv, jc_.krope)
    pc = kvcache.PagedMLACache(pc_.ckv, pc_.krope)
    rng = np.random.default_rng(10 + seed)
    flat = rng.choice(np.arange(bs, nb * bs), size=b, replace=False)
    block, offset = (flat // bs).astype(np.int32), (flat % bs).astype(
        np.int32)
    cn = rng.standard_normal((b, 1, 32)).astype(np.float32)
    rn = rng.standard_normal((b, 1, 8)).astype(np.float32)
    jc = jkv.mla_paged_cache_write_at(jc, jnp.asarray(cn), jnp.asarray(rn),
                                      jnp.asarray(block), jnp.asarray(offset))
    assert kvcache.mla_paged_cache_write_at(
        pc, _t(cn), _t(rn), _t(block), _t(offset)) is pc
    np.testing.assert_array_equal(_np(pc.ckv), _np(jc.ckv))
    np.testing.assert_array_equal(_np(pc.krope), _np(jc.krope))
    table = rng.integers(0, nb, (b, mb)).astype(np.int32)
    jg = jkv.mla_paged_gather(jc, jnp.asarray(table))
    pg = kvcache.mla_paged_gather(pc, _t(table))
    for got, want, width in zip(pg, jg, (32, 8)):
        # float32 and contiguous, as the contiguous decode reads its cache
        assert got.dtype == torch.float32 and got.is_contiguous()
        assert tuple(got.shape) == (b, mb * bs, width) == want.shape
        np.testing.assert_array_equal(_np(got), _np(want))


@pytest.mark.parametrize("stack", [None, 3])
def test_paged_mla_scatter_is_bit_equal_to_jax(stack):
    nb, bs, mb = 10, 4, 4
    lead = () if stack is None else (stack,)
    jc_, pc_ = _mla_pair((*lead, nb, bs, 32), (*lead, nb, bs, 8), 5)
    jc = jkv.PagedMLACache(jc_.ckv, jc_.krope)
    pc = kvcache.PagedMLACache(pc_.ckv, pc_.krope)
    j1, p1 = _mla_pair((*lead, 1, mb * bs, 32), (*lead, 1, mb * bs, 8), 6)
    table_row = np.array([7, 3, 0, 0], np.int32)
    jc = jkv.paged_scatter_mla(jc, j1, jnp.asarray(table_row))
    assert kvcache.paged_scatter_mla(pc, p1, _t(table_row)) is pc
    for got, want in ((pc.ckv, jc.ckv), (pc.krope, jc.krope)):
        # block 0 takes two colliding logical blocks: any winner
        np.testing.assert_array_equal(_np(got)[..., 1:, :, :],
                                      _np(want)[..., 1:, :, :])


# ---------------------------------------------------------------------------
# The MLA mixer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("wide", [False, True], ids=["smoke", "d192_128"])
def test_mla_mixer_prefill_and_decode_match_jax(wide):
    jc = jcfgs.get_config("deepseek_v2_lite_16b", smoke=True)
    cfg = cfgs.get_config("deepseek_v2_lite_16b", smoke=True)
    if wide:
        jc, cfg = _wide_mla(jc), _wide_mla(cfg)
    jp = jt.init_params(jc, jax.random.PRNGKey(2))
    lp = jax.tree.map(np.asarray, jp["segments"][0]["l0"]["mixer"])
    lp["kv_norm"] = np.random.default_rng(3).standard_normal(
        lp["kv_norm"].shape).astype(np.float32) * 0.1
    pp = transformer.ParamTree({k: _t(v) for k, v in lp.items()})
    jlp = {k: jnp.asarray(v) for k, v in lp.items()}
    rng = np.random.default_rng(4)
    b, s, w = 2, 20, 24
    x = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    jy, jcache = jt.mla_mixer(jc, jlp, jnp.asarray(x), jnp.arange(s),
                              mode="prefill", cache_width=w)
    cache = kvcache.init_mla_cache(b, w, cfg.kv_lora_rank, cfg.qk_rope_dim,
                                   device="cpu")
    y = transformer.mla_mixer(cfg, pp, _t(x), torch.arange(s),
                              mode="prefill", cache=cache)
    np.testing.assert_allclose(_np(y), _np(jy), atol=LOGIT_TOL,
                               rtol=LOGIT_TOL)
    np.testing.assert_allclose(_np(cache.ckv), _np(jcache.ckv), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(_np(cache.krope), _np(jcache.krope),
                               atol=2 ** -6, rtol=BF16_STEP)
    # decode from JAX's cache, rows at different depths
    pos = np.array([s, 5], np.int32)
    xd = rng.standard_normal((b, 1, cfg.d_model)).astype(np.float32)
    own = kvcache.MLACache(_t(np.asarray(jcache.ckv)),
                           _t(np.asarray(jcache.krope, np.float32)).to(
                               torch.bfloat16))
    jyd, jcache2 = jt.mla_mixer(jc, jlp, jnp.asarray(xd),
                                jnp.asarray(pos)[:, None], mode="decode",
                                cache=jcache, pos=jnp.asarray(pos))
    yd = transformer.mla_mixer(cfg, pp, _t(xd), _t(pos)[:, None],
                               mode="decode", cache=own, pos=_t(pos))
    np.testing.assert_allclose(_np(yd), _np(jyd), atol=LOGIT_TOL,
                               rtol=LOGIT_TOL)
    np.testing.assert_allclose(_np(own.ckv), _np(jcache2.ckv), atol=1e-5,
                               rtol=1e-5)
    # the same step over a paged pool holding the same rows
    bs, mb = 8, w // 8
    pool = kvcache.init_paged_mla_cache(1 + b * mb, bs, cfg.kv_lora_rank,
                                        cfg.qk_rope_dim, device="cpu")
    table = np.arange(1, 1 + b * mb, dtype=np.int32).reshape(b, mb)
    for i in range(b):
        kvcache.paged_scatter_mla(
            pool, kvcache.MLACache(_t(np.asarray(jcache.ckv))[i:i + 1],
                                   _t(np.asarray(jcache.krope, np.float32)
                                      )[i:i + 1].to(torch.bfloat16)),
            _t(table[i]))
    ypd = transformer.mla_mixer(cfg, pp, _t(xd), _t(pos)[:, None],
                                mode="decode", cache=pool, pos=_t(pos),
                                block_table=_t(table))
    assert torch.equal(ypd, yd)                    # the same view, bit-equal


# ---------------------------------------------------------------------------
# The models: serve(), the masked decode step, the paged steps
# ---------------------------------------------------------------------------

def test_serve_greedy_tokens_match_jax(model):
    """Prompts of 24 tokens: past Mixtral's smoke window of 16, so the
    banded prefill and the ring buffer's wrap both run."""
    cfg, jc, p, jp = model["cfg"], model["jc"], model["p"], model["jp"]
    rng = np.random.default_rng(5)
    prompts = rng.integers(0, cfg.vocab_size, (3, 24), dtype=np.int32)
    gen = 12
    jlog, _ = jax.jit(lambda pp, t: jt.forward_prefill(
        jc, pp, t, max_len=MAX_LEN))(jp, jnp.asarray(prompts))
    plog, _ = transformer.forward_prefill(cfg, p, _t(prompts),
                                          max_len=MAX_LEN)
    np.testing.assert_allclose(_np(plog), _np(jlog), atol=LOGIT_TOL,
                               rtol=LOGIT_TOL)
    want = np.asarray(jserve.serve(jc, jp, jnp.asarray(prompts),
                                   max_len=MAX_LEN, gen=gen))
    got = serve.serve(cfg, p, _t(prompts), max_len=MAX_LEN, gen=gen).numpy()
    assert got.shape == want.shape == (3, gen)
    # JAX's own top-2 margins along its greedy path
    jprefill = jax.jit(lambda pp, t: jt.forward_prefill(
        jc, pp, t, max_len=MAX_LEN))
    jdecode = jax.jit(lambda pp, t, s: jt.forward_decode(jc, pp, t, s))
    lg, state = jprefill(jp, jnp.asarray(prompts))
    margins = []
    for i in range(gen):
        top = np.sort(np.asarray(lg[:, -1]), -1)
        margins.append(top[:, -1] - top[:, -2])
        lg, state = jdecode(jp, jnp.asarray(want[:, i:i + 1]), state)
    margins = np.stack(margins, 1)
    for r in range(3):
        diff = np.nonzero(got[r] != want[r])[0]
        if diff.size:
            t = diff[0]
            assert margins[r, t] < MARGIN, (r, t, margins[r, t])


def test_masked_decode_step_matches_jax_on_the_same_state(model):
    """Four slots, two live: the port's masked decode step against JAX's
    `make_masked_decode_step` (no mesh) from the same prefilled state;
    dead rows claim no MoE capacity on either side."""
    cfg, jc, p, jp = model["cfg"], model["jc"], model["p"], model["jp"]
    rng = np.random.default_rng(6)
    prompts = rng.integers(0, cfg.vocab_size, (4, 20), dtype=np.int32)
    _, jstate = jax.jit(lambda pp, t: jt.forward_prefill(
        jc, pp, t, max_len=MAX_LEN))(jp, jnp.asarray(prompts))
    jstate = jstate._replace(pos=jnp.asarray([20, 9, 20, 3], jnp.int32))
    pstate = _state_from_jax(cfg, jstate)
    active = np.array([True, False, True, False])
    jdec = jax.jit(jsteps.make_masked_decode_step(jc))
    pdec = steps.make_masked_decode_step(cfg)
    tok = rng.integers(0, cfg.vocab_size, (4, 1), dtype=np.int32)
    for _ in range(3):
        jlog, jstate = jdec(jp, jnp.asarray(tok), jstate,
                            jnp.asarray(active))
        plog, pstate = pdec(p, _t(tok), pstate, _t(active))
        np.testing.assert_allclose(_np(plog), _np(jlog), atol=LOGIT_TOL,
                                   rtol=LOGIT_TOL)
        tok = np.asarray(jnp.argmax(jlog[:, -1], -1))[:, None].astype(
            np.int32)
    assert pstate.pos.tolist() == np.asarray(jstate.pos).tolist() == \
        [23, 9, 23, 3]
    _assert_caches_close(cfg, pstate, jstate, rows=[0, 2])


def test_paged_mla_steps_match_the_jax_paged_steps():
    """DeepSeek: a batched prefill of two requests (a dummy row first)
    into slots 2 and 0 of latent pools, then paged decode steps, against
    JAX's paged steps jitted without a mesh. The padded rows claim MoE
    capacity in the prefill on both sides (no mask there)."""
    arch = "deepseek_v2_lite_16b"
    jc = jcfgs.get_config(arch, smoke=True)
    cfg = cfgs.get_config(arch, smoke=True)
    jp = jt.init_params(jc, jax.random.PRNGKey(7))
    p = convert.lm_params_from_numpy(cfg, jax.tree.map(np.asarray, jp),
                                     device="cpu")
    bs, nb, admit = 8, 16, 3
    mb = MAX_LEN // bs
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg.vocab_size, (admit, 12), dtype=np.int32)
    toks[0] = 0
    lengths = np.array([1, 12, 9], np.int32)
    slots = np.array([2, 2, 0], np.int32)
    tables = np.zeros((admit, mb), np.int32)
    tables[1, :2] = (5, 1)
    tables[2, :2] = (2, 9)
    jstate = jsteps.paged_serve_state_zeros(jc, jp, 4, MAX_LEN,
                                            block_size=bs, num_blocks=nb)
    pstate = steps.paged_serve_state_zeros(cfg, p, 4, MAX_LEN,
                                           block_size=bs, num_blocks=nb)
    assert all(isinstance(c, kvcache.PagedMLACache)
               for seg in pstate.caches for c in seg.values())
    jpre = jax.jit(jsteps.make_paged_prefill_step(jc, max_len=MAX_LEN,
                                                  admit=admit))
    jlog, jstate = jpre(jp, {"tokens": jnp.asarray(toks)},
                        jnp.asarray(lengths), jnp.asarray(slots),
                        jnp.asarray(tables), jstate)
    plog, pstate = steps.make_paged_prefill_step(
        cfg, max_len=MAX_LEN, admit=admit)(
        p, {"tokens": _t(toks)}, _t(lengths), _t(slots), _t(tables), pstate)
    np.testing.assert_allclose(_np(plog), _np(jlog), atol=LOGIT_TOL,
                               rtol=LOGIT_TOL)
    block_tables = np.zeros((4, mb), np.int32)
    block_tables[2], block_tables[0] = tables[1], tables[2]
    active = np.array([True, False, True, False])
    jdec = jax.jit(jsteps.make_paged_decode_step(jc))
    pdec = steps.make_paged_decode_step(cfg)
    tok = rng.integers(0, cfg.vocab_size, (4, 1), dtype=np.int32)
    for _ in range(3):
        jlog, jstate = jdec(jp, jnp.asarray(tok), jstate,
                            jnp.asarray(active), jnp.asarray(block_tables))
        plog, pstate = pdec(p, _t(tok), pstate, _t(active),
                            _t(block_tables))
        np.testing.assert_allclose(_np(plog), _np(jlog), atol=OWN_STATE_TOL,
                                   rtol=OWN_STATE_TOL)
        tok = np.asarray(jnp.argmax(jlog[:, -1], -1))[:, None].astype(
            np.int32)
    assert pstate.pos.tolist() == [12, 0, 15, 0]
    live = sorted({5, 1, 2, 9})
    for seg_p, seg_j in zip(pstate.caches, jstate.caches):
        for name in seg_p:
            got = _np(seg_p[name].ckv)
            want = _np(seg_j[name].ckv)
            if got.ndim == want.ndim + 1:
                want = want[None]
            np.testing.assert_allclose(got[:, live], want[:, live],
                                       atol=1e-5, rtol=1e-5)


def test_mixtral_paged_state_keeps_windowed_caches_contiguous():
    """Mixtral's layers are all sliding-window: a paged state has no
    pool, as in the JAX package; the engine still books blocks."""
    cfg = cfgs.get_config("mixtral_8x7b", smoke=True)
    p = transformer.init_params(cfg, torch.Generator().manual_seed(0),
                                device="cpu")
    st = steps.paged_serve_state_zeros(cfg, p, 2, 32, block_size=8,
                                       num_blocks=9)
    c = st.caches[0]["l0"]
    assert isinstance(c, kvcache.AttnCache)
    assert tuple(c.k.shape) == (cfg.num_layers, 2, cfg.num_kv_heads,
                                cfg.sliding_window, cfg.resolved_head_dim)


# ---------------------------------------------------------------------------
# The Engine on both archs
# ---------------------------------------------------------------------------

def _backlog(cfg, n=7, seed=9):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, cfg.vocab_size, int(rng.choice([6, 12, 20]))),
             int(rng.choice([4, 8]))) for _ in range(n)]


def _run(cfg, p, reqs, **kw):
    eng = scheduler.Engine(cfg, p, slots=3, max_len=MAX_LEN, device="cpu",
                           **kw)
    for toks, n in reqs:
        eng.submit(toks, n)
    while eng.busy():
        eng.step()
        if eng.paged:
            eng.allocator.check()
    return [r.tokens for r in eng.drain()], eng


def test_engines_serve_both_archs(model):
    """The contiguous Engine and the paged one with the worst-case pool
    (the same schedule) give the same tokens; a pool too small for every
    slot still drains the backlog, under backpressure."""
    cfg, p = model["cfg"], model["p"]
    reqs = _backlog(cfg)
    want, eng = _run(cfg, p, reqs)
    assert [len(t) for t in want] == [n for _, n in reqs]
    assert eng.trace_counts["decode"] == 1
    got, peng = _run(cfg, p, reqs, paged=True, block_size=8)
    assert got == want
    small, seng = _run(cfg, p, reqs, paged=True, block_size=8, num_blocks=8)
    assert [len(t) for t in small] == [n for _, n in reqs]
    assert seng.stats()["blocks_in_use"] == 0
    assert seng.stats()["peak_blocks"] <= 7
    if model["arch"] == "deepseek_v2_lite_16b":
        # batched prefill: one launch for each group of equal prompts
        batched, beng = _run(cfg, p, reqs, paged=True, block_size=8,
                             prefill_batch=2)
        assert [len(t) for t in batched] == [n for _, n in reqs]
        assert beng.prefill_launches <= len(reqs)
    else:
        with pytest.raises(ValueError, match="sliding-window"):
            scheduler.Engine(cfg, p, bucket="pow2", device="cpu")


def test_serve_stream_takes_the_jax_signature(model, capsys):
    """`serve_stream` with an injected clock, realtime=False, a bucket and
    verbose stats: every arrival at clock 0 is queued at once, and the
    print survives an all-zero clock."""
    cfg, p = model["cfg"], model["p"]
    reqs = scheduler.synth_request_stream(cfg, 5, rate=1e-3, seed=1,
                                          prompt_lens=(6, 12),
                                          gen_lens=(3, 5))
    bucket = None if cfg.sliding_window else "pow2"
    results, eng = serve.serve_stream(
        cfg, p, reqs, slots=2, max_len=MAX_LEN, realtime=False,
        verbose=True, bucket=bucket, clock=lambda: 0.0, device="cpu")
    out = capsys.readouterr().out
    assert "5 requests" in out and "latency mean/p50/p99/max" in out
    assert [len(r.tokens) for r in results] == [r.max_new for r in reqs]
    assert eng.bucket == bucket and eng.clock() == 0.0
    st_ = eng.stats()
    assert st_["latency_max_s"] == 0.0 and st_["tok_per_s"] == float("inf")
    # sampling: the engine's seed comes from the generator
    _, eng2 = serve.serve_stream(
        cfg, p, reqs, slots=2, max_len=MAX_LEN, realtime=False,
        verbose=False, greedy=False, temperature=0.7,
        rng=torch.Generator().manual_seed(3), device="cpu")
    assert not eng2.greedy and eng2.temperature == 0.7
    assert capsys.readouterr().out == ""


def test_serve_main_takes_the_moe_archs(capsys):
    for arch in ARCHS:
        assert serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                           "--batch", "2", "--prompt-len", "24",
                           "--gen", "4"]) == 0
    assert "generated (2, 4)" in capsys.readouterr().out
