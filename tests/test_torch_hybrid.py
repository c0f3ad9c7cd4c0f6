"""The port's RecurrentGemma (`repro_torch.models.rglru`, and the hybrid
family of `models/transformer.py`: two RG-LRU layers to one local MQA
layer) against the JAX package, on the CPU; and the Engine's bucket rule
for both families of this slice.

Inputs are drawn with numpy from a seed and given to both sides;
parameters are the JAX package's `init_params`, carried across as numpy.
The smoke config's local window is 16, so prompts of 20-40 tokens make
the local layers' prefill skip keys and their ring of 16 keys wrap.
Tolerances, with their reasons:
- the RG-LRU scan against `jax.lax.associative_scan`, its step and the
  recurrent block: 1e-5 (float32 products grouped in another tree);
- the log-depth scan against a float64 loop: 1e-5;
- logits: atol = rtol = 1e-4 (the ROADMAP oracle), tokens under the
  margin rule of `tests/test_torch_ssm.py`.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as jcfgs  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import rglru as jrg  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro_torch import convert, kernels  # noqa: E402
from repro_torch.configs import base as cfgs  # noqa: E402
from repro_torch.launch import scheduler, serve, steps  # noqa: E402
from repro_torch.models import kvcache, rglru, transformer  # noqa: E402
from test_torch_ssm import (  # noqa: E402
    LOGIT_TOL, MAX_LEN, _close, _jax_greedy, _np, _state_from_jax, _t,
    assert_tokens_match)

ARCH = "recurrentgemma_2b"


@pytest.fixture(scope="module")
def model():
    jc = jcfgs.get_config(ARCH, smoke=True)
    cfg = cfgs.get_config(ARCH, smoke=True)
    jp = jt.init_params(jc, jax.random.PRNGKey(0))
    p = convert.lm_params_from_numpy(cfg, jax.tree.map(np.asarray, jp),
                                     device="cpu")
    return cfg, jc, jp, p


def _rec(model, seed=1):
    """Layer 0 of the second repeat (a `rec` layer) on both sides, with its
    gate weights, biases and Lambda drawn (they are ones or zeros at
    init)."""
    cfg, _, jp, _ = model
    rng = np.random.default_rng(seed)
    lp = {k: np.asarray(v)[1].copy()
          for k, v in jp["segments"][0]["l0"]["mixer"].items()}
    for k in ("w_a", "b_a", "w_x", "b_x", "lam", "conv_b"):
        lp[k] = (rng.standard_normal(lp[k].shape) * 0.5
                 + (1.0 if k in ("w_a", "w_x") else 0.0)).astype(np.float32)
    return (transformer.ParamTree({k: _t(v) for k, v in lp.items()}),
            {k: jnp.asarray(v) for k, v in lp.items()})


# ---------------------------------------------------------------------------
# The RG-LRU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("h0", [False, True])
@pytest.mark.parametrize("s", [1, 7, 64, 300])
def test_rglru_matches_jax_associative_scan(model, s, h0):
    pp, jlp = _rec(model)
    rng = np.random.default_rng(s)
    x = rng.standard_normal((2, s, 64)).astype(np.float32)
    h = rng.standard_normal((2, 64)).astype(np.float32) if h0 else None
    y, last = rglru.rglru(pp, _t(x), None if h is None else _t(h))
    jy, jlast = jrg.rglru(jlp, jnp.asarray(x),
                          None if h is None else jnp.asarray(h))
    assert last.dtype == torch.float32 and tuple(last.shape) == (2, 64)
    _close(y, jy)
    _close(last, jlast)


def test_linear_scan_matches_a_sequential_loop_without_overflow():
    """The log-depth scan against a float64 loop over 4096 tokens whose
    gates decay hard (a = e^-8 at times): Σ log a reaches -10^4, far past
    float32's exp range, and nothing overflows."""
    rng = np.random.default_rng(0)
    s = 4096
    a = np.exp(-8.0 * rng.random((2, s, 8))).astype(np.float32)
    b = rng.standard_normal((2, s, 8)).astype(np.float32)
    got = rglru.linear_scan(_t(a), _t(b))
    want = np.zeros((2, s, 8))
    h = np.zeros((2, 8))
    for t in range(s):
        h = a[:, t].astype(np.float64) * h + b[:, t]
        want[:, t] = h
    assert np.log(a.astype(np.float64)).sum(1).min() < -1e4
    assert bool(torch.isfinite(got).all())
    np.testing.assert_allclose(_np(got), want, atol=1e-5, rtol=1e-5)


def test_rglru_step_matches_jax(model):
    pp, jlp = _rec(model)
    rng = np.random.default_rng(3)
    x, h = (rng.standard_normal((3, 64)).astype(np.float32)
            for _ in range(2))
    y, hn = rglru.rglru_step(pp, _t(x), _t(h))
    jy, jhn = jrg.rglru_step(jlp, jnp.asarray(x), jnp.asarray(h))
    _close(y, jy)
    _close(hn, jhn)


@pytest.mark.parametrize("s", [2, 20], ids=["below_conv", "ragged"])
def test_recurrent_block_matches_jax(model, s):
    """Prefill with its decode state; S = 2 is shorter than K - 1 = 3."""
    cfg, jc, _, _ = model
    pp, jlp = _rec(model)
    x = np.random.default_rng(s).standard_normal(
        (2, s, cfg.d_model)).astype(np.float32)
    out, st = rglru.recurrent_block(cfg, pp, _t(x), return_state=True)
    jout, jst = jrg.recurrent_block(jc, jlp, jnp.asarray(x),
                                    return_state=True)
    _close(out, jout)
    assert tuple(st.conv.shape) == jst.conv.shape == (2, 64, 3)
    _close(st.conv, jst.conv)
    _close(st.h, jst.h)
    if s < 3:
        assert float(st.conv[..., :3 - s].abs().max()) == 0.0
    assert torch.equal(rglru.recurrent_block(cfg, pp, _t(x)), out)


def test_recurrent_block_decode_matches_jax_and_continues_the_prefill(model):
    cfg, jc, _, _ = model
    pp, jlp = _rec(model)
    x = np.random.default_rng(8).standard_normal(
        (2, 24, cfg.d_model)).astype(np.float32)
    _, jst = jrg.recurrent_block(jc, jlp, jnp.asarray(x[:, :20]),
                                 return_state=True)
    st = rglru.RGState(_t(np.asarray(jst.conv)), _t(np.asarray(jst.h)))
    full = rglru.recurrent_block(cfg, pp, _t(x))
    for i in range(20, 24):
        y, st = rglru.recurrent_block_decode(cfg, pp, _t(x[:, i:i + 1]), st)
        jy, jst = jrg.recurrent_block_decode(jc, jlp,
                                             jnp.asarray(x[:, i:i + 1]), jst)
        _close(y, jy)
        _close(st.conv, jst.conv)
        _close(st.h, jst.h)
        _close(y[:, 0], full[:, i])


def test_init_rg_state_layout():
    cfg = cfgs.get_config(ARCH, smoke=True)
    st = rglru.init_rg_state(cfg, 3, layers=2, device="cpu")
    assert tuple(st.conv.shape) == (2, 3, cfg.lru_width, cfg.conv_kernel - 1)
    assert tuple(st.h.shape) == (2, 3, cfg.lru_width)
    assert st.h.dtype == torch.float32
    st.layer(1).h[2, 5] = 1.0
    assert float(st.h[1, 2, 5]) == 1.0
    j = jrg.init_rg_state(jcfgs.get_config(ARCH, smoke=True), 3)
    assert (j.conv.shape, j.h.shape) == (st.conv.shape[1:], st.h.shape[1:])


# ---------------------------------------------------------------------------
# The local layers' window
# ---------------------------------------------------------------------------

def test_local_layers_attend_over_the_local_window(model):
    """A `local` layer of a block-pattern model attends over
    `cfg.local_window` keys (16 here) and keeps a ring of min(max_len,
    local_window), as the JAX package's: the config's `sliding_window` is
    0, and reading it would attend over the whole prompt and keep a
    full-width cache."""
    cfg, jc, jp, p = model
    assert cfg.sliding_window == 0 and cfg.local_window == 16
    spec = transformer.arch_segments(cfg)[0].layers[2]
    assert spec.mixer == "local"
    for max_len, ring in ((MAX_LEN, 16), (12, 12)):
        c = transformer.init_cache(cfg, 2, max_len, device="cpu")[0]["l2"]
        assert isinstance(c, kvcache.AttnCache)
        assert tuple(c.k.shape) == (2, 2, 1, ring, cfg.resolved_head_dim)
        assert transformer._cache_width(cfg, spec, max_len) == \
            jt._cache_width(jc, spec, max_len) == ring
    # layer 2 alone at S = 40: JAX's local layer, and not the full causal
    # attention the sliding_window wiring gave
    s = 40
    x = np.random.default_rng(4).standard_normal(
        (2, s, cfg.d_model)).astype(np.float32)
    lp = p.segments[0].l2[0]
    jlp = jax.tree.map(lambda a: a[0], jp["segments"][0]["l2"])
    pos = np.arange(s)
    jy, jcache, _, _ = jt._apply_layer(
        jc, spec, jlp, jnp.asarray(x), jnp.asarray(pos), mode="prefill",
        cache_width=jt._cache_width(jc, spec, MAX_LEN))
    cache = transformer.init_cache(cfg, 2, MAX_LEN, device="cpu")[0]["l2"]
    y, _ = transformer._apply_layer(cfg, spec, lp, _t(x), _t(pos),
                                    mode="prefill", cache=cache.layer(0))
    _close(y, jy, LOGIT_TOL)
    np.testing.assert_allclose(_np(cache.k[0]), _np(jcache.k), atol=2 ** -6,
                               rtol=2 ** -7)
    full = dataclasses.replace(cfg, block_pattern=())
    y_full, _ = transformer._apply_layer(
        full, spec, lp, _t(x), _t(pos), mode="prefill",
        cache=transformer.init_cache(cfg, 2, MAX_LEN,
                                     device="cpu")[0]["l2"].layer(0))
    assert float((y_full - y)[:, 16:].abs().max()) > 1e-2
    assert torch.equal(y_full[:, :16], y[:, :16])


# ---------------------------------------------------------------------------
# The model against JAX
# ---------------------------------------------------------------------------

def test_params_cross_with_the_unstacked_tail(model):
    """26 = 8 x 3 + 2 at full size and 6 = 2 x 3 here: the smoke model has
    no tail, so a 7-layer cut of it checks the `tail` segment (repeat 1,
    unstacked in JAX) both ways."""
    jc = dataclasses.replace(jcfgs.get_config(ARCH, smoke=True), num_layers=7)
    cfg = dataclasses.replace(cfgs.get_config(ARCH, smoke=True),
                              num_layers=7)
    full = cfgs.get_config(ARCH)
    assert [(s.name, len(s.layers), s.repeat)
            for s in transformer.arch_segments(full)] == [
        ("group", 3, 8), ("tail", 2, 1)]
    assert [(s.name, s.repeat) for s in transformer.arch_segments(cfg)] == [
        ("group", 2), ("tail", 1)]
    jp = jt.init_params(jc, jax.random.PRNGKey(5))
    p = convert.lm_params_from_numpy(cfg, jax.tree.map(np.asarray, jp),
                                     device="cpu")
    tail = p.segments[1].l0
    assert len(tail) == 1
    np.testing.assert_array_equal(
        _np(tail[0].mixer.w_in_rec),
        np.asarray(jp["segments"][1]["l0"]["mixer"]["w_in_rec"]))
    prompts = np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 21),
                                                dtype=np.int32)
    jlog, jstate = jt.forward_prefill(jc, jp, jnp.asarray(prompts),
                                      max_len=MAX_LEN)
    plog, pstate = transformer.forward_prefill(cfg, p, _t(prompts),
                                               max_len=MAX_LEN)
    _close(plog, jlog, LOGIT_TOL)
    tok = np.asarray(jnp.argmax(jlog[:, -1], -1))[:, None].astype(np.int32)
    jlog, _ = jt.forward_decode(jc, jp, jnp.asarray(tok), jstate)
    plog, _ = transformer.forward_decode(cfg, p, _t(tok), pstate)
    _close(plog, jlog, LOGIT_TOL)


@pytest.mark.parametrize("s", [3, 20, 40], ids=["below_conv", "past_window",
                                                "wraps"])
def test_prefill_and_decode_logits_match_jax(model, s):
    """Decode steps enough to wrap the ring of 16 keys past the prompt."""
    cfg, jc, jp, p = model
    rng = np.random.default_rng(2)
    prompts = rng.integers(0, cfg.vocab_size, (2, s), dtype=np.int32)
    jlog, jstate = jax.jit(lambda pp, t: jt.forward_prefill(
        jc, pp, t, max_len=MAX_LEN))(jp, jnp.asarray(prompts))
    before = kernels.flash_attention.launches
    plog, pstate = transformer.forward_prefill(cfg, p, _t(prompts),
                                               max_len=MAX_LEN)
    assert kernels.flash_attention.launches == before    # plain on the CPU
    _close(plog, jlog, LOGIT_TOL)
    jdec = jax.jit(lambda pp, t, st: jt.forward_decode(jc, pp, t, st))
    tok = rng.integers(0, cfg.vocab_size, (2, 1), dtype=np.int32)
    for _ in range(min(MAX_LEN - s - 1, 20)):
        jlog, jstate = jdec(jp, jnp.asarray(tok), jstate)
        plog, pstate = transformer.forward_decode(cfg, p, _t(tok), pstate)
        _close(plog, jlog, LOGIT_TOL)
        tok = np.asarray(jnp.argmax(jlog[:, -1], -1))[:, None].astype(
            np.int32)
    got = _state_from_jax(cfg, jstate).caches[0]
    for name in ("l0", "l1"):
        _close(pstate.caches[0][name].h, got[name].h, LOGIT_TOL)
    np.testing.assert_allclose(_np(pstate.caches[0]["l2"].k),
                               _np(got["l2"].k), atol=2 ** -6, rtol=2 ** -7)


def test_serve_greedy_tokens_match_jax(model):
    cfg, jc, jp, p = model
    prompts = np.random.default_rng(5).integers(0, cfg.vocab_size, (3, 24),
                                                dtype=np.int32)
    gen = 12
    want = np.asarray(jserve.serve(jc, jp, jnp.asarray(prompts),
                                   max_len=MAX_LEN, gen=gen))
    toks, margins = _jax_greedy(jc, jp, prompts, gen)
    assert np.array_equal(toks, want)
    got = serve.serve(cfg, p, _t(prompts), max_len=MAX_LEN, gen=gen).numpy()
    assert got.shape == want.shape == (3, gen)
    assert_tokens_match(got, want, margins)


def test_masked_decode_step_matches_jax_on_the_same_state(model):
    """Four slots at different depths, two live, against JAX's masked
    step jitted without a mesh: the local ring's kv_len follows each
    row's pos."""
    cfg, jc, jp, p = model
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
        jlog, jstate = jdec(jp, jnp.asarray(tok), jstate, jnp.asarray(active))
        plog, pstate = pdec(p, _t(tok), pstate, _t(active))
        _close(plog, jlog, LOGIT_TOL)
        tok = np.asarray(jnp.argmax(jlog[:, -1], -1))[:, None].astype(
            np.int32)
    assert pstate.pos.tolist() == np.asarray(jstate.pos).tolist() == \
        [23, 9, 23, 3]
    want = _state_from_jax(cfg, jstate).caches[0]
    for name in ("l0", "l1"):
        _close(pstate.caches[0][name].h[:, [0, 2]],
               want[name].h[:, [0, 2]], LOGIT_TOL)


def _backlog(cfg, n=5, seed=9):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, cfg.vocab_size, int(rng.choice([2, 10, 24, 36])),
                          dtype=np.int32), int(rng.choice([4, 8])))
            for _ in range(n)]


@pytest.fixture(scope="module")
def backlog(model):
    """The backlog and, per request, JAX `serve()`'s tokens for its prompt
    alone and the margins behind them."""
    cfg, jc, jp, _ = model
    reqs = _backlog(cfg)
    want = [(np.asarray(jserve.serve(jc, jp, jnp.asarray(toks[None]),
                                     max_len=MAX_LEN, gen=n)),
             _jax_greedy(jc, jp, toks[None], n)[1]) for toks, n in reqs]
    return reqs, want


@pytest.mark.parametrize("engine", ["contiguous", "paged", "paged_batched"])
def test_engine_matches_jax_serve_at_batch_1(model, backlog, engine):
    """Three slots over prompts below the conv kernel, below and past the
    window: every request's tokens equal JAX `serve()` of that prompt
    alone. The local rings and RG-LRU states stay contiguous per slot,
    so the paged engines only book blocks."""
    cfg, _, _, p = model
    reqs, expected = backlog
    kw = {"contiguous": {},
          "paged": dict(paged=True, block_size=8),
          "paged_batched": dict(paged=True, block_size=8,
                                prefill_batch=2)}[engine]
    eng = scheduler.Engine(cfg, p, slots=3, max_len=MAX_LEN, device="cpu",
                           **kw)
    assert not any(isinstance(c, kvcache.PagedAttnCache)
                   for seg in eng.state.caches for c in seg.values())
    for toks, n in reqs:
        eng.submit(toks, n)
    results = eng.drain()
    if eng.paged:
        eng.allocator.check()
        assert eng.stats()["blocks_in_use"] == 0
    for (_, n), r, (want, margins) in zip(reqs, results, expected):
        assert_tokens_match(np.asarray(r.tokens)[None], want, margins)


def test_serve_main_takes_the_arch(capsys):
    assert serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                       "--batch", "2", "--prompt-len", "24",
                       "--gen", "4"]) == 0
    assert "generated (2, 4)" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# The Engine's bucket rule (both families of this slice)
# ---------------------------------------------------------------------------

BOTH = ("mamba2_2p7b", "recurrentgemma_2b")


@pytest.mark.parametrize("arch", BOTH)
def test_bucketed_prefill_refuses_recurrent_state(arch):
    """Padding folds into an SSM or RG-LRU state (and a local ring), so
    `bucket="pow2"` raises, as the JAX `Engine._bucket_eligible` rules;
    the full-attention models keep it."""
    cfg = cfgs.get_config(arch, smoke=True)
    p = transformer.init_params(cfg, torch.Generator().manual_seed(0),
                                device="cpu")
    with pytest.raises(ValueError, match="bucketed"):
        scheduler.Engine(cfg, p, bucket="pow2", device="cpu")
    jc = jcfgs.get_config(arch, smoke=True)
    from repro.launch import scheduler as jsched
    assert not jsched.Engine._bucket_eligible(jc)
    for other in cfgs.ARCH_IDS:
        c = cfgs.get_config(other, smoke=True)
        assert scheduler.Engine._bucket_eligible(c) == \
            jsched.Engine._bucket_eligible(jcfgs.get_config(other,
                                                            smoke=True))


@pytest.mark.parametrize("arch", BOTH)
def test_batched_paged_prefill_groups_only_equal_lengths(arch):
    """prefill_batch=2: a group holds queue heads of one exact prompt
    length (no padding for these families), so prompts of 6, 6, 9, 9, 6
    take three launches, every row at its own length."""
    cfg = cfgs.get_config(arch, smoke=True)
    p = transformer.init_params(cfg, torch.Generator().manual_seed(1),
                                device="cpu")
    eng = scheduler.Engine(cfg, p, slots=4, max_len=32, paged=True,
                           block_size=8, prefill_batch=2, device="cpu")
    seen = []
    inner = eng._prefill

    def spy(params, batch, lengths, *rest):
        live = lengths[lengths > 1].tolist()
        seen.append((batch["tokens"].shape[1], live))
        return inner(params, batch, lengths, *rest)
    eng._prefill = spy
    rng = np.random.default_rng(2)
    for n in (6, 6, 9, 9, 6):
        eng.submit(rng.integers(0, cfg.vocab_size, n), 3)
    results = eng.drain()
    assert [len(r.tokens) for r in results] == [3] * 5
    assert seen == [(6, [6, 6]), (9, [9, 9]), (6, [6])]
    assert eng.prefill_launches == 3
