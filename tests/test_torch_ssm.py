"""The port's Mamba 2 (`repro_torch.models.ssm` and the SSM family of
`models/transformer.py`) against the JAX package, on the CPU.

Inputs are drawn with numpy from a seed and given to both sides;
parameters are the JAX package's `init_params`, carried across as numpy
(`repro_torch.convert.lm_params_from_numpy`). Tolerances, with their
reasons:
- the SSD scan, its decode step and the Mamba 2 mixer: 1e-5 (float32
  products and sums grouped otherwise than XLA's);
- logits: atol = rtol = 1e-4 (the ROADMAP oracle: float32 products summed
  in another order over the layers);
- greedy tokens are compared where JAX's top-2 logit margin is at least
  1e-3 (PERF.md §2's rule): a smaller margin can flip under the 1e-4
  logit tolerance, and once a token differs the sequences part;
- a prefill's final state against the same tokens stepped one by one
  through the decode recurrence: 1e-5 (one chunked sum against a
  sequential one).
The JAX `Engine` does not run here; the port's engines are held to JAX
`serve()` at batch 1, request by request (Mamba's rows are independent),
and the masked decode step to JAX's, jitted without a mesh, on one state.
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
from repro.models import ssm as jssm  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import base as cfgs  # noqa: E402
from repro_torch.launch import scheduler, serve, steps  # noqa: E402
from repro_torch.models import kvcache, rglru, ssm, transformer  # noqa: E402

ARCH = "mamba2_2p7b"
MAX_LEN = 48
PIECE_TOL = 1e-5
LOGIT_TOL = 1e-4
MARGIN = 1e-3


def _np(x):
    return x.detach().float().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol=PIECE_TOL):
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


@pytest.fixture(scope="module")
def model():
    jc = jcfgs.get_config(ARCH, smoke=True)
    cfg = cfgs.get_config(ARCH, smoke=True)
    jp = jt.init_params(jc, jax.random.PRNGKey(0))
    p = convert.lm_params_from_numpy(cfg, jax.tree.map(np.asarray, jp),
                                     device="cpu")
    return cfg, jc, jp, p


def _mixer(model, seed=1):
    """Layer 1's mixer on both sides, with nonzero dt_bias, a_log, biases
    and norm gains (they are zeros or ones at init)."""
    cfg, jc, jp, _ = model
    rng = np.random.default_rng(seed)
    lp = {k: np.asarray(v)[1].copy()
          for k, v in jp["segments"][0]["l0"]["mixer"].items()}
    for k in ("dt_bias", "a_log", "conv_b", "norm_scale"):
        lp[k] = (rng.standard_normal(lp[k].shape) * 0.3).astype(np.float32)
    return (transformer.ParamTree({k: _t(v) for k, v in lp.items()}),
            {k: jnp.asarray(v) for k, v in lp.items()})


_KINDS = {"SSMState": ssm.SSMState, "RGState": rglru.RGState,
          "AttnCache": kvcache.AttnCache}


def _state_from_jax(cfg, jstate):
    """A port ServeState from a JAX one: every leaf stacked on a layer axis
    (the JAX package leaves a one-layer segment unstacked)."""
    def leaf(x, repeat):
        t = _t(np.asarray(x, np.float32)).to(
            torch.bfloat16 if x.dtype == jnp.bfloat16 else torch.float32)
        return t if repeat > 1 else t[None]

    caches = [{name: _KINDS[type(c).__name__](
        *(leaf(x, seg.repeat) for x in c if x is not None))
        for name, c in jseg.items()}
        for seg, jseg in zip(transformer.arch_segments(cfg), jstate.caches)]
    return transformer.ServeState(caches=caches, cross=[None] * len(caches),
                                  pos=_t(np.asarray(jstate.pos)))


def _jax_greedy(jc, jp, prompts, gen):
    """JAX's greedy tokens and, behind each, its logits' top-2 margin."""
    lg, state = jax.jit(lambda pp, t: jt.forward_prefill(
        jc, pp, t, max_len=MAX_LEN))(jp, jnp.asarray(prompts))
    jdecode = jax.jit(lambda pp, t, s: jt.forward_decode(jc, pp, t, s))
    toks, margins = [], []
    for _ in range(gen):
        last = np.asarray(lg[:, -1])
        top = np.sort(last, -1)
        margins.append(top[:, -1] - top[:, -2])
        tok = last.argmax(-1).astype(np.int32)[:, None]
        toks.append(tok)
        lg, state = jdecode(jp, jnp.asarray(tok), state)
    return np.concatenate(toks, 1), np.stack(margins, 1)


def assert_tokens_match(got, want, margins):
    """Equal tokens, except from a position where JAX's margin was below
    MARGIN (a near-tie the logit tolerance may flip)."""
    for r in range(want.shape[0]):
        diff = np.nonzero(np.asarray(got[r]) != want[r])[0]
        if diff.size:
            assert margins[r, diff[0]] < MARGIN, (r, diff[0])


# ---------------------------------------------------------------------------
# The SSD scan and its decode step
# ---------------------------------------------------------------------------

def _ssd_inputs(seed, s, h=4, p=16, g=1, n=16, b=2):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    a = -np.exp(rng.standard_normal(h) * 0.5).astype(np.float32)
    bb, cc = (rng.standard_normal((b, s, g, n)).astype(np.float32)
              for _ in range(2))
    d_skip = rng.standard_normal(h).astype(np.float32)
    return x, dt, a, bb, cc, d_skip


@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("s", [16, 21, 5], ids=["multiple", "ragged",
                                                 "below_chunk"])
def test_ssd_scan_matches_jax(s, groups):
    """S a multiple of the chunk (8), not a multiple (dt = 0 padding), and
    below one chunk; one group of B and C or two (heads 0-1 and 2-3)."""
    args = _ssd_inputs(s, s, g=groups)
    y, state = ssm.ssd_scan(*map(_t, args), chunk=8)
    jy, jstate = jssm.ssd_scan(*map(jnp.asarray, args), chunk=8)
    assert tuple(y.shape) == args[0].shape and state.dtype == torch.float32
    assert tuple(state.shape) == jstate.shape == (2, 4, 16, 16)
    _close(y, jy)
    _close(state, jstate)


def test_segsum_matches_jax():
    x = np.random.default_rng(0).standard_normal((3, 8)).astype(np.float32)
    got, want = _np(ssm._segsum(_t(x))), np.asarray(jssm._segsum(
        jnp.asarray(x)))
    assert np.array_equal(np.isinf(got), np.isinf(want))
    np.testing.assert_allclose(got[~np.isinf(got)], want[~np.isinf(want)],
                               atol=PIECE_TOL, rtol=PIECE_TOL)


@pytest.mark.parametrize("groups", [1, 2])
def test_ssd_decode_step_matches_jax(groups):
    rng = np.random.default_rng(groups)
    b, h, p, n = 3, 4, 16, 16
    state = rng.standard_normal((b, h, p, n)).astype(np.float32)
    x = rng.standard_normal((b, h, p)).astype(np.float32)
    dt = np.abs(rng.standard_normal((b, h))).astype(np.float32)
    a = -np.abs(rng.standard_normal(h)).astype(np.float32)
    bb, cc = (rng.standard_normal((b, groups, n)).astype(np.float32)
              for _ in range(2))
    d_skip = rng.standard_normal(h).astype(np.float32)
    args = (state, x, dt, a, bb, cc, d_skip)
    got = ssm.ssd_decode_step(*map(_t, args))
    want = jssm.ssd_decode_step(*map(jnp.asarray, args))
    for g_, w_ in zip(got, want):
        _close(g_, w_)


def test_scan_state_equals_the_decode_recurrence():
    """The chunked scan's final state and outputs against the same tokens
    stepped through `ssd_decode_step` from a zero state."""
    x, dt, a, bb, cc, d_skip = _ssd_inputs(3, 19, g=2)
    y, state = ssm.ssd_scan(*map(_t, (x, dt, a, bb, cc, d_skip)), chunk=8)
    st = torch.zeros_like(state)
    for i in range(x.shape[1]):
        st, yi = ssm.ssd_decode_step(st, *(_t(v[:, i]) for v in (x, dt)),
                                     _t(a), _t(bb[:, i]), _t(cc[:, i]),
                                     _t(d_skip))
        _close(yi, y[:, i])
    _close(st, state)


# ---------------------------------------------------------------------------
# The Mamba 2 mixer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s", [2, 13, 16], ids=["below_conv", "ragged",
                                                 "two_chunks"])
def test_mamba2_block_matches_jax(model, s):
    """Prefill with its decode state; S = 2 is shorter than K - 1 = 3 (the
    conv state's zero-padded front)."""
    cfg, jc, _, _ = model
    pp, jlp = _mixer(model)
    x = np.random.default_rng(s).standard_normal(
        (2, s, cfg.d_model)).astype(np.float32)
    out, st = ssm.mamba2_block(cfg, pp, _t(x), return_state=True)
    jout, jst = jssm.mamba2_block(jc, jlp, jnp.asarray(x), return_state=True)
    _close(out, jout)
    assert tuple(st.conv.shape) == jst.conv.shape == (
        2, cfg.ssm_expand * cfg.d_model + 2 * cfg.ssm_groups * cfg.ssm_state,
        cfg.conv_kernel - 1)
    _close(st.conv, jst.conv)
    _close(st.state, jst.state)
    if s < cfg.conv_kernel - 1:
        assert float(st.conv[..., :cfg.conv_kernel - 1 - s].abs().max()) == 0
    assert torch.equal(ssm.mamba2_block(cfg, pp, _t(x)), out)


def test_mamba2_decode_matches_jax_and_continues_the_prefill(model):
    """Decode steps from JAX's prefill state, against JAX's; and the
    port's own prefill of S + 3 tokens against its prefill of S and three
    decode steps."""
    cfg, jc, _, _ = model
    pp, jlp = _mixer(model)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 14, cfg.d_model)).astype(np.float32)
    _, jst = jssm.mamba2_block(jc, jlp, jnp.asarray(x[:, :11]),
                               return_state=True)
    st = ssm.SSMState(_t(np.asarray(jst.conv)), _t(np.asarray(jst.state)))
    full = ssm.mamba2_block(cfg, pp, _t(x))
    for i in range(11, 14):
        y, st = ssm.mamba2_decode(cfg, pp, _t(x[:, i:i + 1]), st)
        jy, jst = jssm.mamba2_decode(jc, jlp, jnp.asarray(x[:, i:i + 1]),
                                     jst)
        _close(y, jy)
        _close(st.conv, jst.conv)
        _close(st.state, jst.state)
        _close(y[:, 0], full[:, i])


def test_init_ssm_state_layout():
    cfg = cfgs.get_config(ARCH, smoke=True)
    st = ssm.init_ssm_state(cfg, 3, layers=2, device="cpu")
    d_in = cfg.ssm_expand * cfg.d_model
    assert tuple(st.conv.shape) == (2, 3, d_in + 2 * cfg.ssm_state,
                                    cfg.conv_kernel - 1)
    assert tuple(st.state.shape) == (2, 3, d_in // cfg.ssm_head_dim,
                                     cfg.ssm_head_dim, cfg.ssm_state)
    assert st.state.dtype == torch.float32
    st.layer(1).state[2, 0, 0, 0] = 1.0             # a view of the stack
    assert float(st.state[1, 2, 0, 0, 0]) == 1.0
    j = jssm.init_ssm_state(jcfgs.get_config(ARCH, smoke=True), 3)
    assert (j.conv.shape, j.state.shape) == (st.conv.shape[1:],
                                             st.state.shape[1:])


# ---------------------------------------------------------------------------
# The model: parameters, logits, serve(), the steps, the engines
# ---------------------------------------------------------------------------

def test_params_cross_without_ffn(model):
    """Mamba 2's layers have no FFN: the JAX tree has no ln2 / ffn, and
    neither has the port's, drawn or converted."""
    cfg, _, jp, p = model
    assert set(jp["segments"][0]["l0"]) == {"ln1", "mixer"}
    drawn = transformer.init_params(cfg, torch.Generator().manual_seed(0),
                                    device="cpu")
    for tree in (p, drawn):
        lp = tree.segments[0].l0
        assert len(lp) == cfg.num_layers
        assert set(dict(lp[1].named_children())) == {"ln1", "mixer"}
    np.testing.assert_array_equal(
        _np(p.segments[0].l0[1].mixer.in_proj),
        np.asarray(jp["segments"][0]["l0"]["mixer"]["in_proj"])[1])


@pytest.mark.parametrize("s", [3, 20], ids=["below_conv", "ragged"])
def test_prefill_and_decode_logits_match_jax(model, s):
    cfg, jc, jp, p = model
    rng = np.random.default_rng(2)
    prompts = rng.integers(0, cfg.vocab_size, (2, s), dtype=np.int32)
    jlog, jstate = jax.jit(lambda pp, t: jt.forward_prefill(
        jc, pp, t, max_len=MAX_LEN))(jp, jnp.asarray(prompts))
    plog, pstate = transformer.forward_prefill(cfg, p, _t(prompts),
                                               max_len=MAX_LEN)
    _close(plog, jlog, LOGIT_TOL)
    jdec = jax.jit(lambda pp, t, st: jt.forward_decode(jc, pp, t, st))
    tok = rng.integers(0, cfg.vocab_size, (2, 1), dtype=np.int32)
    for _ in range(4):
        jlog, jstate = jdec(jp, jnp.asarray(tok), jstate)
        caches = pstate.caches
        plog, pstate = transformer.forward_decode(cfg, p, _t(tok), pstate)
        assert pstate.caches is caches               # updated in place
        _close(plog, jlog, LOGIT_TOL)
        tok = np.asarray(jnp.argmax(jlog[:, -1], -1))[:, None].astype(
            np.int32)
    assert pstate.pos.tolist() == [s + 4] * 2
    got = _state_from_jax(cfg, jstate).caches[0]["l0"]
    _close(pstate.caches[0]["l0"].state, got.state, LOGIT_TOL)
    _close(pstate.caches[0]["l0"].conv, got.conv, LOGIT_TOL)


def test_serve_greedy_tokens_match_jax(model):
    cfg, jc, jp, p = model
    prompts = np.random.default_rng(5).integers(0, cfg.vocab_size, (3, 19),
                                                dtype=np.int32)
    gen = 10
    want = np.asarray(jserve.serve(jc, jp, jnp.asarray(prompts),
                                   max_len=MAX_LEN, gen=gen))
    toks, margins = _jax_greedy(jc, jp, prompts, gen)
    assert np.array_equal(toks, want)              # serve() is this loop
    got = serve.serve(cfg, p, _t(prompts), max_len=MAX_LEN, gen=gen).numpy()
    assert got.shape == want.shape == (3, gen)
    assert_tokens_match(got, want, margins)


def test_masked_decode_step_matches_jax_on_the_same_state(model):
    """Four slots, two live: the port's masked step against JAX's
    `make_masked_decode_step` (no mesh) from one prefilled state; the
    frozen rows keep their pos on both sides."""
    cfg, jc, jp, p = model
    rng = np.random.default_rng(6)
    prompts = rng.integers(0, cfg.vocab_size, (4, 12), dtype=np.int32)
    _, jstate = jax.jit(lambda pp, t: jt.forward_prefill(
        jc, pp, t, max_len=MAX_LEN))(jp, jnp.asarray(prompts))
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
        [15, 12, 15, 12]
    want = _state_from_jax(cfg, jstate).caches[0]["l0"]
    for a, b in zip(pstate.caches[0]["l0"], want):
        _close(a[:, [0, 2]], b[:, [0, 2]], LOGIT_TOL)


def test_write_state_slot_splices_ssm_rows(model):
    """A batch-1 prefill state lands in row 2 of a 3-slot state, every
    other row untouched; the paged state keeps the SSM state contiguous
    (no block pool) and splices the same row."""
    cfg, _, _, p = model
    prompts = _t(np.arange(1, 8, dtype=np.int32)[None])
    _, one = transformer.forward_prefill(cfg, p, prompts, max_len=MAX_LEN)
    for full in (steps.serve_state_zeros(cfg, p, 3, MAX_LEN),
                 steps.paged_serve_state_zeros(cfg, p, 3, MAX_LEN,
                                               block_size=8, num_blocks=4)):
        c = full.caches[0]["l0"]
        assert isinstance(c, ssm.SSMState)
        assert not any(isinstance(x, (kvcache.PagedAttnCache,
                                      kvcache.PagedMLACache))
                       for seg in full.caches for x in seg.values())
        steps.write_state_slot(full, one, 2)
        for a, b in zip(c, one.caches[0]["l0"]):
            assert torch.equal(a[:, 2:3], b)
            assert float(a[:, :2].abs().max()) == 0.0
        assert full.pos.tolist() == [0, 0, 7]


def _backlog(cfg, n=5, seed=9):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, cfg.vocab_size, int(rng.choice([2, 6, 12, 20])),
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
    """Three slots over a mixed backlog (prompts shorter than the conv
    kernel among them): every request's tokens equal JAX `serve()` of
    that prompt alone. The paged engines book blocks but hold no pool."""
    cfg, _, _, p = model
    reqs, expected = backlog
    kw = {"contiguous": {},
          "paged": dict(paged=True, block_size=8),
          "paged_batched": dict(paged=True, block_size=8,
                                prefill_batch=2)}[engine]
    eng = scheduler.Engine(cfg, p, slots=3, max_len=MAX_LEN, device="cpu",
                           **kw)
    for toks, n in reqs:
        eng.submit(toks, n)
    results = eng.drain()
    assert eng.trace_counts["decode"] == 1
    if eng.paged:
        eng.allocator.check()
        assert eng.stats()["blocks_in_use"] == 0
    for (_, n), r, (want, margins) in zip(reqs, results, expected):
        assert len(r.tokens) == n
        assert_tokens_match(np.asarray(r.tokens)[None], want, margins)


def test_serve_main_takes_the_arch(capsys):
    assert serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                       "--batch", "2", "--prompt-len", "12",
                       "--gen", "4"]) == 0
    assert serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                       "--stream", "--requests", "4", "--slots", "2",
                       "--paged", "--block-size", "8",
                       "--prefill-batch", "2"]) == 0
    out = capsys.readouterr().out
    assert "generated (2, 4)" in out and "4 requests" in out


def test_config_cut_in_depth_keeps_the_segment_layout():
    """A Mamba config cut to one layer: one unstacked-in-JAX segment,
    still (1, B, ...) in the port, and its params cross."""
    jc = dataclasses.replace(jcfgs.get_config(ARCH, smoke=True), num_layers=1)
    cfg = dataclasses.replace(cfgs.get_config(ARCH, smoke=True),
                              num_layers=1)
    jp = jt.init_params(jc, jax.random.PRNGKey(3))
    p = convert.lm_params_from_numpy(cfg, jax.tree.map(np.asarray, jp),
                                     device="cpu")
    prompts = np.arange(1, 10, dtype=np.int32)[None]
    jlog, _ = jt.forward_prefill(jc, jp, jnp.asarray(prompts), max_len=16)
    plog, st = transformer.forward_prefill(cfg, p, _t(prompts), max_len=16)
    _close(plog, jlog, LOGIT_TOL)
    assert st.caches[0]["l0"].state.shape[0] == 1
