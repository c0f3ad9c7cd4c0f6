"""The port's patch model (InternVL2: patch rows ahead of the prompt in
`models/transformer.py`, and the serve path that carries them and counts
them against the cache) against the JAX package, on the CPU.

The smoke config puts 8 patch rows of width 64 ahead of the prompt, with
RoPE and causal attention over all of them, as the JAX package does. The
helpers, tolerances and the margin rule for tokens are
`tests/test_torch_encdec.py`'s. The JAX `Engine` runs here only as far
as `submit` (its prefill does not run in this JAX): its budget errors
are the oracle for the port's.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as jcfgs  # noqa: E402
from repro.launch import scheduler as jsched  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro_torch.configs import base as cfgs  # noqa: E402
from repro_torch.launch import scheduler, serve, steps  # noqa: E402
from repro_torch.models import kvcache, transformer  # noqa: E402
from test_torch_encdec import (ENGINES, backlog, crossing_model,  # noqa: E402
                               jax_backlog_tokens, jax_greedy, jax_inputs,
                               model_inputs, port_inputs, run_engine,
                               state_from_jax)
from test_torch_ssm import (LOGIT_TOL, _close, _np, _t,  # noqa: E402
                            assert_tokens_match)

ARCH = "internvl2_26b"
MAX_LEN = 48


@pytest.fixture(scope="module")
def model():
    return crossing_model(ARCH, seed=2)


@pytest.mark.parametrize("length_kind", ["none", "scalar", "vector"])
def test_prefill_offset_and_decode_match_jax(model, length_kind):
    """Prompts of 14 tokens behind the 8 patch rows, right-padded where
    `length` is given: the last row is P + length - 1 and pos starts at
    P + length in all three forms of `length`; the caches hold the patch
    rows first; then decode steps."""
    cfg, jc, jp, p = model
    pt = cfg.patch_tokens
    assert pt == 8
    rng = np.random.default_rng(1)
    prompts = rng.integers(0, cfg.vocab_size, (2, 14), dtype=np.int32)
    inputs = model_inputs(cfg, 2, 1)
    length = {"none": None, "scalar": 11,
              "vector": np.array([9, 14], np.int32)}[length_kind]
    want_pos = {"none": [pt + 14] * 2, "scalar": [pt + 11] * 2,
                "vector": [pt + 9, pt + 14]}[length_kind]
    jlen = None if length is None else jnp.asarray(length)
    plen = None if length is None else (
        _t(length) if isinstance(length, np.ndarray) else length)
    jlog, jstate = jax.jit(lambda pp, t, ln, x: jt.forward_prefill(
        jc, pp, t, max_len=MAX_LEN, length=ln, **x))(
        jp, jnp.asarray(prompts), jlen, jax_inputs(inputs))
    plog, pstate = transformer.forward_prefill(
        cfg, p, _t(prompts), max_len=MAX_LEN, length=plen,
        **port_inputs(inputs))
    _close(plog, jlog, LOGIT_TOL)
    assert pstate.pos.tolist() == np.asarray(jstate.pos).tolist() == want_pos
    assert pstate.cross == [None]
    want = state_from_jax(cfg, jstate)
    np.testing.assert_allclose(_np(pstate.caches[0]["l0"].k),
                               _np(want.caches[0]["l0"].k), atol=2 ** -6,
                               rtol=2 ** -7)
    jdec = jax.jit(lambda pp, t, st: jt.forward_decode(jc, pp, t, st))
    tok = rng.integers(0, cfg.vocab_size, (2, 1), dtype=np.int32)
    for _ in range(4):
        jlog, jstate = jdec(jp, jnp.asarray(tok), jstate)
        plog, pstate = transformer.forward_decode(cfg, p, _t(tok), pstate)
        _close(plog, jlog, LOGIT_TOL)
        tok = np.asarray(jnp.argmax(jlog[:, -1], -1))[:, None].astype(
            np.int32)


def test_patch_rows_are_causal_ahead_of_the_prompt(model):
    """The patch rows sit at positions 0..P-1 under the causal mask: the
    prompt does not move their cache keys, and the patches move every
    prompt row's logits."""
    cfg, _, _, p = model
    rng = np.random.default_rng(2)
    prompts = rng.integers(0, cfg.vocab_size, (2, 6), dtype=np.int32)
    patches = port_inputs(model_inputs(cfg, 2, 2))["patches"]
    _, a = transformer.forward_prefill(cfg, p, _t(prompts), max_len=MAX_LEN,
                                       patches=patches)
    _, b = transformer.forward_prefill(cfg, p, _t(prompts[::-1].copy()),
                                       max_len=MAX_LEN, patches=patches)
    pt = cfg.patch_tokens
    k_a, k_b = a.caches[0]["l0"].k, b.caches[0]["l0"].k
    assert torch.equal(k_a[:, :, :, :pt], k_b[:, :, :, :pt])
    assert not torch.equal(k_a[:, :, :, pt:pt + 6], k_b[:, :, :, pt:pt + 6])
    la, _ = transformer.forward_prefill(cfg, p, _t(prompts), max_len=MAX_LEN,
                                        patches=patches)
    lb, _ = transformer.forward_prefill(cfg, p, _t(prompts), max_len=MAX_LEN,
                                        patches=patches * 2)
    assert float((la - lb).abs().max()) > 1e-4


def test_prefill_needs_patches(model):
    cfg, _, _, p = model
    toks = torch.zeros((2, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="needs patches"):
        transformer.forward_prefill(cfg, p, toks, max_len=MAX_LEN)
    with pytest.raises(ValueError, match="patches must be"):
        transformer.forward_prefill(
            cfg, p, toks, max_len=MAX_LEN,
            patches=torch.zeros((2, cfg.patch_tokens + 1, cfg.d_model)))


def test_serve_greedy_tokens_match_jax(model):
    cfg, jc, jp, p = model
    rng = np.random.default_rng(3)
    prompts = rng.integers(0, cfg.vocab_size, (3, 16), dtype=np.int32)
    inputs = model_inputs(cfg, 3, 3)
    gen = 12
    want = np.asarray(jserve.serve(jc, jp, jnp.asarray(prompts),
                                   max_len=MAX_LEN, gen=gen,
                                   **jax_inputs(inputs)))
    toks, margins = jax_greedy(jc, jp, prompts, inputs, gen, MAX_LEN)
    assert np.array_equal(toks, want)
    got = serve.serve(cfg, p, _t(prompts), max_len=MAX_LEN, gen=gen,
                      **port_inputs(inputs)).numpy()
    assert got.shape == want.shape == (3, gen)
    assert_tokens_match(got, want, margins)


def test_slot_prefill_and_masked_decode_steps_match_jax(model):
    """One request (8 patch rows, 11 of 16 tokens real) into slot 1 of 3,
    then masked decode steps, against JAX's mesh-free steps."""
    cfg, jc, jp, p = model
    rng = np.random.default_rng(4)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (1, 16),
                                    dtype=np.int32), **model_inputs(cfg, 1, 4)}
    jstate = jsteps.serve_state_zeros(jc, jp, 3, MAX_LEN)
    pstate = steps.serve_state_zeros(cfg, p, 3, MAX_LEN)
    jlog, jstate = jax.jit(jsteps.make_slot_prefill_step(jc, max_len=MAX_LEN))(
        jp, jax_inputs(batch), jnp.asarray(11), jnp.asarray(1), jstate)
    plog, pstate = steps.make_slot_prefill_step(cfg, max_len=MAX_LEN)(
        p, port_inputs(batch), 11, 1, pstate)
    _close(plog, jlog, LOGIT_TOL)
    jdec = jax.jit(jsteps.make_masked_decode_step(jc))
    pdec = steps.make_masked_decode_step(cfg)
    active = np.array([False, True, False])
    tok = rng.integers(0, cfg.vocab_size, (3, 1), dtype=np.int32)
    for _ in range(3):
        jlog, jstate = jdec(jp, jnp.asarray(tok), jstate, jnp.asarray(active))
        plog, pstate = pdec(p, _t(tok), pstate, _t(active))
        _close(plog, jlog, LOGIT_TOL)
        tok = np.asarray(jnp.argmax(jlog[:, -1], -1))[:, None].astype(
            np.int32)
    assert pstate.pos.tolist() == np.asarray(jstate.pos).tolist() == \
        [0, 8 + 11 + 3, 0]


def test_paged_steps_match_the_jax_paged_steps(model):
    """A batched paged prefill of two requests behind a dummy row (zero
    patches): each row's patch rows and prompt scatter into its blocks;
    then paged decode steps, against JAX's paged steps."""
    cfg, jc, jp, p = model
    bs, nb, admit = 8, 16, 3
    mb = MAX_LEN // bs
    rng = np.random.default_rng(5)
    toks = rng.integers(0, cfg.vocab_size, (admit, 12), dtype=np.int32)
    toks[0] = 0
    inputs = model_inputs(cfg, admit, 5)
    inputs["patches"][0] = 0.0
    lengths = np.array([1, 12, 9], np.int32)
    slots = np.array([2, 2, 0], np.int32)
    tables = np.zeros((admit, mb), np.int32)
    tables[1, :3] = (5, 1, 7)
    tables[2, :3] = (2, 9, 3)
    jstate = jsteps.paged_serve_state_zeros(jc, jp, 4, MAX_LEN,
                                            block_size=bs, num_blocks=nb)
    pstate = steps.paged_serve_state_zeros(cfg, p, 4, MAX_LEN, block_size=bs,
                                           num_blocks=nb)
    batch = {"tokens": toks, **inputs}
    jlog, jstate = jax.jit(jsteps.make_paged_prefill_step(
        jc, max_len=MAX_LEN, admit=admit))(
        jp, jax_inputs(batch), jnp.asarray(lengths), jnp.asarray(slots),
        jnp.asarray(tables), jstate)
    plog, pstate = steps.make_paged_prefill_step(
        cfg, max_len=MAX_LEN, admit=admit)(
        p, port_inputs(batch), _t(lengths), _t(slots), _t(tables), pstate)
    _close(plog[1:], np.asarray(jlog)[1:], LOGIT_TOL)
    block_tables = np.zeros((4, mb), np.int32)
    block_tables[2], block_tables[0] = tables[1], tables[2]
    active = np.array([True, False, True, False])
    jdec = jax.jit(jsteps.make_paged_decode_step(jc))
    pdec = steps.make_paged_decode_step(cfg)
    tok = rng.integers(0, cfg.vocab_size, (4, 1), dtype=np.int32)
    for _ in range(3):
        jlog, jstate = jdec(jp, jnp.asarray(tok), jstate, jnp.asarray(active),
                            jnp.asarray(block_tables))
        plog, pstate = pdec(p, _t(tok), pstate, _t(active), _t(block_tables))
        _close(plog[[0, 2]], np.asarray(jlog)[[0, 2]], LOGIT_TOL)
        tok = np.asarray(jnp.argmax(jlog[:, -1], -1))[:, None].astype(
            np.int32)
    assert pstate.pos.tolist() == np.asarray(jstate.pos).tolist() == \
        [8 + 9 + 3, 0, 8 + 12 + 3, 0]
    live = sorted({5, 1, 7, 2, 9, 3})
    got, want = _np(pstate.caches[0]["l0"].k), _np(jstate.caches[0]["l0"].k)
    np.testing.assert_allclose(got[:, :, live], want[:, :, live],
                               atol=2 ** -6, rtol=2 ** -7)


@pytest.fixture(scope="module")
def vlm_backlog(model):
    """Five requests (prompts of 2-30 tokens, each with its own patches)
    and JAX `serve()`'s tokens for each alone."""
    cfg, jc, jp, _ = model
    reqs = backlog(cfg, [2, 17, 30, 9, 22], [6, 4, 8, 5, 7], seed=20)
    return reqs, jax_backlog_tokens(jc, jp, reqs, MAX_LEN)


@pytest.mark.parametrize("engine", list(ENGINES))
def test_engine_tokens_equal_jax_serve_per_request(model, vlm_backlog,
                                                   engine):
    """Every request's tokens equal JAX `serve()` of that request alone;
    the paged engines book the patch rows' blocks too (8 + 30 + 8 = 46
    rows: 6 blocks of 8 for the longest)."""
    cfg, _, _, p = model
    reqs, expected = vlm_backlog
    results, eng = run_engine(cfg, p, reqs, MAX_LEN, engine)
    if eng.paged:
        assert eng._blocks_needed(scheduler.Request(reqs[2][0], 8)) == 6
        assert eng.stats()["peak_blocks"] >= 6
    for r, (want, margins) in zip(results, expected, strict=True):
        assert_tokens_match(np.asarray(r.tokens)[None], want, margins)


@pytest.mark.parametrize("paged", [False, True])
def test_submit_counts_patch_rows_as_the_jax_engine_does(model, paged):
    """Both budget errors under the same conditions as the JAX `Engine`'s
    `submit`: the request's rows (patches + prompt + max_new) past
    max_len, and (with bucketing forced on both, as no patch model may
    construct with it) the padded prefill's rows; the paged engine books
    ceil(rows / block_size) blocks, patches included, as JAX's does."""
    cfg, jc, jp, p = model
    max_len = 48
    kw = dict(paged=True, block_size=8) if paged else {}
    eng = scheduler.Engine(cfg, p, slots=2, max_len=max_len, device="cpu",
                           **kw)
    jeng = jsched.Engine(jc, jp, slots=2, max_len=max_len, **kw)
    cases = [(24, 16), (24, 17), (33, 4), (39, 1), (40, 1), (12, 20)]
    patches = np.zeros((cfg.patch_tokens, cfg.d_model), np.float32)
    seen = set()
    for bucket in (None, "pow2"):
        eng.bucket = jeng.bucket = bucket
        for plen, gen in cases:
            outcome = []
            for e in (eng, jeng):
                try:
                    e.submit(np.zeros(plen, np.int32), max_new=gen,
                             patches=patches)
                    outcome.append("ok")
                except ValueError as err:
                    assert "cache rows" in str(err)
                    outcome.append("bucket" if "pads" in str(err)
                                   else "rows")
            assert outcome[0] == outcome[1], (bucket, plen, gen, outcome)
            seen.add(outcome[0])
        assert len(eng.queue) == len(jeng.queue)
    assert seen == {"ok", "rows", "bucket"}
    if paged:
        for plen, gen in cases:
            req = scheduler.Request(np.zeros(plen, np.int32), gen)
            jreq = jsched.Request(np.zeros(plen, np.int32), gen)
            assert eng._blocks_needed(req) == jeng._blocks_needed(jreq)


@pytest.mark.parametrize("paged", [False, True])
def test_submit_refuses_a_request_without_its_patches(model, paged):
    """Patches missing or of another shape are refused at submit, before
    the request holds a slot or blocks, on either prefill route."""
    cfg, _, _, p = model
    kw = dict(paged=True, block_size=8, prefill_batch=2) if paged else {}
    eng = scheduler.Engine(cfg, p, slots=2, max_len=48, device="cpu", **kw)
    toks = np.ones(4, np.int32)
    with pytest.raises(ValueError, match="needs patches"):
        eng.submit(toks, max_new=2)
    with pytest.raises(ValueError, match="patches must be"):
        eng.submit(toks, max_new=2, patches=np.zeros(
            (cfg.patch_tokens - 1, cfg.d_model), np.float32))
    assert not eng.queue and not eng.busy()
    eng.submit(toks, max_new=2, patches=np.zeros(
        (cfg.patch_tokens, cfg.d_model), np.float32))
    assert len(eng.drain()) == 1


def test_synth_request_stream_patches_equal_jax():
    cfg = cfgs.get_config(ARCH, smoke=True)
    got = scheduler.synth_request_stream(cfg, 7, seed=6)
    want = jsched.synth_request_stream(jcfgs.get_config(ARCH, smoke=True), 7,
                                       seed=6)
    for a, b in zip(got, want, strict=True):
        np.testing.assert_array_equal(a.tokens, b.tokens)
        assert (a.max_new, a.arrival) == (b.max_new, b.arrival)
        assert a.patches.dtype == np.float32
        assert a.patches.shape == (cfg.patch_tokens, cfg.d_model)
        np.testing.assert_array_equal(a.patches, b.patches)
        assert a.frames is None and b.frames is None


def test_serve_main_takes_the_arch(capsys):
    """The patch rows count in max_len: a 16-token prompt, 4 new tokens
    and 8 patch rows run where 21 cache rows would not hold them."""
    assert serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                       "--batch", "2", "--prompt-len", "16",
                       "--gen", "4"]) == 0
    assert "generated (2, 4)" in capsys.readouterr().out
    assert serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                       "--stream", "--requests", "5", "--rate", "1000",
                       "--slots", "2"]) == 0
    assert "5 requests" in capsys.readouterr().out


def test_no_pool_for_the_patch_rows_of_a_windowless_model(model):
    """InternVL2's full-width attention pages like Llama's: the paged
    state holds a block pool and no cross keys."""
    cfg, _, _, p = model
    st = steps.paged_serve_state_zeros(cfg, p, 2, MAX_LEN, block_size=8,
                                       num_blocks=13)
    assert isinstance(st.caches[0]["l0"], kvcache.PagedAttnCache)
    assert st.cross == [None]
