"""The port's encoder-decoder model (Whisper: `models/transformer.py`'s
encoder, cross attention and learned positions, and the serve path that
carries the encoder frames and the cross keys and values) against the
JAX package, on the CPU.

Inputs are drawn with numpy from a seed and given to both sides;
parameters are the JAX package's `init_params`, carried across as numpy
(`repro_torch.convert.lm_params_from_numpy`), with their biases and
layernorm gains drawn (they are zeros and ones at init) so every bias
the cross layers add is exercised. The smoke config has 24 frames, 2
encoder and 2 decoder layers and 128 learned positions. Tolerances, with
their reasons:
- `sinusoidal_positions`: 1e-6 (float32 sin and cos of the same angles);
- the encoder, the cross mixer and logits: atol = rtol = 1e-4 (the
  ROADMAP oracle: float32 products summed in another order);
- greedy tokens under the margin rule of `tests/test_torch_ssm.py`.
The JAX `Engine` does not run here: the port's engines are held to JAX
`serve()` at batch 1, request by request, and its steps to the JAX
mesh-free steps on the same inputs.
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
from repro.models import layers as jlayers  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro_torch import convert, kernels  # noqa: E402
from repro_torch.configs import base as cfgs  # noqa: E402
from repro_torch.launch import scheduler, serve, steps  # noqa: E402
from repro_torch.models import kvcache, layers, transformer  # noqa: E402
from test_torch_ssm import (LOGIT_TOL, _close, _np, _t,  # noqa: E402
                            assert_tokens_match)

ARCH = "whisper_tiny"
MAX_LEN = 48


def with_drawn_biases(jp, seed):
    """JAX params with every bias and layernorm gain drawn: QKV and MLP
    biases N(0, 0.1), norm gains 1 + N(0, 0.1)."""
    rng = np.random.default_rng(seed)

    def fill(path, x):
        key = path[-1].key
        if key in ("bq", "bk", "bv", "b1", "b2", "bias"):
            return jnp.asarray((rng.standard_normal(x.shape) * 0.1)
                               .astype(np.float32))
        if key == "scale":
            return jnp.asarray((1 + rng.standard_normal(x.shape) * 0.1)
                               .astype(np.float32))
        return x
    return jax.tree_util.tree_map_with_path(fill, jp)


def crossing_model(arch, seed=0):
    """(port cfg, JAX cfg, JAX params, port params) of an arch's smoke
    config, the parameters carried across."""
    jc = jcfgs.get_config(arch, smoke=True)
    cfg = cfgs.get_config(arch, smoke=True)
    jp = with_drawn_biases(jt.init_params(jc, jax.random.PRNGKey(seed)),
                           seed + 1)
    p = convert.lm_params_from_numpy(cfg, jax.tree.map(np.asarray, jp),
                                     device="cpu")
    return cfg, jc, jp, p


def model_inputs(cfg, batch, seed):
    """The frames (B, F, D) or patches (B, P, D) a model takes, normal x
    0.02, as {name: numpy array}."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, rows in (("frames", cfg.encoder_frames),
                       ("patches", cfg.patch_tokens)):
        if rows:
            out[name] = (rng.standard_normal((batch, rows, cfg.d_model))
                         * 0.02).astype(np.float32)
    return out


def jax_inputs(inputs):
    return {k: jnp.asarray(v) for k, v in inputs.items()}


def port_inputs(inputs):
    return {k: _t(v) for k, v in inputs.items()}


def jax_greedy(jc, jp, prompts, inputs, gen, max_len):
    """JAX's greedy tokens and, behind each, its logits' top-2 margin."""
    lg, state = jax.jit(lambda pp, t, x: jt.forward_prefill(
        jc, pp, t, max_len=max_len, **x))(jp, jnp.asarray(prompts),
                                          jax_inputs(inputs))
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


def state_from_jax(cfg, jstate):
    """A port ServeState from a contiguous JAX one: every cache and cross
    leaf stacked on a layer axis (JAX leaves a one-layer segment
    unstacked)."""
    def leaf(x, repeat):
        t = _t(np.asarray(x, np.float32)).to(
            torch.bfloat16 if x.dtype == jnp.bfloat16 else torch.float32)
        return t if repeat > 1 else t[None]

    segs = transformer.arch_segments(cfg)
    caches = [{name: kvcache.AttnCache(leaf(c.k, seg.repeat),
                                       leaf(c.v, seg.repeat))
               for name, c in jseg.items()}
              for seg, jseg in zip(segs, jstate.caches)]
    cross = [None if jx is None else
             {name: kvcache.CrossKV(leaf(k, seg.repeat), leaf(v, seg.repeat))
              for name, (k, v) in jx.items()}
             for seg, jx in zip(segs, jstate.cross)]
    return transformer.ServeState(caches=caches, cross=cross,
                                  pos=_t(np.asarray(jstate.pos)))


def backlog(cfg, lens, gens, seed):
    """Requests (tokens, max_new, inputs of one row) for an Engine."""
    rng = np.random.default_rng(seed)
    out = []
    for i, (n, g) in enumerate(zip(lens, gens)):
        toks = rng.integers(0, cfg.vocab_size, n, dtype=np.int32)
        one = {k: v[0] for k, v in model_inputs(cfg, 1, seed + i).items()}
        out.append((toks, g, one))
    return out


def jax_backlog_tokens(jc, jp, reqs, max_len):
    """Per request, JAX `serve()`'s tokens for it alone and the margins
    behind them."""
    out = []
    for toks, g, one in reqs:
        inputs = {k: v[None] for k, v in one.items()}
        want = np.asarray(jserve.serve(jc, jp, jnp.asarray(toks[None]),
                                       max_len=max_len, gen=g,
                                       **jax_inputs(inputs)))
        out.append((want, jax_greedy(jc, jp, toks[None], inputs, g,
                                     max_len)[1]))
    return out


ENGINES = {"contiguous": {},
           "paged": dict(paged=True, block_size=8),
           "paged_batched": dict(paged=True, block_size=8, prefill_batch=2)}


def run_engine(cfg, p, reqs, max_len, engine, slots=3):
    eng = scheduler.Engine(cfg, p, slots=slots, max_len=max_len,
                           device="cpu", **ENGINES[engine])
    for toks, g, one in reqs:
        eng.submit(toks, g, **one)
    while eng.busy():
        eng.step()
        if eng.paged:
            eng.allocator.check()
    if eng.paged:
        assert eng.stats()["blocks_in_use"] == 0
    return eng.drain(), eng


@pytest.fixture(scope="module")
def model():
    return crossing_model(ARCH)


# ---------------------------------------------------------------------------
# Pieces
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seq,dim,tol", [
    (24, 64, 1e-6), (7, 16, 1e-6),
    # full width: XLA's float32 exp rounds 27 of the 192 frequencies off
    # by one ulp (torch's 2), and position 1499 scales that ulp into the
    # angle: at most 1500 x 2^-23 apart
    (1500, 384, 1500 * 2 ** -23)])
def test_sinusoidal_positions_match_jax(seq, dim, tol):
    got = layers.sinusoidal_positions(seq, dim)
    want = jlayers.sinusoidal_positions(seq, dim)
    assert got.dtype == torch.float32 and tuple(got.shape) == (seq, dim)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=tol, rtol=0)


def test_params_follow_the_jax_schema_and_cross(model):
    """pos_embed, the encoder's stacked layers and final norm, and each
    decoder layer's ln_cross and cross (with its biases) cross leaf by
    leaf; the port's own init draws the same shapes."""
    cfg, _, jp, p = model
    np.testing.assert_array_equal(_np(p.pos_embed), np.asarray(
        jp["pos_embed"]))
    enc = p.encoder.segments[0].l0
    assert len(enc) == cfg.encoder_layers == 2
    jenc = jp["encoder"]["segments"][0]["l0"]
    np.testing.assert_array_equal(_np(enc[1].mixer.bk),
                                  np.asarray(jenc["mixer"]["bk"])[1])
    np.testing.assert_array_equal(_np(p.encoder.final_norm.bias),
                                  np.asarray(jp["encoder"]["final_norm"]
                                             ["bias"]))
    dec = p.segments[0].l0[1]
    np.testing.assert_array_equal(
        _np(dec.cross.bv), np.asarray(jp["segments"][0]["l0"]["cross"]
                                      ["bv"])[1])
    assert set(dict(dec.named_children())) == {"ln1", "mixer", "ln2", "ffn",
                                               "ln_cross", "cross"}
    own = transformer.init_params(cfg, torch.Generator().manual_seed(0),
                                  device="cpu")
    assert transformer.param_count(own) == transformer.param_count(p) == \
        sum(int(np.prod(x.shape)) for x in jax.tree.leaves(jp))
    assert not hasattr(own, "lm_head")              # tied embeddings


def test_run_encoder_matches_jax(model):
    cfg, jc, jp, p = model
    frames = model_inputs(cfg, 2, 1)["frames"]
    before = kernels.flash_attention.launches
    got = transformer.run_encoder(cfg, p, _t(frames))
    assert kernels.flash_attention.launches == before    # plain on the CPU
    want = jax.jit(lambda pp, f: jt.run_encoder(jc, pp, f))(
        jp, jnp.asarray(frames))
    assert tuple(got.shape) == (2, cfg.encoder_frames, cfg.d_model)
    _close(got, want, LOGIT_TOL)


def test_encoder_attention_is_not_causal(model):
    """The encoder's first frame sees the last: changing frame F - 1
    moves every row of the encoder output."""
    cfg, _, _, p = model
    frames = model_inputs(cfg, 1, 2)["frames"]
    base = transformer.run_encoder(cfg, p, _t(frames))
    frames[0, -1] += np.random.default_rng(3).standard_normal(
        cfg.d_model).astype(np.float32)      # not a constant: layernorm
    moved = transformer.run_encoder(cfg, p, _t(frames))
    assert float((moved - base)[0, 0].abs().max()) > 1e-4


def test_cross_mixer_matches_jax_at_prefill_and_decode(model):
    """Decoder layer 1's cross attention: at prefill over an encoder
    output (K and V written into the cross view, with their biases), at
    decode over that view, one query row."""
    cfg, jc, jp, p = model
    rng = np.random.default_rng(4)
    enc = rng.standard_normal((2, cfg.encoder_frames, cfg.d_model)).astype(
        np.float32)
    x = rng.standard_normal((2, 9, cfg.d_model)).astype(np.float32)
    jlp = jax.tree.map(lambda a: a[1], jp["segments"][0]["l0"]["cross"])
    lp = p.segments[0].l0[1].cross
    jout, (jk, jv) = jt.cross_mixer(jc, jlp, jnp.asarray(x),
                                    enc_out=jnp.asarray(enc))
    cross = kvcache.init_cross_kv(2, cfg.num_kv_heads, cfg.encoder_frames,
                                  cfg.resolved_head_dim, layers=1,
                                  device="cpu").layer(0)
    out = transformer.cross_mixer(cfg, lp, _t(x), cross=cross,
                                  enc_out=_t(enc))
    _close(out, jout, LOGIT_TOL)
    _close(cross.k, jk, LOGIT_TOL)
    _close(cross.v, jv, LOGIT_TOL)
    jout, _ = jt.cross_mixer(jc, jlp, jnp.asarray(x[:, :1]),
                             cross_kv=(jk, jv))
    out = transformer.cross_mixer(cfg, lp, _t(x[:, :1]), cross=cross)
    _close(out, jout, LOGIT_TOL)


# ---------------------------------------------------------------------------
# The model against JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("length_kind", ["none", "scalar", "vector"])
def test_prefill_and_decode_logits_match_jax(model, length_kind):
    """Prompts right-padded to 14 tokens where `length` is given; the
    cross keys and values and the caches equal JAX's; then decode
    steps."""
    cfg, jc, jp, p = model
    rng = np.random.default_rng(5)
    prompts = rng.integers(0, cfg.vocab_size, (2, 14), dtype=np.int32)
    inputs = model_inputs(cfg, 2, 5)
    length = {"none": None, "scalar": 11,
              "vector": np.array([9, 14], np.int32)}[length_kind]
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
    np.testing.assert_array_equal(pstate.pos.numpy(), np.asarray(jstate.pos))
    want = state_from_jax(cfg, jstate)
    _close(pstate.cross[0]["l0"].k, want.cross[0]["l0"].k, LOGIT_TOL)
    _close(pstate.cross[0]["l0"].v, want.cross[0]["l0"].v, LOGIT_TOL)
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


def test_decode_crosses_the_learned_positions_clamp(model):
    """A 120-token prompt and 16 decode steps: positions 120-135 run past
    the 128-row table, so the last eight steps read row 127, as the JAX
    `minimum(pos, max_positions - 1)` does."""
    cfg, jc, jp, p = model
    assert cfg.max_positions == 128
    max_len = 144
    rng = np.random.default_rng(6)
    prompts = rng.integers(0, cfg.vocab_size, (2, 120), dtype=np.int32)
    inputs = model_inputs(cfg, 2, 6)
    jlog, jstate = jax.jit(lambda pp, t, x: jt.forward_prefill(
        jc, pp, t, max_len=max_len, **x))(jp, jnp.asarray(prompts),
                                          jax_inputs(inputs))
    plog, pstate = transformer.forward_prefill(
        cfg, p, _t(prompts), max_len=max_len, **port_inputs(inputs))
    _close(plog, jlog, LOGIT_TOL)
    jdec = jax.jit(lambda pp, t, st: jt.forward_decode(jc, pp, t, st))
    tok = np.asarray(jnp.argmax(jlog[:, -1], -1))[:, None].astype(np.int32)
    for _ in range(16):
        jlog, jstate = jdec(jp, jnp.asarray(tok), jstate)
        plog, pstate = transformer.forward_decode(cfg, p, _t(tok), pstate)
        _close(plog, jlog, LOGIT_TOL)
        tok = np.asarray(jnp.argmax(jlog[:, -1], -1))[:, None].astype(
            np.int32)
    assert pstate.pos.tolist() == [136, 136]
    # past the table, a position's embedding is row 127's
    rows = transformer._embed_tokens(cfg, p,
                                     torch.zeros((2, 1), dtype=torch.int32),
                                     pos=torch.tensor([127, 300]))
    assert torch.equal(rows[0], rows[1])


def test_prefill_needs_frames(model):
    """JAX fails inside the encoder without frames; the port raises a
    ValueError that names them, and one for frames of another batch."""
    cfg, _, _, p = model
    toks = torch.zeros((2, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="needs frames"):
        transformer.forward_prefill(cfg, p, toks, max_len=MAX_LEN)
    with pytest.raises(ValueError, match="frames must be"):
        transformer.forward_prefill(
            cfg, p, toks, max_len=MAX_LEN,
            frames=torch.zeros((3, cfg.encoder_frames, cfg.d_model)))


@pytest.mark.parametrize("paged", [False, True])
def test_submit_refuses_a_request_without_its_frames(model, paged):
    """Frames missing or of another shape are refused at submit, before
    the request holds a slot or blocks, on either prefill route."""
    cfg, _, _, p = model
    kw = dict(paged=True, block_size=8, prefill_batch=2) if paged else {}
    eng = scheduler.Engine(cfg, p, slots=2, max_len=MAX_LEN, device="cpu",
                           **kw)
    toks = np.ones(4, np.int32)
    with pytest.raises(ValueError, match="needs frames"):
        eng.submit(toks, max_new=2)
    with pytest.raises(ValueError, match="frames must be"):
        eng.submit(toks, max_new=2, frames=np.zeros(
            (cfg.encoder_frames + 1, cfg.d_model), np.float32))
    assert not eng.queue and not eng.busy()
    eng.submit(toks, max_new=2, frames=np.zeros(
        (cfg.encoder_frames, cfg.d_model), np.float32))
    assert len(eng.drain()) == 1


def test_serve_greedy_tokens_match_jax(model):
    cfg, jc, jp, p = model
    rng = np.random.default_rng(7)
    prompts = rng.integers(0, cfg.vocab_size, (3, 16), dtype=np.int32)
    inputs = model_inputs(cfg, 3, 7)
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
    """One request prefilled into slot 2 of 4 (its cross keys and values
    spliced into that row), then masked decode steps with slots 1 and 2
    live, against JAX's mesh-free steps on the same zero state."""
    cfg, jc, jp, p = model
    rng = np.random.default_rng(8)
    toks = rng.integers(0, cfg.vocab_size, (1, 16), dtype=np.int32)
    inputs = model_inputs(cfg, 1, 8)
    jstate = jsteps.serve_state_zeros(jc, jp, 4, MAX_LEN)
    pstate = steps.serve_state_zeros(cfg, p, 4, MAX_LEN)
    assert tuple(pstate.cross[0]["l0"].k.shape) == tuple(
        jstate.cross[0]["l0"][0].shape) == (
        cfg.num_layers, 4, cfg.num_kv_heads, cfg.encoder_frames,
        cfg.resolved_head_dim)
    jpre = jax.jit(jsteps.make_slot_prefill_step(jc, max_len=MAX_LEN))
    batch = {"tokens": toks, **inputs}
    jlog, jstate = jpre(jp, jax_inputs(batch), jnp.asarray(11),
                        jnp.asarray(2), jstate)
    plog, pstate = steps.make_slot_prefill_step(cfg, max_len=MAX_LEN)(
        p, port_inputs(batch), 11, 2, pstate)
    _close(plog, jlog, LOGIT_TOL)
    want = state_from_jax(cfg, jstate)
    _close(pstate.cross[0]["l0"].k, want.cross[0]["l0"].k, LOGIT_TOL)
    assert float(pstate.cross[0]["l0"].k[:, [0, 1, 3]].abs().max()) == 0.0
    jdec = jax.jit(jsteps.make_masked_decode_step(jc))
    pdec = steps.make_masked_decode_step(cfg)
    active = np.array([False, True, True, False])
    tok = rng.integers(0, cfg.vocab_size, (4, 1), dtype=np.int32)
    for _ in range(3):
        jlog, jstate = jdec(jp, jnp.asarray(tok), jstate, jnp.asarray(active))
        plog, pstate = pdec(p, _t(tok), pstate, _t(active))
        _close(plog, jlog, LOGIT_TOL)
        tok = np.asarray(jnp.argmax(jlog[:, -1], -1))[:, None].astype(
            np.int32)
    assert pstate.pos.tolist() == np.asarray(jstate.pos).tolist() == \
        [0, 3, 14, 0]


def test_paged_steps_match_the_jax_paged_steps(model):
    """A batched paged prefill of two requests behind one dummy row (its
    frames zero) into slots 2 and 0, then paged decode steps, against
    JAX's paged steps jitted without a mesh."""
    cfg, jc, jp, p = model
    bs, nb, admit = 8, 16, 3
    mb = MAX_LEN // bs
    rng = np.random.default_rng(9)
    toks = rng.integers(0, cfg.vocab_size, (admit, 12), dtype=np.int32)
    toks[0] = 0
    inputs = model_inputs(cfg, admit, 9)
    inputs["frames"][0] = 0.0
    lengths = np.array([1, 12, 9], np.int32)
    slots = np.array([2, 2, 0], np.int32)
    tables = np.zeros((admit, mb), np.int32)
    tables[1, :2] = (5, 1)
    tables[2, :2] = (2, 9)
    jstate = jsteps.paged_serve_state_zeros(jc, jp, 4, MAX_LEN,
                                            block_size=bs, num_blocks=nb)
    pstate = steps.paged_serve_state_zeros(cfg, p, 4, MAX_LEN, block_size=bs,
                                           num_blocks=nb)
    assert isinstance(pstate.caches[0]["l0"], kvcache.PagedAttnCache)
    batch = {"tokens": toks, **inputs}
    jlog, jstate = jax.jit(jsteps.make_paged_prefill_step(
        jc, max_len=MAX_LEN, admit=admit))(
        jp, jax_inputs(batch), jnp.asarray(lengths), jnp.asarray(slots),
        jnp.asarray(tables), jstate)
    plog, pstate = steps.make_paged_prefill_step(
        cfg, max_len=MAX_LEN, admit=admit)(
        p, port_inputs(batch), _t(lengths), _t(slots), _t(tables), pstate)
    _close(plog, jlog, LOGIT_TOL)
    for slot, row in ((2, 1), (0, 2)):
        _close(pstate.cross[0]["l0"].v[:, slot],
               np.asarray(jstate.cross[0]["l0"][1])[:, slot], LOGIT_TOL)
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
        [12, 0, 15, 0]


@pytest.fixture(scope="module")
def whisper_backlog(model):
    """Five requests (prompts of 3-30 tokens, each with its own frames)
    and JAX `serve()`'s tokens for each alone."""
    cfg, jc, jp, _ = model
    reqs = backlog(cfg, [3, 17, 30, 9, 22], [6, 4, 8, 5, 7], seed=10)
    return reqs, jax_backlog_tokens(jc, jp, reqs, MAX_LEN)


@pytest.mark.parametrize("engine", list(ENGINES))
def test_engine_tokens_equal_jax_serve_per_request(model, whisper_backlog,
                                                   engine):
    """Three slots over five requests, each with its own frames: every
    request's tokens equal JAX `serve()` of that request alone, through
    the contiguous engine and the paged one (prefill_batch 1 and 2; the
    cross keys and values stay contiguous per slot)."""
    cfg, _, _, p = model
    reqs, expected = whisper_backlog
    results, eng = run_engine(cfg, p, reqs, MAX_LEN, engine)
    assert eng.trace_counts["decode"] == 1
    for r, (want, margins) in zip(results, expected, strict=True):
        assert_tokens_match(np.asarray(r.tokens)[None], want, margins)


def test_synth_request_stream_frames_equal_jax():
    """Frames drawn after each request's tokens, normal x 0.02, bit-equal
    to JAX's for the same seed."""
    cfg = cfgs.get_config(ARCH, smoke=True)
    got = scheduler.synth_request_stream(cfg, 7, seed=4)
    want = jsched.synth_request_stream(jcfgs.get_config(ARCH, smoke=True), 7,
                                       seed=4)
    for a, b in zip(got, want, strict=True):
        np.testing.assert_array_equal(a.tokens, b.tokens)
        assert (a.max_new, a.arrival) == (b.max_new, b.arrival)
        assert a.frames.dtype == np.float32
        assert a.frames.shape == (cfg.encoder_frames, cfg.d_model)
        np.testing.assert_array_equal(a.frames, b.frames)
        assert a.patches is None and b.patches is None


def test_serve_main_takes_the_arch(capsys):
    assert serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                       "--batch", "2", "--prompt-len", "16",
                       "--gen", "4"]) == 0
    assert "generated (2, 4)" in capsys.readouterr().out
    assert serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                       "--stream", "--paged", "--requests", "5", "--rate",
                       "1000", "--slots", "2", "--prefill-batch", "2",
                       "--block-size", "8"]) == 0
    assert "5 requests" in capsys.readouterr().out
