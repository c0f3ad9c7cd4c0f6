"""The port's Qwen 1.5 (`configs/qwen1p5_32b.py`: MHA with QKV bias,
rope_theta 1e6, an int8 KV cache) and its int4 variant against the JAX
package, on the CPU, through `models/transformer.py`, the serve steps,
both `Engine`s and the serve CLI; and `obs.torchhooks.profile_trace`
behind `serve.py --profile`.

Parameters are the JAX package's `init_params` with drawn QKV biases and
norm gains (`tests/test_torch_encdec.py::crossing_model`), carried
across as numpy; prompts are drawn with numpy. Tolerances, with their
reasons:
- logits: atol = rtol = 1e-4 (float32 products summed in another order);
  prefill attends over the float keys and values, so its logits do not
  depend on the cache's dtype;
- the prefill caches: a float32 key may differ from JAX's in its last
  bits, so a value within a hair of a rounding boundary may quantise to
  the neighbouring step. Payloads are equal except at values JAX puts
  within 1e-4 of a step's boundary (counted and bounded), and the
  dequantised caches lie within one step (the token's scale) of JAX's;
- greedy tokens under the margin rule of `tests/test_torch_ssm.py`.
"""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.launch import serve as jserve  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import kvcache as jkv  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro_torch.configs import base as cfgs  # noqa: E402
from repro_torch.launch import serve, steps  # noqa: E402
from repro_torch.models import kvcache, transformer  # noqa: E402
from repro_torch.obs import registry, torchhooks  # noqa: E402
from test_torch_encdec import (ENGINES, backlog, crossing_model,  # noqa: E402
                               jax_backlog_tokens, jax_greedy, run_engine)
from test_torch_ssm import (LOGIT_TOL, _close, _np, _t,  # noqa: E402
                            assert_tokens_match)

ARCH = "qwen1p5_32b"
MAX_LEN = 48
QUANTS = ["int8", "int4"]
QDTYPE = {"int8": jnp.int8, "int4": jnp.int4}
BOUNDARY = 1e-4


@pytest.fixture(scope="module")
def model():
    return crossing_model(ARCH, seed=3)


def with_quant(model, quant):
    """The model's port and JAX configs with `kv_cache_dtype=quant`."""
    cfg, jc, jp, p = model
    return (dataclasses.replace(cfg, kv_cache_dtype=quant),
            dataclasses.replace(jc, kv_cache_dtype=quant), jp, p)


def test_config_is_the_jax_packages_mha_with_an_int8_cache():
    cfg = cfgs.get_config(ARCH)
    assert cfgs.ARCH_IDS[5] == ARCH and cfgs.get_config("qwen1p5-32b") == cfg
    assert (cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim) == \
        (40, 40, 128)
    assert cfg.qkv_bias and cfg.rope_theta == 1e6
    assert cfg.kv_cache_dtype == "int8"
    assert cfgs.get_config(ARCH, smoke=True).kv_cache_dtype == "int8"


@pytest.mark.parametrize("quant", QUANTS)
def test_prefill_logits_and_quantised_caches_match_jax(model, quant):
    """Prefill of 2 x 20 tokens: logits within 1e-4 of JAX's; the int8 or
    int4 caches (payloads, scales) against JAX's, with JAX's keys and
    values before quantisation read back through a debug callback to
    find the values that lie on a rounding boundary."""
    cfg, jc, jp, p = with_quant(model, quant)
    rng = np.random.default_rng(1)
    prompts = rng.integers(0, cfg.vocab_size, (2, 20), dtype=np.int32)
    seen = []
    quantize = jkv._quantize

    def spy(x, qdtype=jnp.int8):
        jax.debug.callback(lambda a: seen.append(np.asarray(a)), x,
                           ordered=True)
        return quantize(x, qdtype)
    jkv._quantize = spy
    try:
        jlog, jstate = jax.jit(lambda pp, t: jt.forward_prefill(
            jc, pp, t, max_len=MAX_LEN))(jp, jnp.asarray(prompts))
        jax.effects_barrier()
    finally:
        jkv._quantize = quantize
    plog, pstate = transformer.forward_prefill(cfg, p, _t(prompts),
                                               max_len=MAX_LEN)
    _close(plog, jlog, LOGIT_TOL)
    pc, jcache = pstate.caches[0]["l0"], jstate.caches[0]["l0"]
    assert pc.quant == quant
    width = cfg.resolved_head_dim // (2 if quant == "int4" else 1)
    assert tuple(pc.k.shape) == (cfg.num_layers, 2, cfg.num_kv_heads,
                                 MAX_LEN, width)
    assert tuple(pc.k_scale.shape) == (cfg.num_layers, 2,
                                       cfg.num_kv_heads, MAX_LEN, 1)
    assert len(seen) == 2 * cfg.num_layers      # k and v of each layer
    qmax = kvcache.QMAX[quant]
    flips = 0
    for li in range(cfg.num_layers):
        for name, x in (("k", seen[2 * li]), ("v", seen[2 * li + 1])):
            got = getattr(pc, name)[li]
            got = (kvcache.unpack_int4(got) if quant == "int4"
                   else got).numpy()[:, :, :20]
            want = np.asarray(getattr(jcache, name)[li]).astype(
                np.int8)[:, :, :20]
            scale = np.asarray(getattr(jcache, name + "_scale")[li])[
                :, :, :20]
            pscale = getattr(pc, name + "_scale")[li].numpy()[:, :, :20]
            np.testing.assert_allclose(pscale, scale, rtol=1e-5, atol=0)
            ratio = x / scale
            near = np.abs(np.abs(ratio - np.floor(ratio)) - 0.5) < BOUNDARY
            near |= np.abs(np.abs(ratio) - qmax) < BOUNDARY
            differ = got != want
            assert not (differ & ~near).any(), (li, name)
            assert (np.abs(got.astype(int) - want) <= 1).all()
            flips += int(differ.sum())
            deq = got * pscale - want * scale
            assert (np.abs(deq) <= scale * (1 + 1e-6)).all()
    # a flip needs a float32 key within a hair of a boundary: none in
    # these 2 x 20 tokens (2 layers, k and v, 4 heads of 16) for either
    # dtype; a few would still be sound
    assert flips <= 4, flips


@pytest.mark.parametrize("quant", QUANTS)
def test_serve_greedy_tokens_match_jax(model, quant):
    """Greedy tokens of 3 x 16 prompts for 12 steps equal JAX `serve()`'s
    (decode reads the dequantised cache in both packages)."""
    cfg, jc, jp, p = with_quant(model, quant)
    rng = np.random.default_rng(7)
    prompts = rng.integers(0, cfg.vocab_size, (3, 16), dtype=np.int32)
    gen = 12
    want = np.asarray(jserve.serve(jc, jp, jnp.asarray(prompts),
                                   max_len=MAX_LEN, gen=gen))
    toks, margins = jax_greedy(jc, jp, prompts, {}, gen, MAX_LEN)
    assert np.array_equal(toks, want)
    got = serve.serve(cfg, p, _t(prompts), max_len=MAX_LEN, gen=gen).numpy()
    assert got.shape == want.shape == (3, gen)
    assert_tokens_match(got, want, margins)


@pytest.mark.parametrize("quant", QUANTS)
def test_slot_prefill_carries_the_scales_and_decode_matches_jax(model,
                                                                quant):
    """One request prefilled into slot 2 of 4 (`write_state_slot` moves
    its payload and scale rows into that row only), then masked decode
    steps with slots 1 and 2 live, against JAX's mesh-free steps on the
    same zero state."""
    cfg, jc, jp, p = with_quant(model, quant)
    rng = np.random.default_rng(8)
    toks = rng.integers(0, cfg.vocab_size, (1, 16), dtype=np.int32)
    jstate = jsteps.serve_state_zeros(jc, jp, 4, MAX_LEN)
    pstate = steps.serve_state_zeros(cfg, p, 4, MAX_LEN)
    c = pstate.caches[0]["l0"]
    assert c.quant == quant
    assert tuple(c.v_scale.shape) == tuple(
        jstate.caches[0]["l0"].v_scale.shape)
    jlog, jstate = jax.jit(jsteps.make_slot_prefill_step(jc, max_len=MAX_LEN))(
        jp, {"tokens": jnp.asarray(toks)}, jnp.asarray(11), jnp.asarray(2),
        jstate)
    plog, pstate = steps.make_slot_prefill_step(cfg, max_len=MAX_LEN)(
        p, {"tokens": _t(toks)}, 11, 2, pstate)
    _close(plog, jlog, LOGIT_TOL)
    one = transformer.forward_prefill(cfg, p, _t(toks), max_len=MAX_LEN,
                                      length=11)[1].caches[0]["l0"]
    for name in ("k", "v", "k_scale", "v_scale"):
        full, row = getattr(c, name), getattr(one, name)
        assert torch.equal(full[:, 2:3], row), name
        assert float(full[:, [0, 1, 3]].abs().max()) == 0, name
    _close(c.k_scale, jstate.caches[0]["l0"].k_scale, 1e-6)
    jdec = jax.jit(jsteps.make_masked_decode_step(jc))
    pdec = steps.make_masked_decode_step(cfg)
    active = np.array([False, True, True, False])
    tok = rng.integers(0, cfg.vocab_size, (4, 1), dtype=np.int32)
    for _ in range(3):
        jlog, jstate = jdec(jp, jnp.asarray(tok), jstate, jnp.asarray(active))
        plog, pstate = pdec(p, _t(tok), pstate, _t(active))
        _close(plog[[1, 2]], np.asarray(jlog)[[1, 2]], LOGIT_TOL)
        tok = np.asarray(jnp.argmax(jlog[:, -1], -1))[:, None].astype(
            np.int32)
    assert pstate.pos.tolist() == np.asarray(jstate.pos).tolist() == \
        [0, 3, 14, 0]


@pytest.mark.parametrize("quant", QUANTS)
def test_paged_prefill_scatters_the_scales_and_steps_match_jax(model,
                                                               quant):
    """A batched paged prefill of two requests behind one dummy row into
    slots 2 and 0 (`write_paged_state_slot` scatters payloads and scales
    into their blocks), then paged decode steps, against JAX's paged
    steps jitted without a mesh."""
    cfg, jc, jp, p = with_quant(model, quant)
    bs, nb, admit = 8, 16, 3
    mb = MAX_LEN // bs
    rng = np.random.default_rng(9)
    toks = rng.integers(0, cfg.vocab_size, (admit, 12), dtype=np.int32)
    toks[0] = 0
    lengths = np.array([1, 12, 9], np.int32)
    slots = np.array([2, 2, 0], np.int32)
    tables = np.zeros((admit, mb), np.int32)
    tables[1, :2] = (5, 1)
    tables[2, :2] = (2, 9)
    jstate = jsteps.paged_serve_state_zeros(jc, jp, 4, MAX_LEN,
                                            block_size=bs, num_blocks=nb)
    pstate = steps.paged_serve_state_zeros(cfg, p, 4, MAX_LEN, block_size=bs,
                                           num_blocks=nb)
    pool = pstate.caches[0]["l0"]
    assert isinstance(pool, kvcache.PagedAttnCache) and pool.quant == quant
    assert tuple(pool.k_scale.shape) == (cfg.num_layers, cfg.num_kv_heads,
                                         nb, bs, 1)
    jlog, jstate = jax.jit(jsteps.make_paged_prefill_step(
        jc, max_len=MAX_LEN, admit=admit))(
        jp, {"tokens": jnp.asarray(toks)}, jnp.asarray(lengths),
        jnp.asarray(slots), jnp.asarray(tables), jstate)
    plog, pstate = steps.make_paged_prefill_step(
        cfg, max_len=MAX_LEN, admit=admit)(
        p, {"tokens": _t(toks)}, _t(lengths), _t(slots), _t(tables), pstate)
    _close(plog, jlog, LOGIT_TOL)
    # request 1's scale rows sit in its blocks 5 and 1, as JAX puts them
    one = transformer.forward_prefill(cfg, p, _t(toks[1:2]), max_len=MAX_LEN,
                                      length=12)[1].caches[0]["l0"]
    for blk, lo in ((5, 0), (1, bs)):
        assert torch.equal(pool.v_scale[:, :, blk],
                           one.v_scale[:, 0, :, lo:lo + bs])
    _close(pool.k_scale[:, :, 1:], np.asarray(
        jstate.caches[0]["l0"].k_scale)[:, :, 1:], 1e-6)
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
def qwen_backlog(model):
    """Five requests (prompts of 3-30 tokens) and JAX `serve()`'s tokens
    for each alone, int8 cache."""
    cfg, jc, jp, _ = model
    reqs = backlog(cfg, [3, 17, 30, 9, 22], [6, 4, 8, 5, 7], seed=10)
    return reqs, jax_backlog_tokens(jc, jp, reqs, MAX_LEN)


@pytest.mark.parametrize("engine", list(ENGINES))
def test_engine_tokens_equal_jax_serve_per_request(model, qwen_backlog,
                                                   engine):
    """Three slots over five requests on the int8 cache: every request's
    tokens equal JAX `serve()` of it alone, through the contiguous engine
    and the paged one (prefill_batch 1 and 2), so the paged tokens equal
    the contiguous ones."""
    cfg, _, _, p = model
    reqs, expected = qwen_backlog
    results, eng = run_engine(cfg, p, reqs, MAX_LEN, engine)
    assert eng.trace_counts["decode"] == 1
    c = eng.state.caches[0]["l0"]
    assert c.quant == "int8" and c.k_scale is not None
    for r, (want, margins) in zip(results, expected, strict=True):
        assert_tokens_match(np.asarray(r.tokens)[None], want, margins)


def test_int4_paged_engine_equals_the_contiguous_one(model):
    """The int4 cache through both engines: the same tokens request for
    request, an int4 pool of half the int8 payload's bytes."""
    cfg, _, _, p = with_quant(model, "int4")
    reqs = backlog(cfg, [3, 17, 30, 9, 22], [6, 4, 8, 5, 7], seed=11)
    contiguous, _ = run_engine(cfg, p, reqs, MAX_LEN, "contiguous")
    paged, eng = run_engine(cfg, p, reqs, MAX_LEN, "paged_batched")
    assert [r.tokens for r in paged] == [r.tokens for r in contiguous]
    pool = eng.state.caches[0]["l0"]
    assert pool.quant == "int4"
    assert pool.k.shape[-1] * 2 == cfg.resolved_head_dim


def test_serve_main_runs_qwen(capsys, tmp_path):
    """`serve.py --arch qwen1p5_32b --smoke --device cpu`, plain and with
    `--stream --paged`, the second with `--profile` and `--metrics-out`:
    a trace file, and a metrics file (no device gauge on the CPU)."""
    assert serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                       "--batch", "2", "--prompt-len", "16",
                       "--gen", "4"]) == 0
    assert "generated (2, 4)" in capsys.readouterr().out
    trace, metrics = tmp_path / "trace", tmp_path / "METRICS.json"
    assert serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                       "--stream", "--paged", "--requests", "5", "--rate",
                       "1000", "--slots", "2", "--prefill-batch", "2",
                       "--block-size", "8", "--profile", str(trace),
                       "--metrics-out", str(metrics)]) == 0
    assert "5 requests" in capsys.readouterr().out
    files = list(trace.glob("trace_*.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any("aten::" in str(e.get("name", "")) for e in events)
    doc = registry.load_metrics(metrics)
    assert not any(k.startswith("torch.cuda") for k in doc["gauges"])


def test_profile_trace_is_a_no_op_when_off(tmp_path):
    for log_dir, enabled in ((None, True), ("", True),
                             (tmp_path / "off", False)):
        with torchhooks.profile_trace(log_dir, enabled=enabled) as prof:
            torch.ones(4).sum()
        assert prof is None
    assert not (tmp_path / "off").exists()
    with torchhooks.profile_trace(tmp_path / "on") as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert any(e.key == "aten::mm" for e in prof.key_averages())
    assert len(list((tmp_path / "on").glob("trace_*.json"))) == 1


def test_record_device_memory_records_no_gauge_on_the_cpu():
    """A no-op with the recorder off; on, it sets the three gauges of each
    visible CUDA device, none on a machine without one."""
    torchhooks.record_device_memory()             # recorder off: no-op
    with registry.recording() as rec:
        torchhooks.record_device_memory(rec)
        names = set(rec.snapshot()["gauges"])
    if torch.cuda.is_available():
        assert "torch.cuda0.bytes_allocated" in names
    else:
        assert not names
