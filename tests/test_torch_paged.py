"""The port's paged KV cache and paged `Engine` against the JAX package, on
the CPU.

The paged cache functions are held bit for bit against the JAX pure
functions (`repro/models/kvcache.py`), the block allocator against the
JAX allocator on random alloc/free traces, and the paged steps against
the JAX paged steps jitted without a mesh. The JAX `Engine` itself does
not run in every JAX this repo meets, so the paged engine is held token
for token against the port's own contiguous `Engine` and JAX `serve()`,
under pools small enough to force backpressure, with the allocator's
invariants checked after every step.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

try:
    from hypothesis import given, settings
    from hypothesis import strategies as st
except ImportError:          # minimal containers: seeded deterministic shim
    from _hypothesis_compat import given, settings  # noqa: E402
    from _hypothesis_compat import strategies as st  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.launch import steps as jsteps  # noqa: E402
from repro.models import kvcache as jkv  # noqa: E402
from repro_torch.launch import scheduler, serve, steps  # noqa: E402
from repro_torch.models import kvcache, transformer  # noqa: E402
from test_torch_lm import (LOGIT_TOL, MAX_LEN, OWN_STATE_TOL, _np,  # noqa: E402
                           _t, llama)

HKV, HD = 2, 8


def bf16_pair(a):
    """The same bf16 values on both sides, from float32 numpy."""
    return jnp.asarray(a, jnp.bfloat16), torch.from_numpy(a).to(torch.bfloat16)


def pools(seed, nb, bs, stack=None):
    rng = np.random.default_rng(seed)
    shape = (HKV, nb, bs, HD) if stack is None else (stack, HKV, nb, bs, HD)
    k, v = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    (jk, pk), (jv, pv) = bf16_pair(k), bf16_pair(v)
    return (jkv.PagedAttnCache(jk, jv, None, None),
            kvcache.PagedAttnCache(pk, pv))


def assert_pool_equal(pc, jc):
    np.testing.assert_array_equal(_np(pc.k), _np(jc.k))
    np.testing.assert_array_equal(_np(pc.v), _np(jc.v))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_paged_write_and_gather_are_bit_equal_to_jax(seed):
    nb, bs, b, mb = 9, 4, 5, 3
    jc, pc = pools(seed, nb, bs)
    rng = np.random.default_rng(10 + seed)
    # distinct (block, offset) pairs: a scatter's winner among duplicates
    # is unspecified on both sides
    flat = rng.choice(np.arange(bs, nb * bs), size=b, replace=False)
    block, offset = (flat // bs).astype(np.int32), (flat % bs).astype(
        np.int32)
    kn, vn = (rng.standard_normal((b, HKV, 1, HD)).astype(np.float32)
              for _ in range(2))
    jc = jkv.paged_cache_write_at(jc, jnp.asarray(kn), jnp.asarray(vn),
                                  jnp.asarray(block), jnp.asarray(offset))
    out = kvcache.paged_cache_write_at(pc, _t(kn), _t(vn), _t(block),
                                       _t(offset))
    assert out is pc                             # in place
    assert_pool_equal(pc, jc)
    table = rng.integers(0, nb, (b, mb)).astype(np.int32)
    jk, jv = jkv.paged_gather(jc, jnp.asarray(table))
    pk, pv = kvcache.paged_gather(pc, _t(table))
    assert tuple(pk.shape) == (b, HKV, mb * bs, HD) == jk.shape
    assert pk.dtype == torch.bfloat16
    # laid out as a contiguous cache's layer view: the decode attention's
    # products then take the same route on the card (bit-equal tokens)
    assert pk.is_contiguous() and pv.is_contiguous()
    np.testing.assert_array_equal(_np(pk), _np(jk))
    np.testing.assert_array_equal(_np(pv), _np(jv))


@pytest.mark.parametrize("stack", [None, 3])
def test_paged_scatter_is_bit_equal_to_jax(stack):
    nb, bs, mb = 10, 4, 4
    jc, pc = pools(5, nb, bs, stack)
    rng = np.random.default_rng(6)
    lead = () if stack is None else (stack,)
    k1, v1 = (rng.standard_normal((*lead, 1, HKV, mb * bs, HD)).astype(
        np.float32) for _ in range(2))
    (jk1, pk1), (jv1, pv1) = bf16_pair(k1), bf16_pair(v1)
    # two live blocks, the rest of the row null: only block 0 collides
    table_row = np.array([7, 3, 0, 0], np.int32)
    jc = jkv.paged_scatter_attn(jc, jkv.AttnCache(jk1, jv1, None, None),
                                jnp.asarray(table_row))
    kvcache.paged_scatter_attn(pc, kvcache.AttnCache(pk1, pv1),
                               _t(table_row))
    for got, want in ((pc.k, jc.k), (pc.v, jc.v)):
        got, want = _np(got), _np(want)
        np.testing.assert_array_equal(got[..., 1:, :, :],
                                      want[..., 1:, :, :])
    # the live blocks hold the slot's first two logical blocks
    np.testing.assert_array_equal(
        _np(pc.k)[..., 7, :, :], _np(pk1).reshape(*lead, HKV, mb, bs,
                                                  HD)[..., 0, :, :])


def test_paged_pool_layout_and_unported_pools():
    c = kvcache.init_paged_attn_cache(2, 6, 4, 8, stack=3, device="cpu")
    assert tuple(c.k.shape) == (3, 2, 6, 4, 8) and c.k.dtype == torch.bfloat16
    lay = c.layer(1)
    lay.k[0, 2, 1, 0] = 1.0
    assert float(c.k[1, 0, 2, 1, 0]) == 1.0      # a view of the stack
    # the int8 pool is ported (`test_torch_kvquant.py` holds it to JAX):
    # int8 payloads, float32 scales a token, views that keep them
    q = kvcache.init_paged_attn_cache(2, 6, 4, 8, "int8", stack=3,
                                      device="cpu")
    assert tuple(q.k.shape) == (3, 2, 6, 4, 8) and q.k.dtype == torch.int8
    assert tuple(q.k_scale.shape) == (3, 2, 6, 4, 1)
    assert q.layer(1).v_scale.data_ptr() == q.v_scale[1].data_ptr()
    # the paged MLA pool is ported (`test_torch_mla.py` holds it to JAX):
    # float32 latents, bf16 rotary keys, stacked views, the card by default
    m = kvcache.init_paged_mla_cache(6, 4, 16, 8, stack=3, device="cpu")
    assert tuple(m.ckv.shape) == (3, 6, 4, 16) and m.ckv.dtype == torch.float32
    assert tuple(m.krope.shape) == (3, 6, 4, 8)
    assert m.krope.dtype == torch.bfloat16
    m.layer(2).ckv[5, 3, 0] = 2.0
    assert float(m.ckv[2, 5, 3, 0]) == 2.0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            kvcache.init_paged_mla_cache(6, 4, 16, 8)


@settings(deadline=None, max_examples=60)
@given(st.integers(0, 10 ** 9), st.integers(2, 24), st.integers(1, 60))
def test_block_allocator_equals_jax_on_random_traces(seed, num_blocks, ops):
    rng = np.random.default_rng(seed)
    a, ja = kvcache.BlockAllocator(num_blocks), jkv.BlockAllocator(num_blocks)
    live = []
    for _ in range(ops):
        if live and rng.random() < 0.4:
            blocks = live.pop(int(rng.integers(len(live))))
            a.free(blocks)
            ja.free(blocks)
        else:
            n = int(rng.integers(1, max(2, num_blocks // 2) + 1))
            got, want = a.alloc(n), ja.alloc(n)
            assert got == want
            if got is not None:
                live.append(got)
        assert (a.used, a.free_blocks, a.peak) == \
            (ja.used, ja.free_blocks, ja.peak)
        a.check()
        ja.check()
        assert 0 not in {b for blocks in live for b in blocks}
    for blocks in live:
        a.free(blocks)
    assert a.used == 0 and a.free_blocks == num_blocks - 1
    a.check()


def test_block_allocator_rejects_what_jax_rejects():
    for n in (0, 1):
        with pytest.raises(ValueError, match="num_blocks"):
            kvcache.BlockAllocator(n)
    a = kvcache.BlockAllocator(4)
    with pytest.raises(ValueError, match="n >= 1"):
        a.alloc(0)
    got = a.alloc(2)
    assert got == [1, 2] and a.alloc(2) is None     # backpressure
    a.free(got)
    with pytest.raises(ValueError, match="double free"):
        a.free(got)
    a._free.append(0)
    with pytest.raises(AssertionError, match="null block"):
        a.check()


def test_paged_steps_match_the_jax_paged_steps(llama):
    """A batched prefill of two requests (one dummy row first) into
    slots 2 and 0, then paged decode steps, against JAX's paged steps
    jitted without a mesh."""
    cfg, jc, p, jp = llama["cfg"], llama["jc"], llama["p"], llama["jp"]
    bs, nb, admit = 8, 16, 3
    mb = MAX_LEN // bs
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg.vocab_size, (admit, 12), dtype=np.int32)
    toks[0] = 0                                    # the dummy row
    lengths = np.array([1, 12, 9], np.int32)
    slots = np.array([2, 2, 0], np.int32)
    tables = np.zeros((admit, mb), np.int32)
    tables[1, :2] = (5, 1)
    tables[2, :2] = (2, 9)
    jstate = jsteps.paged_serve_state_zeros(jc, jp, 4, MAX_LEN,
                                            block_size=bs, num_blocks=nb)
    pstate = steps.paged_serve_state_zeros(cfg, p, 4, MAX_LEN, block_size=bs,
                                           num_blocks=nb)
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
    np.testing.assert_array_equal(pstate.pos.numpy(), np.asarray(jstate.pos))
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
        np.testing.assert_allclose(_np(plog), _np(jlog), atol=OWN_STATE_TOL,
                                   rtol=OWN_STATE_TOL)
        tok = np.asarray(jnp.argmax(jlog[:, -1], -1))[:, None].astype(
            np.int32)
    assert pstate.pos.tolist() == np.asarray(jstate.pos).tolist() == \
        [12, 0, 15, 0]
    # the live blocks (not the null block 0) hold the same keys
    live = sorted({5, 1, 2, 9})
    for seg_p, seg_j in zip(pstate.caches, jstate.caches):
        for name in seg_p:
            got, want = _np(seg_p[name].k), _np(seg_j[name].k)
            np.testing.assert_allclose(got[:, :, live], want[:, :, live],
                                       atol=2 ** -6, rtol=2 ** -7)


def run_engine(llama, **kw):
    """Drain llama["reqs"] through an Engine on the CPU, checking the
    allocator after every step; returns (tokens per request, engine)."""
    eng = scheduler.Engine(llama["cfg"], llama["p"], slots=4,
                           max_len=MAX_LEN, device="cpu", **kw)
    for r in llama["reqs"]:
        eng.submit(r.tokens, r.max_new)
    while eng.busy():
        eng.step()
        if eng.paged:
            eng.allocator.check()
            assert eng.allocator.used <= eng.num_blocks - 1
    return [r.tokens for r in eng.drain()], eng


@pytest.mark.parametrize("prefill_batch", [1, 3])
@pytest.mark.parametrize("num_blocks", [None, 8])
def test_paged_engine_tokens_equal_contiguous_and_jax_serve(
        llama, prefill_batch, num_blocks):
    want, contiguous = run_engine(llama)
    assert want == llama["want"]                 # JAX serve(), per request
    got, eng = run_engine(llama, paged=True, block_size=8,
                          num_blocks=num_blocks, prefill_batch=prefill_batch)
    assert got == want
    stt = eng.stats()
    assert stt["paged"] and stt["block_size"] == 8
    assert stt["blocks_in_use"] == 0 and eng.allocator.free_blocks == \
        eng.num_blocks - 1                       # every block returned
    assert stt["peak_blocks"] <= eng.num_blocks - 1
    assert stt["requests"] == len(llama["reqs"])
    assert eng.trace_counts["decode"] == 1
    if num_blocks is None:
        assert eng.num_blocks == 4 * (MAX_LEN // 8) + 1
    else:
        # 7 usable blocks hold at most two of these requests at once:
        # the pool, not the slots, bounds admission
        assert stt["peak_active"] < 4 and stt["peak_blocks"] <= 7
        assert stt["decode_steps"] > contiguous.stats()["decode_steps"]


def test_batched_prefill_groups_same_bucket_heads(llama):
    """Equal-length prompts are prefilled in groups of prefill_batch, one
    launch a group; the tokens equal the batch-1 engine's."""
    cfg = llama["cfg"]
    rng = np.random.default_rng(8)
    prompts = [rng.integers(0, cfg.vocab_size, 10) for _ in range(7)]

    def run(**kw):
        eng = scheduler.Engine(cfg, llama["p"], slots=4, max_len=MAX_LEN,
                               device="cpu", **kw)
        for t in prompts:
            eng.submit(t, 5)
        return [r.tokens for r in eng.drain()], eng

    want, one = run(paged=True, block_size=8)
    got, eng = run(paged=True, block_size=8, prefill_batch=3)
    assert got == want
    assert one.prefill_launches == 7
    # 4 slots: a group of 3, a group of 1 (the free slot), then 3 as the
    # first four drain together
    assert eng.prefill_launches == 3
    assert eng.trace_counts["prefill_10"] == 1


def test_paged_engine_refuses_what_the_jax_engine_refuses(llama):
    cfg, p = llama["cfg"], llama["p"]
    with pytest.raises(ValueError, match="paged=True"):
        scheduler.Engine(cfg, p, prefill_batch=2, device="cpu")
    with pytest.raises(ValueError, match="multiple of block_size"):
        scheduler.Engine(cfg, p, max_len=40, paged=True, block_size=16,
                         device="cpu")
    with pytest.raises(ValueError, match="worst-case"):
        scheduler.Engine(cfg, p, max_len=48, paged=True, block_size=8,
                         num_blocks=6, device="cpu")
    with pytest.raises(ValueError, match="block_size"):
        scheduler.Engine(cfg, p, paged=True, block_size=0, device="cpu")
    eng = scheduler.Engine(cfg, p, slots=2, max_len=48, paged=True,
                           block_size=8, num_blocks=7, prefill_batch=9,
                           device="cpu")
    assert eng.prefill_batch == 2                # capped at the slots
    st_ = eng.stats()
    assert (st_["paged"], st_["num_blocks"], st_["blocks_in_use"],
            st_["peak_blocks"]) == (True, 7, 0, 0)


def test_serve_main_runs_the_paged_stream(capsys):
    rc = serve.main(["--arch", "llama3p2_3b", "--smoke", "--device", "cpu",
                     "--stream", "--requests", "6", "--rate", "1000",
                     "--slots", "2", "--prompt-len", "12", "--gen", "5",
                     "--paged", "--block-size", "8", "--num-blocks", "4",
                     "--prefill-batch", "2"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "6 requests" in out and "paged: peak" in out
    assert "/4 blocks of 8" in out


def test_decode_refuses_tables_that_do_not_fit_the_state(llama):
    cfg, p = llama["cfg"], llama["p"]
    tok = torch.zeros((2, 1), dtype=torch.int32)
    contiguous = steps.serve_state_zeros(cfg, p, 2, 16)
    with pytest.raises(ValueError, match="contiguous"):
        transformer.forward_decode(cfg, p, tok, contiguous,
                                   block_tables=torch.zeros((2, 2)))
    paged = steps.paged_serve_state_zeros(cfg, p, 2, 16, block_size=8,
                                          num_blocks=5)
    with pytest.raises(ValueError, match="block_tables"):
        transformer.forward_decode(cfg, p, tok, paged)
