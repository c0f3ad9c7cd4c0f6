"""The port's quantised KV cache (`models/kvcache.py`, int8 and int4, the
contiguous cache and the paged pool) against the JAX package, on the CPU.

Inputs are drawn with numpy and carried to both sides. Every comparison
is exact: the quantiser is float32 max, divide, round-half-even and clip
in both packages, and a dequantised read is one float32 product rounded
to the read's dtype. The port stores an int4 payload two values a byte
(`pack_int4`); it is compared unpacked with JAX's int4 array read as
int8.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.models import kvcache as jkv  # noqa: E402
from repro_torch.models import kvcache  # noqa: E402

QDTYPE = {"int8": jnp.int8, "int4": jnp.int4}
QUANTS = ["int8", "int4"]
B, HKV, W, HD = 2, 3, 12, 16


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    return x.detach().float().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _payload(cache):
    """A port cache's payload as one int8 value an element."""
    return (kvcache.unpack_int4(cache.k) if cache.quant == "int4"
            else cache.k).numpy(), \
        (kvcache.unpack_int4(cache.v) if cache.quant == "int4"
         else cache.v).numpy()


def _jpayload(jc):
    return np.asarray(jc.k).astype(np.int8), np.asarray(jc.v).astype(np.int8)


def _assert_same_cache(pc, jc):
    for got, want in zip(_payload(pc), _jpayload(jc)):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(pc.k_scale.numpy(), np.asarray(jc.k_scale))
    np.testing.assert_array_equal(pc.v_scale.numpy(), np.asarray(jc.v_scale))


def _kv(seed, shape, scale=1.0):
    rng = np.random.default_rng(seed)
    return ((rng.standard_normal(shape) * scale).astype(np.float32),
            (rng.standard_normal(shape) * scale).astype(np.float32))


@pytest.mark.parametrize("quant", QUANTS)
@pytest.mark.parametrize("scale", [1.0, 1e-3, 40.0])
def test_quantize_equals_jax_exactly(quant, scale):
    """Payload and scale bit-equal to the JAX `_quantize` (rows of zeros
    included: their scale is the 1e-8 floor)."""
    x = _kv(0, (4, 5, 33, 128), scale)[0]
    x[0, 0, :3] = 0.0
    q, s = kvcache._quantize(_t(x), quant)
    jq, js = jkv._quantize(jnp.asarray(x), QDTYPE[quant])
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert tuple(s.shape) == (4, 5, 33, 1)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq).astype(np.int8))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert int(q.abs().max()) <= kvcache.QMAX[quant]


@pytest.mark.parametrize("quant", QUANTS)
def test_quantized_cache_roundtrip_error_bound(quant):
    """|dequantised - x| <= half a step of the token's scale, the JAX
    package's own bound (`tests/test_perf_features.py`)."""
    k, v = _kv(1, (B, HKV, 3, HD))
    c = kvcache.init_attn_cache(B, HKV, W, HD, quant, device="cpu")
    kvcache.cache_write(c, _t(k), _t(v), torch.arange(3))
    kf, vf = kvcache.cache_read(c, dtype=torch.float32)
    for got, x in ((kf, k), (vf, v)):
        step = np.abs(x).max(-1, keepdims=True) / kvcache.QMAX[quant]
        err = np.abs(got[:, :, :3].numpy() - x)
        assert (err <= 0.5 * step + 1e-6).all()


def test_pack_int4_round_trips_every_nibble_pair():
    """All 256 (even, odd) pairs of 4-bit values pack into one byte each
    and unpack to themselves, signs extended."""
    vals = np.arange(-8, 8, dtype=np.int8)
    pairs = np.stack(np.meshgrid(vals, vals, indexing="ij"), -1)
    q = _t(pairs.reshape(-1, 2))
    p = kvcache.pack_int4(q)
    assert p.dtype == torch.int8 and tuple(p.shape) == (256, 1)
    assert len(set(p.flatten().tolist())) == 256
    np.testing.assert_array_equal(kvcache.unpack_int4(p).numpy(),
                                  pairs.reshape(-1, 2))


@pytest.mark.parametrize("quant", QUANTS)
def test_cache_write_write_at_and_read_equal_jax(quant):
    """A prefill write of 7 tokens, then decode writes at per-sequence
    slots: payloads, scales and the bf16 and float32 reads bit-equal to
    JAX's."""
    k, v = _kv(2, (B, HKV, 7, HD))
    slots = np.array([0, 1, 2, 3, 4, 9, 10], np.int32)
    pc = kvcache.init_attn_cache(B, HKV, W, HD, quant, device="cpu")
    jc = jkv.init_attn_cache(B, HKV, W, HD, quant)
    kvcache.cache_write(pc, _t(k), _t(v), _t(slots))
    jc = jkv.cache_write(jc, jnp.asarray(k), jnp.asarray(v),
                         jnp.asarray(slots))
    _assert_same_cache(pc, jc)
    for step in range(3):
        k1, v1 = _kv(10 + step, (B, HKV, 1, HD), 3.0)
        slot = np.array([5 + step, 11 - step], np.int32)
        kvcache.cache_write_at(pc, _t(k1), _t(v1), _t(slot))
        jc = jkv.cache_write_at(jc, jnp.asarray(k1), jnp.asarray(v1),
                                jnp.asarray(slot))
        _assert_same_cache(pc, jc)
    for dt, jdt in ((torch.bfloat16, jnp.bfloat16),
                    (torch.float32, jnp.float32)):
        got = kvcache.cache_read(pc, dtype=dt)
        want = jkv.cache_read(jc, dtype=jdt)
        for g, w in zip(got, want):
            assert g.dtype == dt
            np.testing.assert_array_equal(_np(g), _np(w))


@pytest.mark.parametrize("quant", QUANTS)
def test_paged_pool_functions_equal_jax(quant):
    """A batch-1 prefilled cache scattered into a quantised pool through a
    table row, then decode writes at (block, offset) pairs and a gather
    of two slots' tables: the stacked pool's payloads and scales and the
    gathered views bit-equal to JAX's mesh-free functions; the gather
    equals the contiguous read of the same rows."""
    lead, bs, nb = 2, 4, 9
    mb = W // bs
    k, v = _kv(3, (lead, 1, HKV, W, HD))
    one = kvcache.init_attn_cache(1, HKV, W, HD, quant, layers=lead,
                                  device="cpu")
    jone_layers = []
    for i in range(lead):
        kvcache.cache_write(one.layer(i), _t(k[i]), _t(v[i]),
                            torch.arange(W))
        jone_layers.append(jkv.cache_write(
            jkv.init_attn_cache(1, HKV, W, HD, quant), jnp.asarray(k[i]),
            jnp.asarray(v[i]), jnp.arange(W)))
    jone = jkv.AttnCache(*(jnp.stack([getattr(c, f) for c in jone_layers])
                           for f in ("k", "v", "k_scale", "v_scale")))
    _assert_same_cache(one, jone)
    table_row = np.array([7, 2, 0], np.int32)
    pc = kvcache.init_paged_attn_cache(HKV, nb, bs, HD, quant, stack=lead,
                                       device="cpu")
    jc = jkv.init_paged_attn_cache(HKV, nb, bs, HD, quant, stack=lead)
    assert tuple(pc.k_scale.shape) == (lead, HKV, nb, bs, 1)
    kvcache.paged_scatter_attn(pc, one, _t(table_row))
    jc = jkv.paged_scatter_attn(jc, jone, jnp.asarray(table_row))
    # block 0 (the null block) takes the colliding tail in either order
    keep = np.s_[..., 1:, :, :]
    for got, want in zip(_payload(pc), _jpayload(jc)):
        np.testing.assert_array_equal(got[keep], want[keep])
    for got, want in ((pc.k_scale, jc.k_scale), (pc.v_scale, jc.v_scale)):
        np.testing.assert_array_equal(got.numpy()[keep],
                                      np.asarray(want)[keep])
    # decode writes through layer 1's view, one per sequence
    lay = pc.layer(1)
    jlay = jkv.PagedAttnCache(*(x[1] for x in jc))
    # blocks outside the scattered slot's: its rows stay as prefilled
    block, offset = np.array([4, 5], np.int32), np.array([3, 1], np.int32)
    k1, v1 = _kv(4, (2, HKV, 1, HD), 2.0)
    kvcache.paged_cache_write_at(lay, _t(k1), _t(v1), _t(block), _t(offset))
    jlay = jkv.paged_cache_write_at(jlay, jnp.asarray(k1), jnp.asarray(v1),
                                    jnp.asarray(block), jnp.asarray(offset))
    for got, want in zip(_payload(pc), _jpayload(jlay)):
        np.testing.assert_array_equal(got[1][:, 1:], want[:, 1:])
    np.testing.assert_array_equal(pc.k_scale[1].numpy()[:, 1:],
                                  np.asarray(jlay.k_scale)[:, 1:])
    table = np.array([[7, 2, 0], [5, 4, 8]], np.int32)
    for dt, jdt in ((torch.bfloat16, jnp.bfloat16),
                    (torch.float32, jnp.float32)):
        got = kvcache.paged_gather(lay, _t(table), dtype=dt)
        want = jkv.paged_gather(jlay, jnp.asarray(table), dtype=jdt)
        for g, w in zip(got, want):
            assert tuple(g.shape) == (2, HKV, mb * bs, HD) and g.dtype == dt
            # rows of real blocks (the null block's content differs)
            np.testing.assert_array_equal(_np(g)[:, :, :2 * bs],
                                          _np(w)[:, :, :2 * bs])
    # slot 0's first two blocks are layer 1 of the prefilled cache
    kg, vg = kvcache.paged_gather(lay, _t(table), dtype=torch.float32)
    kr, vr = kvcache.cache_read(one.layer(1), dtype=torch.float32)
    np.testing.assert_array_equal(kg[0, :, :2 * bs].numpy(),
                                  kr[0, :, :2 * bs].numpy())
    np.testing.assert_array_equal(vg[0, :, :2 * bs].numpy(),
                                  vr[0, :, :2 * bs].numpy())


def test_int4_payload_is_half_the_int8_payload():
    c8 = kvcache.init_attn_cache(2, 4, 128, 64, "int8", layers=3,
                                 device="cpu")
    c4 = kvcache.init_attn_cache(2, 4, 128, 64, "int4", layers=3,
                                 device="cpu")
    cb = kvcache.init_attn_cache(2, 4, 128, 64, layers=3, device="cpu")

    def nbytes(*ts):
        return sum(t.numel() * t.element_size() for t in ts)
    assert nbytes(c4.k, c4.v) * 2 == nbytes(c8.k, c8.v)
    assert nbytes(c8.k, c8.v) * 2 == nbytes(cb.k, cb.v)
    assert nbytes(c4.k_scale) == nbytes(c8.k_scale) == 3 * 2 * 4 * 128 * 4
    p4 = kvcache.init_paged_attn_cache(4, 9, 16, 64, "int4", device="cpu")
    p8 = kvcache.init_paged_attn_cache(4, 9, 16, 64, "int8", device="cpu")
    assert nbytes(p4.k) * 2 == nbytes(p8.k)
    assert (c4.quant, c8.quant, cb.quant) == ("int4", "int8", None)


@pytest.mark.parametrize("quant", QUANTS)
@pytest.mark.parametrize("paged", [False, True])
def test_layer_views_carry_the_scales(quant, paged):
    """`.layer(i)` of a stacked quantised cache or pool keeps the scales
    and the payload's kind, and a write through it lands in the stacked
    payload and scale tensors of layer i only."""
    if paged:
        c = kvcache.init_paged_attn_cache(HKV, 5, 4, HD, quant, stack=3,
                                          device="cpu")
    else:
        c = kvcache.init_attn_cache(B, HKV, W, HD, quant, layers=3,
                                    device="cpu")
    lay = c.layer(1)
    assert lay.quant == quant and lay.k_scale is not None
    assert lay.v_scale.data_ptr() == c.v_scale[1].data_ptr()
    k1, v1 = _kv(5, (2, HKV, 1, HD))
    if paged:
        kvcache.paged_cache_write_at(lay, _t(k1), _t(v1), _t([2, 3]),
                                     _t([1, 0]))
        kf, _ = kvcache.paged_gather(c.layer(1), _t([[2], [3]]),
                                     dtype=torch.float32)
        got = kf[[0, 1], :, [1, 0]]
    else:
        kvcache.cache_write_at(lay, _t(k1), _t(v1), _t([4, 7]))
        kf, _ = kvcache.cache_read(c.layer(1), dtype=torch.float32)
        got = kf[[0, 1], :, [4, 7]]
    assert float(c.k_scale[1].abs().max()) > 0
    assert float(c.k_scale[[0, 2]].abs().max()) == 0.0
    assert float(c.v[[0, 2]].abs().max()) == 0
    step = np.abs(k1[:, :, 0]).max(-1, keepdims=True) / kvcache.QMAX[quant]
    assert (np.abs(got.numpy() - k1[:, :, 0]) <= 0.5 * step + 1e-6).all()


def test_cache_dtypes_are_checked():
    with pytest.raises(ValueError, match="bf16, int8 or int4"):
        kvcache.init_attn_cache(1, 1, 4, 8, "fp8", device="cpu")
    with pytest.raises(ValueError, match="odd"):
        kvcache.init_paged_attn_cache(1, 4, 4, 7, "int4", device="cpu")
    if not torch.cuda.is_available():      # the card by default
        with pytest.raises(RuntimeError, match="no CUDA device"):
            kvcache.init_attn_cache(1, 1, 4, 8, "int8")
