"""KV caches for serving (port of `repro/models/kvcache.py`: the bf16
contiguous cache, the MLA latent cache and their paged block pools).

A cache holds one preallocated tensor per segment and per K or V,
(L, B, Hkv, W, hd), with the layer axis first as the JAX package stacks
scanned segments. Unlike the JAX package, whose arrays are immutable and
whose writes return new caches, the port writes in place (`index_put_` and
slice assignment) into that preallocated tensor: a decode step moves one
token's K and V per layer, not the whole cache. A layer works on its view
`AttnCache(k[l], v[l])`, so a write through the view lands in the segment's
tensor.

Paged layout: instead of one worst-case `max_len` row per slot, a
`PagedAttnCache` holds a shared pool of fixed-size blocks with no batch
axis, (L, Hkv, num_blocks, block_size, hd), and each slot maps its logical
block i to a physical block through a host-side block table
(`BlockAllocator`). Block 0 is the *null* block: a freed slot's table row
resets to it, so an inactive slot's masked decode write lands in a sink
instead of a recycled live block, and unallocated logical blocks read
from it (masked by kv_len before the softmax, so never visible).

DeepSeek's MLA cache holds the compressed latent instead of keys and
values: `MLACache` ([L,] B, W, r) float32 latents and ([L,] B, W, rd) bf16
rotary keys, and `PagedMLACache` the same as (NB, BS, ...) pools. The
latent stays float32 because the w_uk / w_uv up-projections amplify a
bf16 rounding enough to break decode = teacher forcing; the rotary key is
read as it is, so it is bf16 like a GQA cache.

An encoder-decoder model (Whisper) keeps beside its caches the keys and
values of its cross-attention layers over the encoder's output:
`CrossKV` ([L,] B, Hkv, F, hd) in the encoder output's dtype (float32
for float32 frames, over bf16 parameters too, as the JAX package
promotes), written once by the prefill and read by every decode step.

Quantised caches (`kv_cache_dtype` "int8" or "int4", Qwen 1.5) store
integer payloads with a float32 scale per token and head, ([L,] B, Hkv, W,
1) or ([L,] Hkv, NB, BS, 1) in a pool, as the JAX package does: a write
quantises (`_quantize`: scale = max|x| / qmax + 1e-8, q = round(x / scale)
clipped to ±qmax, qmax 127 or 7), a read dequantises as
(q.float() * scale).to(dtype). PyTorch has no int4 dtype: an int4 payload
holds two values a byte along hd, ([L,] ..., hd / 2) int8, so it takes
half the int8 payload's bytes on the card; `AttnCache.quant` and
`PagedAttnCache.quant` name the payload's kind ("int8", "int4" or None).
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional

import torch

from repro_torch.device import DEFAULT_DEVICE, resolve_device

QMAX = {"int8": 127.0, "int4": 7.0}


class AttnCache(NamedTuple):
    k: torch.Tensor                   # ([L,] B, Hkv, W, hd) bf16 or int8,
    v: torch.Tensor                   # ([L,] B, Hkv, W, hd / 2) int8 (int4)
    k_scale: Optional[torch.Tensor] = None    # ([L,] B, Hkv, W, 1) float32
    v_scale: Optional[torch.Tensor] = None    # when quantised
    quant: Optional[str] = None       # "int8" | "int4" | None (bf16)

    def layer(self, i: int) -> "AttnCache":
        """Layer i's view of a stacked ([L, ...]) cache, scales included;
        writes through it land in the stacked tensors."""
        return AttnCache(*_layer_views(self, i), quant=self.quant)


def _layer_views(cache, i: int) -> list:
    return [None if t is None else t[i] for t in cache[:4]]


class CrossKV(NamedTuple):
    """Cross-attention keys and values over the encoder output of F
    frames: ([L,] B, Hkv, F, hd), written at prefill, read at decode."""
    k: torch.Tensor
    v: torch.Tensor

    def layer(self, i: int) -> "CrossKV":
        """Layer i's view; a write through it lands in the stacked
        tensors."""
        return CrossKV(self.k[i], self.v[i])


def init_cross_kv(batch: int, kv_heads: int, frames: int, head_dim: int, *,
                  layers: int, dtype=torch.float32,
                  device=DEFAULT_DEVICE) -> CrossKV:
    """Zero (L, B, Hkv, F, hd) cross keys and values on `device`."""
    shape = (layers, batch, kv_heads, frames, head_dim)
    device = resolve_device(device)
    return CrossKV(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device))


def _zeros(shape: tuple, head_dim: int, dtype: str, device):
    """(k, v, k_scale, v_scale, quant) zeros of a cache or pool whose
    token rows have `shape` (all but hd): bf16 payloads, or int8 payloads
    (hd / 2 wide for int4) with float32 scales."""
    device = resolve_device(device)
    if dtype == "bf16":
        return (torch.zeros((*shape, head_dim), dtype=torch.bfloat16,
                            device=device),
                torch.zeros((*shape, head_dim), dtype=torch.bfloat16,
                            device=device), None, None, None)
    if dtype not in QMAX:
        raise ValueError(f"kv_cache_dtype must be bf16, int8 or int4, got "
                         f"{dtype!r}")
    if dtype == "int4" and head_dim % 2:
        raise ValueError(f"an int4 cache packs two values a byte: head dim "
                         f"{head_dim} is odd")
    width = head_dim // 2 if dtype == "int4" else head_dim

    def z(last, dt):
        return torch.zeros((*shape, last), dtype=dt, device=device)
    return (z(width, torch.int8), z(width, torch.int8),
            z(1, torch.float32), z(1, torch.float32), dtype)


def init_attn_cache(batch: int, kv_heads: int, window: int, head_dim: int,
                    dtype: str = "bf16", *, layers: Optional[int] = None,
                    device=DEFAULT_DEVICE) -> AttnCache:
    """Zero cache (B, Hkv, W, hd), or (L, B, Hkv, W, hd) with `layers`, on
    `device` (the card unless the caller asks for the CPU): bf16, or
    dtype "int8" / "int4" payloads (hd / 2 wide for int4) with float32
    scales (..., W, 1)."""
    shape = (batch, kv_heads, window)
    if layers is not None:
        shape = (layers, *shape)
    return AttnCache(*_zeros(shape, head_dim, dtype, device))


def _quantize(x: torch.Tensor, quant: str = "int8"):
    """(q, scale): q = round(x / scale) clipped to ±qmax, int8 (one value
    an element, before any packing), scale = max|x| / qmax + 1e-8 over
    the last axis, float32 (..., 1); the JAX package's `_quantize`."""
    qmax = QMAX[quant]
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    # qmax as a tensor: CUDA turns division by a Python scalar into a
    # product with its reciprocal, which rounds otherwise
    scale = amax / torch.full_like(amax, qmax) + 1e-8
    q = torch.round(xf / scale).clamp_(-qmax, qmax).to(torch.int8)
    return q, scale


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """(..., hd) int8 values in [-8, 7] -> (..., hd / 2) int8: value 2j in
    the low nibble of byte j, value 2j + 1 in the high one."""
    lo, hi = q[..., 0::2], q[..., 1::2]
    return (lo & 0x0F) | (hi << 4)


def unpack_int4(p: torch.Tensor) -> torch.Tensor:
    """`pack_int4`'s inverse: arithmetic shifts sign-extend each nibble."""
    lo = (p << 4) >> 4
    hi = p >> 4
    return torch.stack([lo, hi], dim=-1).flatten(-2)


def _encode(cache, x: torch.Tensor):
    """x in the cache's storage: (payload, scale), scale None for bf16."""
    if cache.quant is None:
        return x.to(cache.k.dtype), None
    q, scale = _quantize(x, cache.quant)
    return (pack_int4(q) if cache.quant == "int4" else q), scale


def _decode(quant: Optional[str], payload: torch.Tensor,
            scale: Optional[torch.Tensor], dtype) -> torch.Tensor:
    """Stored values in `dtype`: bf16 payloads cast (no copy when already
    `dtype`), quantised ones (q.float() * scale).to(dtype), the JAX
    package's dequantisation order."""
    if quant is None:
        return payload.to(dtype)
    q = unpack_int4(payload) if quant == "int4" else payload
    return (q.float() * scale).to(dtype)


def cache_write(cache: AttnCache, k_new: torch.Tensor, v_new: torch.Tensor,
                slots: torch.Tensor) -> AttnCache:
    """Write T new entries at positions `slots` ((T,) int, shared by the
    batch), in place, quantised if the cache is; k_new/v_new: (B, Hkv, T,
    hd). Returns `cache`."""
    slots = slots.to(torch.long)
    for name, x in (("k", k_new), ("v", v_new)):
        payload, scale = _encode(cache, x)
        getattr(cache, name)[:, :, slots] = payload
        if scale is not None:
            getattr(cache, name + "_scale")[:, :, slots] = scale
    return cache


def cache_write_span(cache: AttnCache, k_new: torch.Tensor,
                     v_new: torch.Tensor, start: int,
                     width: int) -> AttnCache:
    """`cache_write` at slots (start + i) % width for the T new entries,
    the ring a prefill fills; on a placed cache (`dist.placed`) each rank
    writes the slots its slice holds. Returns `cache`."""
    from repro_torch.dist import placed
    t = k_new.shape[2]
    if not placed.is_placed(cache.k):
        return cache_write(cache, k_new, v_new, torch.arange(
            start, start + t, device=cache.k.device) % width)
    for name, x in (("k", k_new), ("v", v_new)):
        payload, scale = _encode(cache, x)
        placed.cache_write(getattr(cache, name), payload, start, t, width)
        if scale is not None:
            placed.cache_write(getattr(cache, name + "_scale"), scale, start,
                               t, width)
    return cache


def cache_write_at(cache: AttnCache, k_new: torch.Tensor,
                   v_new: torch.Tensor, slot: torch.Tensor) -> AttnCache:
    """Decode write: one new entry per sequence, at its own position, in
    place. k_new/v_new: (B, Hkv, 1, hd); slot: (B,) int. Returns `cache`.
    On a placed cache (`dist.placed`) the rank whose slice holds a row's
    slot writes it."""
    from repro_torch.dist import placed
    if placed.is_placed(cache.k):
        for name, x in (("k", k_new), ("v", v_new)):
            payload, scale = _encode(cache, x)
            placed.cache_write_at(getattr(cache, name), payload, slot)
            if scale is not None:
                placed.cache_write_at(getattr(cache, name + "_scale"), scale,
                                      slot)
        return cache
    rows = torch.arange(cache.k.shape[0], device=cache.k.device)
    slot = slot.to(torch.long)
    for name, x in (("k", k_new), ("v", v_new)):
        payload, scale = _encode(cache, x)
        getattr(cache, name)[rows, :, slot] = payload[:, :, 0]
        if scale is not None:
            getattr(cache, name + "_scale")[rows, :, slot] = scale[:, :, 0]
    return cache


def cache_read(cache: AttnCache, dtype=torch.bfloat16):
    """(k, v) in `dtype`, dequantised if the cache is quantised; no copy
    when a bf16 cache already has `dtype`."""
    return (_decode(cache.quant, cache.k, cache.k_scale, dtype),
            _decode(cache.quant, cache.v, cache.v_scale, dtype))


# ---------------------------------------------------------------------------
# Paged (block-granular) caches
# ---------------------------------------------------------------------------


class PagedAttnCache(NamedTuple):
    """The shared GQA block pool: no batch axis; slots index it through a
    block table. k/v: ([L,] Hkv, num_blocks, block_size, hd) bf16, or the
    quantised payloads and ([L,] Hkv, NB, BS, 1) float32 scales of
    `AttnCache`."""
    k: torch.Tensor
    v: torch.Tensor
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None
    quant: Optional[str] = None

    def layer(self, i: int) -> "PagedAttnCache":
        """Layer i's view of a stacked pool, scales included; writes land
        in the pool."""
        return PagedAttnCache(*_layer_views(self, i), quant=self.quant)


def init_paged_attn_cache(kv_heads: int, num_blocks: int, block_size: int,
                          head_dim: int, dtype: str = "bf16",
                          stack: Optional[int] = None, *,
                          device=DEFAULT_DEVICE) -> PagedAttnCache:
    """Zero pool (Hkv, NB, BS, hd) on `device`, bf16 or quantised as
    `init_attn_cache`; `stack` prepends a layer axis."""
    shape = (kv_heads, num_blocks, block_size)
    if stack:
        shape = (stack, *shape)
    return PagedAttnCache(*_zeros(shape, head_dim, dtype, device))


def paged_cache_write_at(cache: PagedAttnCache, k_new: torch.Tensor,
                         v_new: torch.Tensor, block: torch.Tensor,
                         offset: torch.Tensor) -> PagedAttnCache:
    """Decode write, in place: one entry per sequence at (block[b],
    offset[b]). k_new/v_new: (B, Hkv, 1, hd); block/offset: (B,) int.
    Inactive slots carry an all-null block table, so their (masked,
    frozen-pos) writes collide harmlessly in block 0. Returns `cache`."""
    block, offset = block.to(torch.long), offset.to(torch.long)
    for name, x in (("k", k_new), ("v", v_new)):
        # pool (Hkv, NB, BS, X) <- (Hkv, B, X) at the B (block, offset)
        # pairs, X the payload's width or the scale's 1
        payload, scale = _encode(cache, x)
        getattr(cache, name)[:, block, offset] = payload[:, :, 0].transpose(
            0, 1)
        if scale is not None:
            getattr(cache, name + "_scale")[:, block, offset] = \
                scale[:, :, 0].transpose(0, 1)
    return cache


def paged_gather(cache: PagedAttnCache, table: torch.Tensor,
                 dtype=torch.bfloat16):
    """Each slot's logical view for the decode attention read: table
    (B, MB) -> k, v (B, Hkv, MB·BS, hd), dequantised in `cache_read`'s
    order. Unallocated logical blocks read the null block, which sits
    above the kv_len mask like the dead tail of a contiguous cache."""
    table = table.to(torch.long)

    def gather(pool):
        x = pool[:, table]                    # (Hkv, B, MB, BS, X)
        h, b, mb, bs, d = x.shape
        return x.transpose(0, 1).reshape(b, h, mb * bs, d)

    def read(payload, scale):
        # contiguous, as a contiguous cache's layer view is: on the card
        # the decode attention's products take another (differently
        # rounded) route on the transposed view
        return _decode(cache.quant, gather(payload),
                       None if scale is None else gather(scale),
                       dtype).contiguous()

    return read(cache.k, cache.k_scale), read(cache.v, cache.v_scale)


def paged_scatter_attn(pool_cache: PagedAttnCache, one: AttnCache,
                       table_row: torch.Tensor) -> PagedAttnCache:
    """Move a freshly prefilled batch-1 contiguous cache ([L,] 1, Hkv, W,
    X), W = MB·BS, into the blocks of `table_row` ((MB,) int), in place,
    payloads and scales alike. The whole width moves: logical blocks past
    the slot's allocation map to the null block in the table and collide
    there. Returns `pool_cache`."""
    table_row = table_row.to(torch.long)

    def put(pool, src):
        if pool is None:
            return
        src = src.squeeze(-4)                 # ([L,] Hkv, W, X)
        bs, mb = pool.shape[-2], table_row.shape[0]
        src = src.reshape(*src.shape[:-2], mb, bs, src.shape[-1])
        pool[..., table_row, :, :] = src.to(pool.dtype)

    for pool, src in zip(pool_cache[:4], one[:4]):
        put(pool, src)
    return pool_cache


# ---------------------------------------------------------------------------
# MLA latent caches (DeepSeek-V2)
# ---------------------------------------------------------------------------


class MLACache(NamedTuple):
    ckv: torch.Tensor                 # ([L,] B, W, r) float32 latent
    krope: torch.Tensor               # ([L,] B, W, rd) bf16 rotary key

    def layer(self, i: int) -> "MLACache":
        """Layer i's view of a stacked cache; writes land in the stack."""
        return MLACache(self.ckv[i], self.krope[i])


def init_mla_cache(batch: int, window: int, lora_rank: int, rope_dim: int,
                   *, layers: Optional[int] = None,
                   device=DEFAULT_DEVICE) -> MLACache:
    """Zero latent cache: ckv (B, W, r) float32, krope (B, W, rd) bf16, or
    with a leading (L,) axis given `layers`, on `device`."""
    device = resolve_device(device)
    lead = () if layers is None else (layers,)
    return MLACache(
        ckv=torch.zeros((*lead, batch, window, lora_rank),
                        dtype=torch.float32, device=device),
        krope=torch.zeros((*lead, batch, window, rope_dim),
                          dtype=torch.bfloat16, device=device))


def mla_cache_write(cache: MLACache, ckv_new: torch.Tensor,
                    krope_new: torch.Tensor, slots: torch.Tensor) -> MLACache:
    """Prefill write, in place: T entries at positions `slots` ((T,) int,
    shared by the batch). ckv_new (B, T, r); krope_new (B, T, rd)."""
    slots = slots.to(torch.long)
    cache.ckv[:, slots] = ckv_new.to(cache.ckv.dtype)
    cache.krope[:, slots] = krope_new.to(cache.krope.dtype)
    return cache


def mla_cache_write_span(cache: MLACache, ckv_new: torch.Tensor,
                         krope_new: torch.Tensor, start: int,
                         width: int) -> MLACache:
    """`mla_cache_write` at slots (start + i) % width for the T new
    entries, the ring a prefill fills; on a placed cache (`dist.placed`,
    the sequence on dim 1) each rank writes the slots its slice holds.
    Returns `cache`."""
    from repro_torch.dist import placed
    t = ckv_new.shape[1]
    if not placed.is_placed(cache.ckv):
        return mla_cache_write(cache, ckv_new, krope_new, torch.arange(
            start, start + t, device=cache.ckv.device) % width)
    for leaf, x in ((cache.ckv, ckv_new), (cache.krope, krope_new)):
        placed.cache_write(leaf, x, start, t, width, seq_dim=1)
    return cache


def mla_cache_write_at(cache: MLACache, ckv_new: torch.Tensor,
                       krope_new: torch.Tensor,
                       slot: torch.Tensor) -> MLACache:
    """Decode write, in place: one entry per sequence at its own slot.
    ckv_new (B, 1, r); krope_new (B, 1, rd); slot (B,) int. On a placed
    cache the rank whose slice holds a row's slot writes it."""
    from repro_torch.dist import placed
    if placed.is_placed(cache.ckv):
        for leaf, x in ((cache.ckv, ckv_new), (cache.krope, krope_new)):
            placed.cache_write_at(leaf, x, slot, seq_dim=1)
        return cache
    rows = torch.arange(cache.ckv.shape[0], device=cache.ckv.device)
    slot = slot.to(torch.long)
    cache.ckv[rows, slot] = ckv_new[:, 0].to(cache.ckv.dtype)
    cache.krope[rows, slot] = krope_new[:, 0].to(cache.krope.dtype)
    return cache


class PagedMLACache(NamedTuple):
    """The shared latent block pool: ckv ([L,] NB, BS, r) float32, krope
    ([L,] NB, BS, rd) bf16, the dtypes of `MLACache` for its reasons."""
    ckv: torch.Tensor
    krope: torch.Tensor

    def layer(self, i: int) -> "PagedMLACache":
        """Layer i's view of a stacked pool; writes land in the pool."""
        return PagedMLACache(self.ckv[i], self.krope[i])


def init_paged_mla_cache(num_blocks: int, block_size: int, lora_rank: int,
                         rope_dim: int, stack: Optional[int] = None, *,
                         device=DEFAULT_DEVICE) -> PagedMLACache:
    """Zero pool (NB, BS, r) float32 and (NB, BS, rd) bf16 on `device`;
    `stack` prepends a layer axis."""
    device = resolve_device(device)
    lead = (stack,) if stack else ()
    return PagedMLACache(
        ckv=torch.zeros((*lead, num_blocks, block_size, lora_rank),
                        dtype=torch.float32, device=device),
        krope=torch.zeros((*lead, num_blocks, block_size, rope_dim),
                          dtype=torch.bfloat16, device=device))


def mla_paged_cache_write_at(cache: PagedMLACache, ckv_new: torch.Tensor,
                             krope_new: torch.Tensor, block: torch.Tensor,
                             offset: torch.Tensor) -> PagedMLACache:
    """Decode write, in place, at (block[b], offset[b]). ckv_new (B, 1, r);
    krope_new (B, 1, rd); block/offset (B,) int. Returns `cache`."""
    block, offset = block.to(torch.long), offset.to(torch.long)
    cache.ckv[block, offset] = ckv_new[:, 0].to(cache.ckv.dtype)
    cache.krope[block, offset] = krope_new[:, 0].to(cache.krope.dtype)
    return cache


def mla_paged_gather(cache: PagedMLACache, table: torch.Tensor):
    """(B, MB) table -> (ckv (B, MB·BS, r), krope (B, MB·BS, rd)), both
    float32 and contiguous, as the contiguous decode reads its cache."""
    table = table.to(torch.long)

    def gather(pool):
        x = pool[table]                       # (B, MB, BS, X)
        b, mb, bs, d = x.shape
        return x.reshape(b, mb * bs, d).float().contiguous()

    return gather(cache.ckv), gather(cache.krope)


def paged_scatter_mla(pool_cache: PagedMLACache, one: MLACache,
                      table_row: torch.Tensor) -> PagedMLACache:
    """`paged_scatter_attn` for the latent pool: a batch-1 contiguous
    MLACache ([L,] 1, W, X), W = MB·BS, into the blocks of `table_row`,
    in place. Returns `pool_cache`."""
    table_row = table_row.to(torch.long)

    def put(pool, src):
        src = src.squeeze(-3)                 # ([L,] W, X)
        bs, mb = pool.shape[-2], table_row.shape[0]
        src = src.reshape(*src.shape[:-2], mb, bs, src.shape[-1])
        pool[..., table_row, :, :] = src.to(pool.dtype)

    put(pool_cache.ckv, one.ckv)
    put(pool_cache.krope, one.krope)
    return pool_cache


class BlockAllocator:
    """Host-side free-list allocator over the physical block pool.

    Block 0 is the reserved null block and is never handed out; the free
    list starts as [1 .. num_blocks-1] and serves ascending ids first.
    Invariant (`check()`): free and live partition the usable blocks
    exactly — no leaks, no double assignment. `peak` is the most blocks
    ever live at once.
    """

    def __init__(self, num_blocks: int):
        if num_blocks < 2:
            raise ValueError(
                f"need num_blocks >= 2 (1 usable + the null block), "
                f"got {num_blocks}")
        self.num_blocks = int(num_blocks)
        self._free: List[int] = list(range(self.num_blocks - 1, 0, -1))
        self._live: set = set()
        self.peak = 0

    @property
    def used(self) -> int:
        return len(self._live)

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    def alloc(self, n: int) -> Optional[List[int]]:
        """n blocks, or None when the pool cannot satisfy the request (the
        engine leaves the request queued: backpressure, never a drop)."""
        if n < 1:
            raise ValueError(f"need n >= 1 blocks, got {n}")
        if n > len(self._free):
            return None
        out = [self._free.pop() for _ in range(n)]
        self._live.update(out)
        self.peak = max(self.peak, len(self._live))
        return out

    def free(self, blocks) -> None:
        for b in blocks:
            if b not in self._live:
                raise ValueError(
                    f"double free / foreign block {b} (live: "
                    f"{len(self._live)})")
            self._live.remove(b)
            self._free.append(b)

    def check(self) -> None:
        """Reconcile: free and live partition {1..num_blocks-1}; raises
        AssertionError on a duplicate, an overlap, the null block in
        circulation or a leak."""
        free = self._free
        if len(set(free)) != len(free):
            raise AssertionError(f"free list holds duplicates: {free}")
        if set(free) & self._live:
            raise AssertionError(
                f"blocks both free and live: {set(free) & self._live}")
        if 0 in self._live or 0 in free:
            raise AssertionError("null block 0 entered circulation")
        if len(free) + len(self._live) != self.num_blocks - 1:
            raise AssertionError(
                f"leak: {len(free)} free + {len(self._live)} live != "
                f"{self.num_blocks - 1} usable")
