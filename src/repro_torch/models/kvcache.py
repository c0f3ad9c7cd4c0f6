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
`CrossKV` ([L,] B, Hkv, F, hd) in the parameters' dtype, written once by
the prefill and read by every decode step.

The int8/int4 quantised cache (ROADMAP Queue 1 item 4.5) is not ported.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional

import torch

from repro_torch.device import DEFAULT_DEVICE, resolve_device

_QUANTISED_TODO = ("the int8/int4 KV cache is not ported yet (ROADMAP.md, "
                   "Queue 1 item 4.5: the int8/int4 KV cache, Qwen 1.5)")


class AttnCache(NamedTuple):
    k: torch.Tensor                   # ([L,] B, Hkv, W, hd) bf16
    v: torch.Tensor
    k_scale: Optional[torch.Tensor] = None    # int8 caches only (not ported)
    v_scale: Optional[torch.Tensor] = None

    def layer(self, i: int) -> "AttnCache":
        """Layer i's view of a stacked ([L, ...]) cache; writes through it
        land in the stacked tensors."""
        return AttnCache(self.k[i], self.v[i])


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


def init_attn_cache(batch: int, kv_heads: int, window: int, head_dim: int,
                    dtype: str = "bf16", *, layers: Optional[int] = None,
                    device=DEFAULT_DEVICE) -> AttnCache:
    """Zero cache (B, Hkv, W, hd) bf16, or (L, B, Hkv, W, hd) with
    `layers`, on `device` (the card unless the caller asks for the CPU).
    Only dtype="bf16" is ported."""
    if dtype != "bf16":
        raise NotImplementedError(f"kv_cache_dtype={dtype!r}: "
                                  + _QUANTISED_TODO)
    device = resolve_device(device)
    shape = (batch, kv_heads, window, head_dim)
    if layers is not None:
        shape = (layers, *shape)
    return AttnCache(
        k=torch.zeros(shape, dtype=torch.bfloat16, device=device),
        v=torch.zeros(shape, dtype=torch.bfloat16, device=device))


def _check_unquantised(cache: AttnCache) -> None:
    if cache.k_scale is not None:
        raise NotImplementedError(_QUANTISED_TODO)


def cache_write(cache: AttnCache, k_new: torch.Tensor, v_new: torch.Tensor,
                slots: torch.Tensor) -> AttnCache:
    """Write T new entries at positions `slots` ((T,) int, shared by the
    batch), in place; k_new/v_new: (B, Hkv, T, hd). Returns `cache`."""
    _check_unquantised(cache)
    slots = slots.to(torch.long)
    cache.k[:, :, slots] = k_new.to(cache.k.dtype)
    cache.v[:, :, slots] = v_new.to(cache.v.dtype)
    return cache


def cache_write_at(cache: AttnCache, k_new: torch.Tensor,
                   v_new: torch.Tensor, slot: torch.Tensor) -> AttnCache:
    """Decode write: one new entry per sequence, at its own position, in
    place. k_new/v_new: (B, Hkv, 1, hd); slot: (B,) int. Returns `cache`."""
    _check_unquantised(cache)
    rows = torch.arange(cache.k.shape[0], device=cache.k.device)
    slot = slot.to(torch.long)
    cache.k[rows, :, slot] = k_new[:, :, 0].to(cache.k.dtype)
    cache.v[rows, :, slot] = v_new[:, :, 0].to(cache.v.dtype)
    return cache


def cache_read(cache: AttnCache, dtype=torch.bfloat16):
    """(k, v) in `dtype`; no copy when the cache already has it."""
    _check_unquantised(cache)
    return cache.k.to(dtype), cache.v.to(dtype)


# ---------------------------------------------------------------------------
# Paged (block-granular) caches
# ---------------------------------------------------------------------------


class PagedAttnCache(NamedTuple):
    """The shared GQA block pool: no batch axis; slots index it through a
    block table. k/v: ([L,] Hkv, num_blocks, block_size, hd) bf16."""
    k: torch.Tensor
    v: torch.Tensor
    k_scale: Optional[torch.Tensor] = None    # int8 pools only (not ported)
    v_scale: Optional[torch.Tensor] = None

    def layer(self, i: int) -> "PagedAttnCache":
        """Layer i's view of a stacked pool; writes land in the pool."""
        return PagedAttnCache(self.k[i], self.v[i])


def init_paged_attn_cache(kv_heads: int, num_blocks: int, block_size: int,
                          head_dim: int, dtype: str = "bf16",
                          stack: Optional[int] = None, *,
                          device=DEFAULT_DEVICE) -> PagedAttnCache:
    """Zero pool (Hkv, NB, BS, hd) bf16 on `device`; `stack` prepends a
    layer axis. Only dtype="bf16" is ported."""
    if dtype != "bf16":
        raise NotImplementedError(f"kv_cache_dtype={dtype!r}: "
                                  + _QUANTISED_TODO)
    device = resolve_device(device)
    shape = (kv_heads, num_blocks, block_size, head_dim)
    if stack:
        shape = (stack, *shape)
    return PagedAttnCache(
        k=torch.zeros(shape, dtype=torch.bfloat16, device=device),
        v=torch.zeros(shape, dtype=torch.bfloat16, device=device))


def paged_cache_write_at(cache: PagedAttnCache, k_new: torch.Tensor,
                         v_new: torch.Tensor, block: torch.Tensor,
                         offset: torch.Tensor) -> PagedAttnCache:
    """Decode write, in place: one entry per sequence at (block[b],
    offset[b]). k_new/v_new: (B, Hkv, 1, hd); block/offset: (B,) int.
    Inactive slots carry an all-null block table, so their (masked,
    frozen-pos) writes collide harmlessly in block 0. Returns `cache`."""
    _check_unquantised(cache)
    block, offset = block.to(torch.long), offset.to(torch.long)
    # pool (Hkv, NB, BS, hd) <- (Hkv, B, hd) at the B (block, offset) pairs
    cache.k[:, block, offset] = k_new[:, :, 0].transpose(0, 1).to(
        cache.k.dtype)
    cache.v[:, block, offset] = v_new[:, :, 0].transpose(0, 1).to(
        cache.v.dtype)
    return cache


def paged_gather(cache: PagedAttnCache, table: torch.Tensor,
                 dtype=torch.bfloat16):
    """Each slot's logical view for the decode attention read: table
    (B, MB) -> k, v (B, Hkv, MB·BS, hd). Unallocated logical blocks read
    the null block, which sits above the kv_len mask like the dead tail
    of a contiguous cache."""
    _check_unquantised(cache)
    table = table.to(torch.long)

    def gather(pool):
        x = pool[:, table]                    # (Hkv, B, MB, BS, hd)
        h, b, mb, bs, d = x.shape
        # contiguous, as a contiguous cache's layer view is: on the card
        # the decode attention's products take another (differently
        # rounded) route on the transposed view
        return x.transpose(0, 1).reshape(b, h, mb * bs, d).to(
            dtype).contiguous()

    return gather(cache.k), gather(cache.v)


def paged_scatter_attn(pool_cache: PagedAttnCache, one: AttnCache,
                       table_row: torch.Tensor) -> PagedAttnCache:
    """Move a freshly prefilled batch-1 contiguous cache ([L,] 1, Hkv, W,
    hd), W = MB·BS, into the blocks of `table_row` ((MB,) int), in place.
    The whole width moves: logical blocks past the slot's allocation map
    to the null block in the table and collide there. Returns
    `pool_cache`."""
    _check_unquantised(pool_cache)
    table_row = table_row.to(torch.long)

    def put(pool, src):
        src = src.squeeze(-4)                 # ([L,] Hkv, W, hd)
        bs, mb = pool.shape[-2], table_row.shape[0]
        src = src.reshape(*src.shape[:-2], mb, bs, src.shape[-1])
        pool[..., table_row, :, :] = src.to(pool.dtype)

    put(pool_cache.k, one.k)
    put(pool_cache.v, one.v)
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


def mla_cache_write_at(cache: MLACache, ckv_new: torch.Tensor,
                       krope_new: torch.Tensor,
                       slot: torch.Tensor) -> MLACache:
    """Decode write, in place: one entry per sequence at its own slot.
    ckv_new (B, 1, r); krope_new (B, 1, rd); slot (B,) int."""
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
