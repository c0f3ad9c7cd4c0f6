"""KV caches for serving (port of `repro/models/kvcache.py`, the bf16
contiguous cache).

A cache holds one preallocated tensor per segment and per K or V,
(L, B, Hkv, W, hd), with the layer axis first as the JAX package stacks
scanned segments. Unlike the JAX package, whose arrays are immutable and
whose writes return new caches, the port writes in place (`index_put_` and
slice assignment) into that preallocated tensor: a decode step moves one
token's K and V per layer, not the whole cache. A layer works on its view
`AttnCache(k[l], v[l])`, so a write through the view lands in the segment's
tensor.

Only the bf16 cache is ported. The int8/int4 quantised cache and every
paged structure (`PagedAttnCache`, `BlockAllocator`, the paged writes and
gathers) wait for their items in ROADMAP.md (Queue 1 item 3: the int8/int4
KV cache for Qwen 1.5, and the paged engine with batched prefill).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.device import DEFAULT_DEVICE, resolve_device

_QUANTISED_TODO = ("the int8/int4 KV cache is not ported yet (ROADMAP.md, "
                   "Queue 1 item 3: the int8/int4 KV cache, Qwen 1.5)")
PAGED_TODO = ("the paged KV cache is not ported yet (ROADMAP.md, Queue 1 "
               "item 3: the paged engine with batched prefill)")


class AttnCache(NamedTuple):
    k: torch.Tensor                   # ([L,] B, Hkv, W, hd) bf16
    v: torch.Tensor
    k_scale: Optional[torch.Tensor] = None    # int8 caches only (not ported)
    v_scale: Optional[torch.Tensor] = None

    def layer(self, i: int) -> "AttnCache":
        """Layer i's view of a stacked ([L, ...]) cache; writes through it
        land in the stacked tensors."""
        return AttnCache(self.k[i], self.v[i])


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


def init_paged_attn_cache(*args, **kwargs):
    """The paged GQA block pool of the JAX package; not ported yet."""
    raise NotImplementedError(PAGED_TODO)


def init_paged_mla_cache(*args, **kwargs):
    """The paged MLA block pool of the JAX package; not ported yet."""
    raise NotImplementedError(PAGED_TODO)


class BlockAllocator:
    """The JAX package's host-side block free list; not ported yet."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(PAGED_TODO)
