"""Hash functions for Bloom-filter RAM nodes (port of `repro/core/hashing.py`).

H3 family (Carter & Wegman): h_j(x) = XOR_{i : x_i = 1} p_{j,i}, with p
random words in [0, E). Parameters are shared by every Bloom filter of a
submodel, so one (k, n) matrix serves all discriminators.

A MurmurHash3-style double hash is kept solely for the Bloom WiSARD
baseline. The JAX package computes it in uint32 and relies on the
multiplies wrapping; torch has few uint32 ops, so here the words travel
as int64 holding values in [0, 2^32) and every product is reduced mod 2^32
explicitly, without ever overflowing int64.
"""
from __future__ import annotations

import torch

_U32 = 0xFFFFFFFF


def make_h3_params(generator: torch.Generator, k: int, n_inputs: int,
                   log2_entries: int) -> torch.Tensor:
    """(k, n_inputs) int32 parameters, each in [0, 2^log2_entries), drawn
    from `generator` on its device. (The JAX package keeps them as uint32;
    below E <= 2^15 both hold the same values.)"""
    return torch.randint(0, 2 ** log2_entries, (k, n_inputs),
                         generator=generator, device=generator.device,
                         dtype=torch.int32)


def h3_hash(bits: torch.Tensor, params: torch.Tensor) -> torch.Tensor:
    """bits: (..., n) bool/{0,1}; params: (k, n) integer -> (..., k) int32.

    XOR-reduction of the parameter words selected by set input bits.
    The artifact stores H3 parameters as uint32, but they lie in [0, E)
    with E <= 2^15, so int32 holds them exactly (torch has few uint32
    ops).
    """
    params = params.to(device=bits.device, dtype=torch.int32)
    sel = torch.where(bits[..., None, :] != 0, params, 0)    # (..., k, n)
    h = torch.zeros(sel.shape[:-1], dtype=torch.int32, device=bits.device)
    for i in range(sel.shape[-1]):            # torch has no XOR reduction
        h = h ^ sel[..., i]
    return h


def _mul_u32(h: torch.Tensor, c: int) -> torch.Tensor:
    """(h * c) mod 2^32 for int64 h in [0, 2^32) and a uint32 constant c,
    in two 16-bit halves of c so no product leaves int64."""
    lo = h * (c & 0xFFFF)                                   # < 2^48
    hi = ((h * (c >> 16)) & 0xFFFF) << 16                   # < 2^32
    return (lo + hi) & _U32


def _murmur_fmix32(h: torch.Tensor) -> torch.Tensor:
    h = h ^ (h >> 16)
    h = _mul_u32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul_u32(h, 0xC2B2AE35)
    h = h ^ (h >> 16)
    return h


def pack_bits_u32(bits: torch.Tensor) -> torch.Tensor:
    """bits (..., n) bool -> (..., ceil(n/32)) little-endian uint32 words,
    as int64 values in [0, 2^32)."""
    n = bits.shape[-1]
    b = (bits != 0).to(torch.int64)
    pad = (-n) % 32
    if pad:
        b = torch.nn.functional.pad(b, (0, pad))
    shifts = torch.arange(32, dtype=torch.int64, device=b.device)
    return torch.sum(b.reshape(*b.shape[:-1], -1, 32) << shifts, dim=-1)


def murmur_double_hash(bits: torch.Tensor, k: int, entries: int) -> torch.Tensor:
    """Bloom WiSARD's double hashing: h_i = h1 + i*h2 (mod entries), with
    the sum wrapping mod 2^32 first as the JAX package's uint32 does.

    bits: (..., n) bool -> (..., k) int32. Murmur-style finalizer over
    packed words. Used only by the Bloom WiSARD baseline.
    """
    words = pack_bits_u32(bits)

    def fold(seed):
        acc = torch.full(words.shape[:-1], seed, dtype=torch.int64,
                         device=words.device)
        for i in range(words.shape[-1]):
            acc = _murmur_fmix32(acc ^ words[..., i] ^ ((i * 0x01000193) & _U32))
        return acc

    h1 = fold(0x9747B28C)
    h2 = fold(0x5BD1E995) | 1
    ks = torch.arange(k, dtype=torch.int64, device=words.device)
    h = (h1[..., None] + ((ks * h2[..., None]) & _U32)) & _U32
    return (h % entries).to(torch.int32)
