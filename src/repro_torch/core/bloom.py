"""Bloom-filter RAM-node primitives (port of `repro/core/bloom.py`).

Three table flavours over one layout (classes M, filters N_f, entries E):

* binary   (bool)  — inference: response = AND of k looked-up bits
* counting (int32) — one-shot training: min-tied counter increments +
                     bleaching
* continuous (f32) — multi-shot training: response = step(min of k
                     entries), gradients via the straight-through
                     estimator (STE)

The k hash lookups of a filter are one gather along the entries axis,
shared by every class. Autograd differentiates the gather as PyTorch's
scatter-add (`index_put_(accumulate=True)`) and the min as `torch.amin`,
which splits the gradient evenly among tied minima exactly as JAX's min
VJP does (`torch.min(dim=)` would route all of it to one index).
"""
from __future__ import annotations

import math

import torch


def gather_filter_values(table: torch.Tensor,
                         hashes: torch.Tensor) -> torch.Tensor:
    """table: (M, N_f, E); hashes: (B, N_f, k) -> values (B, M, N_f, k).

    The same hash indices are reused for every class (shared input order
    and shared H3 parameters across discriminators).
    """
    n_f = table.shape[1]
    f_idx = torch.arange(n_f, device=table.device)[None, :, None]
    vals = table[:, f_idx, hashes.long()]          # (M, B, N_f, k)
    return vals.permute(1, 0, 2, 3)


def apply_mask(resp: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Apply a pruning mask to filter responses (B, M, N_f).

    A filter survives iff its mask entry is **nonzero**; the mask's
    magnitude never scales the response — the JAX package's canonical
    definition, which every backend and kernel follows.
    """
    keep = (mask != 0)[None]
    if resp.dtype == torch.bool:
        return resp & keep
    return resp * keep.to(resp.dtype)


def ste_step(x: torch.Tensor) -> torch.Tensor:
    """Unit step with straight-through gradient (f'(x) := 1).

    `x + (step(x) - x).detach()`, in x's dtype throughout: the JAX
    package's arithmetic, so a bf16 `x + (1 - x)` rounds where JAX's
    does (it is not always exactly 1)."""
    step = (x >= 0).to(x.dtype)
    return x + (step - x).detach()


def continuous_filter_response(table: torch.Tensor,
                               hashes: torch.Tensor) -> torch.Tensor:
    """(M, N_f, E) float, (B, N_f, k) -> (B, M, N_f) response in {0,1}
    with STE gradient: min over the k accessed entries, then STE-binarised.
    """
    vals = gather_filter_values(table, hashes)
    return ste_step(torch.amin(vals, dim=-1))


def binary_filter_response(table: torch.Tensor,
                           hashes: torch.Tensor) -> torch.Tensor:
    """Inference: AND of the k accessed bits -> (B, M, N_f) bool."""
    vals = gather_filter_values(table, hashes)
    return torch.all(vals != 0, dim=-1)


def counting_min_values(table: torch.Tensor,
                        hashes: torch.Tensor) -> torch.Tensor:
    """Counting tables: min over k accessed counters -> (B, M, N_f) int32.

    `response(b) = minvals >= b` implements bleaching at threshold b."""
    return torch.amin(gather_filter_values(table, hashes), dim=-1)


def counting_increment(table: torch.Tensor, hashes: torch.Tensor,
                       label) -> torch.Tensor:
    """Counting-Bloom update of one training sample (ULEEN one-shot rule),
    or of a batch of samples with distinct labels.

    table: (M, N_f, E) int32; hashes: (N_f, k), or (R, N_f, k); label: a
    scalar, or (R,) labels that differ from each other. Increment the
    *smallest* of the k accessed counters (all of them on ties). Only the
    correct class's discriminator is updated, so samples of distinct
    classes touch disjoint rows and update together as they would one
    after another. When two of a filter's hashes hit the same entry, both
    increments land, as JAX's `.at[].add` does. Returns a new table.
    """
    h = hashes.long()
    cls = torch.as_tensor(label, device=table.device).long().reshape(-1)
    if h.ndim == 2:
        h = h[None]
    cls = cls[:, None, None]                               # (R, 1, 1)
    f_idx = torch.arange(table.shape[1], device=table.device)[None, :, None]
    vals = table[cls, f_idx, h]                            # (R, N_f, k)
    inc = (vals == torch.amin(vals, dim=-1, keepdim=True)).to(table.dtype)
    return table.index_put((cls.expand_as(h), f_idx.expand_as(h), h), inc,
                           accumulate=True)


def binarize_counting(table: torch.Tensor, b) -> torch.Tensor:
    """Counting -> binary Bloom filter at bleaching threshold b
    (entries >= b)."""
    return table >= b


def binarize_continuous(table: torch.Tensor) -> torch.Tensor:
    """Continuous -> binary Bloom filter (unit step at 0)."""
    return table >= 0.0


def false_positive_rate(n_items: int, entries: int, k: int) -> float:
    """Classic Bloom FPR estimate (1 - e^{-kn/m})^k — used by capacity
    planning."""
    return (1.0 - math.exp(-k * n_items / entries)) ** k
