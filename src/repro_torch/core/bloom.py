"""Bloom-filter RAM-node primitives for inference (port of
`repro/core/bloom.py`).

Tables are laid out (classes M, filters N_f, entries E); the k hash
lookups of a filter are one gather along the entries axis, shared by
every class. Counting and continuous tables (training) belong to the
training slice of the port.
"""
from __future__ import annotations

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


def binary_filter_response(table: torch.Tensor,
                           hashes: torch.Tensor) -> torch.Tensor:
    """Inference: AND of the k accessed bits -> (B, M, N_f) bool."""
    vals = gather_filter_values(table, hashes)
    return torch.all(vals != 0, dim=-1)
