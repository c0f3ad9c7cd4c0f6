"""H3 hashing for Bloom-filter RAM nodes (port of `repro/core/hashing.py`).

H3 family (Carter & Wegman): h_j(x) = XOR_{i : x_i = 1} p_{j,i}, with p
random words in [0, E). Parameters are shared by every Bloom filter of a
submodel, so one (k, n) matrix serves all discriminators.

Training-side helpers (`make_h3_params`, the Murmur baseline) belong to
the training slice of the port.
"""
from __future__ import annotations

import torch


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
