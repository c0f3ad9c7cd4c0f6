"""Serve entry for the packed domain: PackedTables -> ensemble scores (port
of `repro/packed/runtime.py`).

On a GPU a batch is one `packed_wnn_ensemble` launch on its
(B, total_bits) rows: the permutation gather, every submodel, the votes
and the bias happen inside the kernel, on the class slices `PackedTables`
built from the words when it was constructed; no (B, N_f, n) tuple
tensor exists. On the CPU the plain per-submodel loop runs (the gather,
then `packed_wnn`'s plain version). `core/export.py::artifact_scores` and
`launch/scheduler.py::WnnBatcher` both route through here. The tables'
geometry was checked when the `PackedTables` was built, so a batch pays
only the wrapper's pointer checks. Tenant-stacked and sharded serving
belong to later slices of the port.
"""
from __future__ import annotations

import torch

from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.kernels.packed_wnn import packed_wnn, packed_wnn_ensemble
from repro_torch.packed.layout import PackedTables


def packed_scores(pt: PackedTables, bits, *, backend: str = "auto",
                  device=DEFAULT_DEVICE) -> torch.Tensor:
    """bits: (B, total_bits) bool/int {0,1} -> scores (B, M) int32.

    backend="packed" and "auto" both run the ensemble kernel once on a
    GPU (the plain per-submodel loop on the CPU). "fused"/"gather"
    are rejected — they would need the 32× unpack this runtime exists to
    avoid.
    """
    if backend not in ("packed", "auto"):
        raise ValueError(
            f"packed_scores serves the packed domain only (backend="
            f"'packed'|'auto', got {backend!r}); use core.model."
            "forward_binary_fused for the unpacked formulations")
    dev = resolve_device(device)
    pt = pt.to(dev)
    bits = torch.as_tensor(bits).to(dev)
    if dev.type == "cuda":
        # the kernel reads any one-byte {0,1} rows as they are
        if bits.dtype not in (torch.int8, torch.uint8, torch.bool):
            bits = bits.to(torch.int8)
        return packed_wnn_ensemble(bits.contiguous(), pt)
    # one int8 copy of the batch, so each submodel's gather below already
    # yields the plain version's int8 tuples
    bits = bits.to(torch.int8)
    scores = torch.zeros((bits.shape[0], pt.num_classes), dtype=torch.int32,
                         device=dev)
    zero_bias = torch.zeros((pt.num_classes,), dtype=torch.int32, device=dev)
    for words, mask, perm, h3 in zip(pt.words, pt.masks, pt.perms, pt.h3s):
        tuples = bits[:, perm]                  # (B, N_f, n); perm is int64
        scores += packed_wnn(tuples, h3, words, mask, zero_bias)
    return scores + pt.bias[None]


def packed_predict(pt: PackedTables, bits, *, backend: str = "auto",
                   device=DEFAULT_DEVICE):
    """(scores (B, M) int32, argmax predictions (B,) int32)."""
    from repro_torch.kernels import ops
    return ops.ensemble_predict(
        packed_scores(pt, bits, backend=backend, device=device))
