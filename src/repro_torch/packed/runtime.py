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
only the wrapper's pointer checks. `stacked_scores` serves a
tenant-stacked fleet (`StackedPackedTables`) in one fixed-shape call;
sharded serving belongs to a later slice (ROADMAP Queue 1 item 3).
"""
from __future__ import annotations

import torch

from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.kernels.packed_wnn import packed_wnn, packed_wnn_ensemble
from repro_torch.packed.layout import PackedTables, StackedPackedTables


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


def stacked_scores(st: StackedPackedTables, bits, tids, *,
                   backend: str = "auto", valid=None,
                   device=DEFAULT_DEVICE) -> torch.Tensor:
    """Tenant-routed fleet scores (B, M) int32: row r of `bits` is scored
    against tenant `tids[r]`'s tables, in one fixed-shape call —
    `ops.wnn_scores_tenant` per submodel plus the row-gathered bias.

    st: `layout.StackedPackedTables`; bits: (B, total_bits) {0,1}; tids:
    (B,) in [0, T). `valid` (optional (B,) bool) zeroes the rows a caller
    does not own, bias included. Packed-domain only, like
    `packed_scores`.
    """
    from repro_torch.kernels import ops
    if backend not in ("packed", "auto"):
        raise ValueError(
            f"stacked_scores serves the packed domain only (backend="
            f"'packed'|'auto', got {backend!r})")
    dev = resolve_device(device)
    st.validate()
    st = st.to(dev)
    bits = torch.as_tensor(bits).to(dev)
    tids = torch.as_tensor(tids).to(dev, torch.int64)
    scores = torch.zeros((bits.shape[0], st.num_classes), dtype=torch.int32,
                         device=dev)
    for perm, h3, words, mask, entries in zip(
            st.perms, st.h3s, st.words, st.masks, st.entries):
        scores += ops.wnn_scores_tenant(bits, tids, perm, h3, words, mask,
                                        backend=backend, entries=entries,
                                        device=dev)
    scores += st.bias[tids]
    if valid is not None:
        valid = torch.as_tensor(valid).to(dev, torch.bool)
        scores = torch.where(valid[:, None], scores, 0)
    return scores


def stacked_predict(st: StackedPackedTables, bits, tids, *,
                    backend: str = "auto", device=DEFAULT_DEVICE):
    """(scores (B, M) int32, per-row argmax (B,) int32) of a fleet on one
    device."""
    from repro_torch.kernels import ops
    return ops.ensemble_predict(stacked_scores(st, bits, tids,
                                               backend=backend,
                                               device=device))
