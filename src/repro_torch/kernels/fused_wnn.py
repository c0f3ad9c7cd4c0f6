"""Fused ULEEN scoring on int8 tables: hash -> lookup -> AND -> popcount ->
bias (port of `repro/kernels/fused_wnn.py`).

The whole accelerator pipeline (paper Fig. 8/9) as one kernel launch. On
a CUDA tensor both entries launch the hand-written Hopper kernel in
`csrc/wnn.cu`, the same kernel as `packed_wnn`: the int8 (M, N_f, E)
tables are probed in their class-sliced form (`kernels/wnn_ensemble.py`),
one load for every class. On a CPU tensor they run their plain versions.

* `fused_wnn_ensemble(bits, prep)` — the served path: a batch's
  (B, total_bits) rows and a `core.export.UnpackedTables`, whose class
  slices were built once when it was prepared; one launch a batch.
* `fused_wnn(tuples, params, table, mask, bias)` — one submodel on its
  (B, N_f, n) tuples (the JAX package's signature), on class slices built
  from the table in the call.

Each launch counts one in `fused_wnn.launches`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import launch, ref, wnn_ensemble


def fused_wnn(tuples: torch.Tensor, params: torch.Tensor, table: torch.Tensor,
              mask: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """tuples: (B, N_f, n) int8 {0,1}; params: (k, n) int32; table:
    (M, N_f, E) int8 {0,1}; mask: (M, N_f) int8; bias: (M,) int32
    -> scores (B, M) int32."""
    if tuples.device.type == "cpu":
        return ref.fused_wnn_ref(tuples, params, table, mask, bias)
    from repro_torch.packed import layout
    b, n_f, n, k, m, entries = launch.wnn_dims("fused_wnn", tuples, params,
                                               table)
    launch.check_cuda_args(
        "fused_wnn", tuples=(tuples, torch.int8, (b, n_f, n)),
        params=(params, torch.int32, (k, n)),
        table=(table, torch.int8, (m, n_f, entries)),
        mask=(mask, torch.int8, (m, n_f)), bias=(bias, torch.int32, (m,)))
    if b == 0:
        return torch.empty((0, m), dtype=torch.int32, device=tuples.device)
    # a hash at or past E (only from malformed parameters) reads nothing
    # and answers 0
    return wnn_ensemble.tuple_scores(fused_wnn, tuples, params,
                                     layout.class_slices_from_table(table),
                                     mask, bias)


def fused_wnn_ensemble(bits: torch.Tensor, prep) -> torch.Tensor:
    """bits: (B, total_bits) int8/uint8/bool {0,1}; prep: a
    `core.export.UnpackedTables` -> scores (B, M) int32 of the whole
    ensemble, bias included, in one launch."""
    return wnn_ensemble.ensemble_scores(fused_wnn, bits, prep)


fused_wnn.launches = 0
wnn_ensemble.register_counter(fused_wnn)
