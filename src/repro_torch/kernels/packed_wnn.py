"""Packed-domain ULEEN scoring: bitplane tables, never unpacked (port of
`repro/kernels/packed_wnn.py`).

The artifact's tables stay in their native uint32 bitplane layout
(`core/export.py::pack_table`, 32 entries per word, little-endian bits):

    entry h of filter (m, f)  ==  bit (h & 31) of word[m, f, h >> 5]

What the kernel probes is the class-sliced form of the same bits, built
from the words once where the tables are prepared (`packed/layout.py`,
`kernels/wnn_ensemble.py`): one load answers every class. On a CUDA
tensor both entries launch the hand-written Hopper kernel in
`csrc/wnn.cu` (the TPU kernel's one-hot contraction existed only because
gathers are slow there); on a CPU tensor they run their plain versions.

* `packed_wnn_ensemble(bits, tables)` — the served path: a batch's
  (B, total_bits) rows and a `PackedTables`; the permutation gather, every
  submodel and the bias in one launch.
* `packed_wnn(tuples, params, words, mask, bias)` — one submodel on its
  (B, N_f, n) tuples (the JAX package's signature): the same kernel with
  the identity permutation, on class slices built from the words in the
  call (a convenience for `ops.wnn_scores` and the parity tests).

Each launch counts one in `packed_wnn.launches`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import launch, ref, wnn_ensemble


def packed_wnn(tuples: torch.Tensor, params: torch.Tensor,
               words: torch.Tensor, mask: torch.Tensor,
               bias: torch.Tensor) -> torch.Tensor:
    """tuples: (B, N_f, n) int8 {0,1}; params: (k, n) int32; words:
    (M, N_f, W) uint32 bitplanes (or their int32 bit patterns); mask:
    (M, N_f) int8; bias: (M,) int32 -> scores (B, M) int32."""
    if tuples.device.type == "cpu":
        return ref.packed_wnn_ref(tuples, params, words, mask, bias)
    from repro_torch.packed import layout
    words = ref.as_int32_words(words)
    b, n_f, n, k, m, w = launch.wnn_dims("packed_wnn", tuples, params, words)
    launch.check_cuda_args(
        "packed_wnn", tuples=(tuples, torch.int8, (b, n_f, n)),
        params=(params, torch.int32, (k, n)),
        words=(words, torch.int32, (m, n_f, w)),
        mask=(mask, torch.int8, (m, n_f)), bias=(bias, torch.int32, (m,)))
    if b == 0:
        return torch.empty((0, m), dtype=torch.int32, device=tuples.device)
    # every entry of the words: hashes past 32·W read nothing and answer
    # 0, like the TPU one-hot; a legal pack keeps every hash below E
    slices = layout.class_slices_from_words(words, 32 * w)
    return wnn_ensemble.tuple_scores(packed_wnn, tuples, params, slices,
                                     mask, bias)


def packed_wnn_ensemble(bits: torch.Tensor, tables) -> torch.Tensor:
    """bits: (B, total_bits) int8/uint8/bool {0,1}; tables: a
    `packed.PackedTables` -> scores (B, M) int32 of the whole ensemble,
    bias included, in one launch."""
    return wnn_ensemble.ensemble_scores(packed_wnn, bits, tables)


packed_wnn.launches = 0
wnn_ensemble.register_counter(packed_wnn)
