"""Packed-domain ULEEN scoring: bitplane tables, never unpacked (port of
`repro/kernels/packed_wnn.py`).

The tables stay in the artifact's native uint32 bitplane layout
(`core/export.py::pack_table`, 32 entries per word, little-endian bits):

    entry h of filter (m, f)  ==  bit (h & 31) of word[m, f, h >> 5]

On a CUDA tensor `packed_wnn` launches the hand-written Hopper kernel in
`csrc/wnn.cu` (a direct word load per probe; the TPU kernel's one-hot
contraction existed only because gathers are slow there). On a CPU
tensor it runs the plain version `ref.packed_wnn_ref`. The words travel
as int32 bit patterns: torch has few uint32 ops, and `(w >> s) & 1`
extracts bit s under int32's arithmetic shift just as well.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, launch, ref

_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_void_p]


def packed_wnn(tuples: torch.Tensor, params: torch.Tensor,
               words: torch.Tensor, mask: torch.Tensor,
               bias: torch.Tensor) -> torch.Tensor:
    """tuples: (B, N_f, n) int8 {0,1}; params: (k, n) int32; words:
    (M, N_f, W) uint32 bitplanes (or their int32 bit patterns); mask:
    (M, N_f) int8; bias: (M,) int32 -> scores (B, M) int32."""
    if tuples.device.type == "cpu":
        return ref.packed_wnn_ref(tuples, params, words, mask, bias)
    words = ref.as_int32_words(words)
    b, n_f, n, k, m, w = launch.wnn_dims("packed_wnn", tuples, params, words)
    device = launch.check_cuda_args(
        "packed_wnn", tuples=(tuples, torch.int8, (b, n_f, n)),
        params=(params, torch.int32, (k, n)),
        words=(words, torch.int32, (m, n_f, w)),
        mask=(mask, torch.int8, (m, n_f)), bias=(bias, torch.int32, (m,)))
    out = torch.empty((b, m), dtype=torch.int32, device=device)
    if b == 0:
        return out
    fn = build.kernel_function("wnn.cu", "packed_wnn_launch", _ARGTYPES)
    # hashes past 32·W read nothing and answer 0, like the TPU one-hot;
    # a legal pack keeps every hash below E <= 32·W
    rc = fn(tuples.data_ptr(), params.data_ptr(), words.data_ptr(),
            mask.data_ptr(), bias.data_ptr(), out.data_ptr(),
            b, n_f, n, k, m, w, 32 * w, launch.stream_handle(device))
    build.check_launch("packed_wnn_launch", rc)
    packed_wnn.launches += 1
    return out


packed_wnn.launches = 0
