"""Fused ULEEN scoring on int8 tables: hash -> lookup -> AND -> popcount ->
bias (port of `repro/kernels/fused_wnn.py`).

The whole accelerator pipeline (paper Fig. 8/9) as one kernel launch per
submodel. On a CUDA tensor `fused_wnn` launches the hand-written Hopper
kernel in `csrc/wnn.cu`, the same kernel template as `packed_wnn` with a
byte lookup `table[m, f, h]` in place of the word-and-bit extract. On a
CPU tensor it runs the plain version `ref.fused_wnn_ref`.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, launch, ref

_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p]


def fused_wnn(tuples: torch.Tensor, params: torch.Tensor, table: torch.Tensor,
              mask: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """tuples: (B, N_f, n) int8 {0,1}; params: (k, n) int32; table:
    (M, N_f, E) int8 {0,1}; mask: (M, N_f) int8; bias: (M,) int32
    -> scores (B, M) int32."""
    if tuples.device.type == "cpu":
        return ref.fused_wnn_ref(tuples, params, table, mask, bias)
    b, n_f, n, k, m, entries = launch.wnn_dims("fused_wnn", tuples, params,
                                               table)
    device = launch.check_cuda_args(
        "fused_wnn", tuples=(tuples, torch.int8, (b, n_f, n)),
        params=(params, torch.int32, (k, n)),
        table=(table, torch.int8, (m, n_f, entries)),
        mask=(mask, torch.int8, (m, n_f)), bias=(bias, torch.int32, (m,)))
    out = torch.empty((b, m), dtype=torch.int32, device=device)
    if b == 0:
        return out
    fn = build.kernel_function("wnn.cu", "fused_wnn_launch", _ARGTYPES)
    # a hash at or past E (only from malformed parameters) reads nothing
    # and answers 0
    rc = fn(tuples.data_ptr(), params.data_ptr(), table.data_ptr(),
            mask.data_ptr(), bias.data_ptr(), out.data_ptr(),
            b, n_f, n, k, m, entries, launch.stream_handle(device))
    build.check_launch("fused_wnn_launch", rc)
    fused_wnn.launches += 1
    return out


fused_wnn.launches = 0
