"""The H3 hash precompute of multi-shot training (port of
`repro/kernels/h3_hash.py`).

Training hashes every sample once per run: B x N_f x k hashes over n-bit
tuples. On CUDA tensors `h3_hash` launches the hand-written Hopper kernel
in `csrc/h3_hash.cu` (one thread per tuple, the (k, n) parameters in
shared memory, no block padding); on CPU tensors it runs the plain version
`ref.h3_hash_ref`. Neither bounds k or n.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, launch, ref

_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int,
                                     ctypes.c_int, ctypes.c_void_p]


def h3_hash(tuples: torch.Tensor, params: torch.Tensor) -> torch.Tensor:
    """tuples: (B, N_f, n) int8 {0,1}; params: (k, n) int32 -> hashes
    (B, N_f, k) int32."""
    if tuples.device.type == "cpu":
        return ref.h3_hash_ref(tuples, params)
    if tuples.ndim != 3 or params.ndim != 2:
        raise ValueError(f"h3_hash: expected tuples (B, N_f, n) and params "
                         f"(k, n), got {tuple(tuples.shape)} and "
                         f"{tuple(params.shape)}")
    b, n_f, n = tuples.shape
    k = params.shape[0]
    device = launch.check_cuda_args(
        "h3_hash", tuples=(tuples, torch.int8, (b, n_f, n)),
        params=(params, torch.int32, (k, n)))
    out = torch.empty((b, n_f, k), dtype=torch.int32, device=device)
    if out.numel() == 0:
        return out
    fn = build.kernel_function("h3_hash.cu", "h3_hash_launch", _ARGTYPES)
    rc = fn(tuples.data_ptr(), params.data_ptr(), out.data_ptr(), b * n_f, n,
            k, launch.stream_handle(device))
    build.check_launch("h3_hash_launch", rc)
    h3_hash.launches += 1
    return out


h3_hash.launches = 0
