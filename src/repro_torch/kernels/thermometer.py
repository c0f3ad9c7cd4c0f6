"""Thermometer encode and bus decompression, the accelerator's input front
end (port of `repro/kernels/thermometer.py`).

`thermometer_encode` compares (B, F) features against per-feature (F, T)
thresholds and emits the unary code as int8 bits; `thermometer_decompress`
rebuilds the same bits from per-feature set-bit counts (paper Fig. 8
left). On CUDA tensors both launch the hand-written kernels in
`csrc/thermometer.cu`; on CPU tensors they run the plain versions
`ref.thermometer_ref` / `ref.decompress_ref`. They are CUDA rather than
Triton so that all four serve-path kernels share one build path.

The kernels see the output as one flat array of B·F·T bytes and write it
in `TILE`-byte tiles a block, `CHUNK` bytes a warp and 16 a lane
(`csrc/thermometer.cu`). The encoder's thresholds, with their first
`CHUNK` values repeated after them, sit in shared memory while that ring
holds at most `STAGED_FLOATS` floats (`thresholds_staged`), else they
are read from global memory. The wrappers take contiguous inputs only (a
column slice of a wider tensor raises) and allocate the output, so its
16-byte stores are aligned.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, launch, ref

_ENCODE_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int,
                                            ctypes.c_int, ctypes.c_void_p]
_DECOMPRESS_ARGTYPES = [ctypes.c_void_p] * 2 + [ctypes.c_longlong,
                                                ctypes.c_int, ctypes.c_void_p]
CHUNK = 512                 # csrc/thermometer.cu kChunk: bytes a warp step
TILE = 16384                # csrc/thermometer.cu kTile: bytes a block step
STAGED_FLOATS = 11264       # csrc/thermometer.cu kMaxStaged


def thresholds_staged(features: int, bits: int) -> bool:
    """Whether the encoder stages its (F, T) thresholds (and the ring's
    first CHUNK repeated) in shared memory."""
    return features * bits + CHUNK <= STAGED_FLOATS


def thermometer_encode(x: torch.Tensor,
                       thresholds: torch.Tensor) -> torch.Tensor:
    """x: (B, F) f32; thresholds: (F, T) f32 -> bits (B, F, T) int8.
    `x > threshold`, so a NaN feature encodes to all zeros."""
    if x.device.type == "cpu":
        return ref.thermometer_ref(x, thresholds)
    if x.ndim != 2 or thresholds.ndim != 2 or \
            thresholds.shape[0] != x.shape[1]:
        raise ValueError(f"expected x (B, F) and thresholds (F, T), got "
                         f"{tuple(x.shape)} and {tuple(thresholds.shape)}")
    b, f = x.shape
    t = thresholds.shape[1]
    device = launch.check_cuda_args(
        "thermometer_encode", x=(x, torch.float32, (b, f)),
        thresholds=(thresholds, torch.float32, (f, t)))
    out = torch.empty((b, f, t), dtype=torch.int8, device=device)
    if b * f == 0 or t == 0:
        return out
    fn = build.kernel_function("thermometer.cu", "thermometer_encode_launch",
                               _ENCODE_ARGTYPES)
    rc = fn(x.data_ptr(), thresholds.data_ptr(), out.data_ptr(), b * f, f, t,
            launch.stream_handle(device))
    build.check_launch("thermometer_encode_launch", rc)
    thermometer_encode.launches += 1
    return out


def thermometer_decompress(counts: torch.Tensor, bits: int) -> torch.Tensor:
    """counts: (B, F) uint8 -> unary bits (B, F, T=bits) int8."""
    if counts.device.type == "cpu":
        return ref.decompress_ref(counts, bits)
    if counts.ndim != 2:
        raise ValueError(f"counts must be (B, F), got {tuple(counts.shape)}")
    b, f = counts.shape
    device = launch.check_cuda_args(
        "thermometer_decompress", counts=(counts, torch.uint8, (b, f)))
    out = torch.empty((b, f, bits), dtype=torch.int8, device=device)
    if b * f == 0 or bits == 0:
        return out
    fn = build.kernel_function("thermometer.cu",
                               "thermometer_decompress_launch",
                               _DECOMPRESS_ARGTYPES)
    rc = fn(counts.data_ptr(), out.data_ptr(), b * f, bits,
            launch.stream_handle(device))
    build.check_launch("thermometer_decompress_launch", rc)
    thermometer_decompress.launches += 1
    return out


thermometer_encode.launches = 0
thermometer_decompress.launches = 0
