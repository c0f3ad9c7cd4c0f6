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

Each launch is a registered operator, `repro_torch::thermometer_encode`
and `repro_torch::thermometer_decompress` (`Library.define/impl`, as
`repro_torch::wnn_ensemble`): a trace with fake tensors records one node
with its (B, F, T) int8 output and its comparisons (one an output
byte), and never builds or launches a kernel. The operator's body is the
`ctypes` launch and the only place a launch is counted.
"""
from __future__ import annotations

import ctypes

import torch
from torch.utils.flop_counter import register_flop_formula

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
    if b * f == 0 or t == 0:
        return torch.empty((b, f, t), dtype=torch.int8, device=device)
    return torch.ops.repro_torch.thermometer_encode.default(x, thresholds)


def thermometer_decompress(counts: torch.Tensor, bits: int) -> torch.Tensor:
    """counts: (B, F) uint8 -> unary bits (B, F, T=bits) int8."""
    if counts.device.type == "cpu":
        return ref.decompress_ref(counts, bits)
    if counts.ndim != 2:
        raise ValueError(f"counts must be (B, F), got {tuple(counts.shape)}")
    b, f = counts.shape
    device = launch.check_cuda_args(
        "thermometer_decompress", counts=(counts, torch.uint8, (b, f)))
    if b * f == 0 or bits == 0:
        return torch.empty((b, f, bits), dtype=torch.int8, device=device)
    return torch.ops.repro_torch.thermometer_decompress.default(counts,
                                                                int(bits))


def encode_direct(x: torch.Tensor, thresholds: torch.Tensor,
                  out: torch.Tensor) -> None:
    """The `ctypes` launch of `thermometer_encode_launch` into `out`
    (B, F, T), with no check and no count: the operator's body, and the
    yardstick it is timed against."""
    b, f = x.shape
    fn = build.kernel_function("thermometer.cu", "thermometer_encode_launch",
                               _ENCODE_ARGTYPES)
    rc = fn(x.data_ptr(), thresholds.data_ptr(), out.data_ptr(), b * f, f,
            thresholds.shape[1], launch.stream_handle(x.device))
    build.check_launch("thermometer_encode_launch", rc)


def decompress_direct(counts: torch.Tensor, out: torch.Tensor) -> None:
    """The `ctypes` launch of `thermometer_decompress_launch` into `out`
    (B, F, T), with no check and no count."""
    b, f = counts.shape
    fn = build.kernel_function("thermometer.cu",
                               "thermometer_decompress_launch",
                               _DECOMPRESS_ARGTYPES)
    rc = fn(counts.data_ptr(), out.data_ptr(), b * f, out.shape[2],
            launch.stream_handle(counts.device))
    build.check_launch("thermometer_decompress_launch", rc)


def thermometer_encode_op(x: torch.Tensor,
                          thresholds: torch.Tensor) -> torch.Tensor:
    """The CUDA body of `repro_torch::thermometer_encode`: one launch into
    a new (B, F, T) int8 tensor. Counts one launch."""
    out = torch.empty((*x.shape, thresholds.shape[1]), dtype=torch.int8,
                      device=x.device)
    encode_direct(x, thresholds, out)
    thermometer_encode.launches += 1
    return out


def thermometer_decompress_op(counts: torch.Tensor,
                              bits: int) -> torch.Tensor:
    """The CUDA body of `repro_torch::thermometer_decompress`: one launch
    into a new (B, F, bits) int8 tensor. Counts one launch."""
    out = torch.empty((*counts.shape, bits), dtype=torch.int8,
                      device=counts.device)
    decompress_direct(counts, out)
    thermometer_decompress.launches += 1
    return out


_LIB = torch.library.Library("repro_torch", "FRAGMENT")
_LIB.define("thermometer_encode(Tensor x, Tensor thresholds) -> Tensor")
_LIB.define("thermometer_decompress(Tensor counts, int bits) -> Tensor")
_LIB.impl("thermometer_encode", thermometer_encode_op, "CUDA")
_LIB.impl("thermometer_decompress", thermometer_decompress_op, "CUDA")


@torch.library.register_fake("repro_torch::thermometer_encode", lib=_LIB)
def _encode_fake(x, thresholds):
    return x.new_empty((*x.shape, thresholds.shape[1]), dtype=torch.int8)


@torch.library.register_fake("repro_torch::thermometer_decompress",
                             lib=_LIB)
def _decompress_fake(counts, bits):
    return counts.new_empty((*counts.shape, bits), dtype=torch.int8)


@register_flop_formula(torch.ops.repro_torch.thermometer_encode)
def _encode_flops(x_shape, thresholds_shape, *, out_shape=None,
                  **kwargs) -> int:
    """One comparison an output bit: x[b, f] > thresholds[f, t]."""
    return x_shape[0] * x_shape[1] * thresholds_shape[1]


@register_flop_formula(torch.ops.repro_torch.thermometer_decompress)
def _decompress_flops(counts_shape, bits, *, out_shape=None,
                      **kwargs) -> int:
    """One comparison an output bit: t < counts[b, f]."""
    return counts_shape[0] * counts_shape[1] * bits


thermometer_encode.launches = 0
thermometer_decompress.launches = 0
