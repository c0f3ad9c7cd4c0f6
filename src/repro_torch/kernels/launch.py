"""Argument checks and stream handles shared by the kernel wrappers.

A kernel reads raw pointers, so before a launch its wrapper checks what
the C side cannot: every tensor on the same CUDA device, of the expected
dtype and shape, contiguous. These are integer compares, cheap enough for
every launch; the geometry checks with the JAX package's messages
(`ops.validate_wnn_geometry`, `PackedTables.validate`) run once, where a
caller hands in tables. A tensor on any other device raises — the
wrappers take their plain version only for CPU tensors, never as a
fallback. The grid of each kernel is chosen by its C entry point from the
shapes it is passed (csrc/*.cu); nothing here depends on the TPU's block
sizes.
"""
from __future__ import annotations

import torch

# The JAX package's bounds on a tuple's width and hash count; the WNN
# kernel keeps each lane's k hashes of its 8 rows in registers
# (csrc/wnn.cu kMaxHashes).
MAX_TUPLE_BITS = 64
MAX_HASHES = 8


def check_cuda_args(kernel: str, *, contiguous: bool = True,
                    **tensors) -> torch.device:
    """tensors: name -> (tensor, expected dtype, expected shape). Returns
    their device. With `contiguous=False` only the last dimension must be
    contiguous: the kernel reads the others through the strides it is
    passed."""
    for name, (t, dtype, shape) in tensors.items():
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{kernel}: {name} has shape {tuple(t.shape)}, "
                             f"expected {tuple(shape)}")
        if t.dtype != dtype:
            raise TypeError(f"{kernel}: {name} must be {dtype}, got {t.dtype}")
    device = None
    for name, (t, _, _) in tensors.items():
        if t.device.type != "cuda":
            raise ValueError(f"{kernel}: {name} is on {t.device}; the "
                             "kernel takes CUDA tensors (the plain version "
                             "serves CPU tensors)")
        if device is None:
            device = t.device
        elif t.device != device:
            raise ValueError(f"{kernel}: {name} is on {t.device}, other "
                             f"inputs on {device}")
        if contiguous and not t.is_contiguous():
            raise ValueError(f"{kernel}: {name} must be contiguous")
        if not contiguous and t.numel() and t.stride(-1) != 1:
            raise ValueError(f"{kernel}: {name} must be contiguous in its "
                             "last dimension")
    return device


def wnn_dims(kernel: str, tuples: torch.Tensor, params: torch.Tensor,
             table: torch.Tensor) -> tuple:
    """(B, N_f, n, k, M, last) of a WNN launch, with k and n inside the
    kernel's bounds; the wrapper checks every tensor against them."""
    if tuples.ndim != 3 or params.ndim != 2 or table.ndim != 3:
        raise ValueError(f"{kernel}: expected tuples (B, N_f, n), params "
                         f"(k, n), table (M, N_f, E or W); got "
                         f"{tuple(tuples.shape)}, {tuple(params.shape)}, "
                         f"{tuple(table.shape)}")
    b, n_f, n = tuples.shape
    k = params.shape[0]
    m, _, last = table.shape
    if not 1 <= n <= MAX_TUPLE_BITS:
        raise ValueError(f"{kernel}: n={n} outside [1, {MAX_TUPLE_BITS}]")
    if not 1 <= k <= MAX_HASHES:
        raise ValueError(f"{kernel}: k={k} outside [1, {MAX_HASHES}]")
    return b, n_f, n, k, m, last


def stream_handle(device: torch.device) -> int:
    """The current PyTorch stream on `device`, as the integer a C entry
    point takes: kernels queue behind PyTorch's own work, unsynchronised."""
    return torch.cuda.current_stream(device).cuda_stream
