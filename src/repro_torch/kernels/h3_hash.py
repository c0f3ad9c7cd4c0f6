"""The H3 hash precompute of multi-shot training (port of
`repro/kernels/h3_hash.py`).

Training hashes every sample once per run: B x N_f x k hashes over n-bit
tuples. On CUDA tensors `h3_hash` launches the hand-written Hopper kernel
in `csrc/h3_hash.cu` (one thread per tuple, the (k, n) parameters in
shared memory, no block padding); on CPU tensors it runs the plain version
`ref.h3_hash_ref`. Neither bounds k or n.

The launch is the registered operator `repro_torch::h3_hash`: a trace with
fake tensors records it as one node with its (B, N_f, k) int32 output and
2·n·k operations a tuple, and never builds or launches the kernel. Its
body is the `ctypes` launch and the only place a launch is counted.
"""
from __future__ import annotations

import ctypes

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import build, launch, ref

_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int,
                                     ctypes.c_int, ctypes.c_void_p]


def launch_direct(tuples: torch.Tensor, params: torch.Tensor,
                  out: torch.Tensor) -> None:
    """The `ctypes` launch of `h3_hash_launch` into `out` (B, N_f, k), with
    no check and no count: the operator's body, and the yardstick the
    operator's dispatch is timed against."""
    b, n_f, n = tuples.shape
    fn = build.kernel_function("h3_hash.cu", "h3_hash_launch", _ARGTYPES)
    rc = fn(tuples.data_ptr(), params.data_ptr(), out.data_ptr(), b * n_f, n,
            params.shape[0], launch.stream_handle(tuples.device))
    build.check_launch("h3_hash_launch", rc)


def h3_hash_op(tuples: torch.Tensor, params: torch.Tensor) -> torch.Tensor:
    """The CUDA body of `repro_torch::h3_hash`: one `csrc/h3_hash.cu`
    launch, (B, N_f, n) int8 tuples and (k, n) int32 parameters ->
    (B, N_f, k) int32 hashes. Counts one launch."""
    out = torch.empty((*tuples.shape[:2], params.shape[0]),
                      dtype=torch.int32, device=tuples.device)
    launch_direct(tuples, params, out)
    h3_hash.launches += 1
    return out


# torch.library's dispatcher interface, as `repro_torch::wnn_ensemble`
_LIB = torch.library.Library("repro_torch", "FRAGMENT")
_LIB.define("h3_hash(Tensor tuples, Tensor params) -> Tensor")
_LIB.impl("h3_hash", h3_hash_op, "CUDA")


@torch.library.register_fake("repro_torch::h3_hash", lib=_LIB)
def _h3_hash_fake(tuples, params):
    return tuples.new_empty((*tuples.shape[:2], params.shape[0]),
                            dtype=torch.int32)


@register_flop_formula(torch.ops.repro_torch.h3_hash)
def _h3_hash_flops(tuples_shape, params_shape, *, out_shape=None,
                   **kwargs) -> int:
    """A select and an XOR per input bit and hash, as the kernel issues
    them: 2·n·k a tuple."""
    b, n_f, n = tuples_shape
    return 2 * n * params_shape[0] * b * n_f


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
    if b * n_f * k == 0:
        return torch.empty((b, n_f, k), dtype=torch.int32, device=device)
    return torch.ops.repro_torch.h3_hash.default(tuples, params)


h3_hash.launches = 0
