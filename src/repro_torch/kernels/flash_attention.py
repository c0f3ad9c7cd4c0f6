"""Prefill attention of the LM zoo (port of
`repro/kernels/flash_attention.py::flash_attention_tiled` together with the
GQA head repetition of `repro/kernels/ops.py::flash_attention`).

On CUDA tensors `flash_attention` launches the hand-written Hopper kernel
in `csrc/flash_attention.cu`: streaming softmax over key tiles in float32,
GQA by reading KV head `h // (H // Hkv)` in place (no repeated copy), key
tiles wholly hidden by the causal or window mask skipped. On CPU tensors it
runs the plain version `ref.attention_ref`.

Layout: the kernel reads q, k and v through their (batch, head, row)
strides and needs only the head dimension contiguous, so the model's
transposed (B, S, H, hd) -> (B, H, S, hd) views enter without a copy. The
output is written into a (B, Sq, H, D) buffer and returned as its
(B, H, Sq, D) transposed view: the model's output projection reads that
buffer as it lies. So a prefill layer makes no copy for attention.

Rows with no visible key (only with `window > 0` and
`Sq + q_offset >= Sk + window`) raise here: the plain version averages all
Sk keys uniformly on such rows, which the kernel does not reproduce.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, launch, ref

HEAD_DIMS = (16, 32, 64, 128, 256)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
             + [ctypes.c_longlong] * 12
             + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p])


def has_empty_rows(sq: int, sk: int, *, window: int, q_offset: int) -> bool:
    """True when some query row sees no key: with a window, row i sees
    keys j > i + q_offset - window, none of which exist once
    i + q_offset >= Sk + window - 1."""
    return sk < 1 or (window > 0 and sq + q_offset >= sk + window)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    scale: float | None = None,
                    q_offset: int = 0) -> torch.Tensor:
    """q: (B, H, Sq, D); k, v: (B, Hkv, Sk, D), H a multiple of Hkv ->
    (B, H, Sq, D) in q's dtype. Float32 or bf16 inputs; `scale` defaults
    to 1/sqrt(D); query row i sits at position i + q_offset."""
    if q.device.type == "cpu":
        return ref.attention_ref(q, k, v, causal=causal, window=window,
                                 scale=scale, q_offset=q_offset)
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError(f"flash_attention: expected q (B, H, Sq, D) and k, v "
                         f"(B, Hkv, Sk, D), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, h, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    if q.dtype not in _DTYPES:
        raise TypeError(f"flash_attention: q must be float32 or bfloat16, "
                        f"got {q.dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {d} not in {HEAD_DIMS}")
    if hkv < 1 or h % hkv:
        raise ValueError(f"flash_attention: {h} query heads are not a "
                         f"multiple of {hkv} KV heads")
    if window < 0 or q_offset < 0:
        raise ValueError(f"flash_attention: window={window} and "
                         f"q_offset={q_offset} must be >= 0")
    if has_empty_rows(sq, sk, window=window, q_offset=q_offset):
        raise ValueError(
            f"flash_attention: Sq={sq}, Sk={sk}, window={window}, "
            f"q_offset={q_offset} leaves query rows with no visible key")
    device = launch.check_cuda_args(
        "flash_attention", contiguous=False, q=(q, q.dtype, (b, h, sq, d)),
        k=(k, q.dtype, (b, hkv, sk, d)), v=(v, q.dtype, (b, hkv, sk, d)))
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=device)
    if sq == 0 or b == 0:
        return out.transpose(1, 2)
    scale = float(d ** -0.5 if scale is None else scale)
    fn = build.kernel_function("flash_attention.cu", "flash_attention_launch",
                               _ARGTYPES)
    os_ = out.transpose(1, 2).stride()
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _DTYPES[q.dtype], b, h, hkv, sq, sk, d,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *os_[:3],
            scale, int(bool(causal)), int(window), int(q_offset),
            launch.stream_handle(device))
    build.check_launch("flash_attention_launch", rc)
    flash_attention.launches += 1
    return out.transpose(1, 2)


flash_attention.launches = 0
