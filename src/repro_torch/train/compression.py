"""Gradient compression for the cross-pod data-parallel reduction (port of
`repro/train/compression.py`).

Intra-pod gradient reduction rides the fast links and stays full
precision; the *cross-pod* hop is the scarce resource, so gradients cross
it int8-quantised: a per-tensor scale, optional stochastic rounding, and
error feedback carried between steps.

Usage inside an SPMD train step, every rank of a mesh with a `pod` axis:

    grads, err = compressed_psum(grads, mesh, "pod", err_state)

The scale is agreed with one MAX all-reduce of a float32 scalar (max |g|
over the pods), then the payloads cross as int8 (`collectives.all_gather`
carries the int8 tensor as it is) and are summed locally in int32, an 8x
cut of cross-pod bytes. The operations follow the JAX package's order
(`x / scale`, round half to even, clip, int32 sum, `total * scale / n`),
so the mean it returns is the JAX package's, bit for bit.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from repro_torch.dist import collectives


def _q8(x: torch.Tensor, scale: torch.Tensor,
        generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """round(x / scale) clipped to [-127, 127] as int8; with a generator,
    stochastic rounding (uniform noise in [-0.5, 0.5) before the round)."""
    y = x / scale
    if generator is not None:
        y = y + (torch.rand(y.shape, generator=generator, dtype=y.dtype,
                            device=y.device) - 0.5)
    return torch.clamp(torch.round(y), -127, 127).to(torch.int8)


def compressed_psum_leaf(g: torch.Tensor, mesh, axis: str,
                         err: Optional[torch.Tensor] = None,
                         generator: Optional[torch.Generator] = None):
    """(int8 mean of `g` over the mesh `axis`, this rank's residual).

    The payload crosses the wire as int8 (all-gather, then a local int32
    sum): an all-reduce of int32-upcast payloads would put 4 B an element
    back on the link. One float32 scalar (the shared scale's absmax) is
    the only float traffic. `err` (the previous residual) is added before
    quantising: error feedback."""
    g32 = g.float()
    if err is not None:
        g32 = g32 + err
    absmax = collectives.all_reduce_max(torch.max(torch.abs(g32)), mesh,
                                        (axis,))
    scale = torch.clamp(absmax, min=1e-12) / torch.tensor(
        127.0, dtype=torch.float32, device=absmax.device)
    q = _q8(g32, scale, generator)
    gathered = collectives.all_gather(q[None], mesh, (axis,), dim=0)
    if gathered.dtype != torch.int8:
        raise AssertionError(f"the compressed wire carried {gathered.dtype}")
    total = torch.sum(gathered.to(torch.int32), dim=0)
    n = torch.tensor(gathered.shape[0], dtype=torch.float32,
                     device=total.device)
    mean = total.to(torch.float32) * scale / n
    new_err = g32 - q.to(torch.float32) * scale
    return mean.to(g.dtype), new_err


def compressed_psum(grads: Sequence[torch.Tensor], mesh, axis: str,
                    err_state: Optional[Sequence] = None):
    """`compressed_psum_leaf` over a sequence of gradient leaves: (means,
    residuals), tuples in the leaves' order. err_state=None starts error
    feedback at zero."""
    errs = list(err_state) if err_state is not None else [None] * len(grads)
    if len(errs) != len(grads):
        errs = [None] * len(grads)
    outs = [compressed_psum_leaf(g, mesh, axis, e)
            for g, e in zip(grads, errs)]
    return tuple(o for o, _ in outs), tuple(e for _, e in outs)


def quantization_bound(tree: Sequence[torch.Tensor], npods: int = 1,
                       slack: float = 1.02) -> float:
    """Worst-case |compressed_psum - exact mean| for one reduction of
    `tree` (per-pod values, or a representative tree whose absmax bounds
    every pod's): round-to-nearest onto the int8 grid of step
    `max(absmax, 1e-12) / 127` errs by at most half a step an element a
    pod, and so does the mean over pods; `slack` covers the float
    evaluation of the dequantised sum."""
    del npods
    absmax = max((float(torch.max(torch.abs(torch.as_tensor(g).float())))
                  for g in tree), default=0.0)
    scale = max(absmax, 1e-12) / 127.0
    return scale / 2.0 * slack


def cross_pod_bytes(grads: Sequence[torch.Tensor], compressed: bool) -> int:
    """Bytes of one rank's cross-pod payload: 4 an element in float32, or
    1 an element and the 4-byte scale when compressed."""
    total = 0
    for g in grads:
        n = 1
        for d in g.shape:
            n *= d
        total += n * (1 if compressed else 4) + (4 if compressed else 0)
    return total
