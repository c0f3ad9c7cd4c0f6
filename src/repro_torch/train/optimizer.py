"""Adam, as the JAX package writes it (port of `repro/train/optimizer.py`,
`adam` and `apply_updates`).

The same functional API: `opt = adam(lr)`, `state = opt.init(params)`,
`updates, state = opt.update(grads, state)`,
`params = apply_updates(params, updates)`, where params, grads and
updates are sequences of tensors. The arithmetic follows the JAX package
step for step in float32 (bias corrections `1 - b ** step` on a float32
step, `-lr * mhat / (sqrt(vhat) + eps)`), which is why this is not
`torch.optim.Adam`: that arranges the bias correction differently and
would round differently. Weight decay (AdamW) and the rest of the JAX
module come with the training infrastructure that uses them.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Sequence

import torch


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable
    update: Callable


class AdamState(NamedTuple):
    step: torch.Tensor      # () int32
    mu: tuple
    nu: tuple


def apply_updates(params: Sequence[torch.Tensor],
                  updates: Sequence[torch.Tensor]) -> tuple:
    return tuple(p + u.to(p.dtype) for p, u in zip(params, updates))


def adam(lr: float, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8) -> Optimizer:
    """Adam with a constant learning rate; float32 moments."""

    def init(params):
        return AdamState(
            torch.zeros((), dtype=torch.int32, device=params[0].device),
            tuple(torch.zeros_like(p, dtype=torch.float32) for p in params),
            tuple(torch.zeros_like(p, dtype=torch.float32) for p in params))

    def update(grads, state: AdamState):
        step = state.step + 1
        stepf = step.to(torch.float32)
        bc1 = 1.0 - torch.full_like(stepf, b1) ** stepf
        bc2 = 1.0 - torch.full_like(stepf, b2) ** stepf
        lr_t = torch.full_like(stepf, lr)
        mu = tuple(b1 * m + (1.0 - b1) * g.float()
                   for m, g in zip(state.mu, grads))
        nu = tuple(b2 * v + (1.0 - b2) * g.float() * g.float()
                   for v, g in zip(state.nu, grads))
        upd = tuple(-lr_t * (m / bc1) / (torch.sqrt(v / bc2) + eps)
                    for m, v in zip(mu, nu))
        return upd, AdamState(step, mu, nu)

    return Optimizer(init, update)
