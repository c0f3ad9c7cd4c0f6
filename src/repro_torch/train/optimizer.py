"""Optimizers and schedules (port of `repro/train/optimizer.py`).

The same functional API: `opt = adamw(lr)`, `state = opt.init(params)`,
`updates, state = opt.update(grads, state, params)`,
`params = apply_updates(params, updates)`, where params, grads and
updates are sequences of tensors in one order. A schedule is a function
of the () int32 step tensor that returns a () float32 tensor on its
device; `lr` may be a schedule or a float (a constant schedule).

The arithmetic follows the JAX package step for step in float32 (bias
corrections `1 - b ** step` on a float32 step, `-lr * mhat / (sqrt(vhat)
+ eps)`, then the decoupled decay `- lr * wd * p`), which is why this is
not `torch.optim`: that arranges the bias correction differently and
would round differently. Divisions by a Python number are taken as
divisions by a tensor: CUDA turns the former into a product with the
reciprocal, which can round otherwise than JAX's division.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple, Optional, Sequence

import torch

Schedule = Callable[[torch.Tensor], torch.Tensor]


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable
    update: Callable


def apply_updates(params: Sequence[torch.Tensor],
                  updates: Sequence[torch.Tensor]) -> tuple:
    return tuple(p + u.to(p.dtype) for p, u in zip(params, updates))


def _zeros_like(params, dtype=None) -> tuple:
    return tuple(torch.zeros_like(p, dtype=dtype or p.dtype) for p in params)


def _div(x: torch.Tensor, divisor: float) -> torch.Tensor:
    """x / divisor as a true float32 division (see the module docstring)."""
    return x / torch.tensor(divisor, dtype=torch.float32, device=x.device)


def global_norm(tree: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of every leaf's sum of squares, in float32."""
    leaves = [torch.sum(torch.square(x.float())) for x in tree]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


def clip_by_global_norm(tree: Sequence[torch.Tensor],
                        max_norm: float) -> tuple:
    """(the leaves scaled by min(1, max_norm / (norm + 1e-9)), norm)."""
    norm = global_norm(tree)
    scale = torch.clamp(torch.full_like(norm, max_norm) / (norm + 1e-9),
                        max=1.0)
    return tuple(x * scale.to(x.dtype) for x in tree), norm


# --------------------------------------------------------------------------
# Schedules
# --------------------------------------------------------------------------

def _step_f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def constant_schedule(value: float) -> Schedule:
    def sched(step):
        return torch.full((), value, dtype=torch.float32,
                          device=torch.as_tensor(step).device)
    return sched


def warmup_cosine_schedule(peak: float, warmup_steps: int, total_steps: int,
                           floor: float = 0.0) -> Schedule:
    """Linear warm-up to `peak` over `warmup_steps`, then a cosine decay
    to `floor` at `total_steps` (held there after it)."""
    def sched(step):
        step = _step_f32(step)
        warm = _div(peak * step, max(1.0, warmup_steps))
        frac = torch.clamp(_div(step - warmup_steps,
                                max(1.0, total_steps - warmup_steps)),
                           0.0, 1.0)
        cos = floor + 0.5 * (peak - floor) * (1.0 + torch.cos(math.pi * frac))
        return torch.where(step < warmup_steps, warm, cos)
    return sched


def linear_warmup_schedule(peak: float, warmup_steps: int) -> Schedule:
    def sched(step):
        step = _step_f32(step)
        return peak * torch.clamp(_div(step, max(1.0, warmup_steps)),
                                  max=1.0)
    return sched


def _as_schedule(lr) -> Schedule:
    return lr if callable(lr) else constant_schedule(lr)


# --------------------------------------------------------------------------
# Optimizers
# --------------------------------------------------------------------------

class SGDState(NamedTuple):
    step: torch.Tensor          # () int32
    momentum: Optional[tuple]


def sgd(lr, momentum: float = 0.0, nesterov: bool = False) -> Optimizer:
    """SGD, with heavy-ball or Nesterov momentum when `momentum` > 0."""
    lr = _as_schedule(lr)

    def init(params):
        mom = _zeros_like(params) if momentum else None
        return SGDState(torch.zeros((), dtype=torch.int32,
                                    device=params[0].device), mom)

    def update(grads, state: SGDState, params=None):
        step = state.step + 1
        lr_t = lr(state.step)
        if momentum:
            mom = tuple(momentum * m + g
                        for m, g in zip(state.momentum, grads))
            if nesterov:
                upd = tuple(-lr_t * (momentum * m + g)
                            for m, g in zip(mom, grads))
            else:
                upd = tuple(-lr_t * m for m in mom)
            return upd, SGDState(step, mom)
        return tuple(-lr_t * g for g in grads), SGDState(step, None)

    return Optimizer(init, update)


class AdamState(NamedTuple):
    step: torch.Tensor      # () int32
    mu: tuple
    nu: tuple


def adam(lr, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
         weight_decay: float = 0.0, mu_dtype=torch.float32) -> Optimizer:
    """Adam, or AdamW (decoupled weight decay) when weight_decay > 0 and
    `update` is given the parameters. First moments in `mu_dtype`, second
    moments in float32."""
    lr = _as_schedule(lr)

    def init(params):
        return AdamState(
            torch.zeros((), dtype=torch.int32, device=params[0].device),
            _zeros_like(params, mu_dtype), _zeros_like(params, torch.float32))

    def update(grads, state: AdamState, params=None):
        step = state.step + 1
        lr_t = lr(state.step)
        stepf = step.to(torch.float32)
        bc1 = 1.0 - torch.full_like(stepf, b1) ** stepf
        bc2 = 1.0 - torch.full_like(stepf, b2) ** stepf
        mu = tuple(b1 * m + (1.0 - b1) * g.to(m.dtype)
                   for m, g in zip(state.mu, grads))
        nu = tuple(b2 * v + (1.0 - b2) * g.float() * g.float()
                   for v, g in zip(state.nu, grads))

        def step_fn(m, v, p):
            u = -lr_t * (m.float() / bc1) / (torch.sqrt(v / bc2) + eps)
            if weight_decay and p is not None:
                u = u - lr_t * weight_decay * p.float()
            return u

        ps = params if params is not None else (None,) * len(mu)
        upd = tuple(step_fn(m, v, p) for m, v, p in zip(mu, nu, ps))
        return upd, AdamState(step, mu, nu)

    return Optimizer(init, update)


def adamw(lr, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1, mu_dtype=torch.float32) -> Optimizer:
    return adam(lr, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay,
                mu_dtype=mu_dtype)


def chain_clip(optimizer: Optimizer, max_norm: float) -> Optimizer:
    """Global-norm clipping composed in front of an optimizer."""

    def update(grads, state, params=None):
        grads, _ = clip_by_global_norm(grads, max_norm)
        return optimizer.update(grads, state, params)

    return Optimizer(optimizer.init, update)
