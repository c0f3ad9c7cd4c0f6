"""Multi-shot (gradient/STE) training for ULEEN (port of
`repro/core/multi_shot.py`).

Continuous Bloom tables in [-1, 1], unit-step binarisation on the forward
pass, straight-through gradients, softmax + cross-entropy over summed
ensemble responses, Adam(1e-3), dropout(0.5) on filter outputs. Hashes are
precomputed once per run (they carry no gradient), through the hash
kernel on a GPU.

The train step is a function of (params, opt_state, hashes, labels,
generator) that returns new params and state, as in the JAX package. Only
the tables and the bias are trained: the pruning masks carry no gradient
and stay out of Adam (JAX's Adam steps them by -0.0).

The blocked batch reduction (`grad_blocks` > 1) can draw each block's
dropout from a generator of its own, `block_generator(seed, step, block)`,
a function of those three numbers alone, as the JAX package folds the
block index into the step's key (`block_rng`): a rank that computes
blocks 4-7 then draws their masks without drawing 0-3, which is what
lets the distributed trainer (`launch/uleen_cell.py`) reproduce this
step bit for bit. Such a step runs under `deterministic(device)`, so
that on the GPU the gather's backward (a scatter-add) sums in a fixed
order, and on the CPU one thread does the work.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Callable, NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.model import (SubmodelStatic, UleenParams, UleenSpec,
                                    compute_hashes, forward)
from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.train import optimizer as opt_lib


@dataclasses.dataclass(frozen=True)
class MultiShotConfig:
    epochs: int = 10
    batch_size: int = 256
    learning_rate: float = 1e-3
    clip_table: float = 1.0          # keep entries in [-1, 1] (paper init range)
    label_smoothing: float = 0.0
    seed: int = 0
    verbose: bool = False


def cross_entropy(scores: torch.Tensor, labels: torch.Tensor,
                  smoothing: float = 0.0) -> torch.Tensor:
    logp = torch.log_softmax(scores, dim=-1)
    m = scores.shape[-1]
    onehot = torch.nn.functional.one_hot(labels.long(), m).to(scores.dtype)
    if smoothing:
        onehot = onehot * (1.0 - smoothing) + smoothing / m
    return -torch.mean(torch.sum(onehot * logp, dim=-1))


def _trainable(params: UleenParams) -> list:
    return [*params.tables, params.bias]


def _with_trainable(params: UleenParams, leaves: Sequence) -> UleenParams:
    n = len(params.tables)
    return params._replace(tables=tuple(leaves[:n]), bias=leaves[n])


def block_generator(seed: int, step: int, block: int,
                    device=DEFAULT_DEVICE) -> torch.Generator:
    """The dropout generator of batch block `block` of train step `step`
    of a run seeded `seed`, on `device`: seeded from the three numbers
    alone (numpy's SeedSequence mixes them into 63 bits), so any rank
    draws block j's masks without drawing another block's."""
    mixed = np.random.SeedSequence([seed, step, block]).generate_state(
        2, np.uint32)
    value = ((int(mixed[0]) << 32) | int(mixed[1])) & (2 ** 63 - 1)
    return torch.Generator(device=resolve_device(device)).manual_seed(value)


@contextlib.contextmanager
def deterministic(device):
    """torch's deterministic algorithms switched on (restored after), so
    that the same step gives the same bits on every run and every rank,
    the GPU's scatter-add included; when `device` is the CPU, one thread
    as well. On several CPU threads, the first float32 `torch.sqrt` of a
    process (Adam's) sometimes returned a few thousand of a table's
    27,520 results up to 6e-4 relative off (about one process in five
    under load); on one thread it never did in 30 runs. The cause is not
    known (PERF.md, Open questions); the GPU's sqrt is not affected."""
    prev = torch.are_deterministic_algorithms_enabled()
    threads = torch.get_num_threads()
    pin = torch.device(device).type == "cpu"
    torch.use_deterministic_algorithms(True)
    if pin:
        torch.set_num_threads(1)
    try:
        yield
    finally:
        if pin:
            torch.set_num_threads(threads)
        torch.use_deterministic_algorithms(prev)


def block_grads(loss_fn, params: UleenParams, hashes, labels, *,
                generator=None, keep=None):
    """(grads, loss, acc) of one batch block: grads over the trainable
    leaves (tables..., bias) of `params`."""
    leaves = [t.detach().requires_grad_(True) for t in _trainable(params)]
    loss, acc = loss_fn(_with_trainable(params, leaves), hashes, labels,
                        generator, keep)
    grads = torch.autograd.grad(loss, leaves)
    return list(grads), loss.detach(), acc


def fold_blocks(grads, losses, accs, like: UleenParams):
    """The blocked reduction's fold: zeros + g_0 + ... + g_{S-1} in block
    order, then x 1/S, for the gradients (one list of trainable leaves a
    block), the losses and the accuracies. The distributed trainer folds
    the gathered blocks with this same function."""
    dev = losses[0].device
    g_acc = [torch.zeros_like(t, dtype=torch.float32)
             for t in _trainable(like)]
    l_acc = torch.zeros((), dtype=torch.float32, device=dev)
    a_acc = torch.zeros((), dtype=torch.float32, device=dev)
    for g, loss, acc in zip(grads, losses, accs):
        g_acc = [x + y for x, y in zip(g_acc, g)]
        l_acc = l_acc + loss
        a_acc = a_acc + acc
    inv = 1.0 / len(losses)
    return [g * inv for g in g_acc], l_acc * inv, a_acc * inv


def blocked_grads(loss_fn, params: UleenParams, hashes, labels, *,
                  blocks: int, generator=None, keep=None,
                  block_generators=None):
    """(grads, loss, acc) via the canonical blocked batch reduction.

    The batch splits into `blocks` equal row blocks; each block's gradient
    is computed whole (its own dropout draws, or rows of `keep`), and the
    blocks combine by a left fold in block order, divided by the block
    count at the end — the JAX package's fixed fold order
    (`fold_blocks`). Block j draws its dropout from `block_generators[j]`
    when they are given (then under `deterministic`), else every block
    draws in turn from `generator`.
    """
    b = labels.shape[0]
    if b % blocks:
        raise ValueError(f"batch {b} not divisible by grad_blocks {blocks}")
    if block_generators is not None and len(block_generators) != blocks:
        raise ValueError(f"{len(block_generators)} block generators for "
                         f"{blocks} blocks")
    rows = b // blocks
    grads, losses, accs = [], [], []
    for s in range(blocks):
        sl = slice(s * rows, (s + 1) * rows)
        kb = None if keep is None else [k[sl] for k in keep]
        gen = generator if block_generators is None else block_generators[s]
        with (deterministic(labels.device) if block_generators is not None
              else contextlib.nullcontext()):
            g, loss, acc = block_grads(loss_fn, params,
                                       tuple(h[sl] for h in hashes),
                                       labels[sl], generator=gen, keep=kb)
        grads.append(g)
        losses.append(loss)
        accs.append(acc)
    return fold_blocks(grads, losses, accs, params)


def make_train_step(spec: UleenSpec, optimizer: opt_lib.Optimizer,
                    clip_table: float = 1.0, smoothing: float = 0.0,
                    *, grad_blocks: int = 1) -> Callable:
    """The single-device multi-shot STE train step:
    `train_step(params, opt_state, hashes, labels, generator=None, *,
    keep=None, block_generators=None) -> (params, opt_state, loss, acc)`.

    `opt_state` is `optimizer.init` of the trainable leaves (tables...,
    bias). `keep` hands in the per-submodel dropout keep-masks for the
    whole batch (row blocks are sliced from it); without it the masks are
    drawn from `generator`, or with grad_blocks=S>1 (the blocked batch
    reduction, `blocked_grads`) from `block_generators`, one a block; the
    step then runs under `deterministic`, the optimizer's update
    included.
    """
    loss_fn = make_loss_fn(spec, smoothing)

    def train_step(params: UleenParams, opt_state, hashes, labels,
                   generator: Optional[torch.Generator] = None, *,
                   keep=None, block_generators=None):
        with (deterministic(labels.device) if block_generators is not None
              else contextlib.nullcontext()):
            if grad_blocks > 1:
                grads, loss, acc = blocked_grads(
                    loss_fn, params, hashes, labels, blocks=grad_blocks,
                    generator=generator, keep=keep,
                    block_generators=block_generators)
            else:
                grads, loss, acc = block_grads(
                    loss_fn, params, hashes, labels, generator=generator,
                    keep=keep)
            params, opt_state = apply_step(params, opt_state, grads,
                                           optimizer, clip_table)
        return params, opt_state, loss, acc

    return train_step


def make_loss_fn(spec: UleenSpec, smoothing: float = 0.0) -> Callable:
    """(params, hashes, labels, generator, keep) -> (loss, accuracy): the
    train-mode forward, cross-entropy and the batch's accuracy."""
    def loss_fn(params, hashes, labels, generator, keep):
        scores = forward(spec, params, hashes, train=True,
                         generator=generator, keep=keep)
        loss = cross_entropy(scores, labels, smoothing)
        acc = torch.mean((torch.argmax(scores, -1) == labels).float())
        return loss, acc.detach()
    return loss_fn


def apply_step(params: UleenParams, opt_state, grads, optimizer,
               clip_table: float = 1.0):
    """(params, opt_state) after the optimizer's update of the trainable
    leaves by `grads`, the tables then clipped to +-clip_table."""
    leaves = _trainable(params)
    updates, opt_state = optimizer.update(grads, opt_state)
    params = _with_trainable(params, opt_lib.apply_updates(leaves, updates))
    if clip_table:
        params = params._replace(tables=tuple(
            torch.clamp(t, -clip_table, clip_table) for t in params.tables))
    return params, opt_state


def make_eval_fn(spec: UleenSpec) -> Callable:
    def eval_fn(params, hashes, labels) -> torch.Tensor:
        with torch.no_grad():
            scores = forward(spec, params, hashes, train=False)
            return torch.mean((torch.argmax(scores, -1) == labels).float())
    return eval_fn


class TrainResult(NamedTuple):
    params: UleenParams      # best-validation-epoch snapshot
    history: list
    val_accuracy: float      # accuracy of the returned params


def params_to(params: UleenParams, device: torch.device) -> UleenParams:
    """`params` with every tensor on `device` (float32 tables and bias)."""
    return UleenParams(
        tables=tuple(torch.as_tensor(t).to(device, torch.float32)
                     for t in params.tables),
        bias=torch.as_tensor(params.bias).to(device, torch.float32),
        masks=tuple(torch.as_tensor(m).to(device, torch.float32)
                    for m in params.masks))


def clone_params(params: UleenParams) -> UleenParams:
    return UleenParams(tables=tuple(t.clone() for t in params.tables),
                       bias=params.bias.clone(),
                       masks=tuple(m.clone() for m in params.masks))


def _labels(labels, device) -> torch.Tensor:
    return torch.as_tensor(labels).to(device, torch.int64)


def train_multi_shot(spec: UleenSpec, statics: Sequence[SubmodelStatic],
                     params: UleenParams, bits_train, labels_train,
                     bits_val, labels_val,
                     cfg: MultiShotConfig = MultiShotConfig(), *,
                     device=DEFAULT_DEVICE) -> TrainResult:
    """Single-device training driver on `device`.

    Batches follow `np.random.default_rng(cfg.seed).permutation(n)` per
    epoch, as in the JAX package; dropout draws from a `torch.Generator`
    seeded with `cfg.seed`. Returns a clone of the best-validation-epoch
    params (the model keeps hopping between nearby solutions under STE +
    dropout, so the last epoch is an arbitrary draw from that plateau).
    val_accuracy is the selected epoch's accuracy on the val split, which
    also does model selection, as the one-shot bleach search does.
    """
    dev = resolve_device(device)
    params = params_to(params, dev)
    optimizer = opt_lib.adam(cfg.learning_rate)
    opt_state = optimizer.init(_trainable(params))
    train_step = make_train_step(spec, optimizer, cfg.clip_table,
                                 cfg.label_smoothing)
    eval_fn = make_eval_fn(spec)

    # hashes are static per sample: compute once for the whole run
    h_train = compute_hashes(spec, statics, bits_train, device=dev)
    h_val = compute_hashes(spec, statics, bits_val, device=dev)
    y_train = _labels(labels_train, dev)
    y_val = _labels(labels_val, dev)

    n = y_train.shape[0]
    steps_per_epoch = max(1, n // cfg.batch_size)
    gen = torch.Generator(device=dev).manual_seed(cfg.seed)
    history = []
    rng_np = np.random.default_rng(cfg.seed)
    best_acc, best_params = -1.0, params

    for epoch in range(cfg.epochs):
        perm = torch.from_numpy(rng_np.permutation(n)).to(dev)
        # float64 sums of the float32 step values, as the JAX driver sums
        # Python floats; read once per epoch
        ep_loss = torch.zeros((), dtype=torch.float64, device=dev)
        ep_acc = torch.zeros((), dtype=torch.float64, device=dev)
        for s in range(steps_per_epoch):
            idx = perm[s * cfg.batch_size:(s + 1) * cfg.batch_size]
            hb = tuple(h[idx] for h in h_train)
            params, opt_state, loss, acc = train_step(
                params, opt_state, hb, y_train[idx], gen)
            ep_loss += loss.double()
            ep_acc += acc.double()
        val_acc = float(eval_fn(params, h_val, y_val))
        if val_acc > best_acc:
            best_acc, best_params = val_acc, clone_params(params)
        history.append(dict(epoch=epoch,
                            loss=float(ep_loss) / steps_per_epoch,
                            train_acc=float(ep_acc) / steps_per_epoch,
                            val_acc=val_acc, time=time.time()))
        if cfg.verbose:
            print(f"[multi-shot] epoch {epoch}: "
                  f"loss={history[-1]['loss']:.4f} "
                  f"train_acc={history[-1]['train_acc']:.4f} "
                  f"val_acc={val_acc:.4f}")
    return TrainResult(params=best_params, history=history,
                       val_accuracy=best_acc if history else 0.0)


def evaluate(spec: UleenSpec, statics: Sequence[SubmodelStatic],
             params: UleenParams, bits, labels, *,
             device=DEFAULT_DEVICE) -> float:
    dev = resolve_device(device)
    hashes = compute_hashes(spec, statics, bits, device=dev)
    return float(make_eval_fn(spec)(params_to(params, dev), hashes,
                                    _labels(labels, dev)))
