"""The paper's own trainer at fleet scale (port of the training part of
`repro/launch/uleen_cell.py`).

The distributed ULEEN multi-shot training step (ULN-L geometry at MNIST
scale: 784 features x 7 thermometer bits, six Bloom submodels): H3
hashing, the continuous-Bloom STE forward and backward, cross-entropy and
Adam, data-parallel over every axis of a mesh of `torch.distributed`
ranks with the tables replicated (the continuous ensemble is ~12 MB; the
batch is what scales).

The JAX package runs the step under `shard_map`; the port runs it SPMD:
every rank calls the same function on its own rows and makes the
collectives itself (`dist.collectives`). The dry-run lowerings of the
JAX module (`uleen_cell_specs`, `lower_*`) have no counterpart here:
they belong to the dry-run tooling (ROADMAP.md Queue 1 item 6).
"""
from __future__ import annotations

import math
import time
from typing import Callable

import torch

from repro_torch.core import multi_shot
from repro_torch.core.model import SubmodelSpec, UleenSpec, compute_hashes
from repro_torch.dist import collectives
from repro_torch.dist.sharding import mesh_sizes
from repro_torch.train import compression
from repro_torch.train import optimizer as opt_lib

# ULN-L geometry (paper Table I), 784 px x 7 bits, dropout shared across
# classes (one mask per (sample, filter)) and bf16 tables: the
# fleet-scale configuration.
ULN_L_SPEC = UleenSpec(
    num_classes=10, total_bits=784 * 7,
    submodels=(SubmodelSpec(12, 6), SubmodelSpec(16, 7),
               SubmodelSpec(20, 7), SubmodelSpec(24, 8),
               SubmodelSpec(28, 8), SubmodelSpec(32, 9)),
    bits_per_input=7, dropout_shared_classes=True, bf16_tables=True)

GLOBAL_BATCH = 131072      # fleet-scale data parallelism
INFER_BATCH = 65536        # fleet-scale serving batch (binary model)

# The executed trainer's geometry: the tiny 2-submodel ensemble of the
# `--arch uleen` CLI and the tests (16 x 16 mnist-like at 2 thermometer
# bits = 512 total bits).
ULEEN_EXEC_SPEC = UleenSpec(
    num_classes=10, total_bits=512,
    submodels=(SubmodelSpec(12, 6), SubmodelSpec(16, 6)),
    bits_per_input=2)
EXEC_BATCH = 256           # global batch of the executed cell

# ULN-XL: 784 px x 8 thermometer bits, E up to 2^15 (the packed layout's
# target).
ULN_XL_SPEC = UleenSpec(
    num_classes=10, total_bits=784 * 8,
    submodels=(SubmodelSpec(16, 11), SubmodelSpec(24, 13),
               SubmodelSpec(32, 15)),
    bits_per_input=8, dropout_shared_classes=True)

# ULN-XL grown to a 32-way label space: the class-sharded serving target.
ULN_XL_ENSEMBLE_SPEC = UleenSpec(
    num_classes=32, total_bits=784 * 8,
    submodels=(SubmodelSpec(16, 11), SubmodelSpec(24, 13),
               SubmodelSpec(32, 15)),
    bits_per_input=8, dropout_shared_classes=True)

# ULN-S: the paper's smallest MNIST ensemble (784 px x 2 bits, three
# submodels, E = 64), the artifact a multi-tenant fleet stacks by the
# thousand.
ULN_S_SPEC = UleenSpec(
    num_classes=10, total_bits=784 * 2,
    submodels=(SubmodelSpec(12, 6), SubmodelSpec(16, 6),
               SubmodelSpec(20, 6)),
    bits_per_input=2, dropout_shared_classes=True)

# Fleet size of the multi-tenant serving cell.
MULTITENANT_TENANTS = 2048


def make_uleen_train_step(spec: UleenSpec, optimizer: opt_lib.Optimizer,
                          clip_table: float = 1.0) -> Callable:
    """(params, opt_state, statics, bits, labels, generator) -> (params,
    opt_state, loss): hashes, the train-mode forward with dropout drawn
    from `generator`, cross-entropy, the optimizer over the trainable
    leaves and the table clip, on `bits`' device."""
    loss_fn = multi_shot.make_loss_fn(spec)

    def train_step(params, opt_state, statics, bits, labels, generator):
        hashes = compute_hashes(spec, statics, bits, device=bits.device)
        grads, loss, _ = multi_shot.block_grads(loss_fn, params, hashes,
                                                labels, generator=generator)
        params, opt_state = multi_shot.apply_step(params, opt_state, grads,
                                                  optimizer, clip_table)
        return params, opt_state, loss

    return train_step


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def make_uleen_dist_train_step(spec: UleenSpec, optimizer: opt_lib.Optimizer,
                               mesh, *, grad_blocks: int = 8,
                               compress: bool = False,
                               clip_table: float = 1.0,
                               smoothing: float = 0.0,
                               time_collectives: bool = False) -> Callable:
    """The executed distributed multi-shot step, SPMD over the ranks of
    `mesh` (a DeviceMesh, or `launch.mesh.make_host_mesh` for one
    process):

        train_step(params, opt_state, statics, bits, labels,
                   block_generators) -> (params, opt_state, loss, acc)

    where `bits` and `labels` are this rank's rows of the global batch
    (`uleen_dist_specs`) and `block_generators(j)` is global block j's
    dropout generator (`multi_shot.block_generator(seed, step, j)`).

    Deterministic blocked reduction: the global batch splits into a FIXED
    number of blocks S = `grad_blocks`, independent of the mesh. The rank
    of linear index `dev` over every mesh axis (`collectives.axis_index`)
    computes blocks [dev·S/n, (dev+1)·S/n) whole; the whole step runs
    under `multi_shot.deterministic`. The exact path all-gathers the
    per-block gradient, loss and accuracy stacks over every axis (no
    arithmetic on the wire) and left-folds them in global block order
    with `multi_shot.fold_blocks`, so the step is bit-equal to
    `multi_shot.make_train_step(grad_blocks=S)` on one device given the
    same block generators, and to itself on any mesh.

    compress=True sums this rank's blocks, sums those over `data` in
    float32 in data-rank order (`collectives.sum_over`) x npods/S, and
    sends the pod's mean across `pod` as int8
    (`compression.compressed_psum`); the loss and accuracy are means over
    every rank. Every operation is deterministic, so the step is bit-equal
    to its one-device emulation (`launch.train.uleen_reference_params(
    compress_mesh=)`) given the same block generators.

    time_collectives=True synchronizes the device around every
    collective and adds their seconds to `train_step.collective_s`.
    """
    axes = tuple(mesh.mesh_dim_names)
    sizes = mesh_sizes(mesh)
    ndev = math.prod(sizes.values())
    s = grad_blocks
    if s % ndev:
        raise ValueError(f"grad_blocks {s} not divisible by {ndev} devices")
    bpd = s // ndev                      # blocks per rank
    npods = sizes.get("pod", 1)
    if compress and "pod" not in sizes:
        raise ValueError("compress=True needs a `pod` mesh axis")
    loss_fn = multi_shot.make_loss_fn(spec, smoothing)

    def collective(fn, device):
        if not time_collectives:
            return fn()
        _sync(device)
        t0 = time.perf_counter()
        out = fn()
        _sync(device)
        train_step.collective_s += time.perf_counter() - t0
        return out

    def local_blocks(params, statics, bits, labels, block_generators):
        """This rank's blocks' (grads, losses, accs), in block order."""
        dev_idx = collectives.axis_index(mesh, axes)
        if bits.shape[0] % bpd:
            raise ValueError(f"{bits.shape[0]} rows a rank do not split into "
                             f"{bpd} blocks")
        rows = bits.shape[0] // bpd
        grads, losses, accs = [], [], []
        for j in range(bpd):
            sl = slice(j * rows, (j + 1) * rows)
            hashes = compute_hashes(spec, statics, bits[sl],
                                    device=bits.device)
            g, loss, acc = multi_shot.block_grads(
                loss_fn, params, hashes, labels[sl],
                generator=block_generators(dev_idx * bpd + j))
            grads.append(g)
            losses.append(loss)
            accs.append(acc)
        return grads, losses, accs

    def train_step(params, opt_state, statics, bits, labels,
                   block_generators):
        with multi_shot.deterministic(bits.device):
            return step(params, opt_state, statics, bits, labels,
                        block_generators)

    def step(params, opt_state, statics, bits, labels, block_generators):
        dev = bits.device
        gs, ls, accs = local_blocks(params, statics, bits, labels,
                                    block_generators)
        if compress:
            # float32 within the pod, int8 across pods (the scarce link)
            scale = npods / s
            gsum = [torch.sum(torch.stack(leaf), 0) for leaf in zip(*gs)]
            gpod = collective(lambda: [
                collectives.sum_over(x, mesh, ("data",)) * scale
                if "data" in sizes else x * scale for x in gsum], dev)
            grads, _ = collective(lambda: compression.compressed_psum(
                gpod, mesh, "pod"), dev)
            loss, acc = collective(lambda: (
                collectives.all_reduce_sum(torch.mean(torch.stack(ls)),
                                           mesh, axes) / ndev,
                collectives.all_reduce_sum(torch.mean(torch.stack(accs)),
                                           mesh, axes) / ndev), dev)
        else:
            # gather the per-block stacks, then the single-device fold
            gall = collective(lambda: [
                collectives.all_gather(torch.stack(leaf), mesh, axes, dim=0)
                for leaf in zip(*gs)], dev)
            lall, aall = collective(lambda: (
                collectives.all_gather(torch.stack(ls), mesh, axes, dim=0),
                collectives.all_gather(torch.stack(accs), mesh, axes,
                                       dim=0)), dev)
            grads, loss, acc = multi_shot.fold_blocks(
                [[leaf[b] for leaf in gall] for b in range(s)],
                list(lall), list(aall), params)
        del gs
        params, opt_state = multi_shot.apply_step(params, opt_state,
                                                  list(grads), optimizer,
                                                  clip_table)
        return params, opt_state, loss, acc

    train_step.collective_s = 0.0
    return train_step


def uleen_dist_specs(spec: UleenSpec, mesh, global_batch: int) -> slice:
    """The rows [lo, hi) of a `global_batch`-row batch that this rank
    holds: the batch is split over every mesh axis in linear rank order
    (the JAX package's batch sharding over all axes); the parameters,
    optimizer state and statics are replicated."""
    del spec
    return collectives.row_slice(global_batch, mesh,
                                 tuple(mesh.mesh_dim_names))
