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
collectives itself (`dist.collectives`).

The dry-run half (the JAX module's `*_specs`, `make_uleen_*_infer_step`
and `lower_*`): each `*_specs` returns one rank's inputs at its shard's
shapes — fake tensors when called under a `FakeTensorMode`, random valid
contents from `generator=` for a real run on the card — and the resolved
sharding entries where JAX returns `NamedSharding`s; each `trace_*`
traces that rank's program (`launch.graph_cost.trace`) where JAX lowers
and compiles, inside a fake world of the mesh's ranks
(`launch.mesh.fake_world`). `launch/dryrun.py` runs the cells.
"""
from __future__ import annotations

import math
import time
from typing import Callable

import torch

from repro_torch.core import multi_shot
from repro_torch.core.model import SubmodelSpec, UleenSpec, compute_hashes
from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.dist import collectives
from repro_torch.dist import sharding as sh
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


def train_batch_axes(mesh) -> tuple:
    """The mesh axes a training batch splits over: the "batch" rule of
    TRAIN_RULES (`pod`, `data`), as the JAX cell shards its bits; the
    other axes (`model`) hold replicas of the same rows."""
    entry = sh.TRAIN_RULES.resolve(("batch",), mesh)[0]
    return sh.entry_axes(entry)


def make_uleen_train_step(spec: UleenSpec, optimizer: opt_lib.Optimizer,
                          clip_table: float = 1.0, *,
                          mesh=None) -> Callable:
    """(params, opt_state, statics, bits, labels, generator, keep=None) ->
    (params, opt_state, loss): hashes, the train-mode forward with dropout
    drawn from `generator` (or the masks `keep`), cross-entropy, the
    optimizer over the trainable leaves and the table clip, on `bits'`
    device.

    With `mesh`, SPMD (the JAX cell's single-device step with its batch
    sharded): `bits` and `labels` are this rank's rows of the batch split
    over `train_batch_axes(mesh)`; the gradients and the loss of its
    rows, flat in one float32 buffer, are summed over those axes
    (`collectives.all_reduce_sum`, one all-reduce an axis) and divided by
    the shard count, the mean over the global batch; then the optimizer.
    On a mesh whose batch axes have size 1 no collective runs and the step
    is the one-device step. Ranks of one batch shard draw the same
    dropout (`train_generator`)."""
    loss_fn = multi_shot.make_loss_fn(spec)
    axes = train_batch_axes(mesh) if mesh is not None else ()
    shards = sh.spec_degree(mesh, axes or None) if axes else 1

    def train_step(params, opt_state, statics, bits, labels, generator,
                   keep=None):
        hashes = compute_hashes(spec, statics, bits, device=bits.device)
        grads, loss, _ = multi_shot.block_grads(loss_fn, params, hashes,
                                                labels, generator=generator,
                                                keep=keep)
        if shards > 1:
            flat = torch.cat([g.reshape(-1) for g in grads]
                             + [loss.reshape(1)])
            flat = collectives.all_reduce_sum(flat, mesh, axes) / shards
            parts = torch.split(flat, [g.numel() for g in grads] + [1])
            grads = [p.view_as(g) for p, g in zip(parts, grads)]
            loss = parts[-1].reshape(())
        params, opt_state = multi_shot.apply_step(params, opt_state, grads,
                                                  optimizer, clip_table)
        return params, opt_state, loss

    return train_step


def train_generator(mesh, seed: int, step: int, device=DEFAULT_DEVICE):
    """The dropout generator of this rank's rows at `step`:
    `multi_shot.block_generator(seed, step, shard)`, `shard` the rank's
    index over the batch axes (the ranks that hold the same rows draw the
    same masks)."""
    shard = (collectives.axis_index(mesh, train_batch_axes(mesh))
             if mesh is not None else 0)
    return multi_shot.block_generator(seed, step, shard, device=device)


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


# ---------------------------------------------------------------------------
# The dry-run half: one rank's inputs, steps and traces
# ---------------------------------------------------------------------------

def _tensor(shape, dtype, device, generator=None, *, low=0, high=2):
    """A (fake under a FakeTensorMode) tensor; with `generator`, random
    values in [low, high) (floats in [low, high) too)."""
    if generator is None:
        return torch.empty(shape, dtype=dtype, device=device)
    if dtype.is_floating_point:
        u = torch.rand(shape, generator=generator, device=device)
        return (low + (high - low) * u).to(dtype)
    if dtype == torch.bool:
        return torch.randint(0, 2, shape, generator=generator,
                             device=device).bool()
    return torch.randint(low, high, shape, generator=generator,
                         device=device, dtype=dtype)


def batch_rows(mesh, rules: sh.ShardingRules, global_batch: int,
               exclude: tuple = ()) -> tuple:
    """(entry axes, shard count, rows a rank) of a `global_batch`-row
    batch under `rules`' "batch" entry (less the axes in `exclude`)."""
    entry = rules.resolve(("batch",), mesh, shape=(global_batch,))[0]
    axes = tuple(a for a in sh.entry_axes(entry) if a not in exclude)
    degree = sh.spec_degree(mesh, axes or None)
    return axes, degree, global_batch // degree


def _statics(spec: UleenSpec, device, generator):
    from repro_torch.core.model import SubmodelStatic
    return tuple(SubmodelStatic(
        perm=_tensor((spec.num_filters(sm), sm.inputs_per_filter),
                     torch.int32, device, generator, high=spec.total_bits),
        h3=_tensor((sm.num_hashes, sm.inputs_per_filter), torch.int32,
                   device, generator, high=sm.entries))
        for sm in spec.submodels)


def uleen_cell_specs(spec: UleenSpec, mesh, *,
                     global_batch: int = GLOBAL_BATCH, device=DEFAULT_DEVICE,
                     generator=None, global_view: bool = False):
    """(this rank's inputs, shardings) of the training cell: the
    continuous tables, bias and masks, the statics, this rank's rows of
    the bits and labels; `global_view` gives every input whole."""
    from repro_torch.core.model import UleenParams
    dev = resolve_device(device)
    axes, _, rows = batch_rows(mesh, sh.TRAIN_RULES, global_batch)
    rows = global_batch if global_view else rows
    m = spec.num_classes
    params = UleenParams(
        tables=tuple(_tensor((m, spec.num_filters(sm), sm.entries),
                             torch.float32, dev, generator, low=-1.0,
                             high=0.1) for sm in spec.submodels),
        bias=_tensor((m,), torch.float32, dev, generator, low=0.0,
                     high=0.0),
        masks=tuple(_tensor((m, spec.num_filters(sm)), torch.float32, dev,
                            generator, low=1.0, high=1.0)
                    for sm in spec.submodels))
    ins = dict(params=params, statics=_statics(spec, dev, generator),
               bits=_tensor((rows, spec.total_bits), torch.bool, dev,
                            generator),
               labels=_tensor((rows,), torch.int64, dev, generator,
                              high=m))
    entry = axes if len(axes) > 1 else (axes[0] if axes else None)
    return ins, dict(params=None, statics=None, bits=(entry, None),
                     labels=(entry,))


def make_uleen_infer_step(spec: UleenSpec, *, backend: str = "auto",
                          device=DEFAULT_DEVICE) -> Callable:
    """The deployed binary-model step from encoded bits:
    `core.model.forward_binary_fused` with `backend` (on the card "auto"
    is the fused kernel: one WNN launch a submodel)."""
    from repro_torch.core.model import forward_binary_fused

    def infer_step(tables_bin, masks, bias, statics, bits):
        return forward_binary_fused(spec, statics, tables_bin, masks, bias,
                                    bits, backend=backend, device=device)
    return infer_step


def uleen_infer_specs(spec: UleenSpec, mesh, *,
                      global_batch: int = INFER_BATCH, device=DEFAULT_DEVICE,
                      generator=None, global_view: bool = False):
    """(this rank's inputs, shardings) of the int8-table inference cell:
    tables, masks, bias and statics replicated, bits split over the
    batch axes."""
    dev = resolve_device(device)
    axes, _, rows = batch_rows(mesh, sh.SERVE_RULES, global_batch)
    rows = global_batch if global_view else rows
    m = spec.num_classes
    ins = dict(
        tables=tuple(_tensor((m, spec.num_filters(sm), sm.entries),
                             torch.int8, dev, generator)
                     for sm in spec.submodels),
        masks=tuple(_tensor((m, spec.num_filters(sm)), torch.float32, dev,
                            generator, low=1.0, high=1.0)
                    for sm in spec.submodels),
        bias=_tensor((m,), torch.float32, dev, generator, low=-5.0,
                     high=5.0),
        statics=_statics(spec, dev, generator),
        bits=_tensor((rows, spec.total_bits), torch.bool, dev, generator))
    entry = axes if len(axes) > 1 else (axes[0] if axes else None)
    return ins, dict(tables=None, masks=None, bias=None, statics=None,
                     bits=(entry, None))


def packed_table_specs(spec: UleenSpec, *, classes: tuple = (),
                       device=DEFAULT_DEVICE, generator=None,
                       kernel_args: bool = True):
    """A `PackedTables` of `spec`'s geometry for classes [lo, hi)
    (`classes`, default all): words, masks, perms, H3 parameters and
    bias; on the card its kernel arguments built too, with the perms'
    reach known from the spec (`total_bits`), as a deployment builds them
    before its first batch."""
    from repro_torch.packed import layout
    dev = resolve_device(device)
    lo, hi = classes or (0, spec.num_classes)
    m = hi - lo
    pt = layout.PackedTables(
        words=tuple(_tensor((m, spec.num_filters(sm),
                             layout.word_count(sm.entries)), torch.int32,
                            dev, generator, low=-2 ** 31, high=2 ** 31)
                    for sm in spec.submodels),
        masks=tuple(_tensor((m, spec.num_filters(sm)), torch.int8, dev,
                            generator) for sm in spec.submodels),
        perms=tuple(_tensor((spec.num_filters(sm), sm.inputs_per_filter),
                            torch.int64, dev, generator,
                            high=spec.total_bits) for sm in spec.submodels),
        h3s=tuple(_tensor((sm.num_hashes, sm.inputs_per_filter),
                          torch.int32, dev, generator, high=sm.entries)
                  for sm in spec.submodels),
        bias=_tensor((m,), torch.int32, dev, generator, low=-5, high=6),
        entries=tuple(sm.entries for sm in spec.submodels),
        num_classes=m)
    if kernel_args and dev.type == "cuda":
        pt.build_kernel_args(columns=spec.total_bits)
    return pt


def uleen_packed_infer_specs(spec: UleenSpec, mesh, *,
                             global_batch: int = INFER_BATCH,
                             device=DEFAULT_DEVICE, generator=None,
                             global_view: bool = False):
    """(this rank's inputs, shardings) of the packed inference cell: the
    packed tables replicated, bits split over the batch axes."""
    dev = resolve_device(device)
    axes, _, rows = batch_rows(mesh, sh.SERVE_RULES, global_batch)
    rows = global_batch if global_view else rows
    ins = dict(ptables=packed_table_specs(spec, device=dev,
                                          generator=generator),
               bits=_tensor((rows, spec.total_bits), torch.bool, dev,
                            generator))
    entry = axes if len(axes) > 1 else (axes[0] if axes else None)
    return ins, dict(ptables=None, bits=(entry, None))


def make_uleen_packed_infer_step(*, backend: str = "auto",
                                 device=DEFAULT_DEVICE) -> Callable:
    """The packed-domain step: `packed.runtime.packed_scores` (one WNN
    launch a batch on the card; no int8 table, no unpack)."""
    from repro_torch.packed import runtime

    def infer_step(ptables, bits):
        return runtime.packed_scores(ptables, bits, backend=backend,
                                     device=device)
    return infer_step


def uleen_sharded_infer_specs(spec: UleenSpec, mesh, *,
                              global_batch: int = INFER_BATCH,
                              device=DEFAULT_DEVICE, generator=None,
                              global_view: bool = False):
    """(this rank's inputs, shardings) of the class-sharded cell: this
    rank's `ClassShardedTables` (classes [lo, lo + M/S) of the packed
    tables over the `classes` entry) and its rows over the batch axes."""
    from repro_torch.packed import runtime
    dev = resolve_device(device)
    entry, degree = sh.class_partition(mesh, spec.num_classes,
                                       sh.SERVE_RULES)
    c_axes = sh.entry_axes(entry)
    axes, _, rows = batch_rows(mesh, sh.SERVE_RULES, global_batch,
                               exclude=c_axes)
    m_loc = spec.num_classes // degree
    lo = collectives.axis_index(mesh, c_axes) * m_loc
    classes = (0, spec.num_classes) if global_view else (lo, lo + m_loc)
    rows = global_batch if global_view else rows
    local = packed_table_specs(spec, classes=classes, device=dev,
                               generator=generator, kernel_args=False)
    # the slices, then the words released (`ClassShardedTables`): the
    # rank holds its classes' slices only
    local.build_kernel_args(columns=spec.total_bits)
    sp = runtime.ClassShardedTables(
        local=local, mesh=mesh, rules=sh.SERVE_RULES, class_axes=c_axes,
        num_classes=spec.num_classes, lo=0 if global_view else lo)
    b_entry = axes if len(axes) > 1 else (axes[0] if axes else None)
    return (dict(ptables=sp, bits=_tensor((rows, spec.total_bits),
                                          torch.bool, dev, generator)),
            dict(ptables=entry, class_degree=degree, bits=(b_entry, None)))


def make_uleen_sharded_infer_step(*, backend: str = "auto",
                                  device=DEFAULT_DEVICE) -> Callable:
    """The class-sharded step on this rank's rows: its classes' score
    columns (one WNN launch on the card), ONE all-gather of the columns
    over the class axes, the argmax over all M -> (scores (B_loc, M),
    predictions). The rows stay this rank's, as the JAX program's do
    (`runtime.class_sharded_scores(local_rows=True)`)."""
    from repro_torch.kernels import ops
    from repro_torch.packed import runtime

    def infer_step(sp, bits):
        return ops.ensemble_predict(runtime.class_sharded_scores(
            sp, bits, lambda p, b: runtime.packed_scores(
                p, b, backend=backend, device=device), local_rows=True))
    return infer_step


def stacked_table_specs(spec: UleenSpec, tenants: int, *,
                        device=DEFAULT_DEVICE, generator=None):
    """A `StackedPackedTables` of `tenants` same-geometry models."""
    from repro_torch.packed import layout
    pt = packed_table_specs(spec, device=device, generator=None,
                            kernel_args=False)
    dev = resolve_device(device)

    def lead(x, low=0, high=2):
        return _tensor((tenants, *x.shape), x.dtype, dev, generator,
                       low=low, high=high)
    return layout.StackedPackedTables(
        words=tuple(lead(w, -2 ** 31, 2 ** 31) for w in pt.words),
        masks=tuple(lead(x) for x in pt.masks),
        perms=tuple(lead(p, 0, spec.total_bits) for p in pt.perms),
        h3s=tuple(lead(h, 0, sm.entries)
                  for h, sm in zip(pt.h3s, spec.submodels)),
        bias=lead(pt.bias, -5, 6), entries=pt.entries,
        num_classes=pt.num_classes, num_tenants=tenants)


def uleen_multitenant_infer_specs(spec: UleenSpec, mesh, *, tenants: int = 0,
                                  global_batch: int = INFER_BATCH,
                                  device=DEFAULT_DEVICE, generator=None,
                                  global_view: bool = False):
    """(this rank's inputs, shardings) of the multi-tenant cell: this
    rank's tenants of the stacked fleet (a `TenantShardedTables` over the
    `tenants` entry), its rows of the bits and tenant ids."""
    from repro_torch.packed import runtime
    dev = resolve_device(device)
    tenants = tenants or MULTITENANT_TENANTS
    entry, degree = sh.tenant_partition(mesh, tenants, sh.SERVE_RULES)
    t_axes = sh.entry_axes(entry)
    axes, _, rows = batch_rows(mesh, sh.SERVE_RULES, global_batch,
                               exclude=t_axes)
    t_loc = tenants // degree
    lo = collectives.axis_index(mesh, t_axes) * t_loc
    rows = global_batch if global_view else rows
    n_loc = tenants if global_view else t_loc
    st = runtime.TenantShardedTables(
        local=stacked_table_specs(spec, n_loc, device=dev,
                                  generator=generator),
        mesh=mesh, rules=sh.SERVE_RULES, tenant_axes=t_axes,
        num_tenants=tenants, lo=0 if global_view else lo)
    b_entry = axes if len(axes) > 1 else (axes[0] if axes else None)
    ins = dict(st=st,
               bits=_tensor((rows, spec.total_bits), torch.bool, dev,
                            generator),
               tids=_tensor((rows,), torch.int32, dev, generator,
                            high=tenants))
    return ins, dict(st=entry, tenant_degree=degree, bits=(b_entry, None),
                     tids=(b_entry,))


def make_uleen_multitenant_infer_step(st_spec, mesh, global_batch: int, *,
                                      backend: str = "auto",
                                      device=DEFAULT_DEVICE) -> Callable:
    """The tenant-sharded fleet step on this rank's rows:
    `runtime.make_tenant_sharded_predict(local_rows=True)` — each rank
    scores the rows whose tenant it owns, ONE all-reduce sum of the
    masked int32 partials, the argmax; the rows stay this rank's."""
    from repro_torch.packed import runtime
    return runtime.make_tenant_sharded_predict(
        st_spec, mesh, sh.SERVE_RULES, global_batch, backend=backend,
        device=device, local_rows=True)


def autograd_traceable(device) -> bool:
    """Whether a training step can be traced on `device` here: autograd
    over fake CUDA tensors needs a torch built with CUDA (its engine
    queries the device's streams); a CPU-only build traces the CPU
    program instead (`trace_*(device="cuda")` says so in `device`)."""
    return torch.device(device).type != "cuda" or \
        torch.backends.cuda.is_built()


def _trace_device(device) -> torch.device:
    """The device a traced program runs on: card 0, or the CPU."""
    return torch.device("cuda", 0) if torch.device(device).type == "cuda" \
        else torch.device("cpu")


def _trace(make, device):
    """Build (step, args) under a fresh fake mode and trace them:
    (Traced, args)."""
    from repro_torch.launch import graph_cost
    from torch._subclasses.fake_tensor import FakeTensorMode
    if device.type == "cuda":
        graph_cost.ensure_fake_cuda_guard()
    fake = FakeTensorMode()
    with fake:
        step, args = make()
    return graph_cost.trace(step, args, fake_mode=fake, device=device), args


def trace_uleen_cell(mesh, *, global_batch: int = GLOBAL_BATCH,
                     spec: UleenSpec = ULN_L_SPEC, device=DEFAULT_DEVICE,
                     seed: int = 0):
    """Trace this rank's training step (the JAX `lower_uleen_cell`):
    (Traced, args). Dropout from a host generator: fake
    tensors take it, and a trace draws nothing."""
    dev = _trace_device(device)

    def make():
        optimizer = opt_lib.adam(1e-3)
        ins, _ = uleen_cell_specs(spec, mesh, global_batch=global_batch,
                                      device=dev)
        opt_state = optimizer.init(list(ins["params"].tables)
                                   + [ins["params"].bias])
        step = make_uleen_train_step(spec, optimizer, mesh=mesh)
        gen = train_generator(mesh, seed, 0, device="cpu")
        return step, (ins["params"], opt_state, ins["statics"], ins["bits"],
                      ins["labels"], gen)
    return _trace(make, dev)


def trace_uleen_infer_cell(mesh, *, global_batch: int = INFER_BATCH,
                           spec: UleenSpec = ULN_L_SPEC,
                           backend: str = "auto", device=DEFAULT_DEVICE):
    """Trace this rank's int8-table inference step
    (`lower_uleen_infer_cell`)."""
    dev = _trace_device(device)

    def make():
        ins, _ = uleen_infer_specs(spec, mesh, global_batch=global_batch,
                                       device=dev)
        return (make_uleen_infer_step(spec, backend=backend, device=dev),
                (ins["tables"], ins["masks"], ins["bias"], ins["statics"],
                 ins["bits"]))
    return _trace(make, dev)


def trace_uleen_packed_infer_cell(mesh, *, global_batch: int = INFER_BATCH,
                                  spec: UleenSpec = ULN_XL_SPEC,
                                  backend: str = "auto",
                                  device=DEFAULT_DEVICE):
    """Trace this rank's packed inference step
    (`lower_uleen_packed_infer_cell`)."""
    dev = _trace_device(device)

    def make():
        ins, _ = uleen_packed_infer_specs(
            spec, mesh, global_batch=global_batch, device=dev)
        return (make_uleen_packed_infer_step(backend=backend, device=dev),
                (ins["ptables"], ins["bits"]))
    return _trace(make, dev)


def trace_uleen_sharded_infer_cell(mesh, *, global_batch: int = INFER_BATCH,
                                   spec: UleenSpec = ULN_XL_ENSEMBLE_SPEC,
                                   backend: str = "auto",
                                   device=DEFAULT_DEVICE):
    """Trace this rank's class-sharded step
    (`lower_uleen_sharded_infer_cell`)."""
    dev = _trace_device(device)

    def make():
        ins, _ = uleen_sharded_infer_specs(
            spec, mesh, global_batch=global_batch, device=dev)
        return (make_uleen_sharded_infer_step(backend=backend, device=dev),
                (ins["ptables"], ins["bits"]))
    return _trace(make, dev)


def trace_uleen_multitenant_infer_cell(mesh, *, tenants: int = 0,
                                       global_batch: int = INFER_BATCH,
                                       spec: UleenSpec = None,
                                       backend: str = "auto",
                                       device=DEFAULT_DEVICE):
    """Trace this rank's tenant-sharded fleet step
    (`lower_uleen_multitenant_infer_cell`)."""
    spec = spec if spec is not None else ULN_S_SPEC
    dev = _trace_device(device)

    def make():
        ins, _ = uleen_multitenant_infer_specs(
            spec, mesh, tenants=tenants, global_batch=global_batch,
            device=dev)
        step = make_uleen_multitenant_infer_step(
            ins["st"], mesh, global_batch, backend=backend, device=dev)
        return step, (ins["st"], ins["bits"], ins["tids"])
    return _trace(make, dev)


def trace_uleen_dist_cell(mesh, *, global_batch: int = EXEC_BATCH,
                          spec: UleenSpec = ULEEN_EXEC_SPEC,
                          grad_blocks: int = 8, compress: bool = False,
                          lr: float = 1e-3, device=DEFAULT_DEVICE,
                          seed: int = 0):
    """Trace this rank's executed distributed step
    (`lower_uleen_dist_cell`): its rows of the global batch, the blocks'
    generators on the host."""
    dev = _trace_device(device)

    def make():
        optimizer = opt_lib.adam(lr)
        ins, _ = uleen_cell_specs(spec, mesh, global_batch=global_batch,
                                      device=dev)
        rows = uleen_dist_specs(spec, mesh, global_batch)
        bits = _tensor((rows.stop - rows.start, spec.total_bits),
                       torch.bool, dev)
        labels = _tensor((rows.stop - rows.start,), torch.int64, dev)
        opt_state = optimizer.init(list(ins["params"].tables)
                                   + [ins["params"].bias])
        step = make_uleen_dist_train_step(spec, optimizer, mesh,
                                          grad_blocks=grad_blocks,
                                          compress=compress)

        def gens(j):
            return multi_shot.block_generator(seed, 0, j, device="cpu")
        return step, (ins["params"], opt_state, ins["statics"], bits, labels,
                      gens)
    return _trace(make, dev)
