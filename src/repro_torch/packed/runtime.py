"""Serve entry for the packed domain: PackedTables -> ensemble scores (port
of `repro/packed/runtime.py`).

On a GPU a batch is one `packed_wnn_ensemble` launch on its
(B, total_bits) rows: the permutation gather, every submodel, the votes
and the bias happen inside the kernel, on the class slices `PackedTables`
built from the words when it was constructed; no (B, N_f, n) tuple
tensor exists. On the CPU the plain per-submodel loop runs (the gather,
then `packed_wnn`'s plain version). `core/export.py::artifact_scores` and
`launch/scheduler.py::WnnBatcher` both route through here. The tables'
geometry was checked when the `PackedTables` was built, so a batch pays
only the wrapper's pointer checks. `stacked_scores` serves a
tenant-stacked fleet (`StackedPackedTables`) in one fixed-shape call.

Sharded serving runs SPMD on `torch.distributed`: every rank makes the
same calls on the same host inputs and holds only its slice of the
tables. A class-sharded rank (`ClassShardedTables`) scores its class
columns with one kernel launch, and one all-gather of the (B, M/S) int32
columns makes the (B, M) matrix whole before the argmax; a
tenant-sharded rank (`make_tenant_sharded_predict`) scores the rows whose
tenant it owns and one sum of the masked int32 scores completes every
row. Integer addition is exact in any order, so both are bit-equal to
the unsharded path.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.dist import collectives
from repro_torch.dist import sharding as sh
from repro_torch.kernels.packed_wnn import packed_wnn, packed_wnn_ensemble
from repro_torch.packed.layout import PackedTables, StackedPackedTables


def packed_scores(pt: PackedTables, bits, *, backend: str = "auto",
                  device=DEFAULT_DEVICE) -> torch.Tensor:
    """bits: (B, total_bits) bool/int {0,1} -> scores (B, M) int32.

    backend="packed" and "auto" both run the ensemble kernel once on a
    GPU (the plain per-submodel loop on the CPU). "fused"/"gather"
    are rejected — they would need the 32× unpack this runtime exists to
    avoid.
    """
    if backend not in ("packed", "auto"):
        raise ValueError(
            f"packed_scores serves the packed domain only (backend="
            f"'packed'|'auto', got {backend!r}); use core.model."
            "forward_binary_fused for the unpacked formulations")
    if isinstance(pt, ClassShardedTables):
        return class_sharded_scores(pt, bits, lambda p, b: packed_scores(
            p, b, backend=backend, device=device))
    dev = resolve_device(device)
    pt = pt.to(dev)
    bits = torch.as_tensor(bits).to(dev)
    if dev.type == "cuda" or pt.words is None:
        # on the CPU, tables whose words were released: the plain
        # ensemble version over their class slices
        # the kernel reads any one-byte {0,1} rows as they are
        if bits.dtype not in (torch.int8, torch.uint8, torch.bool):
            bits = bits.to(torch.int8)
        return packed_wnn_ensemble(bits.contiguous(), pt)
    # one int8 copy of the batch, so each submodel's gather below already
    # yields the plain version's int8 tuples
    bits = bits.to(torch.int8)
    scores = torch.zeros((bits.shape[0], pt.num_classes), dtype=torch.int32,
                         device=dev)
    zero_bias = torch.zeros((pt.num_classes,), dtype=torch.int32, device=dev)
    for words, mask, perm, h3 in zip(pt.words, pt.masks, pt.perms, pt.h3s):
        tuples = bits[:, perm]                  # (B, N_f, n); perm is int64
        scores += packed_wnn(tuples, h3, words, mask, zero_bias)
    return scores + pt.bias[None]


def packed_predict(pt: PackedTables, bits, *, backend: str = "auto",
                   device=DEFAULT_DEVICE):
    """(scores (B, M) int32, argmax predictions (B,) int32); on a
    `ClassShardedTables` the gathered matrix and the argmax over the full
    class axis, the same on every rank."""
    from repro_torch.kernels import ops
    return ops.ensemble_predict(
        packed_scores(pt, bits, backend=backend, device=device))


def stacked_scores(st: StackedPackedTables, bits, tids, *,
                   backend: str = "auto", valid=None,
                   device=DEFAULT_DEVICE) -> torch.Tensor:
    """Tenant-routed fleet scores (B, M) int32: row r of `bits` is scored
    against tenant `tids[r]`'s tables, in one fixed-shape call —
    `ops.wnn_scores_tenant` per submodel plus the row-gathered bias.

    st: `layout.StackedPackedTables`; bits: (B, total_bits) {0,1}; tids:
    (B,) in [0, T). `valid` (optional (B,) bool) zeroes the rows a caller
    does not own, bias included. Packed-domain only, like
    `packed_scores`.
    """
    from repro_torch.kernels import ops
    if backend not in ("packed", "auto"):
        raise ValueError(
            f"stacked_scores serves the packed domain only (backend="
            f"'packed'|'auto', got {backend!r})")
    dev = resolve_device(device)
    st.validate()
    st = st.to(dev)
    bits = torch.as_tensor(bits).to(dev)
    tids = torch.as_tensor(tids).to(dev, torch.int64)
    scores = torch.zeros((bits.shape[0], st.num_classes), dtype=torch.int32,
                         device=dev)
    for perm, h3, words, mask, entries in zip(
            st.perms, st.h3s, st.words, st.masks, st.entries):
        scores += ops.wnn_scores_tenant(bits, tids, perm, h3, words, mask,
                                        backend=backend, entries=entries,
                                        device=dev)
    scores += st.bias[tids]
    if valid is not None:
        valid = torch.as_tensor(valid).to(dev, torch.bool)
        scores = torch.where(valid[:, None], scores, 0)
    return scores


def stacked_predict(st: StackedPackedTables, bits, tids, *,
                    backend: str = "auto", device=DEFAULT_DEVICE):
    """(scores (B, M) int32, per-row argmax (B,) int32) of a fleet on one
    device."""
    from repro_torch.kernels import ops
    return ops.ensemble_predict(stacked_scores(st, bits, tids,
                                               backend=backend,
                                               device=device))


# ---------------------------------------------------------------------------
# Sharded serving (SPMD over torch.distributed)
# ---------------------------------------------------------------------------

def batch_axes(mesh, rules: sh.ShardingRules, batch: int,
               exclude: tuple = ()) -> tuple:
    """The mesh axes a batch of `batch` rows splits over (the "batch"
    rule, sanitised by divisibility), minus the axes in `exclude`."""
    entry = rules.resolve(("batch",), mesh, shape=(batch,))[0]
    return tuple(a for a in sh.entry_axes(entry) if a not in exclude)


@dataclasses.dataclass
class ClassShardedTables:
    """What one rank holds of prepared tables partitioned over a mesh by
    class: `local` (a `PackedTables` or a `core.export.UnpackedTables`)
    holds classes [lo, lo + M/S) of the ensemble's `num_classes`, where S
    is the degree of `class_axes`. Scores through it are the full (B, M)
    matrix on every rank (`class_sharded_scores`).

    A `PackedTables` shard keeps its class slices only: its uint32 words
    are released here (`PackedTables.release_words`), building the kernel
    arguments first where they are not built yet. The slices hold every
    bit of the words; at 2 classes a rank they take 2 bits an entry, the
    same bytes as the words (`kernels.wnn_ensemble.entry_bits`)."""
    local: object
    mesh: object
    rules: sh.ShardingRules
    class_axes: tuple
    num_classes: int
    lo: int

    def __post_init__(self):
        if isinstance(self.local, PackedTables) \
                and self.local.words is not None:
            self.local.release_words()

    @property
    def device(self) -> torch.device:
        return self.local.bias.device

    @property
    def degree(self) -> int:
        return self.num_classes // int(self.local.bias.shape[0])


def class_sharded_scores(sp: ClassShardedTables, bits, score_local, *,
                         local_rows: bool = False):
    """(B, M) int32 scores of a class-sharded ensemble, whole on every
    rank. `score_local(local, rows)` scores this rank's classes (on a GPU
    one WNN kernel launch); the (rows, M/S) columns then cross the `model`
    group in ONE all-gather. Where the mesh also has batch axes (`data`)
    that divide B, each rank scores only its rows, and one more gather
    over those axes makes the rows whole.

    local_rows=True: `bits` are already this rank's rows and the scores
    stay this rank's rows (B_loc, M): the columns' one gather and nothing
    else, as the JAX package's program leaves its rows batch-sharded."""
    bits = torch.as_tensor(bits)
    if local_rows:
        part = score_local(sp.local, bits)
        return collectives.all_gather(part, sp.mesh, sp.class_axes, dim=1)
    b_axes = batch_axes(sp.mesh, sp.rules, int(bits.shape[0]),
                        exclude=sp.class_axes)
    if b_axes:
        bits = bits[collectives.row_slice(int(bits.shape[0]), sp.mesh,
                                          b_axes)]
    part = score_local(sp.local, bits)                   # (B_loc, M/S)
    scores = collectives.all_gather(part, sp.mesh, sp.class_axes, dim=1)
    if b_axes:
        scores = collectives.all_gather(scores, sp.mesh, b_axes, dim=0)
    return scores


@dataclasses.dataclass
class TenantShardedTables:
    """What one rank holds of a stacked fleet partitioned over a mesh by
    tenant: `local` holds tenants [lo, lo + T/S) of the fleet's
    `num_tenants`, S the degree of `tenant_axes`."""
    local: StackedPackedTables
    mesh: object
    rules: sh.ShardingRules
    tenant_axes: tuple
    num_tenants: int
    lo: int

    @property
    def device(self) -> torch.device:
        return self.local.device


def make_tenant_sharded_predict(st_spec, mesh, rules: sh.ShardingRules,
                                global_batch: int, *, backend: str = "auto",
                                device=DEFAULT_DEVICE,
                                local_rows: bool = False):
    """Build `predict(st, bits, tids) -> (scores, preds)` with the fleet
    partitioned over `mesh` by tenant.

    Each rank of the `tenants` axes holds T/S whole tenants; it scores
    only the rows whose tenant it owns, at local index `tid - lo`, the
    others masked to 0 through `valid=`, and the masked int32 partials
    cross the mesh in ONE all-reduce sum: bit-equal to the replicated
    path, and a row whose tenant id is out of range everywhere scores 0
    and predicts class 0. Batch rows split over the batch axes (one more
    gather makes them whole); tenant tables never move.

    `st_spec` gives the fleet's tenant count: a `TenantShardedTables`
    (what `core.export.prepare_tenants(mesh=)` returns) or a whole fleet.
    The returned `predict` takes this rank's `TenantShardedTables`, or
    the `StackedPackedTables` of its shard. When the `tenants` axes
    resolve to replication (T does not divide them, or a one-process
    mesh) it is `stacked_predict`.

    local_rows=True: `predict` takes this rank's rows of the batch (and
    their tenant ids) and returns theirs, with no gather of rows: the
    one sum and nothing else, as the JAX package's program leaves its
    rows batch-sharded."""
    rules = rules if rules is not None else sh.SERVE_RULES
    num_tenants = st_spec.num_tenants
    entry, degree = sh.tenant_partition(mesh, num_tenants, rules)
    if degree == 1:
        def replicated(st, bits, tids):
            if isinstance(st, TenantShardedTables):
                st = st.local
            return stacked_predict(st, bits, tids, backend=backend,
                                   device=device)
        return replicated
    t_axes = sh.entry_axes(entry)
    t_loc = num_tenants // degree
    lo = collectives.axis_index(mesh, t_axes) * t_loc
    b_axes = batch_axes(mesh, rules, global_batch, exclude=t_axes)
    b_loc = global_batch // sh.spec_degree(mesh, b_axes or None)
    dev = resolve_device(device)

    def predict(st, bits, tids):
        if isinstance(st, TenantShardedTables):
            st = st.local
        if st.num_tenants != t_loc:
            raise ValueError(f"a shard of {st.num_tenants} tenants; this "
                             f"rank holds {t_loc} of {num_tenants}")
        bits = torch.as_tensor(bits).to(dev)
        tids = torch.as_tensor(tids).to(dev, torch.int64)
        want = b_loc if local_rows else global_batch
        if bits.shape[0] != want:
            raise ValueError(f"{bits.shape[0]} rows; this predict was "
                             f"built for {want}")
        if b_axes and not local_rows:
            rows = collectives.row_slice(global_batch, mesh, b_axes)
            bits, tids = bits[rows], tids[rows]
        own = (tids >= lo) & (tids < lo + t_loc)
        part = stacked_scores(st, bits, torch.clamp(tids - lo, 0, t_loc - 1),
                              backend=backend, valid=own, device=dev)
        scores = collectives.all_reduce_sum(part, mesh, t_axes)  # the ONE
        if b_axes and not local_rows:
            scores = collectives.all_gather(scores, mesh, b_axes, dim=0)
        from repro_torch.kernels import ops
        return ops.ensemble_predict(scores)
    return predict
