"""Export a trained ULEEN model and serve the deployable artifact (port of
`repro/core/export.py`).

Binary tables are bit-packed (32 entries per uint32 word), pruned filters
carry a survival mask, and model size is accounted as the paper reports it
(surviving filters x entries bits). `export_model` turns training state
into the artifact; `save`/`load` write and read the same npz files as the
JAX package, byte for byte both ways: keys `meta`, `bias` and
`sm{i}_{packed,mask,perm,h3,cfg}`. The artifact itself stays numpy;
`prepare_artifact` moves it to the device once per representation.

With `mesh=` the preparation is sharded: under the `classes` partition a
rank moves only its class slice of the tables to its device
(`prepare_artifact`), under the `tenants` partition only its tenants
(`prepare_tenants`), and the serve loop (`scores_from_prep`) ends in the
one collective that makes the result whole on every rank.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.model import binarize_params
from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.obs import registry as obs_registry


@dataclasses.dataclass
class SubmodelArtifact:
    packed: np.ndarray          # (M, N_f, E//32) uint32 bit-packed table
    mask: np.ndarray            # (M, N_f) bool survival mask
    perm: np.ndarray            # (N_f, n) int32
    h3: np.ndarray              # (k, n) uint32
    entries: int
    inputs_per_filter: int
    num_hashes: int


@dataclasses.dataclass
class InferenceArtifact:
    submodels: list
    bias: np.ndarray            # (M,) int32
    num_classes: int
    total_bits: int
    bits_per_input: int

    @property
    def size_kib(self) -> float:
        bits = sum(int(sm.mask.sum()) * sm.entries for sm in self.submodels)
        return bits / 8.0 / 1024.0

    @property
    def packed_size_kib(self) -> float:
        """Surviving-table storage in the word-aligned packed layout:
        4 bytes per uint32 word, E < 32 rounded up to one word."""
        by = sum(int(sm.mask.sum()) * sm.packed.shape[-1] * 4
                 for sm in self.submodels)
        return by / 1024.0

    @property
    def hash_ops_per_inference(self) -> int:
        """Hash computations: one per filter per hash fn per submodel
        (shared across discriminators — the paper's central hash block)."""
        return sum(sm.perm.shape[0] * sm.num_hashes for sm in self.submodels)

    @property
    def lookups_per_inference(self) -> int:
        return sum(int(sm.mask.sum()) * sm.num_hashes for sm in self.submodels)


def pack_table(table_bin: np.ndarray) -> np.ndarray:
    """(M, N_f, E) bool -> (M, N_f, E//32) uint32."""
    m, n_f, e = table_bin.shape
    if e % 32 and e > 32:
        raise ValueError(f"entries={e} must be < 32 or a multiple of 32")
    pad = (-e) % 32
    if pad:
        table_bin = np.concatenate(
            [table_bin, np.zeros((m, n_f, pad), bool)], axis=-1)
    words = table_bin.reshape(m, n_f, -1, 32).astype(np.uint32)
    weights = (np.uint32(1) << np.arange(32, dtype=np.uint32))
    return (words * weights).sum(axis=-1, dtype=np.uint64).astype(np.uint32)


def unpack_table(packed: np.ndarray, entries: int) -> np.ndarray:
    """(M, N_f, W) uint32 -> (M, N_f, entries) bool."""
    m, n_f, w = packed.shape
    bits = (packed[..., :, None] >> np.arange(32, dtype=np.uint32)) & 1
    return bits.reshape(m, n_f, w * 32)[..., :entries].astype(bool)


def export_model(spec, statics, params) -> InferenceArtifact:
    """Trained state (`core.model.UleenSpec`, statics, `UleenParams`) ->
    the deployable artifact, with the JAX package's dtypes: uint32 words
    and H3 parameters, int32 perms and rounded bias, bool masks."""
    tables_bin, masks, bias = binarize_params(params)

    def host(t):
        return t.detach().cpu().numpy()

    subs = [SubmodelArtifact(
        packed=pack_table(host(tb)), mask=host(mask) > 0,
        perm=host(st.perm).astype(np.int32),
        h3=host(st.h3).astype(np.uint32), entries=sm.entries,
        inputs_per_filter=sm.inputs_per_filter, num_hashes=sm.num_hashes)
        for sm, st, tb, mask in zip(spec.submodels, statics, tables_bin,
                                    masks)]
    return InferenceArtifact(submodels=subs,
                             bias=host(torch.round(bias)).astype(np.int32),
                             num_classes=spec.num_classes,
                             total_bits=spec.total_bits,
                             bits_per_input=spec.bits_per_input)


class UnpackedTables(NamedTuple):
    """Device-resident 32× expansion of an artifact for the int8 backends
    (fused/gather). Built and validated once by `prepare_artifact`; for
    `fused`, with the launch arguments of the kernel
    (`kernels/wnn_ensemble.py`: perms, params, class slices and mask
    words) derived from the int8 tables at the same time."""
    tables: tuple    # per submodel (M, N_f, E) int8
    masks: tuple     # (M, N_f) int8
    perms: tuple     # (N_f, n) int64: torch indexes with int64 only
    h3s: tuple       # (k, n) int32
    bias: torch.Tensor  # (M,) int32
    kernel_args: object = None  # `fused`: the ensemble flattened for one launch

    @property
    def slices(self) -> tuple:
        """Per submodel class slices (N_f, E[, P]), views of `kernel_args`."""
        return self.kernel_args.submodel_slices()[0]

    @property
    def class_masks(self) -> tuple:
        """Per submodel mask words (N_f[, P]), views of `kernel_args`."""
        return self.kernel_args.submodel_slices()[1]


# one prepared object per REPRESENTATION: PackedTables serves both
# packed-domain backends, one UnpackedTables serves both int8 ones
_SAME_REPRESENTATION = {"auto": "packed", "packed": "auto",
                        "fused": "gather", "gather": "fused"}


def _with_kernel_args(prep: UnpackedTables) -> UnpackedTables:
    """`prep` with the fused kernel's launch arguments, derived from its
    int8 tables for its own class count."""
    from repro_torch.kernels import wnn_ensemble
    from repro_torch.packed import layout
    return prep._replace(kernel_args=wnn_ensemble.ensemble_args(
        prep.perms, prep.h3s,
        [layout.class_slices_from_table(t) for t in prep.tables],
        [layout.class_mask_words(m) for m in prep.masks],
        int(prep.bias.shape[0])))


def _build_prep(artifact: InferenceArtifact, backend: str,
                device: torch.device, unpacked=None):
    """The (uncached) representation build behind `prepare_artifact`;
    `unpacked`, a `gather` preparation, lends its int8 tables to `fused`,
    which adds only the kernel's launch arguments."""
    if backend in ("auto", "packed"):
        from repro_torch.packed import layout
        return layout.from_artifact(artifact, device=device)
    prep = _unpack(artifact, device) if unpacked is None else unpacked
    return _with_kernel_args(prep) if backend == "fused" else prep


def artifact_class_slice(artifact: InferenceArtifact, lo: int,
                         hi: int) -> InferenceArtifact:
    """The artifact of classes [lo, hi) (numpy views): per-class packed
    words, masks and bias sliced on M, perms and H3 parameters whole."""
    m = int(artifact.num_classes)
    if not 0 <= lo < hi <= m:
        raise ValueError(f"class range [{lo}, {hi}) outside [0, {m})")
    return dataclasses.replace(
        artifact, bias=np.asarray(artifact.bias)[lo:hi], num_classes=hi - lo,
        submodels=[dataclasses.replace(sm, packed=sm.packed[lo:hi],
                                       mask=np.asarray(sm.mask)[lo:hi])
                   for sm in artifact.submodels])


def prep_class_slice(prep, lo: int, hi: int):
    """The class shard [lo, hi) of prepared tables, for either
    representation: what one rank holds under the `classes` partition.
    Per-class leaves are views; an `UnpackedTables` prepared for `fused`
    gets the kernel's launch arguments for its hi - lo classes."""
    if not isinstance(prep, UnpackedTables):
        return prep.class_slice(lo, hi)
    m = int(prep.bias.shape[0])
    if not 0 <= lo < hi <= m:
        raise ValueError(f"class range [{lo}, {hi}) outside [0, {m})")
    out = UnpackedTables(tables=tuple(t[lo:hi] for t in prep.tables),
                         masks=tuple(x[lo:hi] for x in prep.masks),
                         perms=prep.perms, h3s=prep.h3s,
                         bias=prep.bias[lo:hi])
    return out if prep.kernel_args is None else _with_kernel_args(out)


def prep_shardings(prep, mesh, rules=None):
    """(entries, degree) of prepared tables partitioned over `mesh` by
    class, for either representation: `entries` maps each leaf name to
    its resolved mesh-axis entries (per submodel for the tuple leaves;
    `dist.sharding.ShardingRules.resolve`), `degree` is the class shard
    count. Per-class leaves (tables or words, masks, bias) carry the
    "classes" axis on M, perms and H3 parameters replicate, and the
    divisibility sanitizer degrades every leaf to replication together
    when M does not divide the mesh axis."""
    from repro_torch.dist import sharding as sh
    rules = rules if rules is not None else sh.SERVE_RULES
    if isinstance(prep, UnpackedTables):
        n = len(prep.tables)
        axes = {"tables": (("classes", None, None),) * n,
                "masks": (("classes", None),) * n,
                "perms": ((None, None),) * n, "h3s": ((None, None),) * n,
                "bias": ("classes",)}
        leaves = prep._asdict()
    else:
        axes = prep.logical_axes()
        leaves = {k: getattr(prep, k) for k in axes}
    entries = {}
    for name, log in axes.items():
        if name == "bias":
            entries[name] = rules.resolve(log, mesh,
                                          shape=tuple(leaves[name].shape))
        else:
            entries[name] = tuple(
                rules.resolve(a, mesh, shape=tuple(x.shape))
                for a, x in zip(log, leaves[name]))
    m = int(prep.bias.shape[0])
    return entries, sh.class_partition(mesh, m, rules)[1]


def _unpack(artifact: InferenceArtifact, device: torch.device):
    """The artifact's int8 tables, validated, on `device`."""
    subs = artifact.submodels

    from repro_torch.kernels import ops

    def t(a, dtype):
        return torch.from_numpy(np.asarray(a).astype(dtype)).to(device)

    prep = UnpackedTables(
        tables=tuple(t(unpack_table(sm.packed, sm.entries), np.int8)
                     for sm in subs),
        masks=tuple(t(np.asarray(sm.mask) != 0, np.int8) for sm in subs),
        perms=tuple(t(sm.perm, np.int64) for sm in subs),
        # h3 is stored as uint32 but holds values below E: int32 is exact
        h3s=tuple(t(sm.h3, np.int32) for sm in subs),
        bias=t(artifact.bias, np.int32))
    for table, mask, perm, h3 in zip(prep.tables, prep.masks, prep.perms,
                                     prep.h3s):
        # a batch's tuples are (B, N_f, n) with (N_f, n) the perm's shape
        ops.validate_wnn_geometry(perm.new_empty((0, *perm.shape)), h3, table,
                                  mask, prep.bias)
    return prep


def prepare_artifact(artifact: InferenceArtifact, *, backend: str = "auto",
                     mesh=None, rules=None, device=DEFAULT_DEVICE):
    """Hoisted, cached table preparation for repeated serving.

    backend="packed"/"auto" lifts the artifact's uint32 word planes into a
    `repro_torch.packed.PackedTables` verbatim (no expansion at all);
    "fused"/"gather" unpack to int8 device tables exactly once, and
    "fused" adds the class-sliced launch arguments of its kernel. The result
    is memoized on the artifact instance per (representation, device), so
    the serve path (`artifact_scores`, `launch.scheduler.WnnBatcher`)
    never redoes any table work per batch.

    With `mesh` (called on every rank of it alike) the tables are
    partitioned by class (`prep_shardings`): this rank moves only its
    classes [r·M/S, (r+1)·M/S) to `device` — its slice of the numpy
    artifact, never a replicated device copy — and gets a
    `packed.runtime.ClassShardedTables` whose scores are whole on every
    rank. When M does not divide the `classes` axes every leaf falls back
    to replication together, and the result is the unsharded
    preparation. Memoized per (representation, mesh, rules' content,
    device).
    """
    from repro_torch.kernels import ops
    ops.resolve_wnn_backend(backend)     # reject unknown names eagerly
    dev = resolve_device(device)
    rec = obs_registry.get_recorder()
    cache = getattr(artifact, "_prepared", None)
    if cache is None:
        cache = artifact._prepared = {}
    if mesh is not None:
        return _prepare_class_sharded(artifact, backend, mesh, rules, dev,
                                      cache)
    key = (backend, str(dev))
    if key in cache:
        rec.counter("prep.cache_hit").inc()
        return cache[key]
    prep = cache.get((_SAME_REPRESENTATION[backend], str(dev)))
    if prep is None or (backend == "fused" and prep.kernel_args is None):
        rec.counter("prep.cache_miss").inc()
        with rec.span("prep.build", backend=backend, device=str(dev)):
            prep = _build_prep(artifact, backend, dev, prep)
    else:
        # same-representation reuse: no build, but record the alias fill
        rec.counter("prep.cache_hit").inc()
    cache[key] = prep
    return prep


def _prepare_class_sharded(artifact, backend, mesh, rules, dev, cache):
    """`prepare_artifact(mesh=)`: this rank's class slice, memoized."""
    from repro_torch.dist import collectives
    from repro_torch.dist import sharding as sh
    from repro_torch.packed import runtime
    rules = rules if rules is not None else sh.SERVE_RULES
    m = int(artifact.num_classes)
    entry, degree = sh.class_partition(mesh, m, rules)
    if degree == 1:                      # replication fallback, every leaf
        return prepare_artifact(artifact, backend=backend, device=dev)
    rep = "packed" if backend in ("auto", "packed") else "int8"
    key = (rep, mesh, sh.rules_key(rules), str(dev))
    rec = obs_registry.get_recorder()
    sp = cache.get(key)
    if sp is not None and not (backend == "fused"
                               and sp.local.kernel_args is None):
        rec.counter("prep.cache_hit").inc()
        return sp
    rec.counter("prep.cache_miss").inc()
    axes = sh.entry_axes(entry)
    lo = collectives.axis_index(mesh, axes) * (m // degree)
    with rec.span("prep.build", backend=backend, device=str(dev),
                  sharded=True):
        if sp is None:
            local = _build_prep(artifact_class_slice(artifact, lo,
                                                     lo + m // degree),
                                backend, dev)
        else:                            # a `gather` slice gains `fused`'s
            local = _with_kernel_args(sp.local)  # launch arguments
    sp = runtime.ClassShardedTables(local=local, mesh=mesh, rules=rules,
                                    class_axes=axes, num_classes=m, lo=lo)
    cache[key] = sp
    return sp


def prepare_tenants(artifacts, *, backend: str = "auto", mesh=None,
                    rules=None, device=DEFAULT_DEVICE):
    """Hoisted, cached multi-artifact preparation: one
    `repro_torch.packed.StackedPackedTables` fleet over N same-geometry
    artifacts on `device`.

    Packed-domain only (backend "packed"/"auto"): an int8 fleet would
    multiply the 32x expansion by T. Each artifact goes through the
    `prepare_artifact` cache first (a tenant already served alone costs
    nothing to prepare again; a tenant only ever stacked never builds the
    kernel's class slices), then the tables stack with the geometry gate
    of `packed.stack_tenants`.

    Memoized on the first artifact's cache, keyed on the identity tuple
    of the whole fleet and the device (the same artifact objects in the
    same order hit; the cached value holds the artifacts, so the ids stay
    valid).

    With `mesh` (called on every rank alike) the fleet is partitioned by
    tenant: this rank prepares and stacks only tenants
    [r·T/S, (r+1)·T/S) and gets a `packed.runtime.TenantShardedTables`
    (serve it with `runtime.make_tenant_sharded_predict`). When T does
    not divide the `tenants` axes the whole fleet is stacked on every
    rank (a shard of all T tenants).
    """
    from repro_torch import packed
    from repro_torch.kernels import ops
    ops.resolve_wnn_backend(backend)
    if backend not in ("auto", "packed"):
        raise ValueError(
            f"prepare_tenants serves the packed domain only (backend="
            f"'packed'|'auto', got {backend!r})")
    artifacts = tuple(artifacts)
    if not artifacts:
        raise ValueError("prepare_tenants needs at least one artifact")
    dev = resolve_device(device)
    cache = getattr(artifacts[0], "_prepared", None)
    if cache is None:
        cache = artifacts[0]._prepared = {}
    key = ("tenants", tuple(id(a) for a in artifacts), str(dev))
    lo, hi = 0, len(artifacts)
    if mesh is not None:
        from repro_torch.dist import collectives
        from repro_torch.dist import sharding as sh
        rules = rules if rules is not None else sh.SERVE_RULES
        key += (mesh, sh.rules_key(rules))
        entry, degree = sh.tenant_partition(mesh, len(artifacts), rules)
        t_axes = sh.entry_axes(entry)
        if degree > 1:
            hi = len(artifacts) // degree
            lo = collectives.axis_index(mesh, t_axes) * hi
            hi += lo
    rec = obs_registry.get_recorder()
    hit = cache.get(key)
    if hit is not None:
        rec.counter("prep.cache_hit").inc()
        return hit[0]
    rec.counter("prep.cache_miss").inc()
    with rec.span("prep.stack_tenants", tenants=hi - lo,
                  sharded=mesh is not None):
        stacked = packed.stack_tenants(
            prepare_artifact(a, backend=backend, device=dev)
            for a in artifacts[lo:hi])
    if mesh is not None:
        from repro_torch.packed import runtime
        stacked = runtime.TenantShardedTables(
            local=stacked, mesh=mesh, rules=rules, tenant_axes=t_axes,
            num_tenants=len(artifacts), lo=lo)
    cache[key] = (stacked, artifacts)   # pin the ids the key ranges over
    return stacked


def scores_from_prep(prep, bits, *, backend: str = "auto") -> torch.Tensor:
    """Backend-dispatched scores from prepared tables, on their device.

    THE serve loop — `artifact_scores` and `launch.scheduler.WnnBatcher`
    both route through here, so the dispatch, mask and bias semantics
    cannot drift between them. On a GPU the kernel backends (`auto`,
    `packed`, `fused`) make one launch a batch on its (B, total_bits)
    rows; the CPU and `gather` run the plain per-submodel loop. The
    prepared tables were validated when they were built; a batch pays
    only the wrapper's pointer checks. A class-sharded preparation
    scores this rank's classes and gathers the (B, M) matrix
    (`packed.runtime.class_sharded_scores`).
    """
    from repro_torch.packed import runtime as _runtime
    if isinstance(prep, _runtime.ClassShardedTables):
        return _runtime.class_sharded_scores(
            prep, bits, lambda p, b: scores_from_prep(p, b, backend=backend))
    if not isinstance(prep, UnpackedTables):
        from repro_torch.packed import runtime
        return runtime.packed_scores(prep, bits, backend=backend,
                                     device=prep.device)
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.fused_wnn import fused_wnn, fused_wnn_ensemble
    dev = prep.bias.device
    resolved = ops.resolve_wnn_backend(backend, device=dev)
    if resolved not in ("fused", "gather"):
        raise ValueError(f"int8 tables serve backend='fused'|'gather'|'auto',"
                         f" got {backend!r}")
    if resolved == "fused" and dev.type == "cuda":
        if prep.kernel_args is None:
            raise ValueError("these tables were prepared for 'gather'; "
                             "prepare_artifact(..., backend='fused') adds "
                             "the kernel's class slices")
        bits = torch.as_tensor(bits).to(dev)
        # the kernel reads any one-byte {0,1} rows as they are
        if bits.dtype not in (torch.int8, torch.uint8, torch.bool):
            bits = bits.to(torch.int8)
        return fused_wnn_ensemble(bits.contiguous(), prep)
    # "fused" is the kernel (its plain version on the CPU), "gather" the
    # plain version on any device
    wnn = fused_wnn if resolved == "fused" else ref.fused_wnn_ref
    m = prep.bias.shape[0]
    # one int8 copy of the batch; each submodel's gather is then int8
    bits = torch.as_tensor(bits).to(dev).to(torch.int8)
    scores = torch.zeros((bits.shape[0], m), dtype=torch.int32, device=dev)
    zero_bias = torch.zeros((m,), dtype=torch.int32, device=dev)
    for table, mask, perm, h3 in zip(prep.tables, prep.masks, prep.perms,
                                     prep.h3s):
        scores += wnn(bits[:, perm], h3, table, mask, zero_bias)
    return scores + prep.bias[None]


def predict_from_prep(prep, bits, *, backend: str = "auto"):
    """(scores (B, M), argmax predictions (B,)) from prepared tables; on a
    class-sharded preparation the argmax runs over the gathered class
    axis, the same on every rank."""
    from repro_torch.kernels import ops
    return ops.ensemble_predict(scores_from_prep(prep, bits, backend=backend))


def artifact_scores(artifact: InferenceArtifact, bits, *,
                    backend: str = "auto",
                    device=DEFAULT_DEVICE) -> torch.Tensor:
    """Serve encoded inputs straight from the deployable artifact.

    bits: (B, total_bits) bool/int {0,1} -> scores (B, M) int32 on
    `device`; on a GPU one WNN kernel launch for the whole ensemble,
    which gathers each filter's tuple through the stored permutation
    itself.

    backend="packed"/"auto" serves the artifact's native uint32 bitplanes
    (the packed kernel on a GPU); "fused"/"gather" serve the int8
    expansion, prepared once and cached by `prepare_artifact`.
    Bit-identical across backends and to the JAX package.
    """
    prep = prepare_artifact(artifact, backend=backend, device=device)
    return scores_from_prep(prep, bits, backend=backend)


def to_arrays(artifact: InferenceArtifact) -> dict:
    """The artifact as the npz-keyed arrays `save` writes."""
    arrs = {"bias": artifact.bias,
            "meta": np.array([artifact.num_classes, artifact.total_bits,
                              artifact.bits_per_input, len(artifact.submodels)])}
    for i, sm in enumerate(artifact.submodels):
        arrs[f"sm{i}_packed"] = sm.packed
        arrs[f"sm{i}_mask"] = sm.mask
        arrs[f"sm{i}_perm"] = sm.perm
        arrs[f"sm{i}_h3"] = sm.h3
        arrs[f"sm{i}_cfg"] = np.array([sm.entries, sm.inputs_per_filter,
                                       sm.num_hashes])
    return arrs


def from_arrays(z) -> InferenceArtifact:
    """The artifact from npz-keyed arrays (an open npz file or a dict)."""
    m, total_bits, bpi, n_sub = z["meta"]
    subs = []
    for i in range(int(n_sub)):
        e, n, k = z[f"sm{i}_cfg"]
        subs.append(SubmodelArtifact(
            packed=z[f"sm{i}_packed"], mask=z[f"sm{i}_mask"],
            perm=z[f"sm{i}_perm"], h3=z[f"sm{i}_h3"],
            entries=int(e), inputs_per_filter=int(n), num_hashes=int(k)))
    return InferenceArtifact(submodels=subs, bias=z["bias"],
                             num_classes=int(m), total_bits=int(total_bits),
                             bits_per_input=int(bpi))


def save(artifact: InferenceArtifact, path: str) -> None:
    np.savez_compressed(path, **to_arrays(artifact))


def load(path: str) -> InferenceArtifact:
    with np.load(path) as z:
        return from_arrays(z)
