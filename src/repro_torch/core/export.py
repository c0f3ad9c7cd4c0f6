"""Export a trained ULEEN model and serve the deployable artifact (port of
`repro/core/export.py`).

Binary tables are bit-packed (32 entries per uint32 word), pruned filters
carry a survival mask, and model size is accounted as the paper reports it
(surviving filters x entries bits). `export_model` turns training state
into the artifact; `save`/`load` write and read the same npz files as the
JAX package, byte for byte both ways: keys `meta`, `bias` and
`sm{i}_{packed,mask,perm,h3,cfg}`. The artifact itself stays numpy;
`prepare_artifact` moves it to the device once per representation.
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


def _build_prep(artifact: InferenceArtifact, backend: str,
                device: torch.device, unpacked=None):
    """The (uncached) representation build behind `prepare_artifact`;
    `unpacked`, a `gather` preparation, lends its int8 tables to `fused`,
    which adds only the kernel's launch arguments."""
    if backend in ("auto", "packed"):
        from repro_torch.packed import layout
        return layout.from_artifact(artifact, device=device)
    prep = _unpack(artifact, device) if unpacked is None else unpacked
    if backend != "fused":
        return prep
    from repro_torch.kernels import wnn_ensemble
    from repro_torch.packed import layout
    return prep._replace(kernel_args=wnn_ensemble.ensemble_args(
        prep.perms, prep.h3s,
        [layout.class_slices_from_table(t) for t in prep.tables],
        [layout.class_mask_words(m) for m in prep.masks],
        int(artifact.num_classes)))


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
                     device=DEFAULT_DEVICE):
    """Hoisted, cached table preparation for repeated serving.

    backend="packed"/"auto" lifts the artifact's uint32 word planes into a
    `repro_torch.packed.PackedTables` verbatim (no expansion at all);
    "fused"/"gather" unpack to int8 device tables exactly once, and
    "fused" adds the class-sliced launch arguments of its kernel. The result
    is memoized on the artifact instance per (representation, device), so
    the serve path (`artifact_scores`, `launch.scheduler.WnnBatcher`)
    never redoes any table work per batch.
    """
    from repro_torch.kernels import ops
    ops.resolve_wnn_backend(backend)     # reject unknown names eagerly
    dev = resolve_device(device)
    rec = obs_registry.get_recorder()
    cache = getattr(artifact, "_prepared", None)
    if cache is None:
        cache = artifact._prepared = {}
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


def prepare_tenants(artifacts, *, backend: str = "auto", mesh=None,
                    device=DEFAULT_DEVICE):
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
    valid). A tenant-sharded fleet (`mesh=`) waits for the port's sharded
    serving (ROADMAP Queue 1 item 3).
    """
    from repro_torch import packed
    from repro_torch.kernels import ops
    ops.resolve_wnn_backend(backend)
    if backend not in ("auto", "packed"):
        raise ValueError(
            f"prepare_tenants serves the packed domain only (backend="
            f"'packed'|'auto', got {backend!r})")
    if mesh is not None:
        raise NotImplementedError(
            "a tenant-sharded fleet (mesh=) belongs to the port's sharded "
            "serving, ROADMAP Queue 1 item 3")
    artifacts = tuple(artifacts)
    if not artifacts:
        raise ValueError("prepare_tenants needs at least one artifact")
    dev = resolve_device(device)
    cache = getattr(artifacts[0], "_prepared", None)
    if cache is None:
        cache = artifacts[0]._prepared = {}
    key = ("tenants", tuple(id(a) for a in artifacts), str(dev))
    rec = obs_registry.get_recorder()
    hit = cache.get(key)
    if hit is not None:
        rec.counter("prep.cache_hit").inc()
        return hit[0]
    rec.counter("prep.cache_miss").inc()
    with rec.span("prep.stack_tenants", tenants=len(artifacts),
                  sharded=False):
        stacked = packed.stack_tenants(
            prepare_artifact(a, backend=backend, device=dev)
            for a in artifacts)
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
    only the wrapper's pointer checks.
    """
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
    """(scores (B, M), argmax predictions (B,)) from prepared tables."""
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
