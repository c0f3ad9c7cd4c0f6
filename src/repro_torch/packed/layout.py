"""Packed-domain table layout: uint32 bitplanes as the native serve
representation (port of `repro/packed/layout.py`).

Word layout (matches `core/export.py::pack_table` exactly):

    entry e of filter (m, f)  ==  bit (e & 31) of word[m, f, e >> 5]

little-endian bits within a word, words in entry order. `entries` that are
not a multiple of 32 (E in {8, 16}) pad the single word's high bits with
zeros; H3 hashes stay in [0, E), so padding bits are never read.

The port carries word planes as int32 tensors holding the uint32 bit
patterns: torch has few uint32 ops, and every consumer only shifts and
masks. `StackedPackedTables` stacks a fleet of same-geometry tables along
a leading tenant axis (multi-tenant serving). Both name the logical axes
of their leaves (`logical_axes`: "classes" on every per-class leaf,
"tenants" on every stacked leaf) and cut the slice one rank holds under
that partition (`class_slice`, `tenant_shard`).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from repro_torch.core.model import round_bias
from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.kernels import wnn_ensemble


def word_count(entries: int) -> int:
    """uint32 words per filter for E entries (>= 1 whole word)."""
    return max(1, entries // 32) if entries % 32 == 0 else 1


def validate_packed_geometry(words: torch.Tensor, entries: int) -> None:
    """Check that a word plane matches its declared entries: power-of-two
    entries (H3 range closure), the exact packed width, uint32 words (or
    their int32 bit patterns)."""
    if entries <= 0 or entries & (entries - 1):
        raise ValueError(
            f"entries={entries} must be a power of two (H3 range closure)")
    if words.ndim != 3:
        raise ValueError(f"packed words must be (M, N_f, W), "
                         f"got {tuple(words.shape)}")
    w = words.shape[-1]
    expect = word_count(entries)
    if w != expect:
        raise ValueError(
            f"packed word count {w} != ceil({entries}/32)={expect} "
            f"(word-aligned layout; non-power-of-two word counts cannot "
            f"arise from a legal pack)")
    if words.dtype not in (torch.uint32, torch.int32):
        raise ValueError(f"packed words must be uint32, got {words.dtype}")


def pack_words(table_bin: torch.Tensor) -> torch.Tensor:
    """(M, N_f, E) {0,1} -> (M, N_f, W) int32 holding the uint32 words
    `core/export.py::pack_table` writes."""
    m, n_f, e = table_bin.shape
    bits = (table_bin != 0).to(torch.int64)
    pad = (-e) % 32
    if pad:
        bits = torch.nn.functional.pad(bits, (0, pad))
    shifts = torch.arange(32, dtype=torch.int64, device=bits.device)
    words = torch.sum(bits.reshape(m, n_f, -1, 32) << shifts, dim=-1)
    # words are in [0, 2^32): wrap the top half to int32's negative range
    return (words - ((words >> 31) << 32)).to(torch.int32)


def unpack_words(words: torch.Tensor, entries: int) -> torch.Tensor:
    """(M, N_f, W) uint32/int32 words -> (M, N_f, E) int8 {0,1}; the
    inverse of `pack_words`, for tests and explicit down-conversion."""
    if words.dtype == torch.uint32:
        words = words.view(torch.int32)
    m, n_f, w = words.shape
    shifts = torch.arange(32, dtype=torch.int32, device=words.device)
    bits = (words[..., :, None] >> shifts) & 1
    return bits.reshape(m, n_f, w * 32)[..., :entries].to(torch.int8)


def _class_words(num_classes: int, class_bits) -> torch.Tensor:
    """The class-sliced words of M classes: `class_bits(c)` is class c's
    {0,1} array (any shape S); the result is S in the slice dtype, or
    (*S, P) for P > 1 planes. One class at a time, so the int64 staging
    never holds more than one plane."""
    dtype, planes = wnn_ensemble.slice_format(num_classes)
    acc = None
    for c in range(num_classes):
        bit = (class_bits(c) != 0).to(torch.int64) << (c % 32)
        if acc is None:
            acc = torch.zeros((planes, *bit.shape), dtype=torch.int64,
                              device=bit.device)
        acc[c // 32] |= bit
    width = wnn_ensemble.element_bits(dtype)
    if dtype != torch.uint8:     # the top half wraps to the negative range
        acc = acc - ((acc >> (width - 1)) << width)
    acc = acc.to(dtype)
    return acc[0] if planes == 1 else torch.movedim(acc, 0, -1).contiguous()


def class_slices_from_table(table: torch.Tensor) -> torch.Tensor:
    """(M, N_f, E) {0,1} table -> class slices (N_f, E) (or (N_f, E, P);
    (N_f, E / epb) for M <= 4): entry [f, h] holds bit m = table[m, f, h]
    (layout in `kernels/wnn_ensemble.py`)."""
    return wnn_ensemble.pack_entries(
        _class_words(table.shape[0], lambda c: table[c]), table.shape[0])


def class_slices_from_words(words: torch.Tensor, entries: int) -> torch.Tensor:
    """(M, N_f, W) bitplanes -> the same class slices as
    `class_slices_from_table` on their unpacked table, one class unpacked
    at a time."""
    words = words.view(torch.int32) if words.dtype == torch.uint32 else words
    return wnn_ensemble.pack_entries(_class_words(
        words.shape[0], lambda c: unpack_words(words[c:c + 1], entries)[0]),
        words.shape[0])


def class_mask_words(mask: torch.Tensor) -> torch.Tensor:
    """(M, N_f) survival flags -> one M-bit word per filter, (N_f,) (or
    (N_f, P)): bit m set iff mask[m, f] != 0."""
    return _class_words(mask.shape[0], lambda c: mask[c])


def table_from_class_slices(slices: torch.Tensor, num_classes: int,
                            entries: int | None = None) -> torch.Tensor:
    """Class slices (N_f, E[, P]) -> the (M, N_f, E) int8 {0,1} table they
    hold; the inverse of `class_slices_from_table`. Sub-byte slices
    (M <= 4) unpack to their padded entry count unless `entries` cuts
    them to E."""
    if slices.ndim == 2:
        slices = wnn_ensemble.unpack_entries(slices, num_classes)
        if entries is not None:
            slices = slices[:, :entries]
    words = slices if slices.ndim == 3 else slices[..., None]
    width = wnn_ensemble.element_bits(slices.dtype)
    words = words.to(torch.int64) & ((1 << width) - 1)
    return torch.stack([(words[..., c // 32] >> (c % 32)) & 1
                        for c in range(num_classes)]).to(torch.int8)


@dataclasses.dataclass
class PackedTables:
    """A deployable model in the packed domain — what the serve path
    carries from artifact load to kernel launch.

    Per submodel (tuple-indexed): `words` (M, N_f, W) int32 bitplanes,
    `masks` (M, N_f) int8 survival flags, `perms` (N_f, n) int64 input
    permutations (the artifact stores int32; torch indexes with int64, so
    the conversion happens here, once), `h3s` (k, n) int32 hash
    parameters; plus the ensemble `bias` (M,) int32, `entries` per
    submodel and `num_classes`. Construction validates the geometry, so
    the serve path does not repeat it per batch.

    Derived once, on first use and on the same device: `kernel_args`, the
    whole ensemble flattened for the one kernel launch a batch makes on a
    GPU (`kernels/wnn_ensemble.py`), which holds the class slices
    (N_f, E[, P]) and mask words (N_f[, P]) that answer every class with
    one load (`class_slices_from_words`, `class_mask_words`); `slices`
    and `class_masks` are per-submodel views of them. Tables that are
    only ever stacked into a tenant fleet (`stack_tenants`) never build
    them. The words stay as the artifact has them, unless
    `release_words` drops them once the slices exist (a class-sharded
    rank, whose slices are all it serves from): `words` is then None,
    `plane_words()` rebuilds them from the slices on demand, and the plain
    CPU path reads the slices (`runtime.packed_scores`).
    """
    words: tuple
    masks: tuple
    perms: tuple
    h3s: tuple
    bias: torch.Tensor
    entries: tuple = ()
    num_classes: int = 0
    _kernel_args: object = dataclasses.field(default=None, repr=False,
                                             init=False, compare=False)

    def __post_init__(self):
        n = len(self.words)
        if not (len(self.masks) == len(self.perms) == len(self.h3s)
                == len(self.entries) == n):
            raise ValueError(
                f"per-submodel tuples disagree: words={n} "
                f"masks={len(self.masks)} perms={len(self.perms)} "
                f"h3s={len(self.h3s)} entries={len(self.entries)}")
        self.validate()

    def release_words(self, columns: int | None = None) -> "PackedTables":
        """Build the kernel arguments (if they are not built yet; `columns`
        as `build_kernel_args` takes it), then drop the uint32 words:
        the class slices hold every bit of them. Readers that still want
        word planes call `plane_words()`."""
        if self._kernel_args is None:
            self.build_kernel_args(columns)
        self.words = None
        return self

    def plane_words(self) -> tuple:
        """The (M, N_f, W) int32 word planes: `words`, or, once they were
        released, rebuilt from the class slices (one submodel at a time,
        not kept)."""
        if self.words is not None:
            return self.words
        return tuple(
            pack_words(table_from_class_slices(sl, self.num_classes, e))
            for sl, e in zip(self.slices, self.entries))

    @property
    def kernel_args(self) -> wnn_ensemble.EnsembleArgs:
        """The ensemble's launch arguments, built on first use."""
        if self._kernel_args is None:
            self.build_kernel_args()
        return self._kernel_args

    def build_kernel_args(self, columns: int | None = None) -> "PackedTables":
        """Build `kernel_args` now. `columns` (the input bits the perms may
        read, such as the spec's total_bits) spares reading the perms on
        the host; without it they are read and range-checked."""
        self._kernel_args = wnn_ensemble.ensemble_args(
            self.perms, self.h3s,
            [class_slices_from_words(w, e)
             for w, e in zip(self.plane_words(), self.entries)],
            [class_mask_words(m) for m in self.masks], self.num_classes,
            columns=columns)
        return self

    @property
    def slices(self) -> tuple:
        """Per submodel class slices (N_f, E[, P]), views of `kernel_args`."""
        return self.kernel_args.submodel_slices()[0]

    @property
    def class_masks(self) -> tuple:
        """Per submodel mask words (N_f[, P]), views of `kernel_args`."""
        return self.kernel_args.submodel_slices()[1]

    @property
    def num_submodels(self) -> int:
        return len(self.masks)

    @property
    def device(self) -> torch.device:
        return self.bias.device

    def to(self, device) -> "PackedTables":
        """The same tables on `device` (self when already there); released
        words stay released there."""
        device = torch.device(device)
        if self.device == device:
            return self

        def mv(ts):
            return tuple(t.to(device) for t in ts)

        moved = PackedTables(words=mv(self.plane_words()),
                             masks=mv(self.masks), perms=mv(self.perms),
                             h3s=mv(self.h3s), bias=self.bias.to(device),
                             entries=self.entries,
                             num_classes=self.num_classes)
        if self.words is None:
            moved.release_words(self.kernel_args.columns)
        return moved

    def validate(self) -> None:
        """Per-submodel geometry validation, mirroring `ops.wnn_scores`."""
        for i, (wds, mask, perm, h3, e) in enumerate(zip(
                self.words, self.masks, self.perms, self.h3s, self.entries)):
            validate_packed_geometry(wds, e)
            m, n_f, _ = wds.shape
            if m != self.num_classes:
                raise ValueError(f"submodel {i}: words M={m} != "
                                 f"num_classes={self.num_classes}")
            if tuple(mask.shape) != (m, n_f):
                raise ValueError(f"submodel {i}: mask {tuple(mask.shape)} "
                                 f"!= (M, N_f)=({m}, {n_f})")
            if perm.ndim != 2 or perm.shape[0] != n_f:
                raise ValueError(f"submodel {i}: perm {tuple(perm.shape)} "
                                 f"!= (N_f={n_f}, n)")
            if h3.ndim != 2 or h3.shape[1] != perm.shape[1]:
                raise ValueError(f"submodel {i}: h3 {tuple(h3.shape)} n != "
                                 f"perm n={perm.shape[1]}")
        if tuple(self.bias.shape) != (self.num_classes,):
            raise ValueError(f"bias {tuple(self.bias.shape)} != "
                             f"(M,)=({self.num_classes},)")

    def table_bytes(self) -> int:
        """Packed table storage in bytes: 4 bytes per word (what the words
        take, held or released)."""
        return sum(int(m.shape[0]) * int(m.shape[1]) * word_count(e) * 4
                   for m, e in zip(self.masks, self.entries))

    def slice_bytes(self) -> int:
        """Class-sliced table storage in bytes (what the kernel probes)."""
        return (self.kernel_args.slices.numel()
                * self.kernel_args.slices.element_size())

    def logical_axes(self) -> dict:
        """{leaf name: logical axes}, per submodel for the tuple leaves.
        Per-class discriminators are independent until the final argmax,
        so every per-class leaf (words, masks, bias) carries "classes" on
        its M dimension; the shared perms and H3 parameters (one hash
        block serves every class) stay replicated."""
        n = self.num_submodels
        return {"words": (("classes", None, None),) * n,
                "masks": (("classes", None),) * n,
                "perms": ((None, None),) * n,
                "h3s": ((None, None),) * n,
                "bias": ("classes",)}

    def class_slice(self, lo: int, hi: int) -> "PackedTables":
        """The class shard [lo, hi): words, masks and bias sliced on M
        (views), perms and H3 parameters whole. Its scores are columns
        [lo, hi) of the full (B, M) matrix; its kernel arguments are built
        for hi - lo classes on first use."""
        if not 0 <= lo < hi <= self.num_classes:
            raise ValueError(
                f"class range [{lo}, {hi}) outside [0, {self.num_classes})")
        return PackedTables(
            words=tuple(w[lo:hi] for w in self.plane_words()),
            masks=tuple(m[lo:hi] for m in self.masks),
            perms=self.perms, h3s=self.h3s, bias=self.bias[lo:hi],
            entries=self.entries, num_classes=hi - lo)


def from_binary_model(statics: Sequence, tables_bin: Sequence,
                      masks: Sequence, bias, entries: Sequence[int],
                      num_classes: int, *,
                      device=DEFAULT_DEVICE) -> PackedTables:
    """Pack a binarized model (`core.model.SubmodelStatic`s, (M, N_f, E)
    {0,1} tables, masks, bias) into `PackedTables` on `device`."""
    dev = resolve_device(device)

    def t(x):
        return torch.as_tensor(x).to(dev)

    return PackedTables(
        words=tuple(pack_words(t(tb)) for tb in tables_bin),
        masks=tuple((t(m) != 0).to(torch.int8) for m in masks),
        perms=tuple(t(st.perm).to(torch.int64) for st in statics),
        h3s=tuple(t(st.h3).to(torch.int32) for st in statics),
        bias=round_bias(t(bias)),
        entries=tuple(int(e) for e in entries),
        num_classes=int(num_classes))


def from_artifact(artifact, *, device=DEFAULT_DEVICE) -> PackedTables:
    """Lift a `core.export.InferenceArtifact` into the packed runtime: the
    artifact's uint32 planes move to `device` verbatim, as int32 bit
    patterns; nothing is unpacked."""
    dev = resolve_device(device)
    subs = artifact.submodels
    return PackedTables(
        words=tuple(torch.from_numpy(np.ascontiguousarray(
            sm.packed, np.uint32).view(np.int32)).to(dev) for sm in subs),
        masks=tuple(torch.from_numpy(np.asarray(sm.mask) != 0).to(
            dev, torch.int8) for sm in subs),
        perms=tuple(torch.from_numpy(np.asarray(sm.perm, np.int64)).to(dev)
                    for sm in subs),
        # h3 is stored as uint32 but holds values below E: int32 is exact
        h3s=tuple(torch.from_numpy(np.asarray(sm.h3).astype(np.int32)).to(dev)
                  for sm in subs),
        bias=torch.from_numpy(np.asarray(artifact.bias, np.int32)).to(dev),
        entries=tuple(int(sm.entries) for sm in subs),
        num_classes=int(artifact.num_classes))


@dataclasses.dataclass
class StackedPackedTables:
    """A fleet of same-geometry deployable models: T `PackedTables`
    stacked along a new leading tenant axis.

    Leaves (per submodel, tuple-indexed): `words` (T, M, N_f, W) int32
    bitplanes, `masks` (T, M, N_f) int8, `perms` (T, N_f, n) int64, `h3s`
    (T, k, n) int32; plus `bias` (T, M) int32 — the dtypes of
    `PackedTables`. Every tenant trained its own hash block, so perms and
    H3 parameters are per-tenant leaves too; only the geometry is shared,
    which is what lets one fixed-shape call serve the whole fleet.
    `entries` per submodel, `num_classes` and `num_tenants` are static.
    """
    words: tuple
    masks: tuple
    perms: tuple
    h3s: tuple
    bias: torch.Tensor
    entries: tuple = ()
    num_classes: int = 0
    num_tenants: int = 0

    def __post_init__(self):
        n = len(self.words)
        if not (len(self.masks) == len(self.perms) == len(self.h3s)
                == len(self.entries) == n):
            raise ValueError(
                f"per-submodel tuples disagree: words={n} "
                f"masks={len(self.masks)} perms={len(self.perms)} "
                f"h3s={len(self.h3s)} entries={len(self.entries)}")

    @property
    def num_submodels(self) -> int:
        return len(self.words)

    @property
    def device(self) -> torch.device:
        return self.bias.device

    def validate(self) -> None:
        """Every per-tenant leaf carries the same leading T, and tenant 0's
        slice is a legal single-tenant layout (the leaves are uniform
        along T, so checking one slice checks all)."""
        t = self.num_tenants
        if t < 1:
            raise ValueError(f"num_tenants={t} must be >= 1")
        for i, leaves in enumerate(zip(self.words, self.masks, self.perms,
                                       self.h3s)):
            for leaf in leaves:
                if leaf.shape[0] != t:
                    raise ValueError(
                        f"submodel {i}: leading tenant dim "
                        f"{leaf.shape[0]} != num_tenants={t}")
        if tuple(self.bias.shape) != (t, self.num_classes):
            raise ValueError(f"bias {tuple(self.bias.shape)} != (T, M)="
                             f"({t}, {self.num_classes})")
        self.tenant_slice(0).validate()

    def tenant_slice(self, tid: int) -> PackedTables:
        """The single-tenant `PackedTables` at index `tid` (views)."""
        if not 0 <= tid < self.num_tenants:
            raise ValueError(
                f"tenant {tid} outside [0, {self.num_tenants})")
        return PackedTables(
            words=tuple(w[tid] for w in self.words),
            masks=tuple(m[tid] for m in self.masks),
            perms=tuple(p[tid] for p in self.perms),
            h3s=tuple(h[tid] for h in self.h3s),
            bias=self.bias[tid],
            entries=self.entries, num_classes=self.num_classes)

    def tenant_shard(self, lo: int, hi: int) -> "StackedPackedTables":
        """The tenant shard [lo, hi) (views): what one rank holds under the
        `tenants` partition."""
        if not 0 <= lo < hi <= self.num_tenants:
            raise ValueError(
                f"tenant range [{lo}, {hi}) outside [0, {self.num_tenants})")
        return StackedPackedTables(
            words=tuple(w[lo:hi] for w in self.words),
            masks=tuple(m[lo:hi] for m in self.masks),
            perms=tuple(p[lo:hi] for p in self.perms),
            h3s=tuple(h[lo:hi] for h in self.h3s),
            bias=self.bias[lo:hi],
            entries=self.entries, num_classes=self.num_classes,
            num_tenants=hi - lo)

    def logical_axes(self) -> dict:
        """{leaf name: logical axes}: every leaf carries "tenants" on its
        leading dim, since whole tenants are independent."""
        n = self.num_submodels
        return {"words": (("tenants", None, None, None),) * n,
                "masks": (("tenants", None, None),) * n,
                "perms": (("tenants", None, None),) * n,
                "h3s": (("tenants", None, None),) * n,
                "bias": ("tenants", None)}

    def table_bytes(self) -> int:
        """Packed word storage of the whole fleet (4 bytes per word)."""
        return sum(w.numel() * 4 for w in self.words)

    def nbytes(self) -> int:
        """Every leaf's bytes on the device: words, masks, perms, H3
        parameters and bias."""
        leaves = (*self.words, *self.masks, *self.perms, *self.h3s,
                  self.bias)
        return sum(x.numel() * x.element_size() for x in leaves)

    def to(self, device) -> "StackedPackedTables":
        """The same fleet on `device` (self when already there)."""
        device = torch.device(device)
        if self.device == device:
            return self

        def mv(ts):
            return tuple(t.to(device) for t in ts)

        return StackedPackedTables(
            words=mv(self.words), masks=mv(self.masks), perms=mv(self.perms),
            h3s=mv(self.h3s), bias=self.bias.to(device), entries=self.entries,
            num_classes=self.num_classes, num_tenants=self.num_tenants)


def stack_tenants(tables) -> StackedPackedTables:
    """Stack N same-geometry `PackedTables` (on one device) into one fleet.

    Every model must agree on submodel count, `entries`, `num_classes`
    and per-submodel leaf shapes; a mismatch raises ValueError naming the
    offender, so one fixed-shape call serves every tenant.
    """
    tables = list(tables)
    if not tables:
        raise ValueError("stack_tenants needs at least one PackedTables")
    ref = tables[0]
    for t, pt in enumerate(tables[1:], start=1):
        if pt.entries != ref.entries:
            raise ValueError(
                f"tenant {t}: entries {pt.entries} != tenant 0's "
                f"{ref.entries} — stacked tenants must share geometry")
        if pt.num_classes != ref.num_classes:
            raise ValueError(
                f"tenant {t}: num_classes {pt.num_classes} != tenant 0's "
                f"{ref.num_classes}")
        for i, (a, b) in enumerate(zip(pt.words, ref.words)):
            if a.shape != b.shape:
                raise ValueError(
                    f"tenant {t} submodel {i}: words {tuple(a.shape)} != "
                    f"tenant 0's {tuple(b.shape)}")
        for i, (a, b) in enumerate(zip(pt.perms, ref.perms)):
            if a.shape != b.shape:
                raise ValueError(
                    f"tenant {t} submodel {i}: perm {tuple(a.shape)} != "
                    f"tenant 0's {tuple(b.shape)}")
    n_sub = ref.num_submodels
    st = StackedPackedTables(
        words=tuple(torch.stack([pt.words[i] for pt in tables])
                    for i in range(n_sub)),
        masks=tuple(torch.stack([pt.masks[i] for pt in tables])
                    for i in range(n_sub)),
        perms=tuple(torch.stack([pt.perms[i] for pt in tables])
                    for i in range(n_sub)),
        h3s=tuple(torch.stack([pt.h3s[i] for pt in tables])
                  for i in range(n_sub)),
        bias=torch.stack([pt.bias for pt in tables]),
        entries=ref.entries, num_classes=ref.num_classes,
        num_tenants=len(tables))
    st.validate()
    return st


def stacked_zeros(template: PackedTables,
                  capacity: int) -> StackedPackedTables:
    """An all-empty fleet of `capacity` slots with `template`'s geometry,
    on its device: the resident cache the tenant batcher installs models
    into. Empty Bloom words answer 0 for every lookup, so an unfilled
    slot scores exactly the zero bias it carries."""
    if capacity < 1:
        raise ValueError(f"capacity={capacity} must be >= 1")

    def z(x):
        return torch.zeros((capacity, *x.shape), dtype=x.dtype,
                           device=x.device)

    return StackedPackedTables(
        words=tuple(z(w) for w in template.words),
        masks=tuple(z(m) for m in template.masks),
        perms=tuple(z(p) for p in template.perms),
        h3s=tuple(z(h) for h in template.h3s),
        bias=z(template.bias),
        entries=template.entries, num_classes=template.num_classes,
        num_tenants=capacity)
