"""The class-sliced lookup layout and the one WNN scoring launch behind
`packed_wnn` and `fused_wnn` (`csrc/wnn.cu`).

A submodel's Bloom filters are stored class-sliced: entry `[f, h]` of an
(N_f, E) array holds the M class bits of table entry h of filter f, so
one load answers every class (bit m = class m). The element type is the
narrowest that holds M: uint8 (M <= 8), uint16 (M <= 16), uint32
(M <= 32); above 32 classes an entry is P = ceil(M / 32) uint32 words,
(N_f, E, P). A filter's survival mask is one M-bit word of the same type
(`(N_f,)` or `(N_f, P)`). uint16 and uint32 words travel as their int16
and int32 bit patterns (torch has few unsigned ops; every consumer only
shifts and masks).

`ensemble_args` concatenates a whole ensemble for one launch, and is
where the class-sliced layout is kept: every submodel's permutation,
transposed to (n, N_f) so the lanes of a warp (one filter each) read
neighbouring indices; the H3 parameters as int32; the class slices and
mask words; and one descriptor row per submodel (`DESC_FIELDS`, offsets
in elements). The perms' reach picks the kernel's route
(`EnsembleArgs.route`): `shared_tile` while every index lies below
`TILE_COLUMNS` (uint16 indices, in int16 bit patterns; a tile of the
batch's rows in shared memory), `global_gather` past that (int32
indices; each gathered bit read from global memory). Any class count
runs in one launch: past `GROUP_PLANES` words an entry the kernel's grid
splits the classes into groups of 128. Per-submodel slices are views of
the concatenation (`EnsembleArgs.submodel_slices`). It runs once, where
the tables are prepared, never per batch. Nothing here runs at import
time or needs a GPU.
"""
from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import Sequence

import torch

from repro_torch.kernels import build, launch

# One descriptor row per submodel, int32, read by csrc/wnn.cu's Submodel.
DESC_FIELDS = ("num_filters", "n", "k", "entries", "perm_off", "param_off",
               "slice_off", "mask_off", "chunk_begin")
GROUP_PLANES = 4            # csrc/wnn.cu kGroupPlanes: words a class group
TILE_COLUMNS = 65536        # csrc/wnn.cu kTileCols: the shared tile's reach
ROWS_PER_TILE = 8           # csrc/wnn.cu kRows
WINDOW = 8192               # csrc/wnn.cu kWindow

_ARGTYPES = ([ctypes.c_void_p] + [ctypes.c_int] * 3              # bits, B, row bits, cols
             + [ctypes.c_void_p] * 5                          # perms, params, slices, masks, desc
             + [ctypes.c_int] * 2                             # S, chunks
             + [ctypes.c_void_p] * 2                          # bias, out
             + [ctypes.c_int] * 5                             # M, bytes, P, K, index bytes
             + [ctypes.c_void_p])                             # stream


def slice_format(num_classes: int) -> tuple[torch.dtype, int]:
    """(element dtype, planes) of the class-sliced layout for M classes."""
    if num_classes < 1:
        raise ValueError(f"num_classes={num_classes} < 1")
    if num_classes <= 8:
        return torch.uint8, 1
    if num_classes <= 16:
        return torch.int16, 1
    return torch.int32, -(-num_classes // 32)


def element_bits(dtype: torch.dtype) -> int:
    return {torch.uint8: 8, torch.int16: 16, torch.int32: 32}[dtype]


def shared_bytes(columns: int, num_classes: int,
                 route: str = "shared_tile") -> int:
    """Dynamic shared memory of one block (mirrors csrc/wnn.cu
    `shared_layout`): on the shared-tile route the transposed tile (a byte
    an input column, bit r = row r) and the staged window of each row;
    on both routes the tile's int32 scores of the block's classes (one
    group: at most 32·GROUP_PLANES)."""
    def up16(x):
        return (x + 15) // 16 * 16
    scores = ROWS_PER_TILE * min(num_classes, 32 * GROUP_PLANES) * 4
    if route == "global_gather":
        return scores
    slot = up16(min(columns, WINDOW)) + 16
    return up16(columns) + ROWS_PER_TILE * slot + scores


def perm_route(columns: int) -> str:
    """The kernel's route for perms that read `columns` input bits:
    `shared_tile` (uint16 indices) up to TILE_COLUMNS, else
    `global_gather` (int32 indices)."""
    return "global_gather" if columns > TILE_COLUMNS else "shared_tile"


@dataclasses.dataclass(frozen=True)
class EnsembleArgs:
    """A whole ensemble, flattened for one `wnn_ensemble_launch`."""
    perms: torch.Tensor       # per submodel (n, N_f): int16 (uint16 bit
    #                           patterns) on `shared_tile`, int32 on `global_gather`
    params: torch.Tensor      # int32, per submodel (k, n)
    slices: torch.Tensor      # per submodel (N_f, E[, P]) class words
    masks: torch.Tensor       # per submodel (N_f[, P]) mask words
    desc: torch.Tensor        # (S, len(DESC_FIELDS)) int32
    num_classes: int
    planes: int
    max_hashes: int
    chunks: int               # 32-filter chunks over all submodels
    columns: int              # 1 + the largest input index
    route: str                # `perm_route(columns)`
    slice_shapes: tuple       # per submodel, for `submodel_slices`
    mask_shapes: tuple

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in
                   (self.perms, self.params, self.slices, self.masks,
                    self.desc))

    def submodel_slices(self) -> tuple[tuple, tuple]:
        """Per submodel (class slices, mask words): views of the
        concatenated arrays, no copy."""
        def split(flat, shapes):
            parts = torch.split(flat, [math.prod(s) for s in shapes])
            return tuple(p.view(s) for p, s in zip(parts, shapes))
        return (split(self.slices, self.slice_shapes),
                split(self.masks, self.mask_shapes))


def ensemble_args(perms: Sequence[torch.Tensor], h3s: Sequence[torch.Tensor],
                  slices: Sequence[torch.Tensor],
                  masks: Sequence[torch.Tensor],
                  num_classes: int) -> EnsembleArgs:
    """Flatten per-submodel perms (N_f, n), H3 params (k, n), class slices
    (N_f, E[, P]) and mask words (N_f[, P]) for one launch, on their
    device."""
    dtype, planes = slice_format(num_classes)
    if not perms:
        raise ValueError("an ensemble needs at least one submodel")
    top = max(int(p.max()) if p.numel() else 0 for p in perms)
    low = min(int(p.min()) if p.numel() else 0 for p in perms)
    if low < 0 or top >= 2 ** 31:
        raise ValueError(f"perm indices in [{low}, {top}]: outside the "
                         "int32 input bits the kernel indexes")
    route = perm_route(top + 1)
    rows, perm_parts, param_parts, slice_parts, mask_parts = [], [], [], [], []
    offs = dict(perm=0, param=0, slice=0, mask=0, chunk=0)
    max_k = 1
    for i, (perm, h3, sl, mk) in enumerate(zip(perms, h3s, slices, masks)):
        n_f, n = perm.shape
        k = h3.shape[0]
        entries = sl.shape[1]
        if sl.dtype != dtype or mk.dtype != dtype:
            raise ValueError(f"submodel {i}: class slices are {sl.dtype}, "
                             f"masks {mk.dtype}; M={num_classes} needs "
                             f"{dtype}")
        if tuple(sl.shape[:1]) != (n_f,) or mk.shape[0] != n_f:
            raise ValueError(f"submodel {i}: slices {tuple(sl.shape)} / "
                             f"masks {tuple(mk.shape)} disagree with perm "
                             f"N_f={n_f}")
        if tuple(h3.shape) != (k, n) or not 1 <= k <= launch.MAX_HASHES:
            raise ValueError(f"submodel {i}: h3 {tuple(h3.shape)} against "
                             f"perm n={n}, k in [1, {launch.MAX_HASHES}]")
        max_k = max(max_k, k)
        rows.append([n_f, n, k, entries, offs["perm"], offs["param"],
                     offs["slice"], offs["mask"], offs["chunk"]])
        index = perm.t().reshape(-1).to(torch.int32)
        if route == "shared_tile":
            # uint16 values as int16 bit patterns: the top half wraps negative
            index = (index - ((index >> 15) << 16)).to(torch.int16)
        perm_parts.append(index)
        param_parts.append(h3.reshape(-1).to(torch.int32))
        slice_parts.append(sl.reshape(-1))
        mask_parts.append(mk.reshape(-1))
        offs["perm"] += n_f * n
        offs["param"] += k * n
        offs["slice"] += sl.numel()
        offs["mask"] += mk.numel()
        offs["chunk"] += -(-n_f // 32)
    if offs["slice"] >= 2 ** 31:
        raise ValueError("class slices past 2^31 elements")
    dev = perms[0].device
    return EnsembleArgs(
        perms=torch.cat(perm_parts).contiguous(),
        params=torch.cat(param_parts).contiguous(),
        slices=torch.cat(slice_parts).contiguous(),
        masks=torch.cat(mask_parts).contiguous(),
        desc=torch.tensor(rows, dtype=torch.int32, device=dev),
        num_classes=int(num_classes), planes=planes, max_hashes=max_k,
        chunks=offs["chunk"], columns=top + 1, route=route,
        slice_shapes=tuple(tuple(s.shape) for s in slices),
        mask_shapes=tuple(tuple(m.shape) for m in masks))


def launch_ensemble(kernel: str, bits: torch.Tensor, args: EnsembleArgs,
                    bias: torch.Tensor) -> torch.Tensor:
    """Scores (B, M) int32 of `bits` (B, row_bits) bytes {0, 1} (int8,
    uint8 or bool) through the ensemble kernel: one launch. Raises on
    anything the kernel cannot take; counts nothing (the public wrappers
    count)."""
    if bits.dtype in (torch.uint8, torch.bool):
        bits = bits.view(torch.int8)
    if bits.ndim != 2:
        raise ValueError(f"{kernel}: bits must be (B, total_bits), got "
                         f"{tuple(bits.shape)}")
    b, row_bits = bits.shape
    m = args.num_classes
    if row_bits < args.columns:
        raise ValueError(f"{kernel}: rows of {row_bits} bits, but the "
                         f"permutations read bit {args.columns - 1}")
    device = launch.check_cuda_args(
        kernel, bits=(bits, torch.int8, (b, row_bits)),
        perms=(args.perms, (torch.int16 if args.route == "shared_tile"
                            else torch.int32), tuple(args.perms.shape)),
        params=(args.params, torch.int32, tuple(args.params.shape)),
        slices=(args.slices, args.slices.dtype, tuple(args.slices.shape)),
        masks=(args.masks, args.slices.dtype, tuple(args.masks.shape)),
        desc=(args.desc, torch.int32, (args.desc.shape[0], len(DESC_FIELDS))),
        bias=(bias, torch.int32, (m,)))
    out = torch.empty((b, m), dtype=torch.int32, device=device)
    if b == 0:
        return out
    fn = build.kernel_function("wnn.cu", "wnn_ensemble_launch", _ARGTYPES)
    rc = fn(bits.data_ptr(), b, row_bits, args.columns,
            args.perms.data_ptr(), args.params.data_ptr(),
            args.slices.data_ptr(), args.masks.data_ptr(),
            args.desc.data_ptr(), args.desc.shape[0], args.chunks,
            bias.data_ptr(), out.data_ptr(), m,
            args.slices.element_size(), args.planes, args.max_hashes,
            args.perms.element_size(), launch.stream_handle(device))
    build.check_launch("wnn_ensemble_launch", rc)
    return out


def ensemble_scores(counter, bits: torch.Tensor, tables) -> torch.Tensor:
    """The served path of `packed_wnn_ensemble` and `fused_wnn_ensemble`:
    bits (B, total_bits) int8/uint8/bool {0,1} through prepared tables
    (`perms`, `h3s`, `bias`, `kernel_args`) -> scores (B, M) int32 of the
    whole ensemble, bias included. A CUDA batch is one launch, counted on
    `counter.launches`; a CPU batch runs the plain version."""
    if bits.device.type == "cpu":
        from repro_torch.kernels import ref
        slices, masks = tables.kernel_args.submodel_slices()
        return ref.wnn_ensemble_ref(bits, tables.perms, tables.h3s, slices,
                                    masks, tables.bias)
    out = launch_ensemble(counter.__name__, bits, tables.kernel_args,
                          tables.bias)
    if out.shape[0]:
        counter.launches += 1
    return out


def tuple_scores(counter, tuples: torch.Tensor, params: torch.Tensor,
                 slices: torch.Tensor, mask: torch.Tensor,
                 bias: torch.Tensor) -> torch.Tensor:
    """One submodel's (B, N_f, n) tuples through the ensemble kernel: the
    tuples are (B, N_f·n) rows and filter f reads bits f·n .. f·n + n - 1.
    One launch, counted on `counter.launches`."""
    from repro_torch.packed import layout
    b, n_f, n = tuples.shape
    perm = torch.arange(n_f * n, device=tuples.device).view(n_f, n)
    args = ensemble_args([perm], [params], [slices],
                         [layout.class_mask_words(mask)], mask.shape[0])
    out = launch_ensemble(counter.__name__, tuples.view(b, n_f * n), args,
                          bias)
    counter.launches += 1
    return out
