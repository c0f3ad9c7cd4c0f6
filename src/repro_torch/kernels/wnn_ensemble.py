"""The class-sliced lookup layout and the one WNN scoring launch behind
`packed_wnn` and `fused_wnn` (`csrc/wnn.cu`).

A submodel's Bloom filters are stored class-sliced: entry `[f, h]` of an
(N_f, E) array holds the M class bits of table entry h of filter f, so
one load answers every class (bit m = class m). The element type is the
narrowest that holds M: uint8 (M <= 8), uint16 (M <= 16), uint32
(M <= 32); above 32 classes an entry is P = ceil(M / 32) uint32 words,
(N_f, E, P). Up to 4 classes an entry is narrower than a byte: 1, 2 or 4
bits (`entry_bits`, the power of two >= M), 8 / bits entries a byte,
(N_f, E·bits/8) uint8 with entry h at bits [(h % epb)·bits, + bits) of
byte h / epb, so a rank that holds 2 classes of a class-sharded ensemble
spends 2 bits an entry, not 8. A filter's survival mask is one M-bit word
of the element type (`(N_f,)` or `(N_f, P)`), whatever the entry width. uint16 and uint32 words travel as their int16
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

The launch is the registered operator `repro_torch::wnn_ensemble`, so a
trace with fake tensors (`launch.graph_cost.trace`) records it as one
node with its (B, M) int32 output and the operations `wnn_ensemble_cost`
counts, without building or launching anything. Its body is the
`ctypes` launch and the only place a launch is counted, on the counter
of the public wrapper that asked for it (`packed_wnn` or `fused_wnn`).
"""
from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import Sequence

import torch
from torch.utils.flop_counter import register_flop_formula

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
    """(element dtype, planes) of the class-sliced layout for M classes
    (uint8 up to 8; up to 4 its bytes hold `entries_per_element`
    entries)."""
    if num_classes < 1:
        raise ValueError(f"num_classes={num_classes} < 1")
    if num_classes <= 8:
        return torch.uint8, 1
    if num_classes <= 16:
        return torch.int16, 1
    return torch.int32, -(-num_classes // 32)


def element_bits(dtype: torch.dtype) -> int:
    return {torch.uint8: 8, torch.int16: 16, torch.int32: 32}[dtype]


def entry_bits(num_classes: int) -> int:
    """Bits a class-sliced entry takes for M classes: 1, 2 or 4 (the
    power of two >= M) up to 4 classes, else the element's width."""
    if num_classes <= 4:
        return 1 if num_classes <= 1 else 2 if num_classes == 2 else 4
    dtype, _ = slice_format(num_classes)
    return element_bits(dtype)


def entries_per_element(num_classes: int) -> int:
    """Entries one slice element holds: 8 / `entry_bits` for M <= 4,
    else 1."""
    return 8 // entry_bits(num_classes) if num_classes <= 4 else 1


def pack_entries(words: torch.Tensor, num_classes: int) -> torch.Tensor:
    """Class words (N_f, E) uint8 of M <= 4 classes -> the sub-byte slices
    (N_f, ceil(E / epb)): entry h at bits [(h % epb)·bits, + bits) of
    byte h // epb (`entry_bits`); the padding entries are 0.
    Wider layouts pass through."""
    epb = entries_per_element(num_classes)
    if epb == 1:
        return words
    bits = 8 // epb
    n_f, e = words.shape
    pad = (-e) % epb
    w = torch.nn.functional.pad(words.to(torch.int32), (0, pad))
    shifts = torch.arange(epb, dtype=torch.int32, device=w.device) * bits
    return torch.sum(w.reshape(n_f, -1, epb) << shifts, dim=-1,
                     dtype=torch.int32).to(torch.uint8)


def unpack_entries(slices: torch.Tensor, num_classes: int) -> torch.Tensor:
    """The inverse of `pack_entries`: (N_f, Eb) sub-byte slices ->
    (N_f, Eb·epb) uint8 class words, padding entries included."""
    epb = entries_per_element(num_classes)
    if epb == 1:
        return slices
    bits = 8 // epb
    shifts = torch.arange(epb, dtype=torch.int32, device=slices.device) * bits
    w = (slices.to(torch.int32)[..., None] >> shifts) & ((1 << bits) - 1)
    return w.reshape(*slices.shape[:-1], -1).to(torch.uint8)


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


def instantiation_for(num_classes: int, k: int, route: str) -> str:
    """The `csrc/wnn.cu` instantiation a launch of `num_classes` classes
    and `k` hashes runs on `route`, named as `instantiation_name` names a
    ptxas report's entries: the class-word type, the planes of a class
    group (at most GROUP_PLANES), K = k on the shared tile and K = 8 (k
    at run time) on the global gather."""
    dtype, planes = slice_format(num_classes)
    word = {torch.uint8: "uint8", torch.int16: "uint16",
            torch.int32: "uint32"}[dtype]
    if num_classes <= 4:
        word = "uint8 sub-byte"
    kk = 8 if route == "global_gather" else k
    return (f"wnn_ensemble_kernel<{word}, P={min(planes, GROUP_PLANES)}, "
            f"K={kk}, {route}>")


def instantiation_name(mangled: str) -> str:
    """wnn.cu's template arguments (class-word type, planes P, hashes K,
    the global-gather route, the sub-byte layout) read off a mangled
    kernel name."""
    import re
    types = {"h": "uint8", "t": "uint16", "j": "uint32"}
    args = re.search(r"wnn_ensemble_kernelI([htj])Li(\d+)ELi(\d+)ELb([01])"
                     r"ELb([01])E", mangled)
    if not args:
        return mangled
    route = "global_gather" if args[4] == "1" else "shared_tile"
    word = types[args[1]] + (" sub-byte" if args[5] == "1" else "")
    return (f"wnn_ensemble_kernel<{word}, P={args[2]}, "
            f"K={args[3]}, {route}>")


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
    geometry: tuple = ()      # per submodel (N_f, n, k), host-side

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
                  num_classes: int, *, columns: int | None = None
                  ) -> EnsembleArgs:
    """Flatten per-submodel perms (N_f, n), H3 params (k, n), class slices
    (N_f, E[, P]) and mask words (N_f[, P]) for one launch, on their
    device.

    `columns` is the input bits the perms may read (1 + their largest
    index), where the caller knows it without reading the perms: the
    identity perm of `tuple_scores`, or a spec's `total_bits`. Without it
    the perms are read on the host and range-checked, as perms that
    arrive from a caller must be."""
    dtype, planes = slice_format(num_classes)
    if not perms:
        raise ValueError("an ensemble needs at least one submodel")
    if columns is None:
        top = max(int(p.max()) if p.numel() else 0 for p in perms)
        low = min(int(p.min()) if p.numel() else 0 for p in perms)
        if low < 0 or top >= 2 ** 31:
            raise ValueError(f"perm indices in [{low}, {top}]: outside the "
                             "int32 input bits the kernel indexes")
        columns = top + 1
    elif not 1 <= columns <= 2 ** 31:
        raise ValueError(f"columns={columns} outside [1, 2^31]")
    route = perm_route(columns)
    rows, perm_parts, param_parts, slice_parts, mask_parts = [], [], [], [], []
    offs = dict(perm=0, param=0, slice=0, mask=0, chunk=0)
    max_k = 1
    geometry = []
    epb = entries_per_element(num_classes)
    for i, (perm, h3, sl, mk) in enumerate(zip(perms, h3s, slices, masks)):
        n_f, n = perm.shape
        k = h3.shape[0]
        entries = sl.shape[1] * epb      # padded to whole elements
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
        geometry.append((n_f, n, k))
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
        chunks=offs["chunk"], columns=int(columns), route=route,
        slice_shapes=tuple(tuple(s.shape) for s in slices),
        mask_shapes=tuple(tuple(m.shape) for m in masks),
        geometry=tuple(geometry))


def wnn_ensemble_cost(batch: int, row_bits: int, geoms, m: int,
                      table_bytes: int) -> tuple[dict, dict]:
    """(bytes, integer operations) of one ensemble launch, each term
    named, counted as the kernel issues them. geoms: per submodel (N_f,
    n, k); table_bytes: the flattened launch arguments' bytes
    (`EnsembleArgs.nbytes()`). Per row: for each input bit of every
    filter one select (the gathered bit guards the fold) and the H3 fold,
    one XOR-AND a hash (a single LOP3); per filter k probes and k + 1
    ANDs (with the mask word); per 32-filter chunk a vote per class
    (ballot and popcount). Bytes: each row read once, the arguments once,
    the scores written once."""
    ops = {
        "selects": batch * sum(n_f * n for n_f, n, _ in geoms),
        "hash_fold": batch * sum(n_f * n * k for n_f, n, k in geoms),
        "probes_and_ands": batch * sum(n_f * (2 * k + 1)
                                       for n_f, _, k in geoms),
        "votes": batch * sum(-(-n_f // 32) for n_f, _, _ in geoms) * m * 2,
    }
    bytes_terms = {"rows": batch * row_bits, "tables": int(table_bytes),
                   "scores": batch * m * 4 + m * 4}
    return bytes_terms, ops


# The public wrappers whose `launches` the operator's body counts, by name.
COUNTERS: dict = {}


def register_counter(wrapper):
    """Count launches made for `wrapper` (by its __name__) on it."""
    COUNTERS[wrapper.__name__] = wrapper
    return wrapper


def launch_direct(bits: torch.Tensor, perms: torch.Tensor,
                  params: torch.Tensor, slices: torch.Tensor,
                  masks: torch.Tensor, desc: torch.Tensor,
                  bias: torch.Tensor, out: torch.Tensor, columns: int,
                  chunks: int, planes: int, max_hashes: int) -> None:
    """The `ctypes` launch of `wnn_ensemble_launch` into `out` (B, M),
    with no check and no count: the operator's body, and the yardstick
    the operator's dispatch is timed against."""
    fn = build.kernel_function("wnn.cu", "wnn_ensemble_launch", _ARGTYPES)
    rc = fn(bits.data_ptr(), bits.shape[0], bits.shape[1], columns,
            perms.data_ptr(), params.data_ptr(), slices.data_ptr(),
            masks.data_ptr(), desc.data_ptr(), desc.shape[0], chunks,
            bias.data_ptr(), out.data_ptr(), bias.shape[0],
            slices.element_size(), planes, max_hashes, perms.element_size(),
            launch.stream_handle(bits.device))
    build.check_launch("wnn_ensemble_launch", rc)


def wnn_ensemble_op(bits: torch.Tensor, perms: torch.Tensor,
                    params: torch.Tensor, slices: torch.Tensor,
                    masks: torch.Tensor, desc: torch.Tensor,
                    bias: torch.Tensor, columns: int, chunks: int,
                    planes: int, max_hashes: int, geometry: list,
                    kernel: str) -> torch.Tensor:
    """The CUDA body of `repro_torch::wnn_ensemble`: one `csrc/wnn.cu`
    launch, scores (B, M) int32 of `bits` (B, row_bits) int8 through
    flattened ensemble arguments (`EnsembleArgs`; `geometry` their
    (N_f, n, k) per submodel, flat). Counts one launch on
    `COUNTERS[kernel]`."""
    del geometry
    out = torch.empty((bits.shape[0], bias.shape[0]), dtype=torch.int32,
                      device=bits.device)
    launch_direct(bits, perms, params, slices, masks, desc, bias, out,
                  columns, chunks, planes, max_hashes)
    COUNTERS[kernel].launches += 1
    return out


# Registered through torch.library's dispatcher interface rather than
# `torch.library.custom_op`, whose Python wrapper (input checks, aliasing
# checks) added 44-97 µs of host time a call on an H100 machine
# (`chip_smoke.op_against_direct`), against 5-12 µs for this one.
_LIB = torch.library.Library("repro_torch", "FRAGMENT")
_LIB.define("wnn_ensemble(Tensor bits, Tensor perms, Tensor params, "
            "Tensor slices, Tensor masks, Tensor desc, Tensor bias, "
            "int columns, int chunks, int planes, int max_hashes, "
            "int[] geometry, str kernel) -> Tensor")
_LIB.impl("wnn_ensemble", wnn_ensemble_op, "CUDA")


@torch.library.register_fake("repro_torch::wnn_ensemble", lib=_LIB)
def _wnn_ensemble_fake(bits, perms, params, slices, masks, desc, bias,
                       columns, chunks, planes, max_hashes, geometry, kernel):
    return bits.new_empty((bits.shape[0], bias.shape[0]), dtype=torch.int32)


@register_flop_formula(torch.ops.repro_torch.wnn_ensemble)
def _wnn_ensemble_flops(bits_shape, perms_shape, params_shape, slices_shape,
                        masks_shape, desc_shape, bias_shape, columns, chunks,
                        planes, max_hashes, geometry, kernel, *,
                        out_shape=None, **kwargs) -> int:
    """The integer operations `wnn_ensemble_cost` counts (the tables'
    bytes do not enter the operation count)."""
    geoms = [tuple(geometry[i:i + 3]) for i in range(0, len(geometry), 3)]
    _, ops = wnn_ensemble_cost(bits_shape[0], bits_shape[1], geoms,
                               bias_shape[0], 0)
    return sum(ops.values())


def op_arguments(args: EnsembleArgs) -> tuple:
    """The host-side arguments of `wnn_ensemble_op` after the tensors."""
    return (args.columns, args.chunks, args.planes, args.max_hashes,
            [v for g in args.geometry for v in g])


def launch_ensemble(kernel: str, bits: torch.Tensor, args: EnsembleArgs,
                    bias: torch.Tensor) -> torch.Tensor:
    """Scores (B, M) int32 of `bits` (B, row_bits) bytes {0, 1} (int8,
    uint8 or bool) through the ensemble kernel: one launch of
    `repro_torch::wnn_ensemble`, counted on the wrapper named `kernel`.
    Raises on anything the kernel cannot take."""
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
    if b == 0:
        return torch.empty((b, m), dtype=torch.int32, device=device)
    return torch.ops.repro_torch.wnn_ensemble.default(
        bits, args.perms, args.params, args.slices, args.masks, args.desc,
        bias, *op_arguments(args), kernel)


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
    return launch_ensemble(counter.__name__, bits, tables.kernel_args,
                           tables.bias)


def tuple_scores(counter, tuples: torch.Tensor, params: torch.Tensor,
                 slices: torch.Tensor, mask: torch.Tensor,
                 bias: torch.Tensor) -> torch.Tensor:
    """One submodel's (B, N_f, n) tuples through the ensemble kernel: the
    tuples are (B, N_f·n) rows and filter f reads bits f·n .. f·n + n - 1
    (an identity perm: its reach is known, so nothing is read on the
    host). One launch, counted on `counter.launches`."""
    from repro_torch.packed import layout
    b, n_f, n = tuples.shape
    perm = torch.arange(n_f * n, device=tuples.device).view(n_f, n)
    args = ensemble_args([perm], [params], [slices],
                         [layout.class_mask_words(mask)], mask.shape[0],
                         columns=n_f * n)
    return launch_ensemble(counter.__name__, tuples.view(b, n_f * n), args,
                           bias)
