"""Prefill attention of the LM zoo (port of
`repro/kernels/flash_attention.py::flash_attention_tiled` together with the
GQA head repetition of `repro/kernels/ops.py::flash_attention`).

On CUDA tensors `flash_attention` launches the hand-written Hopper kernels
in `csrc/flash_attention.cu`, one route per type, both on the tensor cores
since the multiply-adds bound attention at prefill shapes:

* bf16 (`wgmma_bf16`): a producer warpgroup stages Q once and K and V
  tiles through a two-stage ring with TMA and mbarriers; one or two
  consumer warpgroups of 64 query rows run S = Q K^T and O += P V with
  `wgmma`, the running softmax on the accumulator registers and P kept in
  registers as bf16. Bound: 989 TFLOP/s.
* float32 (`mma_3xtf32`): warps of 16 query rows run both products as
  three TF32 `mma.sync` products of each operand's big and small halves,
  which keeps float32 accuracy; K and V tiles are double-buffered with
  cp.async. Bound: a third of the 495 TFLOP/s TF32 rate, 165 TFLOP/s.

Both keep the streaming softmax in float32, read KV head `h // (H // Hkv)`
in place (GQA without a repeated copy), skip key tiles wholly hidden by the
causal or window mask and mask only the tiles that cross an edge. On CPU
tensors it runs the plain version `ref.attention_ref`. A CUDA tensor
launches a kernel or raises: there is no fallback.

The host-side plan lives here as plain functions: `plan` picks the tiles
per (D, type, Sq) and states the shared-memory and register budget each
block needs; `tensor_map` gives the TMA tensor map (dims, byte strides,
box, swizzle) of a bf16 operand and raises `ValueError` on strides or
alignments TMA cannot take; `check_cp_async` does the same for the float32
route's 16-byte copies.

Layout: the kernels read q, k and v through their (batch, head, row)
strides and need only the head dimension contiguous, so the model's
transposed (B, S, H, hd) -> (B, H, S, hd) views enter without a copy. The
output is written into a (B, Sq, H, D) buffer and returned as its
(B, H, Sq, D) transposed view: the model's output projection reads that
buffer as it lies. So a prefill layer makes no copy for attention.

Head dims: q and k are D wide, v and the output Dv. Both routes take
D = Dv in `HEAD_DIMS` and (D, Dv) = (192, 128), DeepSeek MLA's prefill
(128 + 64 rotary query and key columns over 128-wide values): the float32
route in 32-key tiles, the bf16 route in 64-key tiles with Q and K as
three 64-column panels, V as two under a tensor map of its own width.
Nothing pads a head dim; any other pair raises a ValueError.

Rows with no visible key (only with `window > 0` and
`Sq + q_offset >= Sk + window`) raise here: the plain version averages all
Sk keys uniformly on such rows, which the kernels do not reproduce.

The launch is the registered operator `repro_torch::flash_attention`
(`Library.define/impl`, as `repro_torch::wnn_ensemble`): a trace with
fake tensors records it as one node with its (B, Sq, H, Dv) output and
2·(D + Dv) operations a visible (query, key) pair (`visible_pairs`),
without building or launching anything. Its body is the `ctypes` launch
and the only place a launch is counted.
"""
from __future__ import annotations

import collections
import ctypes
import dataclasses
import functools

import torch

from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import build, launch, ref

HEAD_DIMS = (16, 32, 64, 128, 256)
# (D, Dv) pairs with Dv != D, per route (csrc: dispatch)
UNEQUAL_HEAD_DIMS = {torch.float32: ((192, 128),),
                     torch.bfloat16: ((192, 128),)}
ROUTES = {torch.float32: "mma_3xtf32", torch.bfloat16: "wgmma_bf16"}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
             + [ctypes.c_longlong] * 12
             + [ctypes.c_float] + [ctypes.c_int] * 5 + [ctypes.c_void_p])

# Hopper (sm_90) limits the plan is checked against
H100_SMS = 132
SMEM_PER_BLOCK = 232_448       # dynamic shared memory a block may opt in to
SMEM_PER_SM = 233_472          # 228 KB an SM, 1 KB of it reserved per block
SMEM_RESERVED_PER_BLOCK = 1024
REGS_PER_SM = 65_536
MAX_REGS_PER_THREAD = 255
TMA_MAX_BOX = 256
TMA_MAX_STRIDE = 2 ** 40


@dataclasses.dataclass(frozen=True)
class FlashPlan:
    """One launch of a route: tiles, block shape and the budget it claims.
    `regs` lists (threads, registers per thread) of the block's roles: the
    launch bound for `mma_3xtf32`; for `wgmma_bf16` the consumer and
    producer warpgroups' `setmaxnreg` counts with two consumers, the launch
    bound with one."""
    route: str
    d: int                     # q and k head dim
    dv: int                    # v and output head dim
    block_q: int               # query rows a block
    block_k: int               # keys a staged K or V tile
    stages: int                # K/V tiles in flight
    threads: int
    smem_bytes: int
    regs: tuple
    grid: tuple                # (H, B, query tiles)

    @property
    def regs_per_block(self) -> int:
        # registers are allocated per warp in units of 8 a thread
        return sum(n * (-(-r // 8) * 8) for n, r in self.regs)

    @property
    def blocks_per_sm(self) -> int:
        by_smem = SMEM_PER_SM // (self.smem_bytes + SMEM_RESERVED_PER_BLOCK)
        return min(by_smem, REGS_PER_SM // self.regs_per_block)

    @property
    def blocks(self) -> int:
        h, b, n = self.grid
        return h * b * n


def f32_tiles(d: int, dv: int | None = None) -> tuple:
    """(block_k, most warps a block, blocks an SM the launch bound asks
    for) of the float32 route (csrc: F32Tile); (192, 128) takes 32-key
    tiles so that Q and the K and V ring fit a block's shared memory."""
    dv = d if dv is None else dv
    block_k = 32 if dv != d else (64 if d <= 128 else 16)
    return block_k, (8 if d >= 128 else 4), (1 if d >= 128 else 2)


def check_head_dims(dtype: torch.dtype, d: int, dv: int) -> None:
    """Raise ValueError unless the route of `dtype` instantiates (D, Dv)."""
    if d == dv and d in HEAD_DIMS:
        return
    if (d, dv) in UNEQUAL_HEAD_DIMS.get(dtype, ()):
        return
    if d == dv:
        raise ValueError(f"flash_attention: head dim {d} not in {HEAD_DIMS}")
    route = ROUTES.get(dtype, str(dtype))
    raise ValueError(
        f"flash_attention: the {route} route does not take (D_qk, D_v) = "
        f"({d}, {dv}); unequal pairs: "
        f"{ {ROUTES[t]: p for t, p in UNEQUAL_HEAD_DIMS.items()} }")


def bf16_tiles(d: int, dv: int | None = None) -> tuple:
    """(block_k, most consumer warpgroups) of the bf16 route (csrc:
    Bf16Tile): 128-key tiles and two consumers up to D = 128; D = 256 takes
    64-key tiles and one consumer to fit O's 128 accumulator registers;
    (D, Dv) = (192, 128) 64-key tiles and two consumers, so that Q and two
    stages of K and V take 128 KB."""
    dv = d if dv is None else dv
    if d == 256:
        return 64, 1
    return (64, 2) if dv != d else (128, 2)


@functools.lru_cache(maxsize=1024)
def plan(dtype: torch.dtype, d: int, *, batch: int, heads: int, sq: int,
         n_sms: int = H100_SMS, dv: int | None = None) -> FlashPlan:
    """The launch of `flash_attention` for these shapes (memoised: a
    prefill asks once per layer). Short prompts (the Engine's batch-1
    prefills) take smaller query tiles so that more of the card works:
    float32 the most warps whose grid reaches at least half the SMs (at
    D = 128 the key ring fills an SM's shared memory, so fewer warps a
    block do not bring more blocks an SM), bf16 two consumer warpgroups
    only where the grid reaches every SM. `dv` is v's head dim (D when
    None)."""
    dv = d if dv is None else dv
    if dtype not in ROUTES:
        raise TypeError(f"flash_attention: q must be float32 or bfloat16, "
                        f"got {dtype}")
    check_head_dims(dtype, d, dv)

    def tiles(rows):
        return batch * heads * -(-sq // rows)

    if dtype == torch.float32:
        block_k, max_warps, min_blocks = f32_tiles(d, dv)
        warps = max_warps
        while warps > 1 and 2 * tiles(16 * warps) < n_sms:
            warps //= 2
        block_q, stages = 16 * warps, 2
        smem = (block_q * (d + 4) + stages * block_k * (d + 4 + dv + 4)) * 4
        regs_cap = min(MAX_REGS_PER_THREAD,
                       REGS_PER_SM // (32 * max_warps * min_blocks))
        return FlashPlan(ROUTES[dtype], d, dv, block_q, block_k, stages,
                         32 * warps, smem, ((32 * warps, regs_cap),),
                         (heads, batch, -(-sq // block_q)))
    if dtype == torch.bfloat16:
        block_k, consumers = bf16_tiles(d, dv)
        if consumers == 2 and tiles(128) < n_sms:
            consumers = 1
        block_q, stages = 64 * consumers, 2
        smem = (1024 + block_q * d * 2 + stages * block_k * (d + dv) * 2
                + 8 * (1 + 2 * stages))
        # two consumers: setmaxnreg moves registers from the producer's 24
        # to the consumers' 240; one: the launch bound leaves 255 to all
        regs = (((256, 240), (128, 24)) if consumers == 2
                else ((128, MAX_REGS_PER_THREAD), (128, MAX_REGS_PER_THREAD)))
        return FlashPlan(ROUTES[dtype], d, dv, block_q, block_k, stages,
                         128 * (consumers + 1), smem, regs,
                         (heads, batch, -(-sq // block_q)))
    raise AssertionError(dtype)


@dataclasses.dataclass(frozen=True)
class TensorMap:
    """A TMA tensor map of a (B, H, S, D) bf16 operand as the C side
    encodes it: dims and box innermost first, byte strides of dims 1-3."""
    dims: tuple                # (D, S, H, B)
    strides: tuple             # bytes, (S, H, B)
    box: tuple                 # (panel columns, rows, 1, 1)
    swizzle: int               # bytes: 32, 64 or 128 (the panel's row)


def kernel_strides(t: torch.Tensor) -> tuple:
    """(batch, head, row) element strides of a (B, H, S, D) operand as the
    kernels take them. A dimension of extent 1 is never stepped, and
    PyTorch may give it any stride; it gets S·H·D, which TMA accepts."""
    b, h, s, d = t.shape
    return tuple(st if n > 1 else s * h * d
                 for n, st in zip((b, h, s), t.stride()[:3]))


def tensor_map(t: torch.Tensor, box_rows: int,
               strides: tuple | None = None) -> TensorMap:
    """The map of `t` (B, H, S, D) bf16 in boxes of `box_rows` rows
    (`strides`: its `kernel_strides`, when the caller has them); raises
    ValueError naming the TMA rule a layout breaks: the head dimension
    contiguous, a 16-byte aligned base, strides that are multiples of 16
    bytes and below 2^40, at most 256 rows a box."""
    b, h, s, d = t.shape
    esize = t.element_size()
    if t.stride(-1) != 1:
        raise ValueError("flash_attention: the head dimension must be "
                         "contiguous")
    if t.data_ptr() % 16:
        raise ValueError("flash_attention: TMA needs a 16-byte aligned base "
                         f"address, got {t.data_ptr():#x}")
    sb, sh, ss = strides or kernel_strides(t)
    strides = (ss * esize, sh * esize, sb * esize)
    for name, st in zip(("row", "head", "batch"), strides):
        if st % 16 or not 0 < st < TMA_MAX_STRIDE:
            raise ValueError(
                f"flash_attention: TMA needs the {name} stride to be a "
                f"positive multiple of 16 bytes below 2^40, got {st} bytes")
    if not 1 <= box_rows <= TMA_MAX_BOX:
        raise ValueError(f"flash_attention: a TMA box has 1-256 rows, not "
                         f"{box_rows}")
    cols = min(d, 64)
    return TensorMap((d, s, h, b), strides, (cols, box_rows, 1, 1),
                     cols * esize)


def check_cp_async(t: torch.Tensor, strides: tuple | None = None) -> None:
    """The float32 route copies rows in 16-byte pieces: a 16-byte aligned
    base and (batch, head, row) strides in multiples of 4 floats."""
    if t.data_ptr() % 16:
        raise ValueError("flash_attention: the float32 route needs a "
                         f"16-byte aligned base address, got "
                         f"{t.data_ptr():#x}")
    if t.stride(-1) != 1 or any(st % 4
                                for st in strides or kernel_strides(t)):
        raise ValueError("flash_attention: the float32 route needs the head "
                         "dimension contiguous and strides in multiples of "
                         f"16 bytes, got {tuple(t.stride())} elements")


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def has_empty_rows(sq: int, sk: int, *, window: int, q_offset: int) -> bool:
    """True when some query row sees no key: with a window, row i sees
    keys j > i + q_offset - window, none of which exist once
    i + q_offset >= Sk + window - 1."""
    return sk < 1 or (window > 0 and sq + q_offset >= sk + window)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    scale: float | None = None,
                    q_offset: int = 0) -> torch.Tensor:
    """q: (B, H, Sq, D); k: (B, Hkv, Sk, D); v: (B, Hkv, Sk, Dv), H a
    multiple of Hkv -> (B, H, Sq, Dv) in q's dtype. Float32 or bf16
    inputs; (D, Dv) as the route takes them (`check_head_dims`); `scale`
    defaults to 1/sqrt(D); query row i sits at position i + q_offset."""
    if q.device.type == "cpu":
        return ref.attention_ref(q, k, v, causal=causal, window=window,
                                 scale=scale, q_offset=q_offset)
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError(f"flash_attention: expected q (B, H, Sq, D) and k, v "
                         f"(B, Hkv, Sk, D), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, h, sq, d = q.shape
    hkv, sk, dv = k.shape[1], k.shape[2], v.shape[3]
    if q.dtype not in _DTYPES:
        raise TypeError(f"flash_attention: q must be float32 or bfloat16, "
                        f"got {q.dtype}")
    check_head_dims(q.dtype, d, dv)
    if hkv < 1 or h % hkv:
        raise ValueError(f"flash_attention: {h} query heads are not a "
                         f"multiple of {hkv} KV heads")
    if window < 0 or q_offset < 0:
        raise ValueError(f"flash_attention: window={window} and "
                         f"q_offset={q_offset} must be >= 0")
    if has_empty_rows(sq, sk, window=window, q_offset=q_offset):
        raise ValueError(
            f"flash_attention: Sq={sq}, Sk={sk}, window={window}, "
            f"q_offset={q_offset} leaves query rows with no visible key")
    device = launch.check_cuda_args(
        "flash_attention", contiguous=False, q=(q, q.dtype, (b, h, sq, d)),
        k=(k, q.dtype, (b, hkv, sk, d)), v=(v, q.dtype, (b, hkv, sk, dv)))
    del device
    scale = float(d ** -0.5 if scale is None else scale)
    return torch.ops.repro_torch.flash_attention.default(
        q, k, v, bool(causal), int(window), scale, int(q_offset)
    ).transpose(1, 2)


def launch_direct(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  out: torch.Tensor, causal: bool, window: int, scale: float,
                  q_offset: int) -> None:
    """The `ctypes` launch of `flash_attention_launch` into `out`
    (B, Sq, H, Dv), its plan and layout checks, with no count: the
    operator's body, and the yardstick it is timed against."""
    b, h, sq, d = q.shape
    hkv, sk, dv = k.shape[1], k.shape[2], v.shape[3]
    p = plan(q.dtype, d, batch=b, heads=h, sq=sq,
             n_sms=_sm_count(q.device.index), dv=dv)
    strides = [kernel_strides(t) for t in (q, k, v)]
    if q.dtype == torch.bfloat16:
        for t, st, rows in zip((q, k, v), strides,
                               (p.block_q, p.block_k, p.block_k)):
            tensor_map(t, rows, st)
    else:
        for t, st in zip((q, k, v), strides):
            check_cp_async(t, st)
    fn = build.kernel_function("flash_attention.cu", "flash_attention_launch",
                               _ARGTYPES)
    out_strides = (sq * h * dv, dv, h * dv)  # (B, Sq, H, Dv) as (b, h, s)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _DTYPES[q.dtype], b, h, hkv, sq, sk, d, dv, *strides[0],
            *strides[1],
            *strides[2], *out_strides, scale, int(bool(causal)), int(window),
            int(q_offset), p.block_q, p.block_k,
            launch.stream_handle(q.device))
    build.check_launch("flash_attention_launch", rc)


def flash_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       causal: bool, window: int, scale: float,
                       q_offset: int) -> torch.Tensor:
    """The CUDA body of `repro_torch::flash_attention`: one
    `csrc/flash_attention.cu` launch into a new (B, Sq, H, Dv) tensor.
    Counts one launch, and one under its shape."""
    b, h, sq, d = q.shape
    hkv, sk, dv = k.shape[1], k.shape[2], v.shape[3]
    out = torch.empty((b, sq, h, dv), dtype=q.dtype, device=q.device)
    if sq and b:
        launch_direct(q, k, v, out, causal, window, scale, q_offset)
        flash_attention.launches += 1
        flash_attention.shapes[(b, h, hkv, sq, sk, d, dv, bool(causal),
                                int(window), int(q_offset))] += 1
    return out


def visible_pairs(sq: int, sk: int, causal: bool, window: int,
                  q_offset: int = 0) -> int:
    """(query, key) pairs the mask leaves visible for one (batch, head):
    row i at position p = i + q_offset sees keys j <= p (causal) and
    j > p - window (window > 0), of the Sk keys."""
    if not causal:
        return sq * sk
    total = 0
    for i in range(sq):
        p = i + q_offset
        hi = min(p, sk - 1)
        lo = max(0, p - window + 1) if window > 0 else 0
        total += max(0, hi - lo + 1)
    return total


_LIB = torch.library.Library("repro_torch", "FRAGMENT")
_LIB.define("flash_attention(Tensor q, Tensor k, Tensor v, bool causal, "
            "int window, float scale, int q_offset) -> Tensor")
_LIB.impl("flash_attention", flash_attention_op, "CUDA")


@torch.library.register_fake("repro_torch::flash_attention", lib=_LIB)
def _flash_attention_fake(q, k, v, causal, window, scale, q_offset):
    b, h, sq, _ = q.shape
    return q.new_empty((b, sq, h, v.shape[3]))


@register_flop_formula(torch.ops.repro_torch.flash_attention)
def _flash_attention_flops(q_shape, k_shape, v_shape, causal, window, scale,
                           q_offset, *, out_shape=None, **kwargs) -> int:
    """2·(D + Dv) operations a visible (query, key) pair and head: the
    two products' multiply-adds, as `PERF.md`'s flash bound counts them."""
    b, h, sq, d = q_shape
    sk, dv = k_shape[2], v_shape[3]
    return 2 * (d + dv) * b * h * visible_pairs(sq, sk, causal, window,
                                                q_offset)


flash_attention.launches = 0
# launches by (B, H, Hkv, Sq, Sk, D, Dv, causal, window, q_offset)
flash_attention.shapes = collections.Counter()
