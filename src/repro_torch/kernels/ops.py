"""Public wrappers over the kernels (port of `repro/kernels/ops.py`).

Every entry point takes `device=` (default `"cuda"`) and moves its inputs
there; with no CUDA device it raises unless the caller asks for the CPU.
Kernel or plain version then follows the tensors' device, inside the
kernel wrappers: on CUDA the hand-written kernels run, on the CPU their
plain versions (`kernels/ref.py`). No path catches a failed build or
launch to run something else.
"""
from __future__ import annotations

import torch

from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.kernels import launch, ref
from repro_torch.kernels.flash_attention import \
    flash_attention as flash_attention_kernel
from repro_torch.kernels.fused_wnn import fused_wnn
from repro_torch.kernels.h3_hash import h3_hash as h3_hash_kernel
from repro_torch.kernels.packed_wnn import packed_wnn
from repro_torch.kernels.thermometer import (thermometer_decompress,
                                             thermometer_encode)
from repro_torch.packed import layout as packed_layout

WNN_BACKENDS = ("fused", "gather", "packed", "auto")

# The kernels keep the k hashes of a tuple in registers and its (k, n) H3
# parameters in shared memory; these bound both (the JAX package's bounds).
_MAX_TUPLE_BITS = launch.MAX_TUPLE_BITS
_MAX_HASHES = launch.MAX_HASHES

# packed word planes travel as uint32 or as their int32 bit patterns
_PACKED_DTYPES = (torch.uint32, torch.int32)


def resolve_wnn_backend(backend: str = "auto", *, packed_tables: bool = False,
                        device=DEFAULT_DEVICE) -> str:
    """'auto' -> 'packed' when the tables are already uint32 bitplanes
    (never pay the 32× expansion), else 'fused' on a GPU (the hand
    kernel) / 'gather' on the CPU."""
    if backend not in WNN_BACKENDS:
        raise ValueError(
            f"backend must be one of {WNN_BACKENDS}, got {backend!r}")
    if backend == "auto":
        if packed_tables:
            return "packed"
        return "fused" if torch.device(device).type == "cuda" else "gather"
    return backend


def validate_wnn_geometry(tuples, params, table, mask, bias, *,
                          entries: int | None = None) -> None:
    """Shape validation shared by every backend — the JAX package's checks
    and messages.

    `table` is either an unpacked (M, N_f, E) int8 table or a packed
    (M, N_f, W) uint32 bitplane (int32 bit patterns accepted), told apart
    by dtype; packed planes must declare `entries`, since E is not
    recoverable from the word count. `entries` must be a power of two:
    H3 XOR-composes parameter words in [0, E), which stays in range only
    then.
    """
    if tuples.ndim != 3:
        raise ValueError(
            f"tuples must be (B, N_f, n), got {tuple(tuples.shape)}")
    if params.ndim != 2 or table.ndim != 3 or mask.ndim != 2 or bias.ndim != 1:
        raise ValueError(
            "expected params (k, n), table (M, N_f, E) or packed "
            f"(M, N_f, E/32), mask (M, N_f), bias (M,); got "
            f"{tuple(params.shape)}, {tuple(table.shape)}, "
            f"{tuple(mask.shape)}, {tuple(bias.shape)}")
    _, n_f, n = tuples.shape
    k, n_p = params.shape
    m, n_f_t, last = table.shape
    if table.dtype in _PACKED_DTYPES:
        if entries is None:
            raise ValueError(
                "packed uint32 tables must declare entries= (the word "
                "count alone does not determine E)")
        packed_layout.validate_packed_geometry(table, entries)
    else:
        if entries is not None and entries != last:
            raise ValueError(f"entries={entries} != table E={last}")
        if last & (last - 1) or last == 0:
            raise ValueError(
                f"entries={last} must be a power of two (H3 range closure)")
    if n_p != n:
        raise ValueError(f"params n={n_p} != tuples n={n}")
    if n_f_t != n_f:
        raise ValueError(f"table N_f={n_f_t} != tuples N_f={n_f}")
    if tuple(mask.shape) != (m, n_f):
        raise ValueError(f"mask {tuple(mask.shape)} != (M, N_f)=({m}, {n_f})")
    if tuple(bias.shape) != (m,):
        raise ValueError(f"bias {tuple(bias.shape)} != (M,)=({m},)")
    if n > _MAX_TUPLE_BITS:
        raise ValueError(f"n={n} exceeds the kernel unroll bound "
                         f"{_MAX_TUPLE_BITS}")
    if not 1 <= k <= _MAX_HASHES:
        raise ValueError(f"k={k} outside [1, {_MAX_HASHES}]")


def _as(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return t.to(dtype).contiguous()


def wnn_scores(tuples, params, table, mask, bias, *, backend: str = "auto",
               entries: int | None = None, device=DEFAULT_DEVICE):
    """One submodel's scores (B, M) int32, backend-dispatched.

    tuples: (B, N_f, n) int8 {0,1}; params: (k, n) int32; table:
    (M, N_f, E) int8 {0,1} or packed (M, N_f, W) uint32 bitplanes
    (dtype-dispatched; packed input requires `entries=`); mask: (M, N_f);
    bias: (M,) int32.

    backend="fused"  — the int8-table kernel (`fused_wnn`);
    backend="gather" — the plain gather formulation (`ref.fused_wnn_ref`);
    backend="packed" — the bitplane kernel (`packed_wnn`); int8 tables are
                       packed on the fly (a test convenience — serving
                       packs once, see `repro_torch.packed`);
    backend="auto"   — packed when the tables arrive packed, otherwise
                       fused on a GPU and gather on the CPU.

    On the CPU the kernel wrappers run their plain versions. All backends
    are exactly score-equal (int32).
    """
    dev = resolve_device(device)
    tuples, params, table, mask, bias = (
        torch.as_tensor(t).to(dev) for t in (tuples, params, table, mask, bias))
    packed_in = table.dtype in _PACKED_DTYPES
    validate_wnn_geometry(tuples, params, table, mask, bias, entries=entries)
    resolved = resolve_wnn_backend(backend, packed_tables=packed_in,
                                   device=dev)
    tuples = _as(tuples, torch.int8)
    params = _as(params, torch.int32)
    # survive iff nonzero (core/bloom.py::apply_mask): the kernels test
    # mask != 0 themselves, so only a non-int8 mask needs converting
    mask = mask.contiguous() if mask.dtype == torch.int8 else \
        (mask != 0).to(torch.int8)
    bias = _as(bias, torch.int32)
    if resolved == "packed":
        words = ref.as_int32_words(table) if packed_in else \
            packed_layout.pack_words(table)
        return packed_wnn(tuples, params, words.contiguous(), mask, bias)
    if packed_in:
        raise ValueError(
            f"backend={resolved!r} needs unpacked (M, N_f, E) int8 tables "
            "but got uint32 bitplanes — use backend='packed'/'auto', or "
            "down-convert explicitly via repro_torch.packed.layout."
            "unpack_words")
    table = _as(table, torch.int8)
    if resolved == "fused":
        return fused_wnn(tuples, params, table, mask, bias)
    return ref.fused_wnn_ref(tuples, params, table, mask, bias)


_INT_DTYPES = (torch.uint8, torch.int8, torch.int16, torch.int32,
               torch.int64)


def validate_tenant_geometry(bits, tids, perms, params, words, mask, *,
                             entries: int) -> None:
    """Validation for the tenant-indexed packed entry (the JAX package's
    checks and messages): every per-tenant leaf carries the same leading
    T, tenant 0's slice is a legal packed geometry, and the batch and tid
    shapes agree."""
    if bits.ndim != 2:
        raise ValueError(
            f"bits must be (B, total_bits), got {tuple(bits.shape)}")
    if tids.ndim != 1 or tids.shape[0] != bits.shape[0]:
        raise ValueError(
            f"tids must be (B,)=({bits.shape[0]},), got {tuple(tids.shape)}")
    if tids.dtype not in _INT_DTYPES:
        raise ValueError(f"tids must be integer, got {tids.dtype}")
    if words.ndim != 4:
        raise ValueError(f"stacked words must be (T, M, N_f, W), "
                         f"got {tuple(words.shape)}")
    t = words.shape[0]
    for name, leaf, nd in (("perms", perms, 3), ("params", params, 3),
                           ("mask", mask, 3)):
        if leaf.ndim != nd or leaf.shape[0] != t:
            raise ValueError(
                f"stacked {name} must have leading T={t} and {nd} dims, "
                f"got {tuple(leaf.shape)}")
    # tenant 0's slice must be a legal single-tenant geometry; the leaves
    # are uniform along T, so one check covers every tenant
    n_f, n = perms.shape[1], perms.shape[2]

    def meta(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    validate_wnn_geometry(
        meta((bits.shape[0], n_f, n), torch.int8),
        meta(params.shape[1:], torch.int32), meta(words.shape[1:], words.dtype),
        meta(mask.shape[1:], mask.dtype), meta((words.shape[1],), torch.int32),
        entries=entries)


def wnn_scores_tenant(bits, tids, perms, params, words, mask, *,
                      backend: str = "auto", entries: int = 0,
                      device=DEFAULT_DEVICE) -> torch.Tensor:
    """One submodel's tenant-indexed scores (B, M) int32 on `device`.

    bits: (B, total_bits) {0,1}; tids: (B,) tenant index per row; perms:
    (T, N_f, n); params: (T, k, n) int32; words: (T, M, N_f, W) uint32
    bitplanes (or their int32 bit patterns); mask: (T, M, N_f) int8.
    Returns the partial scores WITHOUT bias (the caller adds each
    tenant's).

    Packed-domain only: backend must be "packed" or "auto" (the int8
    backends would need T copies of the 32x expansion). Both run the
    row-gather formulation (`ref.packed_wnn_tenant_ref`) as tensor code on
    every device, as the JAX package does on every platform: it has no
    Pallas tenant kernel.
    """
    if backend not in ("packed", "auto"):
        raise ValueError(
            f"wnn_scores_tenant serves the packed domain only (backend="
            f"'packed'|'auto', got {backend!r}); stacked fleets never "
            "materialize int8 tables")
    dev = resolve_device(device)
    bits, tids, perms, params, words, mask = (
        torch.as_tensor(x).to(dev)
        for x in (bits, tids, perms, params, words, mask))
    validate_tenant_geometry(bits, tids, perms, params, words, mask,
                             entries=entries)
    return ref.packed_wnn_tenant_ref(bits, tids, perms, params, words, mask)


def wnn_infer(tuples, params, table, mask, bias, *, use_kernel: bool = False,
              device=DEFAULT_DEVICE) -> torch.Tensor:
    """One submodel's WNN scores (B, M) int32: the legacy wrapper over
    `wnn_scores`. use_kernel=True forces the fused backend; otherwise
    "auto" applies (the kernel on a GPU, its plain version on the CPU)."""
    return wnn_scores(tuples, params, table, mask, bias,
                      backend="fused" if use_kernel else "auto",
                      device=device)


def h3_hash(tuples, params, *, device=DEFAULT_DEVICE) -> torch.Tensor:
    """tuples: (B, N_f, n) {0,1}; params: (k, n) -> H3 hashes (B, N_f, k)
    int32 via the hash kernel (plain version on the CPU)."""
    dev = resolve_device(device)
    return h3_hash_kernel(_as(torch.as_tensor(tuples).to(dev), torch.int8),
                          _as(torch.as_tensor(params).to(dev), torch.int32))


def ensemble_predict(scores: torch.Tensor):
    """(B, M) score matrix -> (scores, argmax predictions (B,) int32).
    Ties go to the first class, as `jnp.argmax` does."""
    return scores, torch.argmax(scores, dim=-1).to(torch.int32)


def thermometer(x, thresholds, *, device=DEFAULT_DEVICE) -> torch.Tensor:
    """x: (B, F) float; thresholds: (F, T) -> bits (B, F, T) int8 via the
    thermometer kernel (plain version on the CPU). Both are compared in
    float32, as the JAX package does: float64 thresholds would move `>` at
    the edges."""
    dev = resolve_device(device)
    return thermometer_encode(_as(torch.as_tensor(x).to(dev), torch.float32),
                              _as(torch.as_tensor(thresholds).to(dev),
                                  torch.float32))


def decompress(counts, bits: int, *, device=DEFAULT_DEVICE) -> torch.Tensor:
    """counts: (B, F) per-feature set-bit counts -> bits (B, F, T) int8 via
    the decompression kernel (plain version on the CPU)."""
    dev = resolve_device(device)
    return thermometer_decompress(
        _as(torch.as_tensor(counts).to(dev), torch.uint8), bits)


class FlashAttention(torch.autograd.Function):
    """`flash_attention` with a gradient. Forward: the flash kernel on
    CUDA tensors, `ref.attention_ref` on CPU tensors. Backward: the plain
    version on either device (`ref.attention_backward_ref`, autograd
    through `attention_ref` recomputed a block of query rows at a time),
    as the JAX package has no backward kernel either: it differentiates
    XLA's chunked attention, and its Pallas flash kernel has no VJP."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale, q_offset):
        ctx.save_for_backward(q, k, v)
        ctx.kw = dict(causal=causal, window=window, scale=scale,
                      q_offset=q_offset)
        return flash_attention_kernel(q, k, v, **ctx.kw)

    @staticmethod
    def backward(ctx, dout):
        q, k, v = ctx.saved_tensors
        dq, dk, dv = ref.attention_backward_ref(q, k, v, dout, **ctx.kw)
        return dq, dk, dv, None, None, None, None


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    scale: float | None = None,
                    q_offset: int = 0) -> torch.Tensor:
    """q: (B, H, Sq, D); k: (B, Hkv, Sk, D), v: (B, Hkv, Sk, Dv) ->
    (B, H, Sq, Dv).

    The JAX package repeats KV heads here and calls the TPU kernel on
    (B·H, S, D) blocks; the port's kernel reads each query head's KV head
    in place, so this only dispatches: the flash kernel on CUDA tensors,
    its plain version (`ref.attention_ref`) on CPU tensors, through
    `FlashAttention`, whose backward is the plain version. It takes no
    `device=`: the model calls it on activations that already lie on the
    device the caller chose."""
    return FlashAttention.apply(q, k, v, causal, window, scale, q_offset)
