"""The ULEEN model: an additive ensemble of Bloom-filter WiSARD submodels
(port of `repro/core/model.py`).

Specs are static config; `SubmodelStatic` holds the frozen random
structures (input permutation + H3 parameters); `UleenParams` holds the
learnable state (continuous tables + per-class bias + pruning masks) as
plain tensors, passed in and returned by the training functions the way
the JAX package passes its pytree. Random draws take an explicit
`torch.Generator` where the JAX package takes a PRNG key; the two give
different numbers from one seed, so the tests hand both packages the same
numpy-drawn state (`repro_torch.convert`).

Shapes use the paper's names: M classes, N_f filters per discriminator, n
inputs per filter, E entries per filter, k hash functions.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional, Sequence

import torch

from repro_torch.core import bloom, hashing
from repro_torch.device import DEFAULT_DEVICE, resolve_device


@dataclasses.dataclass(frozen=True)
class SubmodelSpec:
    inputs_per_filter: int          # n
    log2_entries: int               # E = 2**log2_entries
    num_hashes: int = 2             # k (paper: 2 everywhere)

    @property
    def entries(self) -> int:
        return 2 ** self.log2_entries


@dataclasses.dataclass(frozen=True)
class UleenSpec:
    num_classes: int                # M
    total_bits: int                 # encoded input width (F * T)
    submodels: tuple[SubmodelSpec, ...]
    bits_per_input: int = 1         # T (bookkeeping for size/IO accounting)
    dropout: float = 0.5
    # One dropout mask per (sample, filter), shared across the M class
    # discriminators, instead of one per (sample, class, filter).
    dropout_shared_classes: bool = False
    # Gather and score in bf16 (float32 Adam masters untouched; scores
    # accumulate in float32). {0,1} responses and the sign test are exact
    # in bf16.
    bf16_tables: bool = False

    def num_filters(self, sm: SubmodelSpec) -> int:
        return math.ceil(self.total_bits / sm.inputs_per_filter)

    def size_kib(self, masks: Optional[Sequence[torch.Tensor]] = None) -> float:
        """Inference model size: surviving filters x entries, 1 bit each."""
        total_bits = 0.0
        for i, sm in enumerate(self.submodels):
            if masks is not None:
                surviving = float(torch.count_nonzero(masks[i]))
            else:
                surviving = self.num_classes * self.num_filters(sm)
            total_bits += surviving * sm.entries
        return total_bits / 8.0 / 1024.0


class SubmodelStatic(NamedTuple):
    perm: torch.Tensor   # (N_f, n) int32 indices into [0, total_bits)
    h3: torch.Tensor     # (k, n) hash parameters in [0, E), int32


class UleenParams(NamedTuple):
    tables: tuple        # each (M, N_f, E) float32 (continuous)
    bias: torch.Tensor   # (M,) float32
    masks: tuple         # each (M, N_f) float32 in {0,1}; never trained


def init_static(generator: torch.Generator, spec: UleenSpec, *,
                device=DEFAULT_DEVICE) -> list:
    """Frozen random structures: input reordering + H3 parameters, drawn
    from `generator` on its own device and placed on `device`. When
    N_f·n > total_bits the permutation is padded by resampling (classic
    WiSARD wrap)."""
    dev = resolve_device(device)
    gdev = generator.device
    statics = []
    for sm in spec.submodels:
        n_f = spec.num_filters(sm)
        flat = n_f * sm.inputs_per_filter
        perm = torch.randperm(spec.total_bits, generator=generator,
                              device=gdev)
        if flat > spec.total_bits:
            extra = torch.randint(0, spec.total_bits,
                                  (flat - spec.total_bits,),
                                  generator=generator, device=gdev)
            perm = torch.cat([perm, extra])
        perm = perm[:flat].reshape(n_f, sm.inputs_per_filter)
        h3 = hashing.make_h3_params(generator, sm.num_hashes,
                                    sm.inputs_per_filter, sm.log2_entries)
        statics.append(SubmodelStatic(perm=perm.to(dev, torch.int32),
                                      h3=h3.to(dev)))
    return statics


def init_params(generator: torch.Generator, spec: UleenSpec,
                init_scale: float = 1.0, *,
                device=DEFAULT_DEVICE) -> UleenParams:
    """Tables start as *nearly empty* Bloom filters: U(-init_scale,
    0.1·init_scale), about 91 % of entries negative, as in the JAX
    package (a symmetric init would fire unseen entries at random). Drawn
    from `generator` on its own device and placed on `device`."""
    dev = resolve_device(device)
    tables, masks = [], []
    for sm in spec.submodels:
        n_f = spec.num_filters(sm)
        u = torch.rand((spec.num_classes, n_f, sm.entries),
                       generator=generator, device=generator.device)
        tables.append((-init_scale + 1.1 * init_scale * u).to(dev))
        masks.append(torch.ones((spec.num_classes, n_f), dtype=torch.float32,
                                device=dev))
    return UleenParams(tables=tuple(tables),
                       bias=torch.zeros(spec.num_classes, dtype=torch.float32,
                                        device=dev),
                       masks=tuple(masks))


def compute_hashes(spec: UleenSpec, statics: Sequence[SubmodelStatic], bits,
                   *, hash_family: str = "h3",
                   device=DEFAULT_DEVICE) -> tuple:
    """bits: (B, total_bits) {0,1} -> per-submodel hashes (B, N_f, k)
    int32 on `device`.

    Hashes depend only on the input, never on learnable state: compute
    once, outside the gradient tape. The H3 family goes through
    `kernels.ops.h3_hash` (the hash kernel on a GPU).
    """
    from repro_torch.kernels import ops
    dev = resolve_device(device)
    bits = torch.as_tensor(bits).to(dev).to(torch.int8)
    out = []
    for sm, st in zip(spec.submodels, statics):
        tuples = bits[:, st.perm.to(dev).long()]           # (B, N_f, n)
        if hash_family == "h3":
            out.append(ops.h3_hash(tuples, st.h3, device=dev))
        elif hash_family == "murmur":                      # Bloom WiSARD
            out.append(hashing.murmur_double_hash(tuples, sm.num_hashes,
                                                  sm.entries))
        elif hash_family == "identity":
            # true RAM node (classic WiSARD): the n-bit tuple IS the
            # address; requires entries == 2**n and k == 1.
            weights = 2 ** torch.arange(sm.inputs_per_filter,
                                        dtype=torch.int64, device=dev)
            addr = torch.sum(tuples.to(torch.int64) * weights, dim=-1)
            out.append((addr % sm.entries).to(torch.int32)[..., None])
        else:
            raise ValueError(hash_family)
    return tuple(out)


def forward(spec: UleenSpec, params: UleenParams, hashes: Sequence, *,
            train: bool = False, generator: Optional[torch.Generator] = None,
            keep: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
    """Ensemble scores (B, M) float32: sum of discriminator responses +
    bias, on the tensors' device.

    Train mode binarises continuous tables with STE and applies dropout to
    filter outputs (p = spec.dropout), the paper's recipe. `keep` gives
    the per-submodel keep-masks ((B, M, N_f), or (B, 1, N_f) with
    `dropout_shared_classes`); without it they are drawn from `generator`.
    """
    b = hashes[0].shape[0]
    scores = torch.zeros((b, spec.num_classes), dtype=torch.float32,
                         device=hashes[0].device)
    p = spec.dropout
    for i, (table, mask) in enumerate(zip(params.tables, params.masks)):
        if spec.bf16_tables:
            table = table.to(torch.bfloat16)
        resp = bloom.continuous_filter_response(table, hashes[i])  # (B,M,N_f)
        # masks are structural (pruning): the nonzero test carries no
        # gradient to them
        resp = bloom.apply_mask(resp, mask)
        if train and p > 0.0:
            if keep is not None:
                k_i = keep[i]
            else:
                if generator is None:
                    raise ValueError("train=True draws dropout masks: pass "
                                     "generator= or keep=")
                mshape = (resp.shape[0], 1, resp.shape[2]) \
                    if spec.dropout_shared_classes else tuple(resp.shape)
                k_i = torch.rand(mshape, generator=generator,
                                 device=resp.device) < (1.0 - p)
            resp = resp * k_i.to(resp.device) / (1.0 - p)
        # accumulate in float32: a bf16 popcount over > 256 filters would
        # lose integer precision
        scores = scores + torch.sum(resp, dim=-1, dtype=torch.float32)
    return scores + params.bias[None, :]


def round_bias(bias: torch.Tensor) -> torch.Tensor:
    """(M,) bias -> int32. A float bias rounds half to even, as `jnp.round`
    does (and `torch.round`); an integer bias passes through."""
    if bias.is_floating_point():
        bias = torch.round(bias)
    return bias.to(torch.int32)


def forward_binary(spec: UleenSpec, tables_bin: Sequence[torch.Tensor],
                   masks: Sequence[torch.Tensor], bias: torch.Tensor,
                   hashes: Sequence[torch.Tensor]) -> torch.Tensor:
    """Deployment inference on precomputed hashes: binary tables,
    AND-reduce, popcount, bias. The gather formulation the fused paths
    stay bit-identical to. Runs on the tensors' device."""
    b = hashes[0].shape[0]
    scores = torch.zeros((b, len(bias)), dtype=torch.int32,
                         device=hashes[0].device)
    for i, table in enumerate(tables_bin):
        resp = bloom.binary_filter_response(table, hashes[i])
        resp = bloom.apply_mask(resp, masks[i])
        scores = scores + torch.sum(resp, dim=-1, dtype=torch.int32)
    return scores + round_bias(torch.as_tensor(bias).to(scores.device))[None]


def forward_binary_fused(spec: UleenSpec, statics: Sequence[SubmodelStatic],
                         tables_bin: Sequence[torch.Tensor],
                         masks: Sequence[torch.Tensor], bias, bits, *,
                         backend: str = "auto",
                         device=DEFAULT_DEVICE) -> torch.Tensor:
    """Deployment inference straight from encoded bits (B, total_bits).

    One `kernels.ops.wnn_scores` dispatch per submodel on the raw
    thermometer tuples: with `backend="fused"` each submodel is one launch
    of the int8-table kernel (hash -> lookup -> AND -> popcount), the
    paper's whole accelerator pipeline; `"gather"` runs the plain version
    and is bit-identical; `"packed"` packs the tables on the fly and runs
    the bitplane kernel; `"auto"` is fused on a GPU and gather on the CPU.
    Only the H3 hash family is fused.
    """
    from repro_torch.kernels import ops
    dev = resolve_device(device)
    bits = torch.as_tensor(bits).to(dev).to(torch.int8)
    bias = torch.as_tensor(bias).to(dev)
    m = len(bias)
    scores = torch.zeros((bits.shape[0], m), dtype=torch.int32, device=dev)
    zero_bias = torch.zeros((m,), dtype=torch.int32, device=dev)
    for st, table, mask in zip(statics, tables_bin, masks):
        tuples = bits[:, st.perm.to(dev).long()]       # (B, N_f, n)
        scores += ops.wnn_scores(
            tuples, st.h3.to(dev, torch.int32),
            (torch.as_tensor(table).to(dev) != 0).to(torch.int8),
            (torch.as_tensor(mask).to(dev) != 0).to(torch.int8), zero_bias,
            backend=backend, device=dev)
    return scores + round_bias(bias)[None]


def predict(scores: torch.Tensor) -> torch.Tensor:
    """argmax over classes; ties go to the first index, as jnp.argmax."""
    return torch.argmax(scores, dim=-1)


def binarize_params(params: UleenParams) -> tuple:
    """Continuous training state -> deployable binary model
    (tables_bin, masks, bias)."""
    tables_bin = tuple(bloom.binarize_continuous(t) for t in params.tables)
    return tables_bin, params.masks, params.bias


def binarize_to_packed(spec: UleenSpec, statics: Sequence[SubmodelStatic],
                       params: UleenParams, *, device=DEFAULT_DEVICE):
    """Continuous training state -> `repro_torch.packed.PackedTables` on
    `device`, served by `repro_torch.packed.packed_scores`."""
    from repro_torch.packed import layout
    tables_bin, masks, bias = binarize_params(params)
    return layout.from_binary_model(
        statics, tables_bin, masks, bias,
        entries=[sm.entries for sm in spec.submodels],
        num_classes=spec.num_classes, device=device)
