"""The ULEEN model for inference: an additive ensemble of Bloom-filter
WiSARD submodels (port of `repro/core/model.py`, serve side).

Specs are static config; `SubmodelStatic` holds the frozen random
structures (input permutation + H3 parameters). Shapes use the paper's
names: M classes, N_f filters per discriminator, n inputs per filter, E
entries per filter, k hash functions. The training side (initialisation,
continuous forward, binarisation) belongs to a later slice of the port;
so do the spec's training flags (dropout, bf16 tables).
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional, Sequence

import torch

from repro_torch.core import bloom
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
