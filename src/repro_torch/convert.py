"""Carry state from the JAX package into the port.

The two packages never import each other; state crosses as numpy arrays.
Each function takes what the JAX package holds (converted with
`np.asarray`) and returns the port's object, so both packages can compute
on the same artifact, tables and thresholds.
"""
from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np
import torch

from repro_torch.core import encoding, export, model
from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.packed import layout


def artifact_from_numpy(arrays: Mapping[str, np.ndarray]
                        ) -> export.InferenceArtifact:
    """An `InferenceArtifact` from the npz-keyed arrays of a JAX artifact:
    `meta`, `bias` and `sm{i}_{packed,mask,perm,h3,cfg}` — exactly what
    `repro.core.export.save` writes."""
    return export.from_arrays({k: np.asarray(v) for k, v in arrays.items()})


def packed_tables_from_binary(statics: Sequence, tables_bin: Sequence,
                              masks: Sequence, bias, entries: Sequence[int],
                              num_classes: int, *,
                              device=DEFAULT_DEVICE) -> layout.PackedTables:
    """The mirror of the JAX `packed.layout.from_binary_model`: statics as
    (perm (N_f, n), h3 (k, n)) numpy pairs, binarized (M, N_f, E) tables,
    masks and bias as numpy arrays."""
    dev = resolve_device(device)
    sts = [model.SubmodelStatic(
        perm=torch.from_numpy(np.asarray(perm, np.int32)),
        h3=torch.from_numpy(np.asarray(h3).astype(np.int32)))
        for perm, h3 in statics]
    return layout.from_binary_model(
        sts, [torch.from_numpy(np.asarray(t) != 0) for t in tables_bin],
        [torch.from_numpy(np.asarray(m)) for m in masks],
        torch.from_numpy(np.asarray(bias)), entries, num_classes, device=dev)


def encoder_from_numpy(thresholds, *,
                       device=DEFAULT_DEVICE) -> encoding.ThermometerEncoder:
    """A `ThermometerEncoder` on fitted (F, T) thresholds, as float32 (the
    JAX package's dtype; float64 would move `>` at the edges)."""
    dev = resolve_device(device)
    thr = torch.tensor(np.asarray(thresholds, np.float32), device=dev)
    return encoding.ThermometerEncoder(thresholds=thr)
