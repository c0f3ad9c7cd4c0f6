"""One-shot training with counting Bloom filters + bleaching (port of
`repro/core/one_shot.py`).

Training presents each encoded sample once to the correct class's
discriminator, incrementing the smallest accessed counter(s). Afterwards a
bleaching threshold b is searched on a validation set; counters >= b
binarise to 1 (paper Fig. 7a).
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.core import bloom
from repro_torch.core.model import SubmodelStatic, UleenSpec, compute_hashes
from repro_torch.device import DEFAULT_DEVICE, resolve_device


class OneShotModel(NamedTuple):
    counting: tuple          # (M, N_f, E) int32 per submodel
    bleach: torch.Tensor     # () int32, chosen threshold
    bias: torch.Tensor       # (M,) float32 (zeros; kept for API parity)


def _class_rounds(labels: np.ndarray) -> list:
    """Sample indices in rounds: round r holds the r-th sample of every
    class that has one. A sample updates only its class's row, so the
    samples of one round touch disjoint rows, and each class still sees
    its samples in their original order — the JAX scan's result."""
    per_class = [np.flatnonzero(labels == c) for c in np.unique(labels)]
    depth = max((len(ix) for ix in per_class), default=0)
    return [np.array([ix[r] for ix in per_class if r < len(ix)])
            for r in range(depth)]


def _train_tables(hashes: torch.Tensor, labels: torch.Tensor,
                  rounds: list, num_classes: int, entries: int
                  ) -> torch.Tensor:
    """The sequential counting pass, a host loop over class rounds (index
    tensors on the hashes' device), each round one `counting_increment`
    of samples with distinct labels."""
    table = torch.zeros((num_classes, hashes.shape[1], entries),
                        dtype=torch.int32, device=hashes.device)
    for ix in rounds:
        table = bloom.counting_increment(table, hashes[ix], labels[ix])
    return table


def train_one_shot(spec: UleenSpec, statics: Sequence[SubmodelStatic],
                   bits_train, labels_train, bits_val, labels_val, *,
                   hash_family: str = "h3", search_steps: int = 10,
                   device=DEFAULT_DEVICE) -> OneShotModel:
    """Fit counting tables on (bits, labels) and bleach on the validation
    set, on `device`."""
    dev = resolve_device(device)
    h_train = compute_hashes(spec, statics, bits_train,
                             hash_family=hash_family, device=dev)
    h_val = compute_hashes(spec, statics, bits_val, hash_family=hash_family,
                           device=dev)
    y_train = torch.as_tensor(labels_train).to(dev, torch.int64)
    # the rounds are planned on the host, once
    rounds = [torch.from_numpy(ix).to(dev)
              for ix in _class_rounds(y_train.cpu().numpy())]
    counting = [_train_tables(h_train[i], y_train, rounds, spec.num_classes,
                              sm.entries)
                for i, sm in enumerate(spec.submodels)]

    # validation min-counter values, computed once: (B, M, N_f) each
    minvals = [bloom.counting_min_values(t, h)
               for t, h in zip(counting, h_val)]
    y_val = torch.as_tensor(labels_val).to(dev, torch.int64)

    def accuracy_at(b):
        scores = sum(torch.sum(mv >= b, dim=-1, dtype=torch.int32)
                     for mv in minvals)
        return torch.mean((torch.argmax(scores, dim=-1) == y_val).float())

    max_b = int(max(int(t.max()) for t in counting))
    b = _bleach_search(accuracy_at, max_b, search_steps)
    return OneShotModel(
        counting=tuple(counting),
        bleach=torch.tensor(b, dtype=torch.int32, device=dev),
        bias=torch.zeros(spec.num_classes, dtype=torch.float32, device=dev))


def _bleach_search(accuracy_at, max_b: int, steps: int) -> int:
    """Coarse-to-fine search for the accuracy-maximising bleach threshold:
    a log-spaced grid, then a local refinement, then +-2 (the JAX
    package's search, threshold for threshold)."""
    steps = max(1, steps)
    hi = max(1, max_b)
    grid = sorted({1, hi} | {
        int(round(hi ** (i / max(1, 2 * steps - 1))))
        for i in range(2 * steps)})
    best_b, best_acc = 1, -1.0
    for b in grid:
        a = float(accuracy_at(b))
        if a > best_acc:
            best_b, best_acc = b, a
    lo = max(1, best_b // 2)
    up = min(hi, best_b * 2)
    step = max(1, (up - lo) // (2 * steps))
    for b in range(lo, up + 1, step):
        a = float(accuracy_at(b))
        if a > best_acc:
            best_b, best_acc = b, a
    for b in range(max(1, best_b - 2), min(hi, best_b + 2) + 1):
        a = float(accuracy_at(b))
        if a > best_acc:
            best_b, best_acc = b, a
    return best_b


def binarize(model: OneShotModel) -> tuple:
    """Counting tables -> binary Bloom filters at the chosen bleach
    threshold."""
    return tuple(bloom.binarize_counting(t, model.bleach)
                 for t in model.counting)


def evaluate_one_shot(spec: UleenSpec, statics: Sequence[SubmodelStatic],
                      model: OneShotModel, bits, labels, *,
                      hash_family: str = "h3",
                      device=DEFAULT_DEVICE) -> float:
    dev = resolve_device(device)
    hashes = compute_hashes(spec, statics, bits, hash_family=hash_family,
                            device=dev)
    scores = torch.zeros((hashes[0].shape[0], spec.num_classes),
                         dtype=torch.int32, device=dev)
    for t, h in zip(model.counting, hashes):
        mv = bloom.counting_min_values(t.to(dev), h)
        scores += torch.sum(mv >= model.bleach.to(dev), dim=-1,
                            dtype=torch.int32)
    y = torch.as_tensor(labels).to(dev, torch.int64)
    return float(torch.mean((torch.argmax(scores, dim=-1) == y).float()))
