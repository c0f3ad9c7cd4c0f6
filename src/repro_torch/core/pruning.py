"""Post-training pruning of RAM nodes (port of `repro/core/pruning.py`).

1. Correlate each filter's binarised output with the correct-class
   indicator over the training set (per discriminator).
2. Zero out the lowest-|prune_ratio| fraction per discriminator (mask).
3. Learn integer per-class biases compensating the removed response mass.
4. Fine-tune the surviving filters (+ bias) with the multi-shot rule.

Standard deviations are population ones (`correction=0`, as `jnp.std`),
the sort is stable (as `jnp.argsort`) and rounding is half to even (as
`jnp.round`), so masks and biases match the JAX package exactly on the
same correlations.
"""
from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.core import bloom
from repro_torch.core.model import (SubmodelStatic, UleenParams, UleenSpec,
                                    compute_hashes)
from repro_torch.core.multi_shot import (MultiShotConfig, TrainResult,
                                         evaluate, params_to,
                                         train_multi_shot)
from repro_torch.device import DEFAULT_DEVICE, resolve_device


@torch.no_grad()
def filter_correlations(spec: UleenSpec, params: UleenParams,
                        hashes: Sequence[torch.Tensor],
                        labels) -> list:
    """Pearson correlation of each filter output with the class indicator,
    per submodel (M, N_f). Filter outputs are the binarised responses on
    the (training) batch; the indicator for discriminator c is
    1[label == c]."""
    labels = torch.as_tensor(labels).to(hashes[0].device, torch.int64)
    ind = torch.nn.functional.one_hot(labels, spec.num_classes).float()
    ind_c = ind - torch.mean(ind, dim=0, keepdim=True)
    ind_std = torch.std(ind, dim=0, correction=0) + 1e-6             # (M,)
    out = []
    for table, h in zip(params.tables, hashes):
        resp = bloom.continuous_filter_response(table, h)        # (B, M, N_f)
        mu = torch.mean(resp, dim=0, keepdim=True)
        sd = torch.std(resp, dim=0, correction=0) + 1e-6         # (M, N_f)
        cov = torch.mean((resp - mu) * ind_c[:, :, None], dim=0)
        out.append(cov / (sd * ind_std[:, None]))
    return out


def prune_masks(spec: UleenSpec, correlations: Sequence[torch.Tensor],
                ratio: float) -> tuple:
    """Keep the top-(1-ratio) fraction by |correlation| per discriminator."""
    masks = []
    for corr in correlations:
        m, n_f = corr.shape
        mask = torch.ones((m, n_f), dtype=torch.float32, device=corr.device)
        k_drop = int(round(ratio * n_f))
        if k_drop:
            order = torch.argsort(torch.abs(corr), dim=1, stable=True)
            rows = torch.arange(m, device=corr.device)[:, None]
            mask[rows, order[:, :k_drop]] = 0.0
        masks.append(mask)
    return tuple(masks)


@torch.no_grad()
def init_bias(spec: UleenSpec, params: UleenParams, new_masks,
              hashes: Sequence[torch.Tensor]) -> torch.Tensor:
    """Integer bias ~= mean response mass removed by pruning, per class."""
    removed = torch.zeros(spec.num_classes, dtype=torch.float32,
                          device=hashes[0].device)
    for table, h, old_m, new_m in zip(params.tables, hashes, params.masks,
                                      new_masks):
        resp = bloom.continuous_filter_response(table, h)
        gone = (old_m - new_m)[None]                            # (1, M, N_f)
        removed = removed + torch.mean(torch.sum(resp * gone, dim=-1), dim=0)
    return torch.round(removed)


def prune_and_finetune(spec: UleenSpec, statics: Sequence[SubmodelStatic],
                       params: UleenParams, bits_train, labels_train,
                       bits_val, labels_val, *, ratio: float = 0.3,
                       finetune: MultiShotConfig = MultiShotConfig(epochs=3),
                       device=DEFAULT_DEVICE) -> TrainResult:
    dev = resolve_device(device)
    params = params_to(params, dev)
    hashes = compute_hashes(spec, statics, bits_train, device=dev)
    corr = filter_correlations(spec, params, hashes, labels_train)
    masks = prune_masks(spec, corr, ratio)
    bias = params.bias + init_bias(spec, params, masks, hashes)
    pruned = params._replace(masks=masks, bias=bias)
    if finetune.epochs <= 0:
        acc = evaluate(spec, statics, pruned, bits_val, labels_val,
                       device=dev)
        return TrainResult(params=pruned, history=[], val_accuracy=acc)
    return train_multi_shot(spec, statics, pruned, bits_train, labels_train,
                            bits_val, labels_val, finetune, device=dev)
