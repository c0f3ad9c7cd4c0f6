"""UleenHead: the paper's technique as a module for LM backbones (port of
`repro/core/head.py`).

Attaches a weightless (Bloom-filter WiSARD ensemble) classifier to pooled
hidden states of a backbone: early-exit gating, classification
distillation, or extreme-edge export of the head alone.

Pipeline: pooled hidden h (B, D) -> RMS-normalise (features ~ N(0, 1)) ->
Gaussian thermometer encode against T shared quantile thresholds -> H3
hash -> continuous Bloom discriminators -> class scores. Trained with STE
on the tables; the thermometer comparison is a hard threshold, so the
backbone receives no gradient through the head by default (the head is
an observer). The deployed route (`apply_head(backend=...)`) binarizes
the head and scores it through the WNN kernel on a GPU.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Sequence

import torch

from repro_torch.core import bloom
from repro_torch.core import model as uleen_model
from repro_torch.core.model import SubmodelSpec, UleenSpec
from repro_torch.device import DEFAULT_DEVICE, resolve_device


@dataclasses.dataclass(frozen=True)
class UleenHeadConfig:
    num_classes: int
    hidden_dim: int
    bits_per_feature: int = 4
    submodels: tuple = (SubmodelSpec(16, 9), SubmodelSpec(24, 10))
    dropout: float = 0.5
    backbone_grad: bool = False   # if True, STE through the thermometer too

    def spec(self) -> UleenSpec:
        return UleenSpec(num_classes=self.num_classes,
                         total_bits=self.hidden_dim * self.bits_per_feature,
                         submodels=self.submodels,
                         bits_per_input=self.bits_per_feature,
                         dropout=self.dropout)


class UleenHeadState(NamedTuple):
    params: uleen_model.UleenParams
    statics: tuple                      # SubmodelStatic per submodel
    thresholds: torch.Tensor            # (T,) Gaussian quantiles, float32


def gaussian_thresholds(bits: int, *, device=DEFAULT_DEVICE) -> torch.Tensor:
    """(T,) float32 standard-normal quantiles i / (T + 1), i = 1..T."""
    dev = resolve_device(device)
    probs = torch.arange(1, bits + 1, dtype=torch.float32,
                         device=dev) / (bits + 1)
    return torch.special.ndtri(probs)


def init_head(generator: torch.Generator, cfg: UleenHeadConfig, *,
              device=DEFAULT_DEVICE) -> UleenHeadState:
    """Random statics and tables drawn from `generator`, on `device`."""
    dev = resolve_device(device)
    spec = cfg.spec()
    statics = tuple(uleen_model.init_static(generator, spec, device=dev))
    params = uleen_model.init_params(generator, spec, device=dev)
    return UleenHeadState(params=params, statics=statics,
                          thresholds=gaussian_thresholds(
                              cfg.bits_per_feature, device=dev))


def _rms_normalize(h: torch.Tensor) -> torch.Tensor:
    """(h - mean) / (population std + 1e-6), as the JAX package (`jnp.std`
    has ddof 0; torch's default is unbiased)."""
    mu = torch.mean(h, dim=-1, keepdim=True)
    sd = torch.std(h, dim=-1, keepdim=True, correction=0) + 1e-6
    return (h - mu) / sd


def encode_hidden(cfg: UleenHeadConfig, state: UleenHeadState,
                  h: torch.Tensor) -> torch.Tensor:
    """h: (B, D) -> bits (B, D·T) bool (or STE float if backbone_grad)."""
    z = _rms_normalize(h)
    cmp = z[..., :, None] - state.thresholds.to(z.device)   # (B, D, T)
    bits = bloom.ste_step(cmp) if cfg.backbone_grad else cmp > 0
    return bits.reshape(*h.shape[:-1], -1)


def apply_head(cfg: UleenHeadConfig, state: UleenHeadState, h, *,
               train: bool = False,
               generator: Optional[torch.Generator] = None,
               keep: Optional[Sequence[torch.Tensor]] = None,
               backend: str | None = None,
               device=DEFAULT_DEVICE) -> torch.Tensor:
    """Pooled hidden states -> (B, num_classes) ensemble scores on `device`.

    backend=None (the default) is the continuous training/eval forward
    (STE tables, float scores; `train=True` applies dropout from
    `generator`, or the keep-masks `keep`). A WNN backend name ("fused" |
    "gather" | "packed" | "auto") instead binarizes the head and scores
    it through `core.model.forward_binary_fused` — int32 scores, what the
    exported edge artifact of this head would serve (the WNN kernel on a
    GPU).
    """
    dev = resolve_device(device)
    spec = cfg.spec()
    h = torch.as_tensor(h).to(dev)
    bits = encode_hidden(cfg, state, h if cfg.backbone_grad else h.detach())
    bits_b = bits if bits.dtype == torch.bool else bits > 0
    if backend is not None:
        if train:
            raise ValueError("backend= serves the binarized deployment "
                             "path; training uses the continuous forward "
                             "(backend=None)")
        tables_bin, masks, bias = uleen_model.binarize_params(state.params)
        return uleen_model.forward_binary_fused(
            spec, state.statics, tables_bin, masks, bias, bits_b,
            backend=backend, device=dev)
    hashes = uleen_model.compute_hashes(spec, state.statics, bits_b,
                                        device=dev)
    return uleen_model.forward(spec, state.params, hashes, train=train,
                               generator=generator, keep=keep)


def head_loss(cfg: UleenHeadConfig, state: UleenHeadState, h, labels, *,
              generator: Optional[torch.Generator] = None,
              keep: Optional[Sequence[torch.Tensor]] = None,
              device=DEFAULT_DEVICE) -> torch.Tensor:
    """Cross-entropy of the head's continuous scores; dropout (training)
    when a `generator` or the keep-masks `keep` are given, as the JAX
    package trains when given a key."""
    from repro_torch.core.multi_shot import cross_entropy
    dev = resolve_device(device)
    train = generator is not None or keep is not None
    scores = apply_head(cfg, state, h, train=train, generator=generator,
                        keep=keep, device=dev)
    return cross_entropy(scores, torch.as_tensor(labels).to(dev))
