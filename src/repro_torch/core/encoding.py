"""Input encoding for weightless networks (port of `repro/core/encoding.py`).

Gaussian non-linear thermometer encoding: per-feature thresholds at
Gaussian quantiles fitted on training data, so a T-bit code splits the
fitted normal into T+1 equal-probability regions. Thresholds are float32,
as in the JAX package: float64 thresholds would move `>` at the edges.
The linear and mean-binarizer baselines belong to the training slice.

The encoder's methods are plain tensor ops on the thresholds' device; the
serve path's kernel versions are `kernels.ops.thermometer` (encode) and
`kernels.ops.decompress`.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class ThermometerEncoder:
    """Stateless encoder; thresholds (F, T) float32 are the fitted state."""
    thresholds: torch.Tensor  # (features, bits)

    @property
    def num_features(self) -> int:
        return self.thresholds.shape[0]

    @property
    def bits_per_input(self) -> int:
        return self.thresholds.shape[1]

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """x: (..., F) float -> bits (..., F*T) bool, LSB-first unary code."""
        bits = x[..., :, None] > self.thresholds
        return bits.reshape(*x.shape[:-1], -1)

    def encode_counts(self, x: torch.Tensor) -> torch.Tensor:
        """Compressed form (the paper's bus compression): per-feature
        set-bit count (..., F) uint8."""
        return torch.sum(x[..., :, None] > self.thresholds, dim=-1).to(
            torch.uint8)

    def decompress(self, counts: torch.Tensor) -> torch.Tensor:
        """Recover unary bits (..., F*T) bool from counts (the
        accelerator's decompression unit)."""
        iota = torch.arange(self.bits_per_input, dtype=counts.dtype,
                            device=counts.device)
        bits = iota[None, :] < counts[..., :, None]
        return bits.reshape(*counts.shape[:-1], -1)


def fit_gaussian_thermometer(x_train: torch.Tensor,
                             bits: int) -> ThermometerEncoder:
    """Thresholds at Gaussian quantiles i/(T+1), i = 1..T (ULEEN's
    encoding), in float32 on `x_train`'s device."""
    x_train = torch.as_tensor(x_train).to(torch.float32)
    mean = torch.mean(x_train, dim=0)
    std = torch.std(x_train, dim=0, correction=0) + 1e-6   # jnp.std: ddof 0
    probs = torch.arange(1, bits + 1, dtype=torch.float32,
                         device=x_train.device) / (bits + 1)
    z = torch.special.ndtri(probs)  # (T,)
    thr = mean[:, None] + std[:, None] * z[None, :]
    return ThermometerEncoder(thresholds=thr)
