"""Input encoding for weightless networks (port of `repro/core/encoding.py`).

Gaussian non-linear thermometer encoding: per-feature thresholds at
Gaussian quantiles fitted on training data, so a T-bit code splits the
fitted normal into T+1 equal-probability regions. Linear thermometer and
1-bit mean binarization are the paper's baselines. Thresholds are float32,
as in the JAX package: float64 thresholds would move `>` at the edges.
Every fit takes `device=` (default "cuda"; raises without a GPU unless
given "cpu").

The encoder's methods are plain tensor ops on the thresholds' device; the
kernel versions are `kernels.ops.thermometer` (encode) and
`kernels.ops.decompress`.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import DEFAULT_DEVICE, resolve_device


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


def _train_features(x_train, device) -> torch.Tensor:
    """x_train (numpy or tensor) as float32 on the resolved `device`."""
    dev = resolve_device(device)
    if not isinstance(x_train, torch.Tensor):
        x_train = torch.from_numpy(np.array(x_train, np.float32))
    return x_train.to(dev, torch.float32)


def fit_gaussian_thermometer(x_train, bits: int, *,
                             device=DEFAULT_DEVICE) -> ThermometerEncoder:
    """Thresholds at Gaussian quantiles i/(T+1), i = 1..T (ULEEN's
    encoding), fitted in float32 on `device`."""
    x_train = _train_features(x_train, device)
    mean = torch.mean(x_train, dim=0)
    std = torch.std(x_train, dim=0, correction=0) + 1e-6   # jnp.std: ddof 0
    probs = torch.arange(1, bits + 1, dtype=torch.float32,
                         device=x_train.device) / (bits + 1)
    z = torch.special.ndtri(probs)  # (T,)
    thr = mean[:, None] + std[:, None] * z[None, :]
    return ThermometerEncoder(thresholds=thr)


def fit_linear_thermometer(x_train, bits: int, *,
                           device=DEFAULT_DEVICE) -> ThermometerEncoder:
    """Equal-interval thresholds between per-feature min and max (prior
    work), fitted in float32 on `device`."""
    x_train = _train_features(x_train, device)
    lo = torch.amin(x_train, dim=0)
    hi = torch.amax(x_train, dim=0)
    fracs = torch.arange(1, bits + 1, dtype=torch.float32,
                         device=x_train.device) / (bits + 1)
    thr = lo[:, None] + (hi - lo)[:, None] * fracs[None, :]
    return ThermometerEncoder(thresholds=thr)


def fit_mean_binarizer(x_train, *, device=DEFAULT_DEVICE) -> ThermometerEncoder:
    """Classic 1-bit WiSARD encoding: x > mean, fitted on `device`."""
    x_train = _train_features(x_train, device)
    return ThermometerEncoder(thresholds=torch.mean(x_train, dim=0)[:, None])
