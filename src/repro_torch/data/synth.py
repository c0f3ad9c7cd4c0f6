"""Synthetic dataset generators (port of `repro/data/synth.py`).

`make_mnist_like` builds class-prototype images with smooth random
structure plus per-sample deformation and noise, hard enough that the
one-shot vs multi-shot and ensemble vs monolith gaps show, like the
paper's MNIST study. `make_tabular` builds Gaussian-mixture
classification sets with the (F, M, n) signatures of the nine Bloom
WiSARD datasets (Table IV).

Random draws take an explicit `torch.Generator` where the JAX package
takes a key, and are kept apart from the deterministic arithmetic
(`resize_bilinear`, `compose_images`, `skew_probs`, `compose_tabular`),
which the tests hold to the JAX package's on the same numpy inputs. The
draws themselves differ from JAX's (Philox, not threefry); the shapes,
ranges and class structure do not. Every generator places its tensors on
`device` (default "cuda"; raises without a GPU unless given "cpu").
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.device import DEFAULT_DEVICE, resolve_device


class Dataset(NamedTuple):
    x_train: torch.Tensor
    y_train: torch.Tensor
    x_test: torch.Tensor
    y_test: torch.Tensor
    name: str = ""

    @property
    def num_features(self) -> int:
        return self.x_train.shape[-1]

    @property
    def num_classes(self) -> int:
        return int(torch.max(self.y_train)) + 1


def resize_bilinear(coarse: torch.Tensor, hw: int) -> torch.Tensor:
    """(..., c, c) -> (..., hw, hw), bilinear on half-pixel centres: what
    `jax.image.resize(..., "bilinear")` computes when it upsamples (at
    the borders both clamp to the edge sample)."""
    lead = coarse.shape[:-2]
    flat = coarse.reshape(-1, 1, *coarse.shape[-2:])
    up = F.interpolate(flat, size=(hw, hw), mode="bilinear",
                       align_corners=False)
    return up.reshape(*lead, hw, hw)


def _smooth_field(generator, shape, hw, device, cutoff=4):
    """Low-frequency random image: a random coarse grid, bilinear
    upsampled."""
    coarse = torch.randn((*shape, cutoff, cutoff), generator=generator,
                         device=generator.device)
    return resize_bilinear(coarse.to(device), hw)


def roll_rows(img: torch.Tensor, shifts: torch.Tensor) -> torch.Tensor:
    """img (n, hw, hw), shifts (n, 2) int -> each image rolled by its own
    (dy, dx), as `jnp.roll(im, s, axis=(0, 1))` per sample:
    out[i, j] = im[(i - dy) mod hw, (j - dx) mod hw]."""
    n, h, w = img.shape
    iy = torch.arange(h, device=img.device)
    ix = torch.arange(w, device=img.device)
    rows = (iy[None, :] - shifts[:, :1].long()) % h           # (n, hw)
    cols = (ix[None, :] - shifts[:, 1:].long()) % w           # (n, hw)
    flat = rows[:, :, None] * w + cols[:, None, :]            # (n, hw, hw)
    return torch.gather(img.reshape(n, h * w), 1,
                        flat.reshape(n, h * w)).reshape(n, h, w)


def compose_images(protos, styles, labels, mix, pixel_noise, shifts,
                   noise: float) -> torch.Tensor:
    """The deterministic part of `make_mnist_like`: prototype + mixed
    styles + scaled pixel noise, rolled per sample, squashed by
    sigmoid(2x) -> (n, hw·hw) in (0, 1)."""
    base = protos[labels]                                     # (n, hw, hw)
    styl = torch.einsum("ns,nsij->nij", mix, styles[labels])
    img = roll_rows(base + styl + noise * pixel_noise, shifts)
    img = torch.sigmoid(2.0 * img)
    return img.reshape(img.shape[0], -1)


def make_mnist_like(generator: torch.Generator, n_train: int = 8000,
                    n_test: int = 2000, num_classes: int = 10, hw: int = 28,
                    noise: float = 0.45, warp: float = 0.35, *,
                    device=DEFAULT_DEVICE) -> Dataset:
    """Digit-like grayscale images in [0, 1]: per-class smooth prototypes
    with 2 stochastic 'style' components per sample, pixel noise, and
    ±1 px shifts (the augmentation family the paper applies to MNIST)."""
    dev = resolve_device(device)
    gdev = generator.device
    n = n_train + n_test
    protos = _smooth_field(generator, (num_classes,), hw, dev)
    styles = _smooth_field(generator, (num_classes, 2), hw, dev)
    labels = torch.randint(0, num_classes, (n,), generator=generator,
                           device=gdev)
    mix = torch.randn((n, 2), generator=generator, device=gdev) * warp
    pixel = torch.randn((n, hw, hw), generator=generator, device=gdev)
    shifts = torch.randint(-1, 2, (n, 2), generator=generator, device=gdev)
    labels = labels.to(dev)
    x = compose_images(protos, styles, labels, mix.to(dev), pixel.to(dev),
                       shifts.to(dev), noise)
    return Dataset(x[:n_train], labels[:n_train], x[n_train:],
                   labels[n_train:], name="mnist-like")


def shift_augment(generator, x: torch.Tensor, y: torch.Tensor, hw: int,
                  copies: int = 9) -> tuple[torch.Tensor, torch.Tensor]:
    """The paper's MNIST augmentation: copies shifted in {-1, 0, 1}^2
    pixels, in that order. Deterministic; `generator` is kept for the JAX
    signature (its key is unused too)."""
    n = x.shape[0]
    img = x.reshape(n, hw, hw)
    shifts = [(dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1)][:copies]
    outs = [torch.roll(img, (dy, dx), dims=(1, 2)).reshape(n, -1)
            for dy, dx in shifts]
    return torch.cat(outs), torch.cat([y] * len(shifts))


def skew_probs(num_classes: int, skew: float) -> torch.Tensor:
    """Class probabilities where class 0 takes a `skew` fraction of the
    data (Shuttle-style): p0 / (p0 + (M - 1)) = skew."""
    p0 = skew * (num_classes - 1) / max(1e-6, 1.0 - skew)
    p = torch.ones(num_classes, dtype=torch.float32)
    p[0] = p0
    return p / torch.sum(p)


def compose_tabular(mus, labels, clusters, scale_noise, x_noise,
                    noise: float) -> torch.Tensor:
    """The deterministic part of `make_tabular`: the sample's cluster
    centre plus noise scaled per feature by exp(0.3·g)."""
    scale = torch.exp(0.3 * scale_noise)
    return mus[labels, clusters] + noise * scale * x_noise


def make_tabular(generator: torch.Generator, num_features: int,
                 num_classes: int, n_train: int, n_test: int, *,
                 separation: float = 2.2, clusters_per_class: int = 2,
                 noise: float = 1.0, skew: float = 0.0,
                 name: str = "tabular", device=DEFAULT_DEVICE) -> Dataset:
    """Gaussian-mixture tabular data; `skew` > 0 makes class 0 dominate
    (the Shuttle anomaly set, where 80 % of the data is 'normal')."""
    dev = resolve_device(device)
    gdev = generator.device
    n = n_train + n_test
    mus = separation * torch.randn(
        (num_classes, clusters_per_class, num_features), generator=generator,
        device=gdev)
    if skew > 0:
        labels = torch.multinomial(skew_probs(num_classes, skew).to(gdev), n,
                                   replacement=True, generator=generator)
    else:
        labels = torch.randint(0, num_classes, (n,), generator=generator,
                               device=gdev)
    clusters = torch.randint(0, clusters_per_class, (n,), generator=generator,
                             device=gdev)
    scale_noise = torch.randn((num_features,), generator=generator,
                              device=gdev)
    x_noise = torch.randn((n, num_features), generator=generator, device=gdev)
    labels = labels.to(dev)
    x = compose_tabular(mus.to(dev), labels, clusters.to(dev),
                        scale_noise.to(dev), x_noise.to(dev), noise)
    return Dataset(x[:n_train], labels[:n_train], x[n_train:],
                   labels[n_train:], name=name)


# (features, classes, n_train, n_test, skew) signatures of the paper's nine
# Table-IV datasets, sized for single-core CPU runs (full sizes in comments).
UCI_SUITE = {
    #                F   M  n_tr  n_te  skew
    "mnist":      (784, 10, 6000, 1500, 0.0),   # 60000/10000 in the paper
    "ecoli":      (7,   8,  224,  112,  0.0),
    "iris":       (4,   3,  100,  50,   0.0),
    "letter":     (16,  26, 4000, 1000, 0.0),   # 20000 in the paper
    "satimage":   (36,  6,  2000, 800,  0.0),   # 6435 in the paper
    "shuttle":    (9,   7,  4000, 1000, 0.8),   # 58000 in the paper; skewed
    "vehicle":    (18,  4,  564,  282,  0.0),
    "vowel":      (10,  11, 660,  330,  0.0),
    "wine":       (13,  3,  118,  60,   0.0),
}


def make_uci_like(generator: torch.Generator, name: str, *,
                  device=DEFAULT_DEVICE) -> Dataset:
    f, m, n_tr, n_te, skew = UCI_SUITE[name]
    if name == "mnist":
        return make_mnist_like(generator, n_tr, n_te, device=device)
    return make_tabular(generator, f, m, n_tr, n_te, skew=skew, name=name,
                        device=device)


def make_lm_tokens(seed: int, vocab: int, num_tokens: int, order: int = 2,
                   *, device=DEFAULT_DEVICE) -> torch.Tensor:
    """Synthetic token stream with a Zipfian unigram and copy structure,
    for LM training examples (loss decreases measurably, unlike uniform
    noise) -> (num_tokens,) int32 on `device`. numpy draws from `seed`:
    given the integer the JAX package derives from its key
    (`jax.random.randint(key, (), 0, 2**31 - 1)`), the tokens are the
    same, bit for bit."""
    dev = resolve_device(device)
    rng = np.random.default_rng(int(seed))
    ranks = np.arange(1, vocab + 1)
    probs = 1.0 / ranks ** 1.1
    probs /= probs.sum()
    base = rng.choice(vocab, size=num_tokens, p=probs)
    # inject copy structure: with p = 0.3, token t = token[t - lag]
    lag = rng.integers(1, 64, size=num_tokens)
    copy = rng.random(num_tokens) < 0.3
    idx = np.arange(num_tokens) - lag
    ok = copy & (idx >= 0)
    base[ok] = base[idx[ok]]
    return torch.from_numpy(base.astype(np.int32)).to(dev)
