"""Transformer building blocks: norms, RoPE, MLP, attention (port of
`repro/models/layers.py`).

Functions take plain tensors and parameter modules whose attribute names
are the JAX package's dict keys (`p.scale`, `p.w1`, ...). Arithmetic
follows the JAX functions step for step: norms and RoPE in float32, the
RMSNorm gain as `1 + scale`, RoPE on split halves. Prefill and training
attention (`chunked_attention`, and `banded_attention` for Mixtral's
sliding window) goes through `kernels.ops.flash_attention`, the
hand-written flash kernel on CUDA tensors and its plain version on CPU
tensors, differentiable (`ops.FlashAttention`, a plain backward); decode
attention (`decode_attention`) is plain PyTorch over the whole cache, as
the JAX package's is plain XLA. `sinusoidal_positions` gives Whisper's
encoder its fixed positions.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.dist import placed
from repro_torch.dist.sharding import logical_constraint
from repro_torch.kernels import ops

DEFAULT_CHUNK = 512
NEG_INF = -1e30


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * (1.0 + scale.float())).to(x.dtype)


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    out = (xf - mu) * torch.rsqrt(var + eps)
    return (out * scale + bias).to(x.dtype)


def apply_norm(cfg, p, x: torch.Tensor) -> torch.Tensor:
    if cfg.norm == "layernorm":
        return layernorm(x, p.scale, p.bias)
    return rmsnorm(x, p.scale)


def sinusoidal_positions(seq: int, dim: int, dtype=torch.float32,
                         device=None) -> torch.Tensor:
    """(seq, dim) fixed positions: sin of position x 10000^(-2i/dim) in the
    first dim/2 columns, cos in the rest, computed in float32 as the JAX
    function does and cast to `dtype`."""
    pos = torch.arange(seq, dtype=torch.float32, device=device)[:, None]
    inv = torch.exp(-math.log(10000.0) * torch.arange(
        0, dim, 2, dtype=torch.float32, device=device) / dim)
    ang = pos * inv[None]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float,
               device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (B, S, H, D); positions: (B, S) or (S,). Split-halves rotation
    in float32, cast back to x's dtype."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, device=x.device)
    ang = positions[..., None].float() * freqs            # (B, S, D/2)
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def causal_conv(x: torch.Tensor, w: torch.Tensor,
                bias: torch.Tensor) -> torch.Tensor:
    """x: (B, S, C); w: (K, C) depthwise causal conv (Mamba 2's and the
    RG-LRU's), the JAX package's sum of shifted products in its order."""
    k = w.shape[0]
    xp = F.pad(x, (0, 0, k - 1, 0))
    out = sum(xp[:, i:i + x.shape[1], :] * w[i][None, None]
              for i in range(k))
    return out + bias[None, None]


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """`x @ w` under the JAX package's type promotion, where torch's `@`
    refuses two dtypes: both operands in the wider one (Whisper's float32
    encoder over bf16 weights multiplies the weights' bf16 values in
    float32)."""
    if x.dtype != w.dtype:
        dt = torch.promote_types(x.dtype, w.dtype)
        x, w = x.to(dt), w.to(dt)
    return x @ w


def mlp(cfg, p, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU (w1/w3 gate) or GELU (w1 only; JAX's default tanh
    approximation), per cfg.act; products as `matmul` promotes them."""
    if cfg.act == "swiglu":
        h = F.silu(matmul(x, p.w1)) * matmul(x, p.w3)
    else:
        h = matmul(x, p.w1)
        if hasattr(p, "b1"):
            h = h + p.b1
        h = F.gelu(h, approximate="tanh")
    h = logical_constraint(h, ("batch", "seq", "ffn"))
    out = matmul(h, p.w2)
    if hasattr(p, "b2"):
        out = out + p.b2
    return out


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool, window: int = 0, q_offset: int = 0,
                      kv_len=None, chunk: int = DEFAULT_CHUNK,
                      scale: Optional[float] = None,
                      remat_body: bool = True) -> torch.Tensor:
    """q: (B, Hq, Sq, D); k: (B, Hkv, Sk, D); v: (B, Hkv, Sk, Dv) ->
    (B, Hq, Sq, Dv); Dv may differ from D (MLA's 192-wide queries and
    keys over 128-wide values).

    The JAX function streams the softmax over KV chunks in XLA; here the
    same streaming softmax is the flash kernel (`ops.flash_attention`) on
    CUDA tensors and its plain version on CPU tensors, GQA folded in
    without repeating keys on the card; under autograd its gradient is
    the plain version's (`ops.FlashAttention`). `chunk` (XLA's scan
    chunk) and `remat_body` (checkpointing of the scan body for the
    backward pass) are facts of the XLA program: they are accepted and
    ignored.
    `kv_len` (an int or a 0-d tensor) masks keys at or past it, which is
    the same as dropping them.
    """
    del chunk, remat_body
    if placed.is_placed(q):
        return placed.attention(q, k, v, attend=ops.flash_attention,
                                causal=causal, window=window, scale=scale,
                                q_offset=q_offset)
    if kv_len is not None:
        kv_len = int(kv_len)
        k, v = k[:, :, :kv_len], v[:, :, :kv_len]
    return ops.flash_attention(q, k, v, causal=causal, window=window,
                               scale=scale, q_offset=q_offset)


def banded_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     window: int, q_block: int = DEFAULT_CHUNK,
                     scale: Optional[float] = None,
                     remat_body: bool = True) -> torch.Tensor:
    """Causal sliding-window attention that touches only the band: query
    i sees keys (i - window, i]. q: (B, Hq, S, D); k, v: (B, Hkv, S, D).

    The JAX function walks query blocks of `q_block` and slices each
    block's (window + q_block) keys, O(S·(window + q_block)) work where
    masking a full scan would be O(S²). The flash kernel does the same
    inside one launch: a query tile starts at its band's first key tile
    and skips the tiles outside the band, so `q_block` and `remat_body`
    (facts of the XLA program) are accepted and ignored."""
    del q_block, remat_body
    if placed.is_placed(q):     # rank shards; a `ctx` shard's row offset
        return placed.attention(q, k, v, attend=ops.flash_attention,
                                causal=True, window=window, scale=scale)
    return ops.flash_attention(q, k, v, causal=True, window=window,
                               scale=scale)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     kv_len: torch.Tensor, window: int = 0,
                     scale: Optional[float] = None) -> torch.Tensor:
    """Single-step decode: q (B, Hq, 1, D) over the whole cache k, v
    (B, Hkv, W, D), keys at or past kv_len (B,) masked. Scores in float32;
    the probabilities are rounded to the cache's dtype before the product
    with v, as the JAX function's `p.astype(v.dtype)` does."""
    if placed.is_placed(k):
        return placed.decode_attention(q, k, v, kv_len=kv_len, window=window,
                                       scale=scale)
    b, hq, _, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    dv = v.shape[-1]
    g = hq // hkv
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    qg = q.reshape(b, hkv, g, d).float()
    s = torch.matmul(qg, k.float().transpose(-1, -2)) * scale  # (B,Hkv,G,W)
    ik = torch.arange(sk, device=q.device)
    mask = ik[None, :] < kv_len[:, None]                        # (B, W)
    if window > 0:
        mask = mask & (ik[None, :] > kv_len[:, None] - 1 - window)
    s = torch.where(mask[:, None, None], s,
                    torch.tensor(NEG_INF, device=q.device))
    p = torch.softmax(s, dim=-1).to(v.dtype)
    out = torch.matmul(p.float(), v.float())
    return out.reshape(b, hq, 1, dv).to(q.dtype)
