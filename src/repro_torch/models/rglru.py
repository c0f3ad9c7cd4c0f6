"""RG-LRU recurrent blocks (RecurrentGemma / Griffin; port of
`repro/models/rglru.py`).

The Real-Gated Linear Recurrent Unit:
    r_t = sigmoid(W_a x_t + b_a)           (recurrence gate)
    i_t = sigmoid(W_x x_t + b_x)           (input gate)
    log a_t = -c * softplus(Lambda) * r_t  (c = 8)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

Prefill runs the linear recurrence as a log-depth scan over the sequence:
ceil(log2 S) Hillis-Steele steps of the associative combine
(a, b) o (a', b') = (a·a', a'·b + b'), each a few whole-tensor operations
(the JAX package calls `jax.lax.associative_scan`, which PyTorch lacks).
Products of gates underflow to 0, harmlessly; the cumulative-sum-of-logs
form would instead divide by exp(Σ log a), which overflows float32 within
tens of tokens at c = 8. Decode is the single-step recurrence. The
recurrent block is conv1d + RG-LRU on one branch, GeLU on the other
(Griffin's gated block). Plain PyTorch on every device: the JAX package
computes all of it in XLA.

Placed (x a DTensor, `dist.sharding.use_placement`), `placed_mixer` runs
the block on each rank's batch rows and its channels of the width W:
`w_in_rec` and `w_in_gate` split their columns over `model`, and the
conv, the gates, `lam` and both `RGState` leaves split the same channels
the same way, so everything up to `w_out` is local (the scan too, on
the rank's channels), and the row-parallel `w_out` sums over `model`
once. The JAX package puts no constraint inside the block.
"""
from __future__ import annotations

import types
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.dist import placed
from repro_torch.models.layers import causal_conv

C_FACTOR = 8.0


def _gates(p, x):
    """Per-channel (block size 1) gates, as the JAX package has them:
    (a, sqrt(1 - a²)·(i·x))."""
    r = torch.sigmoid(x * p.w_a + p.b_a)
    i = torch.sigmoid(x * p.w_x + p.b_x)
    log_a = -C_FACTOR * F.softplus(p.lam) * r
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a),
                                   min=1e-12)) * (i * x)
    return a, gated


def linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t·h_{t-1} + b_t from h_{-1} = 0 along axis 1, for every t:
    Hillis-Steele over the combine (a, b) o (a', b') = (a·a', a'·b + b'),
    ceil(log2 S) steps."""
    s = a.shape[1]
    off = 1
    while off < s:
        b = torch.cat([b[:, :off], a[:, off:] * b[:, :-off] + b[:, off:]],
                      dim=1)
        if off * 2 < s:              # the last step's products go unread
            a = torch.cat([a[:, :off], a[:, :-off] * a[:, off:]], dim=1)
        off *= 2
    return b


def rglru(p, x: torch.Tensor, h0=None):
    """x: (B, S, W) -> (y (B, S, W), h_last (B, W) float32)."""
    a, b = _gates(p, x.float())
    if h0 is not None:
        b = torch.cat([b[:, :1] + a[:, :1] * h0[:, None], b[:, 1:]], dim=1)
    h = linear_scan(a, b)
    return h.to(x.dtype), h[:, -1]


def rglru_step(p, x: torch.Tensor, h: torch.Tensor):
    """x: (B, W), h: (B, W) -> (y, h')."""
    a, b = _gates(p, x.float())
    h_new = a * h + b
    return h_new.to(x.dtype), h_new


class RGState(NamedTuple):
    conv: torch.Tensor   # ([L,] B, W, K-1) rolling conv window
    h: torch.Tensor      # ([L,] B, W) float32 recurrent state

    def layer(self, i: int) -> "RGState":
        """Layer i's view of a stacked state; writes land in the stack."""
        return RGState(self.conv[i], self.h[i])


def _gelu(x):
    # jax.nn.gelu's default is the tanh approximation
    return F.gelu(x, approximate="tanh")


def recurrent_block(cfg, p, x: torch.Tensor, *, return_state: bool = False):
    """Griffin recurrent mixer. x: (B, S, D) -> (B, S, D) [, RGState]."""
    k = p.conv_w.shape[0]
    br_raw = x @ p.w_in_rec                        # (B, S, W)
    br = causal_conv(br_raw, p.conv_w, p.conv_b)
    br, h_last = rglru(p, br)
    bg = _gelu(x @ p.w_in_gate)                    # (B, S, W)
    out = (br * bg) @ p.w_out
    if return_state:
        # zero-padded at the front: prompts shorter than the conv kernel
        # still yield the fixed (B, W, K-1) decode state
        br_pad = F.pad(br_raw, (0, 0, k - 1, 0))
        conv = br_pad[:, x.shape[1]:, :].transpose(1, 2)
        return out, RGState(conv=conv, h=h_last)
    return out


def recurrent_block_decode(cfg, p, x: torch.Tensor, cache: RGState):
    """x: (B, 1, D) -> (y (B, 1, D), the next RGState)."""
    xt = x[:, 0]
    br = xt @ p.w_in_rec                           # (B, W)
    window = torch.cat([cache.conv, br[:, :, None]], dim=-1)
    br = torch.einsum("bwk,kw->bw", window, p.conv_w) + p.conv_b
    br, h_new = rglru_step(p, br, cache.h)
    bg = _gelu(xt @ p.w_in_gate)
    y = ((br * bg) @ p.w_out)[:, None]
    return y, RGState(conv=window[:, :, 1:], h=h_new)


def placed_mixer(cfg, p, x, *, cache: Optional[RGState] = None,
                 decode: bool = False):
    """The recurrent block on placed x (B, S, D) (the module docstring's
    placement): training with no `cache`, a prefill that writes `cache`
    (a placed `RGState` layer view), or a decode step (x (B, 1, D)) that
    reads and advances it. `recurrent_block` or `recurrent_block_decode`
    runs on the rank's rows and channels; their partial output is summed
    over `model`. Returns the placed (B, S, D) output; the cache is
    written in place."""
    mesh = x.device_mesh
    chans = placed.split_dims(p.w_in_rec, (1,))
    c0, cl = placed.dim_offset(p.w_in_rec, 1), p.w_in_rec.to_local().shape[1]
    rows = placed.batch_dims(x)
    split = rows + chans
    xl = placed.grad_sum_over(placed.local_rows(x, rows), mesh, chans)
    # the rank's channels: w_out's rows, every other weight's last dim
    lp = types.SimpleNamespace(**{
        name: placed.local_parts(w, 0 if name == "w_out" else w.ndim - 1,
                                 [(c0, cl)], split)[0]
        for name in ("w_in_rec", "w_in_gate", "w_out", "conv_w", "conv_b",
                     "w_a", "b_a", "w_x", "b_x", "lam")
        for w in (getattr(p, name),)})
    if cache is None:
        out = recurrent_block(cfg, lp, xl)
    else:
        local = RGState(cache.conv.to_local(), cache.h.to_local())
        if (placed.dim_offset(cache.conv, 1), local.conv.shape[1]) != (c0, cl):
            raise NotImplementedError(
                "placed RG-LRU: the state's channels split otherwise than "
                "the block's")
        out, new = (recurrent_block_decode(cfg, lp, xl, local) if decode
                    else recurrent_block(cfg, lp, xl, return_state=True))
        for dst, src in zip(local, new):
            dst.copy_(src)
    out = placed.sum_over(out, mesh, chans)
    return placed.wrap(out, mesh, x.placements, x.shape)


def init_rg_state(cfg, batch: int, dtype=torch.float32, *,
                  layers: Optional[int] = None,
                  device=DEFAULT_DEVICE) -> RGState:
    """Zero state: conv (B, W, K-1) in `dtype`, h (B, W) float32, or with a
    leading (L,) axis given `layers`, on `device`."""
    device = resolve_device(device)
    w = cfg.lru_width or cfg.d_model
    lead = () if layers is None else (layers,)
    return RGState(
        conv=torch.zeros((*lead, batch, w, cfg.conv_kernel - 1),
                         dtype=dtype, device=device),
        h=torch.zeros((*lead, batch, w), dtype=torch.float32, device=device))
