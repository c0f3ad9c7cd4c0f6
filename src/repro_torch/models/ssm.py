"""Mamba-2 (SSD: state-space duality) blocks (port of
`repro/models/ssm.py`).

The sequence is processed in chunks of Q = `cfg.ssm_chunk` tokens, a Python
loop carrying the (B, H, P, N) float32 inter-chunk state, so nothing
quadratic in S is materialised: per chunk the Q x Q lower-triangular decay
("intra-chunk attention"), the chunk's contribution to the running state and
the state's contribution to the chunk's output (Dao & Gu 2024, minimal-SSD
formulation). The chunk is kept from the JAX package: it fixes where the
dt = 0 padding falls and how the arithmetic groups, so both run the same
chunks. The JAX package computes all of this in XLA, outside any Pallas
kernel, so it is plain PyTorch here on every device.

B and C are shared by the heads of a group: the products read each group's
(Q, N) rows through a broadcast head axis instead of a repeated copy, the
same dot products as the JAX package's repeat.

Decode is the O(1) recurrent update: state = state * exp(dt*A) + dt * x B^T.
A serving state (`SSMState`) holds the rolling conv window and the SSD
state with the layer axis first, as the port's KV caches do.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.models.layers import causal_conv, rmsnorm


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """x: (..., Q) -> (..., Q, Q) lower-tri cumulative sums: sum_{j<i<=k};
    -inf above the diagonal."""
    q = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    seg = cs[..., :, None] - cs[..., None, :]
    ii = torch.arange(q, device=x.device)
    mask = ii[:, None] >= ii[None, :]
    return seg.masked_fill(~mask, float("-inf"))


def _by_group(t: torch.Tensor, g: int) -> torch.Tensor:
    """(B, H, ...) -> (B, G, H // G, ...): a head's group on its own axis
    (head h in group h // (H // G), as `jnp.repeat` assigns them)."""
    return t.reshape(t.shape[0], g, t.shape[1] // g, *t.shape[2:])


def ssd_scan(x, dt, a, b, c, d_skip, *, chunk: int,
             remat_body: bool = True):
    """SSD forward. x: (B, S, H, P); dt: (B, S, H); a: (H,) (negative);
    b, c: (B, S, G, N); d_skip: (H,) -> (y (B, S, H, P), final state
    (B, H, P, N) float32). `remat_body` only matters for a backward pass
    (the JAX package checkpoints each chunk); it is accepted and
    ignored."""
    del remat_body
    bsz, s, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    pad = (-s) % chunk
    if pad:
        # dt = 0 padding is exact: decay exp(0·a) = 1 keeps the state, and
        # the padded tokens contribute dt·x·Bᵀ = 0 to it
        x_p = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        b = F.pad(b, (0, 0, 0, 0, 0, pad))
        c = F.pad(c, (0, 0, 0, 0, 0, pad))
    else:
        x_p = x
    a = a.float()
    state = torch.zeros((bsz, h, p, n), dtype=torch.float32, device=x.device)
    ys = []
    for c0 in range(0, s + pad, chunk):
        sl = slice(c0, c0 + chunk)
        # per-chunk float32 upcast, as the JAX body does
        xq = x_p[:, sl].float().permute(0, 2, 1, 3)         # (B, H, Q, P)
        dtq = dt[:, sl].float().transpose(1, 2)              # (B, H, Q)
        bq = b[:, sl].float().transpose(1, 2)                # (B, G, Q, N)
        cq = c[:, sl].float().transpose(1, 2)
        da = dtq * a[None, :, None]                          # (B, H, Q)
        # intra-chunk: L[i, j] = exp(sum_{j<k<=i} da_k)
        ll = torch.exp(_segsum(da))                          # (B, H, Q, Q)
        scores = cq @ bq.transpose(-1, -2)                   # (B, G, Q, Q)
        m = _by_group(ll, g) * scores[:, :, None] \
            * _by_group(dtq, g)[..., None, :]                # (B, G, R, Q, K)
        y_diag = m @ _by_group(xq, g)                        # (B, G, R, Q, P)
        # state -> output (inter-chunk)
        cum = torch.cumsum(da, dim=-1)                       # (B, H, Q)
        y_off = (cq[:, :, None] @ _by_group(state, g).transpose(-1, -2)) \
            * _by_group(torch.exp(cum), g)[..., None]        # (B, G, R, Q, P)
        # chunk -> new state
        total = cum[..., -1:]                                # (B, H, 1)
        w = dtq * torch.exp(total - cum)                     # (B, H, Q)
        contrib = (_by_group(xq * w[..., None], g).transpose(-1, -2)
                   @ bq[:, :, None])                         # (B, G, R, P, N)
        state = state * torch.exp(total)[..., None] \
            + contrib.reshape(bsz, h, p, n)
        ys.append((y_diag + y_off).reshape(bsz, h, chunk, p).to(x.dtype))
    y = torch.cat(ys, dim=2).permute(0, 2, 1, 3)[:, :s]      # (B, S, H, P)
    skip = d_skip[None, None, :, None].to(x.dtype)
    return (y + x * skip).to(x.dtype), state


def ssd_decode_step(state, x, dt, a, b, c, d_skip):
    """One-token recurrence. state: (B, H, P, N); x: (B, H, P); dt: (B, H);
    b, c: (B, G, N) -> (state', y (B, H, P))."""
    h = x.shape[1]
    da = torch.exp(dt * a)                                   # (B, H)
    upd = (dt[..., None] * x)[..., None] \
        * _by_group_rows(b, h)[:, :, None, :]                # (B, H, P, N)
    state = state * da[..., None, None] + upd
    y = (state @ _by_group_rows(c, h)[..., None])[..., 0]    # (B, H, P)
    return state, (y + x * d_skip[None, :, None]).to(x.dtype)


def _by_group_rows(t: torch.Tensor, h: int) -> torch.Tensor:
    """(B, G, N) -> (B, H, N): each head gets its group's row (head h
    in group h // (H // G), as `jnp.repeat` assigns them)."""
    bsz, g, n = t.shape
    return t[:, :, None].expand(bsz, g, h // g, n).reshape(bsz, h, n)


class SSMState(NamedTuple):
    conv: torch.Tensor    # ([L,] B, conv_dim, K-1) rolling conv window
    state: torch.Tensor   # ([L,] B, H, P, N) float32

    def layer(self, i: int) -> "SSMState":
        """Layer i's view of a stacked state; writes land in the stack."""
        return SSMState(self.conv[i], self.state[i])


def _split_in_proj(cfg, zxbcdt):
    d_in = cfg.ssm_expand * cfg.d_model
    gn = cfg.ssm_groups * cfg.ssm_state
    return torch.split(zxbcdt, [d_in, d_in, 2 * gn,
                                zxbcdt.shape[-1] - 2 * d_in - 2 * gn], -1)


def mamba2_block(cfg, p, x: torch.Tensor, *, return_state: bool = False):
    """Full Mamba-2 mixer. x: (B, S, D) -> (B, S, D) [, SSMState at S-1]."""
    bsz, s, d = x.shape
    d_in = cfg.ssm_expand * d
    hdim = cfg.ssm_head_dim
    nh = d_in // hdim
    g, n = cfg.ssm_groups, cfg.ssm_state
    k = cfg.conv_kernel

    z, xs, bc, dt = _split_in_proj(cfg, x @ p.in_proj)
    xbc_raw = torch.cat([xs, bc], dim=-1)
    xbc = F.silu(causal_conv(xbc_raw, p.conv_w, p.conv_b))
    xs, b, c = torch.split(xbc, [d_in, g * n, g * n], -1)
    dt = F.softplus(dt + p.dt_bias[None, None])              # (B, S, H)
    a = -torch.exp(p.a_log)                                  # (H,)

    y, state_fin = ssd_scan(xs.reshape(bsz, s, nh, hdim), dt, a,
                            b.reshape(bsz, s, g, n), c.reshape(bsz, s, g, n),
                            p.d_skip, chunk=cfg.ssm_chunk,
                            remat_body=cfg.inner_remat)
    y = y.reshape(bsz, s, d_in)
    y = rmsnorm(y * F.silu(z), p.norm_scale)
    out = y @ p.out_proj
    if return_state:
        # the last k-1 inputs, zero-padded at the front so prompts shorter
        # than the conv kernel still yield the fixed (B, C, K-1) state
        xbc_pad = F.pad(xbc_raw, (0, 0, k - 1, 0))
        conv = xbc_pad[:, s:, :].transpose(1, 2)             # (B, C, K-1)
        return out, SSMState(conv=conv, state=state_fin)
    return out


def mamba2_decode(cfg, p, x: torch.Tensor, cache: SSMState):
    """x: (B, 1, D) -> (y (B, 1, D), the next SSMState)."""
    bsz, _, d = x.shape
    d_in = cfg.ssm_expand * d
    hdim = cfg.ssm_head_dim
    nh = d_in // hdim
    g, n = cfg.ssm_groups, cfg.ssm_state

    z, xs, bc, dt = _split_in_proj(cfg, x[:, 0] @ p.in_proj)
    xbc = torch.cat([xs, bc], dim=-1)                        # (B, conv_dim)
    window = torch.cat([cache.conv, xbc[:, :, None]], dim=-1)  # K wide
    conv_out = torch.einsum("bck,kc->bc", window, p.conv_w) + p.conv_b
    xbc = F.silu(conv_out)
    xs, b, c = torch.split(xbc, [d_in, g * n, g * n], -1)
    dt = F.softplus(dt + p.dt_bias[None])
    a = -torch.exp(p.a_log)
    state, y = ssd_decode_step(
        cache.state, xs.reshape(bsz, nh, hdim).float(), dt.float(), a,
        b.reshape(bsz, g, n).float(), c.reshape(bsz, g, n).float(),
        p.d_skip)
    y = y.reshape(bsz, d_in).to(x.dtype)
    y = rmsnorm(y * F.silu(z), p.norm_scale)
    out = (y @ p.out_proj)[:, None]
    return out, SSMState(conv=window[:, :, 1:], state=state)


def init_ssm_state(cfg, batch: int, dtype=torch.float32, *,
                   layers: Optional[int] = None,
                   device=DEFAULT_DEVICE) -> SSMState:
    """Zero state: conv (B, conv_dim, K-1) in `dtype`, SSD state
    (B, H, P, N) float32, or with a leading (L,) axis given `layers`, on
    `device` (the card unless the caller asks for the CPU)."""
    device = resolve_device(device)
    d_in = cfg.ssm_expand * cfg.d_model
    conv_dim = d_in + 2 * cfg.ssm_groups * cfg.ssm_state
    nh = d_in // cfg.ssm_head_dim
    lead = () if layers is None else (layers,)
    return SSMState(
        conv=torch.zeros((*lead, batch, conv_dim, cfg.conv_kernel - 1),
                         dtype=dtype, device=device),
        state=torch.zeros((*lead, batch, nh, cfg.ssm_head_dim,
                           cfg.ssm_state), dtype=torch.float32,
                          device=device))
