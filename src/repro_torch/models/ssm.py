"""Mamba-2 (SSD: state-space duality) blocks (port of
`repro/models/ssm.py`).

The sequence is processed in chunks of Q = `cfg.ssm_chunk` tokens, blocks
of chunks at once, carrying the (B, H, P, N) float32 inter-chunk state from
chunk to chunk, so nothing quadratic in S is materialised: per chunk the
Q x Q lower-triangular decay ("intra-chunk attention"), the chunk's
contribution to the running state and the state's contribution to the
chunk's output (Dao & Gu 2024, minimal-SSD formulation). The chunk is
kept from the JAX package: it fixes where the dt = 0 padding falls and
how the arithmetic groups, so both run the same chunks. The JAX package
computes all of this in XLA, outside any Pallas kernel, so it is plain
PyTorch here on every device.

B and C are shared by the heads of a group: the products read each group's
(Q, N) rows through a broadcast head axis instead of a repeated copy, the
same dot products as the JAX package's repeat.

Decode is the O(1) recurrent update: state = state * exp(dt*A) + dt * x B^T.
A serving state (`SSMState`) holds the rolling conv window and the SSD
state with the layer axis first, as the port's KV caches do.

Placed (x a DTensor, `dist.sharding.use_placement`), `placed_mixer` runs
the mixer on each rank's batch rows and heads: the heads split as the
rules split `heads` (`model`), and the JAX layouts do not line up with
them, so the step regroups them:

* `in_proj` (D, z | x | B | C | dt) splits its columns evenly over
  `model`, across the parts. A rank needs its heads' z, x and dt
  columns and all of B and C (one group is every head's). Prefill and
  training gather the weight whole over `model` and cut those columns
  (the (B, S, 2·d_in + 2GN + H) product outweighs the weight; the
  backward reduce-scatters its gradient to the shard); a decode step's
  product is one row a sequence, so it multiplies by its own column
  shard and gathers the product instead.
* The conv weights (its x channels, B and C) are gathered whole and cut
  the same way. The decode state's conv window (B, conv_dim, K-1) is
  placed by channel over `model`, across the parts as well: a decode
  step gathers it whole, convolves its channels and writes the shifted
  window of its own channels back; the prefill writes the last K-1
  inputs of its own channels.
* The scan runs on the rank's heads (the heads' x, dt and decay, B and C
  whole), with no collective, and the SSD state (B, H, P, N) is placed
  by heads, so it stays local. JAX's one constraint in the block, x
  over ("batch", "seq", "ffn"), is this split: a rank's x channels are
  its heads'.
* The gated RMSNorm normalises over all of d_in: each rank's sum of
  squares over its heads' channels is summed over `model` first.
* `out_proj` is row-parallel: one all-reduce over `model`.
"""
from __future__ import annotations

import types
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.dist import placed
from repro_torch.dist import sharding as sh
from repro_torch.models.layers import causal_conv, rmsnorm


# the most elements of a block's (B, chunks, H, Q, Q) float32 products
SCAN_BLOCK_ELEMS = 1 << 26


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
    ignored.

    The chunks' own parts (the intra-chunk products, each chunk's
    contribution to the state and the decays) are computed for a block
    of chunks at once, as many as keep the block's (B, ·, H, Q, Q)
    float32 products within SCAN_BLOCK_ELEMS; only the inter-chunk
    recurrence state' = state·exp(total) + contribution runs chunk by
    chunk, two operations each. The arithmetic is the per-chunk body's,
    so a block's results are those of its chunks one at a time."""
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
    nc = (s + pad) // chunk
    blk = max(1, SCAN_BLOCK_ELEMS // (bsz * h * chunk * chunk))
    state = torch.zeros((bsz, h, p, n), dtype=torch.float32, device=x.device)
    ys = []
    for c0 in range(0, nc, blk):
        nb = min(blk, nc - c0)
        sl = slice(c0 * chunk, (c0 + nb) * chunk)
        r = bsz * nb             # the block's chunks as rows

        def rows(t):             # (B, nb·Q, K, ...) -> (B·nb, K, Q, ...)
            t = t[:, sl].float().reshape(bsz, nb, chunk, *t.shape[2:])
            return t.transpose(2, 3).reshape(r, t.shape[3], chunk,
                                             *t.shape[4:])
        # per-chunk float32 upcast, as the JAX body does
        xq = rows(x_p)                                       # (R, H, Q, P)
        dtq = rows(dt[..., None])[..., 0]                    # (R, H, Q)
        bq, cq = rows(b), rows(c)                            # (R, G, Q, N)
        da = dtq * a[None, :, None]                          # (R, H, Q)
        # intra-chunk: L[i, j] = exp(sum_{j<k<=i} da_k)
        ll = torch.exp(_segsum(da))                          # (R, H, Q, Q)
        scores = cq @ bq.transpose(-1, -2)                   # (R, G, Q, Q)
        m = _by_group(ll, g) * scores[:, :, None] \
            * _by_group(dtq, g)[..., None, :]              # (R, G, H/G, Q, K)
        y_diag = m @ _by_group(xq, g)                      # (R, G, H/G, Q, P)
        cum = torch.cumsum(da, dim=-1)                       # (R, H, Q)
        # chunk -> its contribution to the state
        total = cum[..., -1:]                                # (R, H, 1)
        w = dtq * torch.exp(total - cum)                     # (R, H, Q)
        contrib = (_by_group(xq * w[..., None], g).transpose(-1, -2)
                   @ bq[:, :, None]).reshape(bsz, nb, h, p, n)
        decay = torch.exp(total).reshape(bsz, nb, h, 1, 1)
        before = []              # the state entering each chunk
        for j in range(nb):
            before.append(state)
            state = state * decay[:, j] + contrib[:, j]
        before = torch.stack(before, 1).reshape(r, h, p, n)
        # state -> output (inter-chunk)
        y_off = (cq[:, :, None] @ _by_group(before, g).transpose(-1, -2)) \
            * _by_group(torch.exp(cum), g)[..., None]      # (R, G, H/G, Q, P)
        y = (y_diag + y_off).reshape(bsz, nb, h, chunk, p).to(x.dtype)
        ys.append(y.transpose(2, 3).reshape(bsz, nb * chunk, h, p))
    y = torch.cat(ys, dim=1)[:, :s]                          # (B, S, H, P)
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


def _mixer(cfg, p, zxbcdt, nh: int, g: int, *,
           cache: Optional[SSMState] = None, return_state: bool = False,
           norm=rmsnorm):
    """The mixer after `in_proj`, on `nh` heads of `g` groups. zxbcdt:
    (B, S, ·), those heads' columns z | x | B | C | dt; p: the conv's
    weights of their channels (x | B | C), their `dt_bias`, `a_log` and
    `d_skip`, and `norm_scale` and `out_proj`'s rows of their x channels.
    Without `cache` the chunked scan from a zero state (with
    `return_state`, the SSMState at S-1 besides); with `cache` (its conv
    window of those channels and state of those heads) one decode step
    (S = 1) and the next SSMState. `norm(v, scale)` is the gated RMSNorm
    over all of d_in. Returns out (B, S, D) [, SSMState]."""
    bsz, s = zxbcdt.shape[:2]
    hdim, n, k = cfg.ssm_head_dim, cfg.ssm_state, cfg.conv_kernel
    d_in = nh * hdim
    z, xs, bc, dt = torch.split(zxbcdt, [d_in, d_in, 2 * g * n, nh], -1)
    xbc_raw = torch.cat([xs, bc], dim=-1)                    # (B, S, C)
    a = -torch.exp(p.a_log)                                  # (H,)
    if cache is None:
        xbc = F.silu(causal_conv(xbc_raw, p.conv_w, p.conv_b))
        xs, b, c = torch.split(xbc, [d_in, g * n, g * n], -1)
        dt = F.softplus(dt + p.dt_bias[None, None])          # (B, S, H)
        y, state = ssd_scan(xs.reshape(bsz, s, nh, hdim), dt, a,
                            b.reshape(bsz, s, g, n), c.reshape(bsz, s, g, n),
                            p.d_skip, chunk=cfg.ssm_chunk,
                            remat_body=cfg.inner_remat)
        y = y.reshape(bsz, s, d_in)
        if return_state:
            # the last k-1 inputs, zero-padded at the front so prompts
            # shorter than the conv kernel still yield the fixed
            # (B, C, K-1) state
            conv = F.pad(xbc_raw, (0, 0, k - 1, 0))[:, s:, :].transpose(1, 2)
    else:
        window = torch.cat([cache.conv, xbc_raw[:, 0, :, None]], -1)
        xbc = F.silu(torch.einsum("bck,kc->bc", window, p.conv_w) + p.conv_b)
        xs, b, c = torch.split(xbc, [d_in, g * n, g * n], -1)
        dt = F.softplus(dt[:, 0] + p.dt_bias[None])
        state, y = ssd_decode_step(
            cache.state, xs.reshape(bsz, nh, hdim).float(), dt.float(), a,
            b.reshape(bsz, g, n).float(), c.reshape(bsz, g, n).float(),
            p.d_skip)
        y = y.reshape(bsz, 1, d_in).to(zxbcdt.dtype)
        conv, return_state = window[:, :, 1:], True
    out = norm(y * F.silu(z), p.norm_scale) @ p.out_proj
    return (out, SSMState(conv=conv, state=state)) if return_state else out


def _heads(cfg) -> int:
    return cfg.ssm_expand * cfg.d_model // cfg.ssm_head_dim


def mamba2_block(cfg, p, x: torch.Tensor, *, return_state: bool = False):
    """Full Mamba-2 mixer. x: (B, S, D) -> (B, S, D) [, SSMState at S-1]."""
    return _mixer(cfg, p, x @ p.in_proj, _heads(cfg), cfg.ssm_groups,
                  return_state=return_state)


def mamba2_decode(cfg, p, x: torch.Tensor, cache: SSMState):
    """x: (B, 1, D) -> (y (B, 1, D), the next SSMState)."""
    return _mixer(cfg, p, x @ p.in_proj, _heads(cfg), cfg.ssm_groups,
                  cache=cache)


def placed_mixer(cfg, p, x, *, cache: Optional[SSMState] = None,
                 decode: bool = False):
    """The Mamba-2 mixer on placed x (B, S, D) (the module docstring's
    placement): training with no `cache`, a prefill that writes `cache`
    (a placed `SSMState` layer view), or a decode step (x (B, 1, D)) that
    reads and advances it. `_mixer` runs on the rank's rows and heads,
    the gated RMSNorm's sum of squares summed over `model`; its partial
    output is summed over `model`. Returns the placed (B, S, D) output;
    the cache is written in place."""
    bsz, s, d = x.shape
    d_in = cfg.ssm_expand * d
    hdim = cfg.ssm_head_dim
    nh = d_in // hdim
    g, n = cfg.ssm_groups, cfg.ssm_state
    k = cfg.conv_kernel
    mesh, rules = sh.current_context()
    heads, h0, hl = placed.split_of(mesh, rules, "heads", nh)
    rep = nh // g                   # heads a group
    g0, g1 = h0 // rep, (h0 + hl - 1) // rep + 1
    if g1 - g0 > 1 and (h0 % rep or hl % rep):
        raise NotImplementedError(
            f"placed Mamba 2: heads [{h0}, {h0 + hl}) split groups of "
            f"{rep} heads")
    gl = g1 - g0
    rows = placed.batch_dims(x)
    split = rows + heads
    xl = placed.grad_sum_over(placed.local_rows(x, rows), mesh, heads)
    # this rank's channels of the conv's x | B | C, and its columns of
    # in_proj's z | x | B | C | dt
    cr = [(h0 * hdim, hl * hdim), (d_in + g0 * n, gl * n),
          (d_in + g * n + g0 * n, gl * n)]
    pr = [(h0 * hdim, hl * hdim)] + [(d_in + a, m) for a, m in cr] + [
        (2 * d_in + 2 * g * n + h0, hl)]
    lp = types.SimpleNamespace(
        **{name: torch.cat(placed.local_parts(w, w.ndim - 1, cr, split), -1)
           for name in ("conv_w", "conv_b") for w in (getattr(p, name),)},
        **{name: placed.local_parts(getattr(p, name), 0, [(h0, hl)],
                                    split)[0]
           for name in ("dt_bias", "a_log", "d_skip")},
        norm_scale=placed.local_parts(p.norm_scale, 0,
                                      [(h0 * hdim, hl * hdim)], split)[0],
        out_proj=placed.local_parts(p.out_proj, 0, [(h0 * hdim, hl * hdim)],
                                    split)[0])

    def norm(v, scale):
        # over all d_in channels: the sum of squares of this rank's heads'
        # channels, summed over the heads' ranks (each rank normalises
        # its own channels by it, so its gradient is summed over them too)
        vf = v.float()
        ms = placed.grad_sum_over(placed.sum_over(
            torch.sum(torch.square(vf), -1, keepdim=True), mesh, heads),
            mesh, heads) / d_in
        return (vf * torch.rsqrt(ms + 1e-6) * (1.0 + scale.float())).to(
            v.dtype)

    if decode:
        # one row a sequence: the rank's column shard of the product,
        # gathered whole
        wl = placed.local_parts(p.in_proj, 1, [(
            placed.dim_offset(p.in_proj, 1), p.in_proj.to_local().shape[1])],
            rows)[0]
        whole = placed.gather_last(
            (xl @ wl)[:, 0], mesh, rows,
            placed.split_dims(p.in_proj, (1,)), (bsz, p.in_proj.shape[1]))
        zxbcdt = torch.cat([whole[:, a:a + m] for a, m in pr], -1)[:, None]
        conv = cache.conv
        c0, cl = placed.dim_offset(conv, 1), conv.to_local().shape[1]
        window_all = placed.gather_last(
            conv.to_local().transpose(1, 2).contiguous(), mesh, rows,
            placed.split_dims(conv, (1,)),
            (bsz, k - 1, conv.shape[1])).transpose(1, 2)   # (B, C, K-1)
        st = cache.state.to_local()
        out, new = _mixer(
            cfg, lp, zxbcdt, hl, gl, norm=norm, cache=SSMState(
                torch.cat([window_all[:, a:a + m] for a, m in cr], 1), st))
        # the window shifted, with this step's inputs of the rank's own
        # channels (other ranks' heads' x among them) appended
        new_in = whole[:, d_in:2 * d_in + 2 * g * n]
        conv.to_local().copy_(torch.cat(
            [window_all[:, c0:c0 + cl, 1:], new_in[:, c0:c0 + cl, None]],
            -1))
        st.copy_(new.state)
    else:
        zxbcdt = xl @ torch.cat(placed.local_parts(p.in_proj, 1, pr, split),
                                -1)
        out = _mixer(cfg, lp, zxbcdt, hl, gl, norm=norm,
                     return_state=cache is not None)
        if cache is not None:
            out, new = out
            if gl != g:
                raise NotImplementedError(
                    "placed Mamba 2 prefill: B and C split by group")
            cache.state.to_local().copy_(new.state)
            # the last K-1 inputs of every channel (zeros before the
            # prompt), the x part gathered over the heads' ranks
            tail = new.conv.transpose(1, 2)                  # (B, K-1, ·)
            x_all = placed.gather_last(
                tail[..., :hl * hdim].contiguous(), mesh, rows, heads,
                (bsz, k - 1, d_in))
            conv = cache.conv
            c0, cl = placed.dim_offset(conv, 1), conv.to_local().shape[1]
            conv.to_local().copy_(torch.cat([x_all, tail[..., hl * hdim:]],
                                            -1)[:, :, c0:c0 + cl]
                                  .transpose(1, 2))
    out = placed.sum_over(out, mesh, heads)
    return placed.wrap(out, mesh, x.placements, x.shape)


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
