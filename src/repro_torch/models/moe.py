"""Mixture-of-Experts: grouped top-k routing with capacity, GShard style
(port of `repro/models/moe.py`).

Tokens go in groups of about GROUP: (B, S) tokens become g = max(1,
B·S // GROUP) groups of B·S // g, and B·S must be a multiple of g, as in
the JAX package (which fails on the reshape otherwise; here a ValueError
says so). In each group every expert takes at most
cap = max(1, int(capacity_factor · k · T / E)) of the group's (token,
choice) entries, in the flattened (token, choice) order; the rest are
dropped and combine to zero.

Two dispatches (`cfg.moe_dispatch`), which agree:

  sorted (default): each kept (token, choice) entry is written into an
    (E, C + 1, D) buffer of its group at (expert, slot) and read back
    weighted by its gate; dropped entries go to the extra overflow slot,
    which is cut off. Every kept (expert, slot) holds exactly one entry,
    so a plain (non-accumulating) indexed write fills the buffer
    deterministically where the JAX package adds into zeros: the same
    values.
  einsum: the one-hot formulation, (G, T, E, C) dispatch and combine
    tensors contracted with the tokens and the expert outputs (DeepSeek's
    `moe_dispatch="einsum"`).

The experts are a per-expert SwiGLU as batched matrix products. MoE is
plain XLA in the JAX package, with no Pallas kernel, so it is plain
PyTorch here. The JAX package's sharding constraints (experts over
`model` or d_ff over `model`) have no counterpart on one card.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

GROUP = 512


def _route(cfg, p, xg: torch.Tensor, mask=None):
    """Shared routing: gates, expert ids, capacity slots, aux loss.

    xg: (G, T, D) -> gate_vals / gate_idx / pos / keep (G, T, K), cap,
    the aux loss (0-d float32) and the (G, T, K, E) float32 one-hot of
    the choices. mask: optional (G, T) bool; False tokens claim no
    capacity slot and combine to zero, so an idle decode slot's token
    never displaces a live one from an expert's queue (capacity is shared
    across the batch)."""
    e, k = cfg.num_experts, cfg.top_k
    t = xg.shape[1]
    logits = xg @ p.router.to(xg.dtype)                      # (G, T, E)
    probs = torch.softmax(logits.float(), dim=-1)
    gate_vals, gate_idx = torch.topk(probs, k, dim=-1)       # (G, T, K)
    gate_vals = gate_vals / torch.sum(gate_vals, -1, keepdim=True)

    # load-balance loss (Switch): E * sum_e f_e * p_e
    onehot = F.one_hot(gate_idx, e).float()                  # (G, T, K, E)
    me = torch.mean(probs, dim=(0, 1))
    ce = torch.mean(torch.sum(onehot, dim=2), dim=(0, 1))
    aux = e * torch.sum(me * ce)

    cap = max(1, int(cfg.capacity_factor * k * t / e))
    # queue position per expert over the flattened (token, choice) order,
    # so a first and a second choice never share a slot
    if mask is not None:
        onehot = onehot * mask[:, :, None, None].to(onehot.dtype)
    oh_flat = onehot.reshape(-1, t * k, e)
    pos_flat = torch.cumsum(oh_flat, dim=1) - oh_flat
    pos = pos_flat.reshape(-1, t, k, e)
    pos = torch.sum(pos * onehot, dim=-1).to(torch.int32)    # (G, T, K)
    keep = pos < cap
    if mask is not None:
        keep = keep & mask[:, :, None]
    return gate_vals, gate_idx, pos, keep, cap, aux, onehot


def _experts(cfg, p, xin: torch.Tensor) -> torch.Tensor:
    """xin (E, G, C, D) -> (E, G, C, D) through each expert's SwiGLU, as
    (E, G·C, D) x (E, D, F) batched products."""
    e, g, c, d = xin.shape
    x = xin.reshape(e, g * c, d)
    h = F.silu(torch.bmm(x, p.w1.to(x.dtype))) * torch.bmm(
        x, p.w3.to(x.dtype))
    return torch.bmm(h, p.w2.to(x.dtype)).reshape(e, g, c, d)


def _moe_sorted(cfg, p, xg: torch.Tensor, mask=None):
    """Indexed dispatch and combine: O(T·k·D) data movement."""
    g, t, d = xg.shape
    e, k = cfg.num_experts, cfg.top_k
    gate_vals, gate_idx, pos, keep, cap, aux, _ = _route(cfg, p, xg, mask)

    e_flat = gate_idx.reshape(g, t * k)
    p_flat = torch.where(keep, pos, cap).reshape(g, t * k).long()
    g_flat = torch.arange(g, device=xg.device)[:, None].expand(g, t * k)
    x_rep = torch.repeat_interleave(xg, k, dim=1)            # (G, T*K, D)
    buf = torch.zeros((g, e, cap + 1, d), dtype=xg.dtype, device=xg.device)
    # kept (expert, slot) pairs are unique; dropped entries collide in the
    # overflow slot `cap`, which is cut off
    buf.index_put_((g_flat, e_flat, p_flat), x_rep)
    out = _experts(cfg, p, buf[:, :, :cap].transpose(0, 1))  # (E, G, C, D)
    out = F.pad(out.transpose(0, 1), (0, 0, 0, 1))           # (G, E, C+1, D)
    y = out[g_flat, e_flat, p_flat]                          # (G, T*K, D)
    w = (gate_vals * keep).reshape(g, t * k, 1).to(xg.dtype)
    y = torch.sum((y * w).reshape(g, t, k, d), dim=2)
    return y, aux


def _moe_einsum(cfg, p, xg: torch.Tensor, mask=None):
    """One-hot dispatch and combine: O(T·E·C) data movement."""
    gate_vals, gate_idx, pos, keep, cap, aux, onehot = _route(cfg, p, xg,
                                                              mask)
    # one-hot of the slot; a position at or past cap has none (as
    # jax.nn.one_hot gives zeros out of range)
    slots = torch.arange(cap, device=xg.device)
    pos_oh = (pos[..., None] == slots).float() * keep[..., None]
    dispatch = torch.einsum("gtke,gtkc->gtec", onehot, pos_oh)
    combine = torch.einsum("gtke,gtkc,gtk->gtec", onehot, pos_oh,
                           gate_vals.float())
    xin = torch.einsum("gtec,gtd->egcd", dispatch.to(xg.dtype), xg)
    out = _experts(cfg, p, xin)
    y = torch.einsum("gtec,egcd->gtd", combine.to(xg.dtype), out)
    return y, aux


def moe_block(cfg, p, x: torch.Tensor, token_mask=None):
    """x: (B, S, D) -> ((B, S, D), load-balance aux loss).

    token_mask: optional (B, S) bool: False tokens neither claim expert
    capacity nor produce output (see `_route`); None on the prefill
    path, as in the JAX package."""
    b, s, d = x.shape
    tokens = b * s
    g = max(1, tokens // GROUP)
    if tokens % g:
        raise ValueError(
            f"moe_block: {tokens} tokens do not split into {g} groups of "
            f"{tokens // g} (GROUP {GROUP}); the JAX package's reshape "
            "fails on the same shape")
    xg = x.reshape(g, tokens // g, d)
    mg = None if token_mask is None else token_mask.reshape(g, tokens // g)

    if getattr(cfg, "moe_dispatch", "sorted") == "einsum":
        y, aux = _moe_einsum(cfg, p, xg, mg)
    else:
        y, aux = _moe_sorted(cfg, p, xg, mg)

    if cfg.num_shared_experts:
        hs = F.silu(xg @ p.shared_w1) * (xg @ p.shared_w3)
        y = y + hs @ p.shared_w2
    return y.reshape(b, s, d), aux
