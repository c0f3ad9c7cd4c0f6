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
PyTorch here.

Placed (x a DTensor, `dist.sharding.use_placement`): each rank runs the
block on its own batch rows, the way `dist.placed` runs attention:

* Routing belongs to a group. Where this rank's rows are whole groups
  (train_4k, prefill_32k) it routes them alone; where a group spans the
  batch shards (decode_32k: one group of 128 tokens over the `data`
  ranks) the group's expert choices are gathered over the batch's mesh
  dims first, so every rank computes the group's capacity and queue
  positions as one device does and keeps its own rows' slots. Other
  ranks' tokens take no slot of this rank's buffer.
* The experts this rank holds: all of them, each expert's hidden dim
  split over `model` (Mixtral's `expert_sharding="tp"`: `w1`/`w3`
  column shards, `w2` a row shard), or E / model whole experts
  (DeepSeek's "ep"). Either way the block's output is this rank's part
  of a sum over the mesh dims that split the experts, reduced once
  (after the shared experts, split the same way, add theirs); the tokens
  and the gates enter through `placed.grad_sum_over`, whose backward
  sums their gradients over the same dims (Megatron's f and g).
* The load-balance loss is made of means over every group: the
  per-expert sums of probabilities and choices are summed over the batch
  shards before the product, so every rank holds one device's loss.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

GROUP = 512


def _router_probs(router, xg: torch.Tensor) -> torch.Tensor:
    """Float32 softmax of the router's logits over the experts."""
    logits = xg @ router.to(xg.dtype)
    return torch.softmax(logits.float(), dim=-1)


def _top_k(probs: torch.Tensor, k: int):
    """(gate values normalised over the k choices, expert ids)."""
    gate_vals, gate_idx = torch.topk(probs, k, dim=-1)
    return gate_vals / torch.sum(gate_vals, -1, keepdim=True), gate_idx


def _onehot(gate_idx: torch.Tensor, e: int) -> torch.Tensor:
    """gate_idx (G, T, K) -> the (G, T, K, E) float32 one-hot of the
    choices. F.one_hot's values, by comparison: an id outside [0, E)
    (another rank's choice as a fake process group's gather leaves it)
    has none rather than stopping the device."""
    experts = torch.arange(e, device=gate_idx.device)
    return (gate_idx[..., None] == experts).float()


def _queue(cfg, onehot: torch.Tensor, mask=None):
    """Capacity and queue positions of groups' choices: the (G, T, K, E)
    one-hot of the choices -> it with masked tokens zeroed, pos and keep
    (G, T, K), and cap. Each expert's queue runs over the flattened
    (token, choice) order of its group, so a first and a second choice
    never share a slot."""
    e, k = cfg.num_experts, cfg.top_k
    t = onehot.shape[1]
    cap = max(1, int(cfg.capacity_factor * k * t / e))
    if mask is not None:
        onehot = onehot * mask[:, :, None, None].to(onehot.dtype)
    oh_flat = onehot.reshape(-1, t * k, e)
    pos_flat = torch.cumsum(oh_flat, dim=1) - oh_flat
    pos = pos_flat.reshape(-1, t, k, e)
    pos = torch.sum(pos * onehot, dim=-1).to(torch.int32)    # (G, T, K)
    keep = pos < cap
    if mask is not None:
        keep = keep & mask[:, :, None]
    return onehot, pos, keep, cap


def _route(cfg, p, xg: torch.Tensor, mask=None, need_aux: bool = True):
    """Shared routing: gates, expert ids, capacity slots, aux loss.

    xg: (G, T, D) -> gate_vals / gate_idx / pos / keep (G, T, K), cap,
    the aux loss (0-d float32; 0.0 unless `need_aux`) and the
    (G, T, K, E) float32 one-hot of the choices. mask: optional (G, T)
    bool; False tokens claim no capacity slot and combine to zero, so an
    idle decode slot's token never displaces a live one from an expert's
    queue (capacity is shared across the batch)."""
    e = cfg.num_experts
    probs = _router_probs(p.router, xg)                      # (G, T, E)
    gate_vals, gate_idx = _top_k(probs, cfg.top_k)           # (G, T, K)
    onehot = _onehot(gate_idx, e)                            # (G, T, K, E)
    aux = 0.0
    if need_aux:
        # load-balance loss (Switch): E * sum_e f_e * p_e
        me = torch.mean(probs, dim=(0, 1))
        ce = torch.mean(torch.sum(onehot, dim=2), dim=(0, 1))
        aux = e * torch.sum(me * ce)
    onehot, pos, keep, cap = _queue(cfg, onehot, mask)
    return gate_vals, gate_idx, pos, keep, cap, aux, onehot


def _swiglu(xin: torch.Tensor, w1, w3, w2) -> torch.Tensor:
    """xin (E, G, C, D) -> (E, G, C, D) through each expert's SwiGLU, as
    (E, G·C, D) x (E, D, F) batched products."""
    e, g, c, d = xin.shape
    x = xin.reshape(e, g * c, d)
    h = F.silu(torch.bmm(x, w1.to(x.dtype))) * torch.bmm(x, w3.to(x.dtype))
    return torch.bmm(h, w2.to(x.dtype)).reshape(e, g, c, -1)


def _sorted(xg, gate_vals, gate_idx, pos, keep, cap: int, experts,
            e_range: tuple):
    """Indexed dispatch and combine: O(T·k·D) data movement. `experts`
    runs the experts [e0, e0 + n) of `e_range` = (e0, n, E) on their
    (n, G, C, D) slots; the other experts' slots combine to zero."""
    g, t, d = xg.shape
    k = gate_idx.shape[-1]
    e0, n, e = e_range
    e_flat = gate_idx.reshape(g, t * k)
    p_flat = torch.where(keep, pos, cap).reshape(g, t * k).long()
    g_flat = torch.arange(g, device=xg.device)[:, None].expand(g, t * k)
    x_rep = torch.repeat_interleave(xg, k, dim=1)            # (G, T*K, D)
    buf = torch.zeros((g, e, cap + 1, d), dtype=xg.dtype, device=xg.device)
    # kept (expert, slot) pairs are unique; dropped entries collide in the
    # overflow slot `cap`, which is cut off
    buf.index_put_((g_flat, e_flat, p_flat), x_rep)
    out = experts(buf[:, e0:e0 + n, :cap].transpose(0, 1))   # (n, G, C, D)
    out = F.pad(out.transpose(0, 1), (0, 0, 0, 1, e0, e - e0 - n))
    y = out[g_flat, e_flat, p_flat]                          # (G, T*K, D)
    w = (gate_vals * keep).reshape(g, t * k, 1).to(xg.dtype)
    return torch.sum((y * w).reshape(g, t, k, d), dim=2)


def _einsum(xg, gate_vals, pos, keep, onehot, cap: int, experts,
            e_range: tuple):
    """One-hot dispatch and combine: O(T·E·C) data movement, over the
    experts [e0, e0 + n) of `e_range` = (e0, n, E)."""
    e0, n, _ = e_range
    onehot = onehot[..., e0:e0 + n]
    # one-hot of the slot; a position at or past cap has none (as
    # jax.nn.one_hot gives zeros out of range)
    slots = torch.arange(cap, device=xg.device)
    pos_oh = (pos[..., None] == slots).float() * keep[..., None]
    dispatch = torch.einsum("gtke,gtkc->gtec", onehot, pos_oh)
    combine = torch.einsum("gtke,gtkc,gtk->gtec", onehot, pos_oh,
                           gate_vals.float())
    xin = torch.einsum("gtec,gtd->egcd", dispatch.to(xg.dtype), xg)
    out = experts(xin)
    return torch.einsum("gtec,egcd->gtd", combine.to(xg.dtype), out)


def _dispatch(cfg, xg, gate_vals, gate_idx, pos, keep, cap, onehot,
              experts, e_range):
    if getattr(cfg, "moe_dispatch", "sorted") == "einsum":
        return _einsum(xg, gate_vals, pos, keep, onehot, cap, experts,
                       e_range)
    return _sorted(xg, gate_vals, gate_idx, pos, keep, cap, experts,
                   e_range)


def _shared(xg, w1, w3, w2):
    """DeepSeek's shared experts: one dense SwiGLU."""
    return (F.silu(xg @ w1) * (xg @ w3)) @ w2


def _groups(tokens: int) -> int:
    g = max(1, tokens // GROUP)
    if tokens % g:
        raise ValueError(
            f"moe_block: {tokens} tokens do not split into {g} groups of "
            f"{tokens // g} (GROUP {GROUP}); the JAX package's reshape "
            "fails on the same shape")
    return g


def moe_block(cfg, p, x: torch.Tensor, token_mask=None, *,
              need_aux: bool = True):
    """x: (B, S, D) -> ((B, S, D), load-balance aux loss).

    token_mask: optional (B, S) bool: False tokens neither claim expert
    capacity nor produce output (see `_route`); None on the prefill
    path, as in the JAX package. The aux loss is computed (and, placed,
    its sums reduced over the batch shards) only where `need_aux`
    (training); otherwise it is 0.0. A placed x runs `_placed_block`
    (see the module docstring)."""
    from repro_torch.dist import placed
    if placed.is_placed(x):
        return _placed_block(cfg, p, x, token_mask, need_aux)
    b, s, d = x.shape
    tokens = b * s
    g = _groups(tokens)
    xg = x.reshape(g, tokens // g, d)
    mg = None if token_mask is None else token_mask.reshape(g, tokens // g)
    gate_vals, gate_idx, pos, keep, cap, aux, onehot = _route(
        cfg, p, xg, mg, need_aux)
    e = cfg.num_experts
    y = _dispatch(cfg, xg, gate_vals, gate_idx, pos, keep, cap, onehot,
                  lambda xin: _swiglu(xin, p.w1, p.w3, p.w2), (0, e, e))
    if cfg.num_shared_experts:
        y = y + _shared(xg, p.shared_w1, p.shared_w3, p.shared_w2)
    return y.reshape(b, s, d), aux


def _placed_block(cfg, p, x, token_mask, need_aux: bool):
    """`moe_block` on this rank's batch rows of a placed x (the module
    docstring's placement)."""
    from repro_torch.dist import placed
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.top_k
    tokens = b * s
    t = tokens // _groups(tokens)
    mesh = x.device_mesh
    rows = placed.batch_dims(x)
    xl = placed.local_rows(x, rows)
    nl = xl.shape[0] * s
    t0 = placed.dim_offset(x, 0) * s           # this rank's first token
    xf = xl.reshape(nl, d)
    probs = _router_probs(placed.local_param(p.router, rows), xf)
    gate_vals, gate_idx = _top_k(probs, k)
    first, last = t0 // t, (t0 + nl - 1) // t
    gs, off = last - first + 1, t0 - first * t
    span = slice(first * t, (last + 1) * t)
    whole = off == 0 and nl == gs * t
    if whole:                    # this rank's rows are whole groups
        idx = gate_idx.view(gs, t, k)
    else:                        # the groups span the batch shards
        idx = placed.gather_rows(gate_idx.to(torch.int32), mesh, rows,
                                 tokens)[span].long().view(gs, t, k)
    mask = None
    if token_mask is not None:
        mask = placed.whole(token_mask).reshape(tokens)[span].view(gs, t)
    onehot = _onehot(idx, e)
    if need_aux:                 # this rank's tokens' choices, per expert
        chosen = onehot.view(gs * t, k, e)[off:off + nl].sum((0, 1))
    onehot, pos, keep, cap = _queue(cfg, onehot, mask)
    if not whole:                # other ranks' tokens take no slot here
        mine = torch.arange(gs * t, device=xl.device)
        mine = ((mine >= off) & (mine < off + nl)).view(gs, t, 1)
        keep = keep & mine
        onehot = onehot * mine[..., None].to(onehot.dtype)
        idx = torch.where(mine, idx, 0)
    pad = (off, gs * t - off - nl)
    xg = F.pad(xf, (0, 0, *pad)).view(gs, t, d)
    gv = F.pad(gate_vals, (0, 0, *pad)).view(gs, t, k)

    w1, w3, w2 = (placed.local_param(w, rows) for w in (p.w1, p.w3, p.w2))
    n = w1.shape[0]
    e_range = (placed.dim_offset(p.w1, 0), n, e)
    split = placed.split_dims(p.w1, (0, 2))
    y = _dispatch(cfg, placed.grad_sum_over(xg, mesh, split),
                  placed.grad_sum_over(gv, mesh, split), idx, pos, keep,
                  cap, onehot, lambda xin: _swiglu(xin, w1, w3, w2),
                  e_range)
    if cfg.num_shared_experts:
        sw = [placed.local_param(w, rows)
              for w in (p.shared_w1, p.shared_w3, p.shared_w2)]
        s_split = placed.split_dims(p.shared_w1, (1,))
        hs = _shared(placed.grad_sum_over(xg, mesh, s_split), *sw)
        if s_split == split:
            y = y + hs
        else:
            y = placed.sum_over(y, mesh, split) + placed.sum_over(
                hs, mesh, s_split)
            split = ()
    y = placed.sum_over(y, mesh, split).reshape(gs * t, d)[off:off + nl]
    out = placed.wrap(y.reshape(xl.shape), mesh, x.placements, x.shape)
    if not need_aux:
        return out, 0.0
    # the means over every group: sums over this rank's tokens, summed
    # over the batch shards
    sums = torch.stack([probs.sum(0), chosen])
    me, ce = placed.sum_over(sums, mesh, rows) / tokens
    from torch.distributed.tensor import Replicate
    return out, placed.wrap(e * torch.sum(me * ce), mesh,
                            [Replicate()] * mesh.ndim, ())

