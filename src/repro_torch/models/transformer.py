"""Model assembly of the LM zoo (port of `repro/models/transformer.py`, the
dense family).

A model is a list of *segments*, each a homogeneous group of layers; a
layer is (mixer, ffn). The JAX package scans each segment over stacked
parameters. Here the layers of a segment are an `nn.ModuleList` run by a
Python loop, and the parameter tree keeps the JAX dict keys as attribute
names: `params.embed`, `params.segments[0].l0[i]` for layer i (with `ln1`,
`mixer.wq`/`wk`/`wv`/`wo`, `ln2`, `ffn.w1`/`w2`/`w3`), `params.final_norm`
and `params.lm_head`.

Serving state: the KV cache of a segment is one preallocated tensor per K
and per V, (L, B, Hkv, W, hd) bf16 (stacked also for a one-layer segment),
written in place — prefill writes the prompt's keys, each decode step one
key per sequence — where the JAX package returns new arrays. So
`forward_decode` updates the caches of the state it is given and returns
them in a state with the advanced positions.

A paged serving state holds a shared block pool per segment instead
(`kvcache.PagedAttnCache`); `forward_decode(block_tables=)` writes each
sequence's key at (block_table[b, pos // BS], pos % BS) and attends over
the slot's gathered logical view under the same kv_len mask as the
contiguous path.

Only the dense family with GQA attention runs here. MoE and MLA (ROADMAP
Queue 1 item 4.2), SSM and recurrent (4.3), encoder-decoder and patch
models (4.4) and the quantised cache (4.5) raise `NotImplementedError`
naming their item; `forward_train` waits for the LM train steps (4.6).
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.models import kvcache
from repro_torch.models.layers import (apply_norm, apply_rope,
                                       chunked_attention, decode_attention,
                                       mlp)

_ROADMAP = "ROADMAP.md, Queue 1 item 4"

# ---------------------------------------------------------------------------
# Segments
# ---------------------------------------------------------------------------


class LayerSpec(NamedTuple):
    mixer: str
    ffn: str
    cross: bool = False


class Segment(NamedTuple):
    name: str
    layers: tuple          # tuple[LayerSpec]
    repeat: int


def arch_segments(cfg: ArchConfig) -> list:
    if cfg.family == "ssm":
        return [Segment("ssd", (LayerSpec("ssd", "none"),), cfg.num_layers)]
    if cfg.family == "hybrid":
        pat = tuple(LayerSpec(m, "mlp") for m in cfg.block_pattern)
        groups = cfg.num_layers // len(pat)
        segs = [Segment("group", pat, groups)]
        tail = cfg.num_layers % len(pat)
        if tail:
            segs.append(Segment("tail", pat[:tail], 1))
        return segs
    mixer = {"mla": "mla"}.get(cfg.attn_kind,
                               "local" if cfg.sliding_window else "attn")
    if cfg.num_experts:
        segs = []
        if cfg.first_dense_layers:
            segs.append(Segment("dense", (LayerSpec(mixer, "mlp"),),
                                cfg.first_dense_layers))
        segs.append(Segment("moe", (LayerSpec(mixer, "moe"),),
                            cfg.num_layers - cfg.first_dense_layers))
        return segs
    cross = cfg.cross_attention
    return [Segment("decoder", (LayerSpec(mixer, "mlp", cross),),
                    cfg.num_layers)]


def check_supported(cfg: ArchConfig) -> None:
    """Raise NotImplementedError naming the ROADMAP item for anything but a
    dense GQA model with a bf16 cache."""
    waits = None
    if cfg.num_experts or cfg.attn_kind == "mla":
        waits = "MoE (Mixtral with banded SWA, DeepSeek MLA)", ".2"
    elif cfg.family in ("ssm", "hybrid"):
        waits = "SSM and hybrid (Mamba 2, RecurrentGemma)", ".3"
    elif (cfg.encoder_layers or cfg.cross_attention or cfg.patch_tokens
          or cfg.max_positions):
        waits = ("the encoder-decoder and patch models (Whisper, InternVL2)",
                 ".4")
    elif cfg.kv_cache_dtype != "bf16":
        waits = "the int8/int4 KV cache (Qwen 1.5)", ".5"
    elif cfg.family != "dense" or cfg.attn_kind != "gqa":
        waits = f"the {cfg.family} family", ""
    if waits:
        raise NotImplementedError(
            f"{cfg.name}: the port runs the dense GQA family only; "
            f"{waits[0]} is not ported yet ({_ROADMAP}{waits[1]})")


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


class ParamTree(nn.Module):
    """A nested parameter dict as modules: tensors become (frozen)
    parameters, dicts sub-trees and lists `nn.ModuleList`s, under the
    dict's keys."""

    def __init__(self, tree: dict):
        super().__init__()
        for name, val in tree.items():
            if isinstance(val, torch.Tensor):
                self.register_parameter(
                    name, nn.Parameter(val, requires_grad=False))
            elif isinstance(val, dict):
                self.add_module(name, ParamTree(val))
            else:
                self.add_module(name, nn.ModuleList(
                    ParamTree(x) for x in val))


class Builder:
    """The JAX schema's `init` mode: each `param` call draws one tensor
    with the schema's distribution from a seeded generator on the target
    device — fan-in-scaled normal, `normal_1` (normal x 0.02), zeros or
    ones. The numbers differ from JAX's (Philox, not threefry); the
    distributions do not."""

    def __init__(self, generator: torch.Generator, dtype=torch.float32,
                 device=None):
        self.generator = generator
        self.dtype = dtype
        self.device = device

    def param(self, shape, *, init="fan_in", fan_in=None) -> torch.Tensor:
        kw = dict(dtype=self.dtype, device=self.device)
        if init == "zeros":
            return torch.zeros(shape, **kw)
        if init == "ones":
            return torch.ones(shape, **kw)
        out = torch.randn(shape, generator=self.generator, **kw)
        if init == "normal_1":
            return out.mul_(0.02)
        fi = fan_in if fan_in is not None else shape[-2] if len(shape) >= 2 \
            else shape[-1]
        return out.mul_((1.0 / max(1, fi)) ** 0.5)


def _norm_params(bld, cfg, dim=None):
    d = dim or cfg.d_model
    if cfg.norm == "layernorm":
        return {"scale": bld.param((d,), init="ones"),
                "bias": bld.param((d,), init="zeros")}
    return {"scale": bld.param((d,), init="zeros")}


def _attn_params(bld, cfg):
    d, hd = cfg.d_model, cfg.resolved_head_dim
    h, hkv = cfg.num_heads, cfg.num_kv_heads
    p = {
        "wq": bld.param((d, h * hd)),
        "wk": bld.param((d, hkv * hd)),
        "wv": bld.param((d, hkv * hd)),
        "wo": bld.param((h * hd, d)),
    }
    if cfg.qkv_bias:
        p["bq"] = bld.param((h * hd,), init="zeros")
        p["bk"] = bld.param((hkv * hd,), init="zeros")
        p["bv"] = bld.param((hkv * hd,), init="zeros")
    return p


def _mlp_params(bld, cfg):
    d, f = cfg.d_model, cfg.d_ff
    p = {"w1": bld.param((d, f)), "w2": bld.param((f, d))}
    if cfg.act == "swiglu":
        p["w3"] = bld.param((d, f))
    else:
        p["b1"] = bld.param((f,), init="zeros")
        p["b2"] = bld.param((d,), init="zeros")
    return p


def _layer_params(bld, cfg, spec: LayerSpec):
    return {"ln1": _norm_params(bld, cfg), "mixer": _attn_params(bld, cfg),
            "ln2": _norm_params(bld, cfg), "ffn": _mlp_params(bld, cfg)}


def _build(cfg: ArchConfig, bld: Builder) -> dict:
    """The parameter tree as nested dicts; a segment's `l{i}` is the list
    of its `repeat` layers (the JAX package stacks them on a leading
    axis)."""
    check_supported(cfg)
    d, v = cfg.d_model, cfg.padded_vocab
    params: dict = {"embed": bld.param((v, d), init="normal_1")}
    params["segments"] = [
        {f"l{i}": [_layer_params(bld, cfg, ls) for _ in range(seg.repeat)]
         for i, ls in enumerate(seg.layers)}
        for seg in arch_segments(cfg)]
    params["final_norm"] = _norm_params(bld, cfg)
    if not cfg.tie_embeddings:
        params["lm_head"] = bld.param((d, v), init="normal_1")
    return params


def init_params(cfg: ArchConfig, generator: torch.Generator, *,
                dtype=torch.float32, device=DEFAULT_DEVICE) -> ParamTree:
    """Random parameters drawn on `device` from `generator` (a
    `torch.Generator` on that device): at full width every tensor is
    filled on the card, with no host copy."""
    dev = resolve_device(device)
    return ParamTree(_build(cfg, Builder(generator, dtype, dev)))


def param_count(params: nn.Module) -> int:
    return sum(p.numel() for p in params.parameters())


# ---------------------------------------------------------------------------
# Mixer
# ---------------------------------------------------------------------------

def _qkv(cfg, p, x):
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    q = x @ p.wq
    k = x @ p.wk
    v = x @ p.wv
    if cfg.qkv_bias:
        q, k, v = q + p.bq, k + p.bk, v + p.bv
    return (q.view(b, s, cfg.num_heads, hd),
            k.view(b, s, cfg.num_kv_heads, hd),
            v.view(b, s, cfg.num_kv_heads, hd))


def attn_mixer(cfg, p, x, positions, *, window: int, mode: str, cache,
               pos=None, block_table=None):
    """Causal GQA attention; a ring-buffer cache when window > 0.

    prefill: attention over the prompt through `chunked_attention` (the
    flash kernel on the card), and the prompt's last W keys and values
    written into `cache` (width W). decode (x (B, 1, D), pos (B,)): one
    key and value per sequence written at pos % W, then `decode_attention`
    over the cache; on a paged pool at (block_table[b, pos // BS],
    pos % BS), then over the slot's gathered view, MB·BS == max_len wide,
    so the same kv_len mask makes paged decode equal to contiguous decode.
    Returns x @ wo; the cache is updated in place."""
    b, s, _ = x.shape
    q, k, v = _qkv(cfg, p, x)
    if cfg.rope_theta > 0:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    q, k, v = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    w = cache.k.shape[-2]
    if mode == "prefill":
        out = chunked_attention(q, k, v, causal=True, window=window,
                                chunk=cfg.attn_chunk,
                                remat_body=cfg.inner_remat)
        keep = min(w, s)
        slots = torch.arange(s - keep, s, device=x.device) % w
        kvcache.cache_write(cache, k[:, :, s - keep:], v[:, :, s - keep:],
                            slots)
    elif isinstance(cache, kvcache.PagedAttnCache):
        bs = cache.k.shape[-2]
        mb = block_table.shape[1]
        # a frozen (inactive) slot's pos stays in its table's range; the
        # clamp mirrors JAX's clamped take_along_axis all the same
        logical = torch.clamp(pos // bs, max=mb - 1).to(torch.long)
        blk = torch.gather(block_table.to(torch.long), 1, logical[:, None])
        kvcache.paged_cache_write_at(cache, k, v, blk[:, 0], pos % bs)
        kf, vf = kvcache.paged_gather(cache, block_table,
                                      dtype=torch.bfloat16)
        kv_len = torch.clamp(pos + 1, max=mb * bs)
        out = decode_attention(q, kf, vf, kv_len=kv_len, window=0)
    else:
        kvcache.cache_write_at(cache, k, v, pos % w)
        kf, vf = kvcache.cache_read(cache, dtype=torch.bfloat16)
        kv_len = torch.clamp(pos + 1, max=w)
        out = decode_attention(q, kf, vf, kv_len=kv_len,
                               window=0)  # the ring buffer bounds the window
    out = out.transpose(1, 2).reshape(b, s, -1)
    return out @ p.wo


# ---------------------------------------------------------------------------
# Layers and caches
# ---------------------------------------------------------------------------

def _apply_layer(cfg, spec: LayerSpec, p, x, positions, *, mode, cache,
                 pos=None, block_table=None):
    """x after one layer (norm -> attention -> residual, norm -> MLP ->
    residual); `cache` is updated in place."""
    if spec.mixer not in ("attn", "local") or spec.ffn != "mlp" \
            or spec.cross:
        raise _unsupported_layer(spec)
    h = apply_norm(cfg, p.ln1, x)
    x = x + attn_mixer(cfg, p.mixer, h, positions, window=cfg.sliding_window,
                       mode=mode, cache=cache, pos=pos,
                       block_table=block_table)
    return x + mlp(cfg, p.ffn, apply_norm(cfg, p.ln2, x))


def _unsupported_layer(spec: LayerSpec) -> NotImplementedError:
    return NotImplementedError(
        f"layer {spec} is not ported yet: the port runs attention + MLP "
        f"layers ({_ROADMAP})")


def _empty_layer_cache(cfg, spec: LayerSpec, batch: int, width: int, *,
                       layers: Optional[int] = None, device=DEFAULT_DEVICE):
    if spec.mixer not in ("attn", "local"):
        raise _unsupported_layer(spec)
    return kvcache.init_attn_cache(batch, cfg.num_kv_heads,
                                   _cache_width(cfg, spec, width),
                                   cfg.resolved_head_dim, cfg.kv_cache_dtype,
                                   layers=layers, device=device)


def _cache_width(cfg, spec: LayerSpec, width: int) -> int:
    """A sliding-window layer keeps a ring buffer of its window."""
    if cfg.sliding_window:
        return min(width, cfg.sliding_window)
    return width


def init_cache(cfg: ArchConfig, batch: int, max_len: int, *,
               device=DEFAULT_DEVICE) -> list:
    """Per segment, {"l{i}": AttnCache} with (L, B, Hkv, W, hd) zeros on
    `device` (the card unless the caller asks for the CPU)."""
    check_supported(cfg)
    return [{f"l{i}": _empty_layer_cache(cfg, ls, batch, max_len,
                                         layers=seg.repeat, device=device)
             for i, ls in enumerate(seg.layers)}
            for seg in arch_segments(cfg)]


# ---------------------------------------------------------------------------
# Forward passes
# ---------------------------------------------------------------------------

def _embed_tokens(cfg, params, tokens):
    return params.embed[tokens.long()]


def _logits(cfg, params, x):
    x = apply_norm(cfg, params.final_norm, x)
    head = params.embed.T if cfg.tie_embeddings else params.lm_head
    return x @ head


class ServeState(NamedTuple):
    caches: Any           # per segment {"l{i}": AttnCache (L, B, Hkv, W, hd)
    #                       or PagedAttnCache (L, Hkv, NB, BS, hd)}
    cross: Any            # per segment cross kv (encoder-decoder) or None
    pos: torch.Tensor     # (B,) int32: next position index per sequence


def _layers(cfg, params, caches):
    """(spec, layer params, layer cache view) in execution order."""
    for seg, seg_p, seg_c in zip(arch_segments(cfg), params.segments,
                                 caches):
        for li in range(seg.repeat):
            for i, ls in enumerate(seg.layers):
                yield ls, getattr(seg_p, f"l{i}")[li], seg_c[f"l{i}"].layer(li)


def forward_prefill(cfg: ArchConfig, params, tokens: torch.Tensor, *,
                    max_len: int, length=None):
    """Process the prompt (B, S), build caches of width max_len; returns
    (last-position logits (B, 1, V), ServeState).

    length: None, an int or 0-d tensor, or a (B,) vector of per-sequence
    real prompt lengths when `tokens` is right-padded. Logits come from
    position length - 1 of each row and pos starts at length; keys written
    for padded positions sit above the decode mask (kv_len = pos + 1) and
    are overwritten before they become visible."""
    check_supported(cfg)
    x = _embed_tokens(cfg, params, tokens)
    b, s = tokens.shape
    positions = torch.arange(s, device=x.device)
    caches = init_cache(cfg, b, max_len, device=x.device)
    for ls, lp, lc in _layers(cfg, params, caches):
        x = _apply_layer(cfg, ls, lp, x, positions, mode="prefill", cache=lc)
    if length is None:
        last = x[:, -1:]
        next_pos = torch.full((b,), s, dtype=torch.int32, device=x.device)
    elif not isinstance(length, torch.Tensor) or length.ndim == 0:
        n = int(length)
        last = x[:, n - 1:n]
        next_pos = torch.full((b,), n, dtype=torch.int32, device=x.device)
    else:
        length = length.to(x.device)
        idx = (length - 1).long()
        last = x[torch.arange(b, device=x.device)[:, None], idx[:, None]]
        next_pos = length.to(torch.int32)
    logits = _logits(cfg, params, last)
    return logits, ServeState(caches=caches, cross=[None] * len(caches),
                              pos=next_pos)


def forward_decode(cfg: ArchConfig, params, token: torch.Tensor,
                   state: ServeState, *, block_tables=None, token_mask=None):
    """One decode step. token: (B, 1) -> (logits (B, 1, V), new state).

    The caches of `state` are updated in place and shared by the returned
    state, whose pos is state.pos + 1. block_tables: (B, max_blocks) int
    when the state holds paged pools, shared by every layer; None for a
    contiguous state. token_mask: a (B,) bool of live rows, which only MoE
    layers read (dense rows are independent)."""
    del token_mask
    check_supported(cfg)
    paged = [isinstance(c, kvcache.PagedAttnCache)
             for seg in state.caches for c in seg.values()]
    if any(paged) and block_tables is None:
        raise ValueError("a paged serving state needs block_tables")
    if block_tables is not None and not any(paged):
        raise ValueError("block_tables given for a contiguous serving state")
    x = _embed_tokens(cfg, params, token)
    positions = state.pos[:, None]
    for ls, lp, lc in _layers(cfg, params, state.caches):
        x = _apply_layer(cfg, ls, lp, x, positions, mode="decode", cache=lc,
                         pos=state.pos, block_table=block_tables)
    logits = _logits(cfg, params, x)
    return logits, ServeState(caches=state.caches, cross=state.cross,
                              pos=state.pos + 1)
