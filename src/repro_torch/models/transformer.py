"""Model assembly of the LM zoo (port of `repro/models/transformer.py`: the
dense, MoE, SSM and hybrid families).

A model is a list of *segments*, each a homogeneous group of layers; a
layer is (mixer, ffn). The JAX package scans each segment over stacked
parameters. Here the layers of a segment are an `nn.ModuleList` run by a
Python loop, and the parameter tree keeps the JAX dict keys as attribute
names: `params.embed`, `params.segments[0].l0[i]` for layer i (with `ln1`,
`mixer.wq`/`wk`/`wv`/`wo`, `ln2`, `ffn.w1`/`w2`/`w3`), `params.final_norm`
and `params.lm_head`. An MoE layer's `ffn` holds `router` (D, E) and the
experts' `w1`/`w3` (E, D, F) and `w2` (E, F, D), with DeepSeek's shared
experts as `shared_w1`/`w3`/`w2`; an MLA layer's `mixer` holds `wq`,
`w_dkv`, `kv_norm`, `w_uk` (r, H, nd), `w_uv` (r, H, vd) and `wo`. A
Mamba 2 layer (`ssd`) has `ln1` and `mixer` only (`in_proj`, `conv_w`,
`conv_b`, `dt_bias`, `a_log`, `d_skip`, `norm_scale`, `out_proj`); a
RecurrentGemma recurrent layer (`rec`) holds `w_in_rec`, `w_in_gate`,
`w_out`, `conv_w`, `conv_b`, `w_a`, `b_a`, `w_x`, `b_x` and `lam`. Whisper adds
`params.pos_embed` (learned positions, max_positions x D), a decoder
layer's `ln_cross` and `cross` (`wq`/`wk`/`wv`/`wo` with their biases)
and the encoder: `params.encoder.segments[0].l0[i]` for its layer i
(attention and MLP, as a decoder layer without cross attention) and
`params.encoder.final_norm`.

Serving state: the KV cache of a segment is one preallocated tensor per K
and per V, (L, B, Hkv, W, hd) bf16 (stacked also for a one-layer segment),
or, with `kv_cache_dtype` "int8" or "int4", integer payloads and float32
scales a token (`kvcache.AttnCache`), written in place — prefill writes
the prompt's keys, each decode step one key per sequence — where the JAX
package returns new arrays. So
`forward_decode` updates the caches of the state it is given and returns
them in a state with the advanced positions. Prefill attends over the
float keys and values and then writes them, quantised where the cache is;
decode attends over the cache read back (dequantised) in bf16.

An MLA layer caches its float32 latent and bf16 rotary key instead,
(L, B, W, r) and (L, B, W, rd) (`kvcache.MLACache`), and decodes in the
absorbed form over them. A sliding-window layer (Mixtral) keeps a ring of
min(max_len, window) keys; so does a hybrid's `local` layer, whose window
is `cfg.local_window`. A Mamba 2 layer keeps `ssm.SSMState` (its conv
window and SSD state) and an RG-LRU layer `rglru.RGState`, both with the
layer axis first and updated in place like the caches. On a mesh (x a
DTensor) both layers run their module's `placed_mixer` on each rank's
shards.

A paged serving state holds a shared block pool per segment instead
(`kvcache.PagedAttnCache`, `kvcache.PagedMLACache`);
`forward_decode(block_tables=)` writes each sequence's key or latent at
(block_table[b, pos // BS], pos % BS) and attends over the slot's
gathered logical view under the same kv_len mask as the contiguous path.

Whisper's prefill runs the encoder over the audio frames (non-causal
self-attention, no cache) and fills `ServeState.cross` with each
cross-attention layer's keys and values over its output (`CrossKV`, per
segment); decode reads them there. InternVL2's prefill puts its patch
rows ahead of the prompt: they take the first cache rows and positions,
and `pos` starts past them.

Every family of the zoo runs here: the dense and MoE families, with GQA
(full or sliding-window) or MLA attention, the SSM (Mamba 2) and hybrid
(RecurrentGemma) families, the encoder-decoder (Whisper) and the patch
model (InternVL2), with a bf16, int8 or int4 KV cache.

Training (`forward_train`) runs every family too, under autograd: the
layers in mode "train" write no cache or state, the attention is the
differentiable `ops.FlashAttention` (the flash kernel forward, a plain
backward), and with `remat` each segment body is recomputed in the
backward pass (`torch.utils.checkpoint`), as the JAX package's
`jax.checkpoint(nothing_saveable)` does.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.dist import placed
from repro_torch.dist import sharding as sh
from repro_torch.dist.sharding import logical_constraint
from repro_torch.models import kvcache, moe, rglru, ssm
from repro_torch.models.layers import (apply_norm, apply_rope,
                                       banded_attention, chunked_attention,
                                       decode_attention, matmul, mlp,
                                       rmsnorm, sinusoidal_positions)

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


_FAMILIES = ("dense", "moe", "ssm", "hybrid", "audio", "vlm")


def check_supported(cfg: ArchConfig) -> None:
    """Raise NotImplementedError for a config outside the zoo's families:
    anything but a dense, MoE, SSM, hybrid, encoder-decoder (audio) or
    patch (vlm) model with GQA or MLA attention (none for SSM). Any KV
    cache dtype the cache takes (bf16, int8, int4) runs."""
    if cfg.family not in _FAMILIES or (
            cfg.family != "ssm" and cfg.attn_kind not in ("gqa", "mla")):
        raise NotImplementedError(
            f"{cfg.name}: the port runs the dense, MoE, SSM, hybrid, audio "
            f"and vlm families with GQA or MLA attention, not the "
            f"{cfg.family} family with {cfg.attn_kind!r} attention")


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


class ParamTree(nn.Module):
    """A nested parameter dict as modules: tensors become parameters,
    dicts sub-trees and lists `nn.ModuleList`s, under the dict's keys.
    Parameters are frozen (`requires_grad=False`) unless `requires_grad`
    is set: the train step's compute copy takes gradients, the master
    weights and every serving tree do not."""

    def __init__(self, tree: dict, requires_grad: bool = False):
        super().__init__()
        for name, val in tree.items():
            if isinstance(val, torch.Tensor):
                self.register_parameter(name, nn.Parameter(
                    val, requires_grad=(requires_grad
                                        and val.is_floating_point())))
            elif isinstance(val, dict):
                self.add_module(name, ParamTree(val, requires_grad))
            else:
                self.add_module(name, nn.ModuleList(
                    ParamTree(x, requires_grad) for x in val))


class Builder:
    """The JAX schema's three modes. `init`: each `param` call draws one
    tensor with the schema's distribution from a seeded generator on the
    target device — fan-in-scaled normal, `normal_1` (normal x 0.02),
    zeros or ones. The numbers differ from JAX's (Philox, not threefry);
    the distributions do not. `shape`: a meta tensor of the shape and
    dtype, nothing allocated. `logical`: the parameter's logical axes,
    one name (or None) a dim, as the JAX schema gives them."""

    def __init__(self, generator: Optional[torch.Generator] = None,
                 dtype=torch.float32, device=None, *, mode: str = "init"):
        if mode not in ("init", "shape", "logical"):
            raise ValueError(f"Builder mode {mode!r}: init, shape or "
                             "logical")
        self.generator = generator
        self.dtype = dtype
        self.device = device
        self.mode = mode

    def param(self, shape, logical, *, init="fan_in", fan_in=None):
        if self.mode == "logical":
            return tuple(logical)
        if self.mode == "shape":
            return torch.empty(shape, dtype=self.dtype, device="meta")
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
        return {"scale": bld.param((d,), (None,), init="ones"),
                "bias": bld.param((d,), (None,), init="zeros")}
    return {"scale": bld.param((d,), (None,), init="zeros")}


def _attn_params(bld, cfg):
    d, hd = cfg.d_model, cfg.resolved_head_dim
    h, hkv = cfg.num_heads, cfg.num_kv_heads
    p = {
        "wq": bld.param((d, h * hd), ("fsdp", "tp")),
        "wk": bld.param((d, hkv * hd), ("fsdp", "tp")),
        "wv": bld.param((d, hkv * hd), ("fsdp", "tp")),
        "wo": bld.param((h * hd, d), ("tp", "fsdp")),
    }
    if cfg.qkv_bias:
        p["bq"] = bld.param((h * hd,), ("tp",), init="zeros")
        p["bk"] = bld.param((hkv * hd,), ("tp",), init="zeros")
        p["bv"] = bld.param((hkv * hd,), ("tp",), init="zeros")
    return p


def _mla_params(bld, cfg):
    d, h = cfg.d_model, cfg.num_heads
    r, nd, rd, vd = (cfg.kv_lora_rank, cfg.qk_nope_dim, cfg.qk_rope_dim,
                     cfg.v_head_dim)
    return {
        "wq": bld.param((d, h * (nd + rd)), ("fsdp", "tp")),
        "w_dkv": bld.param((d, r + rd), ("fsdp", None)),
        "kv_norm": bld.param((r,), (None,), init="zeros"),
        "w_uk": bld.param((r, h, nd), (None, "tp", None)),
        "w_uv": bld.param((r, h, vd), (None, "tp", None)),
        "wo": bld.param((h * vd, d), ("tp", "fsdp")),
    }


def _mlp_params(bld, cfg):
    d, f = cfg.d_model, cfg.d_ff
    p = {"w1": bld.param((d, f), ("fsdp", "tp")),
         "w2": bld.param((f, d), ("tp", "fsdp"))}
    if cfg.act == "swiglu":
        p["w3"] = bld.param((d, f), ("fsdp", "tp"))
    else:
        p["b1"] = bld.param((f,), ("tp",), init="zeros")
        p["b2"] = bld.param((d,), (None,), init="zeros")
    return p


def _moe_params(bld, cfg):
    d, f, e = cfg.d_model, cfg.moe_d_ff, cfg.num_experts
    ep = cfg.expert_sharding == "ep"
    e_ax = "experts" if ep else None
    f_ax = "expert_ffn" if ep else "tp"
    p = {
        "router": bld.param((d, e), ("fsdp", None), init="normal_1"),
        "w1": bld.param((e, d, f), (e_ax, "fsdp", f_ax), fan_in=d),
        "w3": bld.param((e, d, f), (e_ax, "fsdp", f_ax), fan_in=d),
        "w2": bld.param((e, f, d), (e_ax, f_ax, "fsdp"), fan_in=f),
    }
    if cfg.num_shared_experts:
        fs = f * cfg.num_shared_experts
        p["shared_w1"] = bld.param((d, fs), ("fsdp", "tp"))
        p["shared_w3"] = bld.param((d, fs), ("fsdp", "tp"))
        p["shared_w2"] = bld.param((fs, d), ("tp", "fsdp"))
    return p


def _ssd_params(bld, cfg):
    d = cfg.d_model
    d_in = cfg.ssm_expand * d
    g, n = cfg.ssm_groups, cfg.ssm_state
    nh = d_in // cfg.ssm_head_dim
    conv_dim = d_in + 2 * g * n
    return {
        "in_proj": bld.param((d, 2 * d_in + 2 * g * n + nh), ("fsdp", "tp")),
        "conv_w": bld.param((cfg.conv_kernel, conv_dim), (None, "tp")),
        "conv_b": bld.param((conv_dim,), ("tp",), init="zeros"),
        "dt_bias": bld.param((nh,), (None,), init="zeros"),
        "a_log": bld.param((nh,), (None,), init="zeros"),
        "d_skip": bld.param((nh,), (None,), init="ones"),
        "norm_scale": bld.param((d_in,), ("tp",), init="zeros"),
        "out_proj": bld.param((d_in, d), ("tp", "fsdp")),
    }


def _rec_params(bld, cfg):
    d = cfg.d_model
    w = cfg.lru_width or d
    return {
        "w_in_rec": bld.param((d, w), ("fsdp", "tp")),
        "w_in_gate": bld.param((d, w), ("fsdp", "tp")),
        "w_out": bld.param((w, d), ("tp", "fsdp")),
        "conv_w": bld.param((cfg.conv_kernel, w), (None, "tp")),
        "conv_b": bld.param((w,), ("tp",), init="zeros"),
        "w_a": bld.param((w,), ("tp",), init="ones"),
        "b_a": bld.param((w,), ("tp",), init="zeros"),
        "w_x": bld.param((w,), ("tp",), init="ones"),
        "b_x": bld.param((w,), ("tp",), init="zeros"),
        "lam": bld.param((w,), ("tp",), init="ones"),
    }


_ENCODER_LAYER = LayerSpec("attn", "mlp")
_MIXER_SCHEMA = {"attn": _attn_params, "local": _attn_params,
                 "mla": _mla_params, "ssd": _ssd_params, "rec": _rec_params}
_FFN_SCHEMA = {"mlp": _mlp_params, "moe": _moe_params}


def _layer_params(bld, cfg, spec: LayerSpec):
    p = {"ln1": _norm_params(bld, cfg),
         "mixer": _MIXER_SCHEMA[spec.mixer](bld, cfg)}
    if spec.ffn != "none":            # Mamba 2 has no FFN
        p["ln2"] = _norm_params(bld, cfg)
        p["ffn"] = _FFN_SCHEMA[spec.ffn](bld, cfg)
    if spec.cross:                    # Whisper's decoder layers
        p["ln_cross"] = _norm_params(bld, cfg)
        p["cross"] = _attn_params(bld, cfg)
    return p


def _build(cfg: ArchConfig, bld: Builder) -> dict:
    """The parameter tree as nested dicts; a segment's `l{i}` is the list
    of its `repeat` layers (the JAX package stacks them on a leading
    axis), and so is the encoder's."""
    check_supported(cfg)
    d, v = cfg.d_model, cfg.padded_vocab
    params: dict = {"embed": bld.param((v, d), ("vocab", "fsdp"),
                                       init="normal_1")}
    if cfg.max_positions:
        params["pos_embed"] = bld.param((cfg.max_positions, d),
                                        (None, "fsdp"), init="normal_1")
    params["segments"] = [
        {f"l{i}": [_layer_params(bld, cfg, ls) for _ in range(seg.repeat)]
         for i, ls in enumerate(seg.layers)}
        for seg in arch_segments(cfg)]
    params["final_norm"] = _norm_params(bld, cfg)
    if not cfg.tie_embeddings:
        params["lm_head"] = bld.param((d, v), ("fsdp", "vocab"),
                                      init="normal_1")
    if cfg.encoder_layers:
        params["encoder"] = {
            "segments": [{"l0": [_layer_params(bld, cfg, _ENCODER_LAYER)
                                 for _ in range(cfg.encoder_layers)]}],
            "final_norm": _norm_params(bld, cfg)}
    return params


def init_params(cfg: ArchConfig, generator: torch.Generator, *,
                dtype=torch.float32, device=DEFAULT_DEVICE) -> ParamTree:
    """Random parameters drawn on `device` from `generator` (a
    `torch.Generator` on that device): at full width every tensor is
    filled on the card, with no host copy."""
    dev = resolve_device(device)
    return ParamTree(_build(cfg, Builder(generator, dtype, dev)))


def param_shapes(cfg: ArchConfig, dtype=torch.float32) -> dict:
    """The parameter tree of `init_params` as meta tensors of its shapes
    and `dtype` (nested dicts and per-layer lists, as `_build` gives
    them): nothing is allocated."""
    return _build(cfg, Builder(dtype=dtype, mode="shape"))


def param_logical(cfg: ArchConfig) -> dict:
    """The logical axes of every parameter, in `param_shapes`' tree: the
    JAX schema's tuples, per layer (JAX's stacked leaves carry a leading
    None for the layer axis; `convert` maps the one tree onto the
    other)."""
    return _build(cfg, Builder(mode="logical"))


def param_count(params: nn.Module) -> int:
    return sum(p.numel() for p in params.parameters())


# ---------------------------------------------------------------------------
# Mixer
# ---------------------------------------------------------------------------

def _constrain_heads(x, heads: int, logical: tuple):
    """JAX's constraint of the (B, H, S, hd) attention operand, applied to
    its flat (B, S, H·hd) form before the view splits it: the entries of
    `logical` on the 4-d shape, moved onto the flat dims (batch, rows,
    heads·hd). DTensor cannot split a sharded flat dim that the heads do
    not divide evenly, so the placement comes first (identity outside a
    mesh context)."""
    ctx = sh.current_context()
    if ctx is None or not placed.is_placed(x):
        return x
    mesh, rules = ctx
    b, s, f = x.shape
    e = rules.resolve(logical, mesh, shape=(b, heads, s, f // heads))
    want = sh.placements((e[0], e[2], e[1]), mesh)
    return x if list(x.placements) == want else x.redistribute(mesh, want)


def _qkv(cfg, p, x):
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    q, k, v = matmul(x, p.wq), matmul(x, p.wk), matmul(x, p.wv)
    if cfg.qkv_bias:
        q, k, v = q + p.bq, k + p.bk, v + p.bv
    q = _constrain_heads(q, cfg.num_heads, ("batch", "heads", "ctx", None))
    k = _constrain_heads(k, cfg.num_kv_heads, ("batch", "kv_heads", None,
                                               None))
    v = _constrain_heads(v, cfg.num_kv_heads, ("batch", "kv_heads", None,
                                               None))
    return (q.view(b, s, cfg.num_heads, hd),
            k.view(b, s, cfg.num_kv_heads, hd),
            v.view(b, s, cfg.num_kv_heads, hd))


def attn_mixer(cfg, p, x, positions, *, window: int, mode: str, cache,
               pos=None, block_table=None, causal: bool = True):
    """GQA attention, causal unless `causal=False`; a ring-buffer cache
    when window > 0.

    prefill: attention over the prompt through `chunked_attention`, or
    `banded_attention` for a causal banded sliding window (the flash
    kernel on the card either way), and the prompt's last W keys and
    values written into `cache` (width W). train and encode: the same
    attention with no cache (`cache` None; Whisper's encoder runs it with
    causal=False), differentiable (`ops.FlashAttention`). decode
    (x (B, 1, D), pos (B,)): one key and value per sequence written at
    pos % W, then `decode_attention` over the cache; on a paged pool at
    (block_table[b, pos // BS], pos % BS), then over the slot's gathered
    view, MB·BS == max_len wide, so the same kv_len mask makes paged
    decode equal to contiguous decode.
    Returns x @ wo; the cache is updated in place."""
    b, s, _ = x.shape
    q, k, v = _qkv(cfg, p, x)
    if cfg.rope_theta > 0:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    q, k, v = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    if mode in ("prefill", "encode", "train"):
        if window > 0 and causal and cfg.banded_swa:
            out = banded_attention(q, k, v, window=window,
                                   q_block=cfg.attn_chunk,
                                   remat_body=cfg.inner_remat)
        else:
            out = chunked_attention(q, k, v, causal=causal, window=window,
                                    chunk=cfg.attn_chunk,
                                    remat_body=cfg.inner_remat)
        if mode == "prefill":
            w = cache.k.shape[-2]
            keep = min(w, s)
            kvcache.cache_write_span(cache, k[:, :, s - keep:],
                                     v[:, :, s - keep:], s - keep, w)
    elif isinstance(cache, kvcache.PagedAttnCache):
        bs = cache.k.shape[-2]
        mb = block_table.shape[1]
        kvcache.paged_cache_write_at(cache, k, v, _block_of(block_table, pos,
                                                            bs), pos % bs)
        kf, vf = kvcache.paged_gather(cache, block_table,
                                      dtype=torch.bfloat16)
        kv_len = torch.clamp(pos + 1, max=mb * bs)
        out = decode_attention(q, kf, vf, kv_len=kv_len, window=0)
    else:
        w = cache.k.shape[-2]
        kvcache.cache_write_at(cache, k, v, pos % w)
        kf, vf = kvcache.cache_read(cache, dtype=torch.bfloat16)
        kv_len = torch.clamp(pos + 1, max=w)
        out = decode_attention(q, kf, vf, kv_len=kv_len,
                               window=0)  # the ring buffer bounds the window
    # rows split by query (`ctx`) come whole again before the heads are
    # flattened into the output projection's rows: the residual stream
    # keeps JAX's ("batch", "seq", None), where JAX's MLP constraint wants
    # it whole (identity outside a mesh context)
    out = logical_constraint(out, ("batch", "heads", None, None))
    out = out.transpose(1, 2).reshape(b, s, -1)
    return logical_constraint(matmul(out, p.wo), ("batch", "seq", None))


def _block_of(block_table, pos, bs: int):
    """Each sequence's physical block of position `pos` (B,): its table
    row's entry pos // BS. A frozen (inactive) slot's pos stays in its
    table's range; the clamp mirrors JAX's clamped take_along_axis all the
    same."""
    mb = block_table.shape[1]
    logical = torch.clamp(pos // bs, max=mb - 1).to(torch.long)
    return torch.gather(block_table.to(torch.long), 1, logical[:, None])[:, 0]


def cross_mixer(cfg, p, x, *, cross=None, enc_out=None):
    """Whisper's cross attention: queries from the decoder's x (B, S, D),
    keys and values over the encoder's F frames, non-causal through
    `chunked_attention` (the flash kernel on the card).

    With `enc_out` (B, F, D), K and V are projected from it (with the
    biases where the layer has them) in the dtype the encoder's output
    and the weights promote to (float32 frames keep them float32 over
    bf16 weights, as in the JAX package): at prefill written into
    `cross` (a `CrossKV` view, (B, Hkv, F, hd)) and read there; in
    training (`cross` None) used as they are, with no write. Without
    `enc_out`, a decode step reads them from `cross`. The queries meet
    them in the wider dtype and the output comes back in the queries'
    (JAX's `chunked_attention` on bf16 queries and float32 keys). On a
    mesh the queries are placed as the self-attention's (by heads, else
    by query rows) and K and V as JAX constrains them (by kv_heads, else
    whole over `model`). Returns the output projection (B, S, D)."""
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    q = matmul(x, p.wq)
    if hasattr(p, "bq"):
        q = q + p.bq
    q = _constrain_heads(q, cfg.num_heads, ("batch", "heads", "ctx", None))
    q = q.view(b, s, cfg.num_heads, hd).transpose(1, 2)
    if enc_out is not None:
        f = enc_out.shape[1]
        kv = []
        for name in ("k", "v"):
            y = matmul(enc_out, getattr(p, "w" + name))
            if hasattr(p, "b" + name):
                y = y + getattr(p, "b" + name)
            y = _constrain_heads(y, cfg.num_kv_heads,
                                 ("batch", "kv_heads", None, None))
            kv.append(y.view(b, f, cfg.num_kv_heads, hd).transpose(1, 2))
        if cross is not None:
            for dst, src in zip(cross, kv):
                if placed.is_placed(dst):      # this rank's rows, in place
                    src = src.redistribute(dst.device_mesh, dst.placements)
                    dst.to_local().copy_(src.to_local())
                else:
                    dst.copy_(src)
    k, v = (kv if cross is None else (cross.k, cross.v))
    dt = torch.promote_types(q.dtype, k.dtype)
    out = chunked_attention(q.to(dt), k.to(dt), v.to(dt), causal=False,
                            chunk=cfg.attn_chunk,
                            remat_body=cfg.inner_remat).to(q.dtype)
    # as the self-attention's output: rows split by query come whole
    # before the heads are flattened (identity outside a mesh context)
    out = logical_constraint(out, ("batch", "heads", None, None))
    out = out.transpose(1, 2).reshape(b, s, -1)
    return logical_constraint(matmul(out, p.wo), ("batch", "seq", None))


def mla_mixer(cfg, p, x, positions, *, mode: str, cache, pos=None,
              block_table=None):
    """DeepSeek-V2 multi-head latent attention.

    prefill: keys [w_uk·latent, shared rotary key] (D_qk = nd + rd) and
    values w_uv·latent (vd) through `chunked_attention` (the flash
    kernel's (192, 128) instantiation at full width) with scale
    1/sqrt(nd + rd); the prompt's last W latents and rotary keys written
    into `cache`. train: the same attention, no cache. decode
    (x (B, 1, D), pos (B,)): the absorbed form in float32, q_nope·w_uk
    scored against the latent cache plus q_rope against the rotary keys,
    softmax under kv_len = min(pos + 1, W), and the context's latent
    mapped through w_uv; on a paged pool over the slot's gathered view.
    Returns x @ wo; the cache is updated in place."""
    b, s, _ = x.shape
    h = cfg.num_heads
    r, nd, rd, vd = (cfg.kv_lora_rank, cfg.qk_nope_dim, cfg.qk_rope_dim,
                     cfg.v_head_dim)
    scale = 1.0 / ((nd + rd) ** 0.5)

    heads = ("batch", "heads", "ctx", None)
    q = _constrain_heads(x @ p.wq, h, heads).view(b, s, h, nd + rd)
    qn, qr = q[..., :nd], q[..., nd:]
    qr = apply_rope(qr, positions, cfg.rope_theta)
    dkv = x @ p.w_dkv
    ckv, kr = dkv[..., :r], dkv[..., r:]
    ckv = rmsnorm(ckv, p.kv_norm)
    kr = apply_rope(kr[:, :, None, :], positions, cfg.rope_theta)[:, :, 0]

    if mode in ("prefill", "train"):
        # plain products over the latent (the JAX package's einsums), so
        # k and v come out contiguous with real strides for the kernel;
        # the shared rotary key is copied into every head's columns. On
        # a mesh q, k and v are placed by heads, as JAX constrains them
        # (`dist.placed.attention` then runs each rank's heads)
        kv_heads = ("batch", "heads", None, None)
        kn = _constrain_heads(ckv @ p.w_uk.reshape(r, h * nd), h,
                              kv_heads).view(b, s, h, nd)
        v = _constrain_heads(ckv @ p.w_uv.reshape(r, h * vd), h,
                             kv_heads).view(b, s, h, vd)
        kr_h = kr[:, :, None].expand(b, s, h, rd)
        if placed.is_placed(kn):      # the shared key's copy on kn's heads
            kr_h = kr_h.redistribute(kn.device_mesh, kn.placements)
        k = torch.cat([kn, kr_h], dim=-1)
        qf = torch.cat([qn, qr], dim=-1)
        out = chunked_attention(qf.transpose(1, 2), k.transpose(1, 2),
                                v.transpose(1, 2), causal=True,
                                chunk=cfg.attn_chunk, scale=scale,
                                remat_body=cfg.inner_remat)
        out = logical_constraint(out, ("batch", "heads", None, None))
        out = out.transpose(1, 2).reshape(b, s, h * vd)
        if mode == "prefill":
            w = cache.ckv.shape[-2]
            keep = min(w, s)
            kvcache.mla_cache_write_span(cache, ckv[:, s - keep:],
                                         kr[:, s - keep:], s - keep, w)
    elif placed.is_placed(cache.ckv):
        # the latent's positions split over `model` as the heads are:
        # each rank scores its positions for every head (`dist.placed`)
        w = cache.ckv.shape[1]
        kvcache.mla_cache_write_at(cache, ckv, kr, pos % w)
        out = placed.mla_decode_attention(
            qn, qr, p.w_uk, p.w_uv, cache.ckv, cache.krope,
            kv_len=torch.clamp(pos + 1, max=w), scale=scale).to(x.dtype)
    else:
        if isinstance(cache, kvcache.PagedMLACache):
            bs = cache.ckv.shape[-2]
            blk = _block_of(block_table, pos, bs)
            kvcache.mla_paged_cache_write_at(cache, ckv, kr, blk, pos % bs)
            ckv_all, kr_all = kvcache.mla_paged_gather(cache, block_table)
            w = block_table.shape[1] * bs
        else:
            w = cache.ckv.shape[1]
            kvcache.mla_cache_write_at(cache, ckv, kr, pos % w)
            ckv_all = cache.ckv.float()                      # (B, W, r)
            kr_all = cache.krope.float()                     # (B, W, rd)
        q_abs = torch.einsum("bhn,rhn->bhr", qn[:, 0].float(),
                             p.w_uk.float())
        scores = (torch.einsum("bhr,bwr->bhw", q_abs, ckv_all)
                  + torch.einsum("bhd,bwd->bhw", qr[:, 0].float(),
                                 kr_all)) * scale
        valid = torch.clamp(pos + 1, max=w)
        mask = (torch.arange(w, device=x.device)[None, None]
                < valid[:, None, None])
        scores = torch.where(mask, scores,
                             torch.tensor(-1e30, device=x.device))
        attn = torch.softmax(scores, dim=-1)
        ctx = torch.einsum("bhw,bwr->bhr", attn, ckv_all)
        out = torch.einsum("bhr,rhv->bhv", ctx, p.w_uv.float())
        out = out.reshape(b, 1, h * vd).to(x.dtype)
    # the row-parallel output projection's sum, whole on the residual's
    # placement (identity outside a mesh context)
    return logical_constraint(out @ p.wo, ("batch", "seq", None))


# ---------------------------------------------------------------------------
# Layers and caches
# ---------------------------------------------------------------------------

def _apply_layer(cfg, spec: LayerSpec, p, x, positions, *, mode, cache=None,
                 pos=None, block_table=None, token_mask=None, cross=None,
                 enc_out=None):
    """(x after one layer, the layer's MoE aux loss): norm -> mixer ->
    residual, then (a cross layer) norm -> cross attention -> residual,
    then (unless the layer has none) norm -> MLP or MoE -> residual;
    `cache` (a KV cache, or an SSM or RG-LRU state) is updated in place.
    mode "encode" (Whisper's encoder): non-causal attention, no cache.
    mode "train": no cache and no state, nothing written in place (the
    SSD and RG-LRU blocks run from a zero state, a cross layer projects
    `enc_out` itself), so autograd can take the layer's gradient.
    cross: a cross layer's `CrossKV` view, written from `enc_out` at
    prefill and read at decode. token_mask: (B,) bool of live rows, which
    only an MoE layer reads (as its routing mask); any other layer's aux
    loss is 0.0."""
    if spec.mixer not in ("attn", "local", "mla", "ssd", "rec") \
            or spec.ffn not in ("mlp", "moe", "none"):
        raise _unsupported_layer(spec)
    if placed.is_placed(x):
        p = placed.gather_fsdp(p)     # this layer's weights, FSDP-style
    h = apply_norm(cfg, p.ln1, x)
    if spec.mixer == "mla":
        out = mla_mixer(cfg, p.mixer, h, positions, mode=mode, cache=cache,
                        pos=pos, block_table=block_table)
    elif spec.mixer in ("ssd", "rec"):
        block, step = ((ssm.mamba2_block, ssm.mamba2_decode)
                       if spec.mixer == "ssd" else
                       (rglru.recurrent_block, rglru.recurrent_block_decode))
        if placed.is_placed(h):       # each rank's rows, heads or channels
            module = ssm if spec.mixer == "ssd" else rglru
            out = module.placed_mixer(cfg, p.mixer, h, cache=cache,
                                      decode=mode == "decode")
        elif mode == "train":
            out = block(cfg, p.mixer, h)
        else:
            if mode == "prefill":
                out, new = block(cfg, p.mixer, h, return_state=True)
            else:
                out, new = step(cfg, p.mixer, h, cache)
            for dst, src in zip(cache, new):
                dst.copy_(src)
    else:
        out = attn_mixer(cfg, p.mixer, h, positions,
                         window=_window(cfg, spec), mode=mode, cache=cache,
                         pos=pos, block_table=block_table,
                         causal=mode != "encode")
    x = x + out
    if spec.cross:
        out = cross_mixer(cfg, p.cross, apply_norm(cfg, p.ln_cross, x),
                          cross=cross, enc_out=enc_out)
        x = x + out
    if spec.ffn == "none":
        return x, 0.0
    if spec.ffn == "mlp":
        # the MLP's row-parallel sum lands whole on the residual's
        # placement (identity outside a mesh context)
        return logical_constraint(x + mlp(cfg, p.ffn, apply_norm(
            cfg, p.ln2, x)), ("batch", "seq", None)), 0.0
    mask = (None if token_mask is None
            else token_mask[:, None].expand(x.shape[:2]))
    y, aux = moe.moe_block(cfg, p.ffn, apply_norm(cfg, p.ln2, x),
                           token_mask=mask, need_aux=mode == "train")
    return logical_constraint(x + y, ("batch", "seq", None)), aux


def _unsupported_layer(spec: LayerSpec) -> NotImplementedError:
    return NotImplementedError(
        f"layer {spec} is not a layer of the zoo: the port runs attention, "
        f"MLA, SSD or RG-LRU layers (with or without cross attention) with "
        f"an MLP, an MoE or no FFN")


def _window(cfg, spec: LayerSpec) -> int:
    """The attention window of a layer: a hybrid's `local` layer attends
    over `cfg.local_window` keys, any other over `cfg.sliding_window` (0:
    the whole causal prefix)."""
    if spec.mixer == "local" and cfg.block_pattern:
        return cfg.local_window
    return cfg.sliding_window


def _empty_layer_cache(cfg, spec: LayerSpec, batch: int, width: int, *,
                       layers: Optional[int] = None, device=DEFAULT_DEVICE,
                       dtype=torch.float32):
    if spec.mixer == "mla":
        return kvcache.init_mla_cache(batch, width, cfg.kv_lora_rank,
                                      cfg.qk_rope_dim, layers=layers,
                                      device=device)
    if spec.mixer == "ssd":
        return ssm.init_ssm_state(cfg, batch, dtype, layers=layers,
                                  device=device)
    if spec.mixer == "rec":
        return rglru.init_rg_state(cfg, batch, dtype, layers=layers,
                                   device=device)
    if spec.mixer not in ("attn", "local"):
        raise _unsupported_layer(spec)
    return kvcache.init_attn_cache(batch, cfg.num_kv_heads,
                                   _cache_width(cfg, spec, width),
                                   cfg.resolved_head_dim, cfg.kv_cache_dtype,
                                   layers=layers, device=device)


def _cache_width(cfg, spec: LayerSpec, width: int) -> int:
    """A windowed layer (sliding or a hybrid's `local`) keeps a ring buffer
    of its window."""
    window = _window(cfg, spec)
    return min(width, window) if window else width


def init_cache(cfg: ArchConfig, batch: int, max_len: int, *,
               device=DEFAULT_DEVICE, dtype=torch.float32) -> list:
    """Per segment, {"l{i}": AttnCache} with (L, B, Hkv, W, hd) zeros in
    `cfg.kv_cache_dtype` (an MLACache of (L, B, W, r) and (L, B, W, rd) for
    an MLA layer, an SSMState or RGState for an SSD or RG-LRU layer, its
    conv window in `dtype`: the activations' dtype, as the JAX package's
    prefill returns the block's own window) on `device` (the card unless
    the caller asks for the CPU)."""
    check_supported(cfg)
    return [{f"l{i}": _empty_layer_cache(cfg, ls, batch, max_len,
                                         layers=seg.repeat, device=device,
                                         dtype=dtype)
             for i, ls in enumerate(seg.layers)}
            for seg in arch_segments(cfg)]


def _meta_shapes(init, *args, **kw) -> list:
    """`init(*args, **kw)`'s tree (`init_cache`, `init_cross`) as meta
    tensors, made with every dispatch mode off: a trace records nothing
    of it, and nothing is allocated."""
    from torch.utils._python_dispatch import _disable_current_modes
    with _disable_current_modes():
        return init(*args, **kw, device="meta")


def init_cross(cfg: ArchConfig, batch: int, frames: int, *,
               dtype=torch.float32, device=DEFAULT_DEVICE) -> list:
    """Per segment, {"l{i}": CrossKV} of (L, B, Hkv, F, hd) zeros for each
    cross-attention layer, or None for a segment without one (every
    segment of a model without an encoder). `dtype` is the projections'
    (`cross_mixer`): float32 for float32 frames, whatever the
    parameters' dtype."""
    out = []
    for seg in arch_segments(cfg):
        names = [f"l{i}" for i, ls in enumerate(seg.layers) if ls.cross]
        out.append({name: kvcache.init_cross_kv(
            batch, cfg.num_kv_heads, frames, cfg.resolved_head_dim,
            layers=seg.repeat, dtype=dtype, device=device)
            for name in names} or None)
    return out


# ---------------------------------------------------------------------------
# Forward passes
# ---------------------------------------------------------------------------

def _embed_tokens(cfg, params, tokens, pos=None):
    """Token embeddings, plus the learned positions of a model that has
    them: rows 0..S-1 at prefill; at decode (`pos` (B,)) each sequence's
    own row, clamped to the table's last. On a placed table, the
    vocabulary-parallel lookup (`dist.placed.embedding`) and the rows of
    the positions' column shards (`dist.placed.learned_positions`)."""
    if placed.is_placed(params.embed):
        x = placed.embedding(params.embed, tokens)
    else:
        x = params.embed[tokens.long()]
    if cfg.max_positions and placed.is_placed(params.pos_embed):
        if pos is None:
            x = x + placed.learned_positions(params.pos_embed,
                                             n=tokens.shape[1])[None]
        else:
            x = x + placed.learned_positions(params.pos_embed,
                                             pos=pos)[:, None]
    elif cfg.max_positions:
        if pos is None:
            x = x + params.pos_embed[:tokens.shape[1]][None]
        else:
            row = torch.clamp(pos, max=cfg.max_positions - 1).long()
            x = x + params.pos_embed[row][:, None]
    return x


def _logits(cfg, params, x):
    x = apply_norm(cfg, placed.gather_fsdp(params.final_norm), x)
    head = params.embed.T if cfg.tie_embeddings else params.lm_head
    return logical_constraint(x @ placed.gather_fsdp(head),
                              ("batch", "seq", "vocab"))


class ServeState(NamedTuple):
    caches: Any           # per segment {"l{i}": AttnCache (L, B, Hkv, W, hd),
    #                       with (L, B, Hkv, W, 1) scales when quantised,
    #                       PagedAttnCache (L, Hkv, NB, BS, hd), MLACache
    #                       (L, B, W, r | rd), PagedMLACache, SSMState or
    #                       RGState}
    cross: Any            # per segment {"l{i}": CrossKV (L, B, Hkv, F, hd)}
    #                       of its cross layers (Whisper), or None
    pos: torch.Tensor     # (B,) int32: next position index per sequence


def _layers(cfg, params, caches, cross):
    """(spec, layer params, layer cache view, layer cross view or None) in
    execution order."""
    for seg, seg_p, seg_c, seg_x in zip(arch_segments(cfg), params.segments,
                                        caches, cross):
        for li in range(seg.repeat):
            for i, ls in enumerate(seg.layers):
                name = f"l{i}"
                yield (ls, getattr(seg_p, name)[li], seg_c[name].layer(li),
                       seg_x[name].layer(li) if ls.cross else None)


def run_encoder(cfg: ArchConfig, params, frames: torch.Tensor):
    """Whisper's encoder over precomputed front-end frames (B, F, D): plus
    the fixed sinusoidal positions, `encoder_layers` non-causal attention
    and MLP layers, then the encoder's final norm."""
    _, f, d = frames.shape
    x = frames + sinusoidal_positions(f, d, frames.dtype,
                                      device=frames.device)[None]
    positions = torch.arange(f, device=frames.device)
    for lp in params.encoder.segments[0].l0:
        x, _ = _apply_layer(cfg, _ENCODER_LAYER, lp, x, positions,
                            mode="encode", cache=None)
    return apply_norm(cfg, params.encoder.final_norm, x)


def _check_inputs(cfg, b, frames, patches):
    """An encoder model needs its frames and a patch model its patches,
    (B, F, D) and (B, patch_tokens, D): the prefill reads them, and the
    patch rows' count fixes where the prompt's last row and `pos` lie."""
    needs = []
    if cfg.encoder_layers:
        needs.append(("frames", frames, None))
    if cfg.patch_tokens:
        needs.append(("patches", patches, cfg.patch_tokens))
    for name, t, rows in needs:
        if t is None:
            raise ValueError(f"{cfg.name}: the prefill needs {name} "
                             f"(B, {rows or 'F'}, {cfg.d_model}); none given")
        if t.ndim != 3 or t.shape[0] != b or t.shape[2] != cfg.d_model or (
                rows and t.shape[1] != rows):
            raise ValueError(f"{cfg.name}: {name} must be (B={b}, "
                             f"{rows or 'F'}, {cfg.d_model}), got "
                             f"{tuple(t.shape)}")


def forward_train(cfg: ArchConfig, params, tokens: torch.Tensor, *,
                  frames=None, patches=None, remat: bool = True):
    """Teacher-forced logits (B, S, V) — (B, P + S, V) for a patch model,
    its P patch rows first — and the summed MoE aux loss (0-d float32).

    frames (B, F, D): an encoder-decoder model's encoder input, which
    keeps its dtype: float32 frames run the encoder and the cross keys
    and values in float32 over bf16 weights, as the JAX package's type
    promotion runs them (`layers.matmul`). patches (B, P, D): a patch
    model's rows ahead of the tokens, cast to the activations' dtype.
    Every layer runs in mode "train", under autograd when the parameters
    require gradients. With `remat` the body of each segment repetition
    (its layers, one after the other) runs under
    `torch.utils.checkpoint`, so the backward pass recomputes its
    activations, the flash kernel's forward included, as
    `jax.checkpoint(nothing_saveable)` does; nothing in a body draws
    random numbers, so no generator state is kept."""
    check_supported(cfg)
    b = tokens.shape[0]
    _check_inputs(cfg, b, frames, patches)
    x = _embed_tokens(cfg, params, tokens)
    enc_out = None
    if cfg.encoder_layers:
        enc_out = run_encoder(cfg, params, frames.to(x.device))
    if cfg.patch_tokens:
        x = torch.cat([patches.to(x.device, x.dtype), x], dim=1)
    x = logical_constraint(x, ("batch", "seq", None))
    positions = torch.arange(x.shape[1], device=x.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)

    def body(specs, lps, y, a):
        for ls, lp in zip(specs, lps):
            y, da = _apply_layer(cfg, ls, lp, y, positions, mode="train",
                                 enc_out=enc_out)
            a = a + da
        return y, a

    for seg, seg_p in zip(arch_segments(cfg), params.segments):
        for li in range(seg.repeat):
            lps = [getattr(seg_p, f"l{i}")[li]
                   for i in range(len(seg.layers))]
            if remat:
                x, aux = checkpoint(body, seg.layers, lps, x, aux,
                                    use_reentrant=False,
                                    preserve_rng_state=False)
            else:
                x, aux = body(seg.layers, lps, x, aux)
    return _logits(cfg, params, x), aux


def forward_prefill(cfg: ArchConfig, params, tokens: torch.Tensor, *,
                    max_len: int, frames=None, patches=None, length=None):
    """Process the prompt (B, S), build caches of width max_len; returns
    (last-position logits (B, 1, V), ServeState).

    frames (B, F, D): an encoder-decoder model's encoder input, run in
    its own dtype promoted with the parameters' (float32 frames: a
    float32 encoder over bf16 weights, as in the JAX package); each
    cross layer's keys and values over the encoder output go into
    `ServeState.cross`, in the encoder output's dtype. patches (B, P,
    D), P = cfg.patch_tokens: a patch model's rows, cast to the
    activations' dtype and put ahead of the prompt: positions, causal
    attention and the cache run over P + S rows, and `length` counts
    prompt tokens only (the last row is P + length - 1, pos starts at
    P + length).

    length: None, an int or 0-d tensor, or a (B,) vector of per-sequence
    real prompt lengths when `tokens` is right-padded. Logits come from
    position length - 1 of each row and pos starts at length; keys written
    for padded positions sit above the decode mask (kv_len = pos + 1) and
    are overwritten before they become visible. Only sound for full-width
    attention caches: a windowed, SSM or RG-LRU state folds the padding in,
    so those models prefill at exact length (the Engine sees to it). MoE
    layers route without a token mask, as the JAX package's prefill does:
    padded rows of a batched prefill claim expert capacity."""
    check_supported(cfg)
    b = tokens.shape[0]
    _check_inputs(cfg, b, frames, patches)
    x = _embed_tokens(cfg, params, tokens)
    enc_out = None
    if cfg.encoder_layers:
        enc_out = run_encoder(cfg, params, frames.to(x.device))
    if cfg.patch_tokens:
        x = torch.cat([patches.to(x.device, x.dtype), x], dim=1)
    s = x.shape[1]
    positions = torch.arange(s, device=x.device)
    ctx = sh.current_context()
    frames_n = 0 if enc_out is None else enc_out.shape[1]
    cross_dtype = x.dtype if enc_out is None else enc_out.dtype
    if ctx is not None and placed.is_placed(x):
        # the state pinned to its serving placement: each rank allocates
        # its slice (`launch.specs.cache_entries`)
        dev = x.to_local().device
        caches = placed.state_zeros(_meta_shapes(
            init_cache, cfg, b, max_len, dtype=x.dtype), *ctx, device=dev)
        cross = placed.state_zeros(_meta_shapes(
            init_cross, cfg, b, frames_n, dtype=cross_dtype), *ctx,
            device=dev)
    else:
        caches = init_cache(cfg, b, max_len, device=x.device, dtype=x.dtype)
        cross = init_cross(cfg, b, frames_n, dtype=cross_dtype,
                           device=x.device)
    for ls, lp, lc, lx in _layers(cfg, params, caches, cross):
        x, _ = _apply_layer(cfg, ls, lp, x, positions, mode="prefill",
                            cache=lc, cross=lx, enc_out=enc_out)
    off = cfg.patch_tokens
    if length is None:
        last = x[:, -1:]
        next_pos = torch.full((b,), s, dtype=torch.int32, device=x.device)
    elif not isinstance(length, torch.Tensor) or length.ndim == 0:
        n = off + int(length)
        last = x[:, n - 1:n]
        next_pos = torch.full((b,), n, dtype=torch.int32, device=x.device)
    else:
        length = length.to(x.device) + off
        idx = (length - 1).long()
        last = x[torch.arange(b, device=x.device)[:, None], idx[:, None]]
        next_pos = length.to(torch.int32)
    logits = _logits(cfg, params, last)
    return logits, ServeState(caches=caches, cross=cross, pos=next_pos)


def forward_decode(cfg: ArchConfig, params, token: torch.Tensor,
                   state: ServeState, *, block_tables=None, token_mask=None):
    """One decode step. token: (B, 1) -> (logits (B, 1, V), new state).

    The caches of `state` are updated in place and shared by the returned
    state, whose pos is state.pos + 1. block_tables: (B, max_blocks) int
    when the state holds paged pools, shared by every layer; None for a
    contiguous state. A model with no full-width attention layer
    (Mixtral's windowed layers, Mamba 2, RecurrentGemma) has no pool in a
    paged state either, and ignores the tables, as the JAX package does. token_mask: a (B,) bool of live rows, which only MoE
    layers read (dense rows are independent): a dead row claims no expert
    capacity, so live rows' outputs do not depend on it."""
    check_supported(cfg)
    paged = [isinstance(c, (kvcache.PagedAttnCache, kvcache.PagedMLACache))
             for seg in state.caches for c in seg.values()]
    pageable = any(ls.mixer in ("attn", "mla")
                   for seg in arch_segments(cfg) for ls in seg.layers)
    if any(paged) and block_tables is None:
        raise ValueError("a paged serving state needs block_tables")
    if block_tables is not None and pageable and not any(paged):
        raise ValueError("block_tables given for a contiguous serving state")
    x = _embed_tokens(cfg, params, token, pos=state.pos)
    positions = state.pos[:, None]
    for ls, lp, lc, lx in _layers(cfg, params, state.caches, state.cross):
        x, _ = _apply_layer(cfg, ls, lp, x, positions, mode="decode",
                            cache=lc, pos=state.pos,
                            block_table=block_tables, token_mask=token_mask,
                            cross=lx)
    logits = _logits(cfg, params, x)
    return logits, ServeState(caches=state.caches, cross=state.cross,
                              pos=state.pos + 1)
