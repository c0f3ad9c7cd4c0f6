"""Stand-ins and resolved shardings for every (arch x shape) cell (port of
`repro/launch/specs.py`).

Everything the LM dry run traces is described here with nothing
allocated: the stand-ins are meta tensors of the step's argument shapes
and dtypes (`launch.dryrun` turns them into fake tensors of one rank's
shard), and the shardings come from the same logical-axis tables the
placement uses (`dist.sharding`), resolved per leaf. Where the JAX
package returns a `NamedSharding` a leaf, the port returns the resolved
entries (one per dim: None, a mesh axis, or a tuple of axes), as
`ShardingRules.resolve` gives them.

The parameter tree keeps the port's layout: a segment's layers are a
list (`models/transformer.py`), where the JAX package stacks them on a
leading axis. The serving state is the port's `ServeState` of NamedTuple
caches; `cache_entries` classifies its leaves by their field names, as
JAX's `cache_shardings` does, with the layer axis first.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.dist import sharding as sh
from repro_torch.models import kvcache, transformer
from repro_torch.train import optimizer as opt_lib

META = torch.device("meta")


def dp_degree(mesh) -> int:
    """The data-parallel degree: pod x data."""
    sizes = sh.mesh_sizes(mesh)
    return sizes.get("pod", 1) * sizes.get("data", 1)


def microbatches_for(cfg: ArchConfig, shape: ShapeSpec, mesh) -> int:
    """Gradient-accumulation depth of a train cell: one sequence a device
    a microbatch."""
    del cfg
    if shape.kind != "train":
        return 1
    return max(1, shape.global_batch // dp_degree(mesh))


def _spec(shape, dtype, device=META) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=device)


# ---------------------------------------------------------------------------
# Input specs
# ---------------------------------------------------------------------------

INPUT_LOGICAL = {"tokens": ("batch", "seq"), "labels": ("batch", "seq"),
                 "token": ("batch", None), "frames": ("batch", None, None),
                 "patches": ("batch", None, None)}


def input_specs(cfg: ArchConfig, shape: ShapeSpec, device=META) -> dict:
    """Stand-ins for the step function's data arguments."""
    b, s = shape.global_batch, shape.seq_len
    i32 = torch.int32
    if shape.kind == "train":
        specs = {"tokens": _spec((b, s), i32, device),
                 "labels": _spec((b, s), i32, device)}
    elif shape.kind == "prefill":
        specs = {"tokens": _spec((b, s), i32, device)}
    else:       # decode: one new token against a seq_len-deep cache
        specs = {"token": _spec((b, 1), i32, device)}
    if cfg.encoder_layers:
        specs["frames"] = _spec((b, cfg.encoder_frames, cfg.d_model),
                                torch.float32, device)
    if cfg.patch_tokens and shape.kind != "decode":
        specs["patches"] = _spec((b, cfg.patch_tokens, cfg.d_model),
                                 torch.float32, device)
    return specs


def input_shardings(cfg: ArchConfig, shape: ShapeSpec, mesh, rules) -> dict:
    """{input name: resolved entries}."""
    return {k: rules.resolve(INPUT_LOGICAL[k], mesh, shape=tuple(v.shape))
            for k, v in input_specs(cfg, shape).items()}


def engine_input_specs(cfg: ArchConfig, prompt_len: int, slots: int, *,
                       paged: bool = False, block_size: int = 16,
                       prefill_batch: int = 1,
                       max_len: Optional[int] = None, device=META) -> dict:
    """Stand-ins for the continuous-batching engine's per-step data: the
    slot prefill's request and the masked decode's feed; paged, the
    batched admission (prefill_batch rows, per-row lengths, slots and
    block-table rows) and the decode's (slots, max_blocks) tables."""
    i32 = torch.int32
    if paged:
        ml = max_len if max_len is not None else prompt_len
        mb = -(-ml // block_size)
        a = prefill_batch
        specs = {"tokens": _spec((a, prompt_len), i32, device),
                 "lengths": _spec((a,), i32, device),
                 "slots": _spec((a,), i32, device),
                 "table_rows": _spec((a, mb), i32, device),
                 "token": _spec((slots, 1), i32, device),
                 "active": _spec((slots,), torch.bool, device),
                 "block_tables": _spec((slots, mb), i32, device)}
    else:
        a = 1
        specs = {"tokens": _spec((1, prompt_len), i32, device),
                 "length": _spec((), i32, device),
                 "slot": _spec((), i32, device),
                 "token": _spec((slots, 1), i32, device),
                 "active": _spec((slots,), torch.bool, device)}
    if cfg.encoder_layers:
        specs["frames"] = _spec((a, cfg.encoder_frames, cfg.d_model),
                                torch.float32, device)
    if cfg.patch_tokens:
        specs["patches"] = _spec((a, cfg.patch_tokens, cfg.d_model),
                                 torch.float32, device)
    return specs


# logical axes of the engine's data arguments; block tables and lengths
# replicate beyond the batch axis (small int32 host tables)
ENGINE_INPUT_LOGICAL = {
    "tokens": ("batch", "seq"), "length": (), "slot": (),
    "token": ("batch", None), "active": ("batch",),
    "frames": ("batch", None, None), "patches": ("batch", None, None),
    "lengths": ("batch",), "slots": ("batch",),
    "table_rows": ("batch", None), "block_tables": ("batch", None),
}


def engine_input_shardings(cfg: ArchConfig, prompt_len: int, slots: int,
                           mesh, rules, **paged_kw) -> dict:
    specs = engine_input_specs(cfg, prompt_len, slots, **paged_kw)
    return {k: rules.resolve(ENGINE_INPUT_LOGICAL[k], mesh,
                             shape=tuple(v.shape))
            for k, v in specs.items()}


# ---------------------------------------------------------------------------
# Parameter / optimizer specs
# ---------------------------------------------------------------------------

def param_specs(cfg: ArchConfig, dtype=torch.float32) -> dict:
    """The parameter tree as meta tensors (`transformer.param_shapes`)."""
    return transformer.param_shapes(cfg, dtype)


def map_tree(fn, tree, *more):
    """`fn` over the leaves of nested dicts and lists (and trees of the
    same structure beside it); a tuple is a leaf (a logical tuple, or
    resolved entries)."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v, *(m[k] for m in more))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [map_tree(fn, v, *(m[i] for m in more))
                for i, v in enumerate(tree)]
    return fn(tree, *more)


def tree_leaves(tree) -> list:
    """The leaves of nested dicts and lists in the order `parameters()`
    visits a `ParamTree` built from them: a dict's own leaves first, in
    insertion order, then its sub-trees in order."""
    if isinstance(tree, list):
        return [x for v in tree for x in tree_leaves(v)]
    if not isinstance(tree, dict):
        return [tree]
    own = [v for v in tree.values() if not isinstance(v, (dict, list))]
    return own + [x for v in tree.values() if isinstance(v, (dict, list))
                  for x in tree_leaves(v)]


def param_shardings(cfg: ArchConfig, mesh, rules,
                    dtype=torch.float32) -> dict:
    """The resolved entries of every parameter, in `param_specs`' tree."""
    return map_tree(
        lambda spec, log: rules.resolve(log, mesh, shape=tuple(spec.shape)),
        param_specs(cfg, dtype), transformer.param_logical(cfg))


def opt_specs(optimizer: opt_lib.Optimizer, params_like) -> object:
    """The optimizer's state over the parameters' stand-ins (meta
    tensors), in `tree_leaves` order: `AdamState(step, mu, nu)`."""
    leaves = (tree_leaves(params_like) if isinstance(params_like, dict)
              else list(params_like))
    return optimizer.init(leaves)


def opt_shardings(cfg: ArchConfig, optimizer: opt_lib.Optimizer, mesh,
                  rules, dtype=torch.float32):
    """The optimizer state's entries: the moments mirror the parameters'
    entries leaf for leaf, the step replicates."""
    pentries = tree_leaves(param_shardings(cfg, mesh, rules, dtype))
    state = opt_specs(optimizer, param_specs(cfg, dtype))
    if isinstance(state, opt_lib.AdamState):
        return opt_lib.AdamState(step=(), mu=tuple(pentries),
                                 nu=tuple(pentries))
    if isinstance(state, opt_lib.SGDState):
        return opt_lib.SGDState(
            step=(), momentum=(tuple(pentries) if state.momentum is not None
                               else None))
    raise TypeError(f"no shardings for optimizer state {type(state)}")


# ---------------------------------------------------------------------------
# Serve-state (KV cache / SSM state) entries
# ---------------------------------------------------------------------------

_BASE = {
    "k": ("batch", "kv_heads", "cache_seq", None),
    "v": ("batch", "kv_heads", "cache_seq", None),
    "k_scale": ("batch", "kv_heads", "cache_seq", None),
    "v_scale": ("batch", "kv_heads", "cache_seq", None),
    "ckv": ("batch", "cache_seq", None),
    "krope": ("batch", "cache_seq", None),
    "conv": ("batch", "ffn", None),
    "state": ("batch", "heads", None, None),
    "h": ("batch", "ffn"),
}


# the cross keys and values (L, B, Hkv, F, hd): by batch and kv_heads,
# their F frames whole (JAX's `CrossKV` constraint)
CROSS_LOGICAL = (None, "batch", "kv_heads", None, None)


def leaf_logical(cache, field: str, t: torch.Tensor) -> tuple:
    """Logical axes of leaf `field` (a tensor `t`) of a cache NamedTuple:
    a `CrossKV` leaf's `CROSS_LOGICAL`, any other classified by its field
    name (`_BASE`, with the layer axis first when stacked)."""
    if isinstance(cache, kvcache.CrossKV):
        return CROSS_LOGICAL
    base = _BASE[field]
    if t.ndim > len(base):
        base = (None, *base)
    if len(base) != t.ndim:
        raise ValueError(f"cache field {field!r}: {t.ndim} dims against "
                         f"logical axes {base}")
    return base


def cache_entries(cfg: ArchConfig, state, mesh, rules):
    """The resolved entries of a `ServeState` (contiguous caches): per
    segment and layer name, the cache NamedTuple's fields classified by
    `leaf_logical` (the cross keys and values over batch and kv_heads),
    and the (B,) positions over batch. The same tree as `state`, None
    where the state holds None."""
    del cfg

    def cache(c):
        out = {f: (getattr(c, f) if f == "quant" or getattr(c, f) is None
                   else rules.resolve(leaf_logical(c, f, getattr(c, f)),
                                      mesh, shape=tuple(getattr(c, f).shape)))
               for f in c._fields}
        return type(c)(**out)

    caches = [{name: cache(c) for name, c in seg.items()}
              for seg in state.caches]
    cross = [None if seg is None else {name: cache(c)
                                       for name, c in seg.items()}
             for seg in state.cross]
    pos = rules.resolve(("batch",), mesh, shape=tuple(state.pos.shape))
    return transformer.ServeState(caches=caches, cross=cross, pos=pos)


def state_leaves(state) -> list:
    """(path, tensor) of every tensor of a `ServeState`, in a fixed order
    (segments, layer names, fields; cross; pos)."""
    out = []
    for si, seg in enumerate(state.caches):
        for name, c in seg.items():
            for f in c._fields:
                t = getattr(c, f)
                if isinstance(t, torch.Tensor) or (
                        t is not None and f != "quant"):
                    out.append((f"caches[{si}].{name}.{f}", t))
    for si, seg in enumerate(state.cross):
        if seg is not None:
            for name, c in seg.items():
                for f in c._fields:
                    out.append((f"cross[{si}].{name}.{f}", getattr(c, f)))
    out.append(("pos", state.pos))
    return out
