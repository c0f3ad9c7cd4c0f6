"""Step functions of the LM zoo (port of `repro/launch/steps.py`: the
train step, the contiguous and paged serve steps).

The JAX package builds pure functions that `jax.jit` compiles; here the
same factories return plain functions that run eagerly.

`make_train_step` returns (params, opt_state, batch) -> (params,
opt_state, metrics): a bf16 (or `compute_dtype`) copy of the float32
master weights takes the gradients of `lm_loss` under autograd, over
`microbatches` slices of the batch summed in float32, then global-norm
clipping and the optimizer's update of the master weights. It returns a
new parameter tree and state; the old ones are freed when the caller
drops them. `lm_loss` is the mean next-token cross-entropy over the real
vocabulary plus AUX_COEF times the MoE load-balance loss.

The serve steps run under `torch.inference_mode()`. A prefill batch is a
dict: `tokens`, and `frames` (Whisper's encoder input) or `patches`
(InternVL2's rows ahead of the prompt) where the model takes them. States
are updated in place: a prefill into a slot copies the fresh batch-1
state into that row of the engine's state, and a decode step writes one
key and value per sequence into the caches it is given, and advances the
SSM and RG-LRU states in place (see `models/transformer.py`).

The paged steps serve from shared block pools: a batched prefill admits
up to `admit` same-bucket requests in one forward (one flash-attention
launch a layer) and scatters each row's fresh cache into its slot's
blocks (`write_paged_state_slot`); the paged decode step takes the slots'
block tables beside the masked decode's arguments.
"""
from __future__ import annotations

import math
from typing import Callable

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import kvcache, transformer
from repro_torch.train import optimizer as opt_lib


AUX_COEF = 0.01


def _map_tree(tree: torch.nn.Module, fn, *,
              requires_grad: bool = False) -> transformer.ParamTree:
    """A new parameter tree of the same structure whose every tensor is
    `fn(parameter)`, visited in `tree.parameters()` order."""
    def walk(mod):
        out = {}
        for name, p in mod.named_parameters(recurse=False):
            out[name] = fn(p)
        for name, child in mod.named_children():
            if isinstance(child, torch.nn.ModuleList):
                out[name] = [walk(c) for c in child]
            else:
                out[name] = walk(child)
        return out
    return transformer.ParamTree(walk(tree), requires_grad=requires_grad)


def cast_tree(tree: torch.nn.Module, dtype) -> transformer.ParamTree:
    """A copy of a parameter tree with every floating tensor cast to
    `dtype` (integer tensors shared): the compute-dtype copy of float32
    master weights."""
    return _map_tree(tree, lambda p: p.to(dtype) if p.is_floating_point()
                     else p.data)


def cast_params_pinned(cfg: ArchConfig, params,
                       dtype) -> transformer.ParamTree:
    """`cast_tree`. The JAX package pins each cast to its parameter's
    sharding so that XLA does not move the convert past the FSDP
    all-gather; that is a fact of the XLA program, and one card has no
    all-gather to move it past."""
    del cfg
    return cast_tree(params, dtype)


def tree_leaves(tree: torch.nn.Module) -> list:
    """The tensors of a parameter tree in `parameters()` order: the order
    of optimizer states, gradients and updates."""
    return list(tree.parameters())


def tree_with_leaves(tree: torch.nn.Module, leaves) -> transformer.ParamTree:
    """A frozen parameter tree of `tree`'s structure holding `leaves`
    (in `tree_leaves` order)."""
    it = iter(leaves)
    out = _map_tree(tree, lambda p: next(it))
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree has parameters")
    return out


def _compute_copy(params, compute_dtype) -> transformer.ParamTree:
    """The tree autograd differentiates: detached copies of the master
    weights in `compute_dtype` (aliases of them when None) that require
    gradients; the master tree itself stays frozen."""
    def leaf(p):
        p = p.detach()
        return p.to(compute_dtype) if (compute_dtype is not None
                                       and p.is_floating_point()) else p
    return _map_tree(params, leaf, requires_grad=True)


def lm_loss(cfg: ArchConfig, params, tokens, labels, *, frames=None,
            patches=None, remat: bool = True):
    """(loss + AUX_COEF·aux, (loss, aux)): the mean next-token
    cross-entropy of `forward_train`'s logits against `labels` (B, S),
    over the real vocabulary (logits of the padded entries set to -1e30),
    with the log-softmax in float32; a patch model's patch rows carry no
    label."""
    logits, aux = transformer.forward_train(cfg, params, tokens,
                                            frames=frames, patches=patches,
                                            remat=remat)
    if cfg.patch_tokens:
        logits = logits[:, cfg.patch_tokens:]
    v = cfg.vocab_size
    if logits.shape[-1] > v:
        pad = torch.arange(logits.shape[-1], device=logits.device) >= v
        logits = logits.masked_fill(pad, -1e30)
    from repro_torch.dist import placed
    if placed.is_placed(logits):     # the vocabulary stays sharded
        ll = placed.log_likelihood(logits, labels)
    else:
        logp = torch.log_softmax(logits.float(), dim=-1)
        ll = torch.gather(logp, -1, labels.long()[..., None])[..., 0]
    loss = -torch.mean(ll)
    return loss + AUX_COEF * aux, (loss, aux)


def _microbatch(v, i: int, microbatches: int):
    """Rows of microbatch i of `microbatches`: rows [i·n, (i+1)·n) of a
    plain batch; of a placed one (rows sharded over d ranks), the same
    local rows [i·m, (i+1)·m) of every rank's shard, so each microbatch
    stays sharded as the batch is and no row crosses a rank."""
    from repro_torch.dist import placed
    rows = v.shape[0]
    if not placed.is_placed(v):
        n = rows // microbatches
        return v[i * n:(i + 1) * n]
    local = v.to_local()
    d, m = rows // local.shape[0], local.shape[0] // microbatches
    return placed.wrap(local[i * m:(i + 1) * m], v.device_mesh,
                       v.placements, (d * m, *v.shape[1:]))


def _placed_as(grad, param):
    """A placed parameter's gradient on the parameter's placements, as
    the JAX package's gradients take their parameters' shardings: a
    replicated weight's gradient leaves the backward pass as a partial
    sum over the batch's shards (one all-reduce makes it whole), and the
    optimizer's moments then stay placed as their parameters."""
    from repro_torch.dist import placed
    if not placed.is_placed(grad) or list(grad.placements) == list(
            param.placements):
        return grad
    return grad.redistribute(param.device_mesh, param.placements)


def make_train_step(cfg: ArchConfig, optimizer, *, microbatches: int = 1,
                    compute_dtype=torch.bfloat16, remat: bool = True,
                    clip_norm: float = 1.0,
                    cross_pod_mesh=None) -> Callable:
    """(params, opt_state, batch) -> (params, opt_state, metrics).

    params: the float32 master `ParamTree`; opt_state: the optimizer's
    state over `tree_leaves(params)`; batch: `tokens` and `labels`
    (B, S), and `frames` or `patches` where the model takes them.
    Gradients are taken on the `compute_dtype` copy (the master weights
    themselves when None), cast to float32 and, over `microbatches`
    equal slices of the batch's rows, summed and scaled by
    1/microbatches, as are the loss and aux metrics. Then global-norm
    clipping at `clip_norm` (0: none, the norm still reported) and the
    optimizer's update, given the master weights. metrics: `loss`, `aux`
    and `grad_norm`, 0-d float32 tensors.

    `cross_pod_mesh` (a mesh of `torch.distributed` ranks) makes the step
    SPMD data-parallel, as the JAX package's compressed cross-pod
    reduction: every rank calls it with its own (pod, data) rows of the
    batch; the float32 gradients of those rows are averaged over `data`
    (`collectives.all_reduce_sum`, the same bits on every rank) and sent
    across `pod` as int8 (`compression.compressed_psum`); the loss and
    aux are means over every rank. Clipping and the optimizer follow, the
    same on every rank, so the replicated weights stay equal."""

    def grads_of(params_c, leaves_c, mb):
        total, (loss, aux) = lm_loss(
            cfg, params_c, mb["tokens"], mb["labels"],
            frames=mb.get("frames"), patches=mb.get("patches"), remat=remat)
        grads = torch.autograd.grad(total, leaves_c)
        return (tuple(g.float() for g in grads), loss.detach(),
                aux.detach())

    def local_grads(params_c, batch):
        leaves_c = tree_leaves(params_c)
        if microbatches == 1:
            return grads_of(params_c, leaves_c, batch)
        rows = next(iter(batch.values())).shape[0]
        if rows % microbatches:
            raise ValueError(f"make_train_step: a batch of {rows} rows does "
                             f"not split into {microbatches} microbatches")
        n = rows // microbatches
        g_acc = tuple(torch.zeros_like(p, dtype=torch.float32)
                      for p in leaves_c)
        l_acc = a_acc = torch.zeros((), dtype=torch.float32,
                                    device=leaves_c[0].device)
        for i in range(microbatches):
            mb = {k: _microbatch(v, i, microbatches)
                  for k, v in batch.items()}
            g, l, a = grads_of(params_c, leaves_c, mb)
            g_acc = tuple(ga + gi for ga, gi in zip(g_acc, g))
            l_acc, a_acc = l_acc + l, a_acc + a
            del g
        inv = 1.0 / microbatches
        return tuple(g * inv for g in g_acc), l_acc * inv, a_acc * inv

    def reduce(grads, loss, aux):
        """The mean over the ranks of `cross_pod_mesh` (see above)."""
        from repro_torch.dist import collectives
        from repro_torch.train import compression
        mesh = cross_pod_mesh
        names = tuple(mesh.mesh_dim_names)
        sizes = dict(zip(names, mesh.shape))
        if "data" in names:
            grads = [collectives.all_reduce_sum(g, mesh, ("data",))
                     / sizes["data"] for g in grads]
        if "pod" in names:
            grads, _ = compression.compressed_psum(grads, mesh, "pod")
        world = math.prod(mesh.shape)
        return (tuple(grads),
                collectives.all_reduce_sum(loss, mesh, names) / world,
                collectives.all_reduce_sum(aux, mesh, names) / world)

    def train_step(params, opt_state, batch):
        grads, loss, aux = local_grads(_compute_copy(params, compute_dtype),
                                       batch)
        leaves = tree_leaves(params)
        grads = tuple(map(_placed_as, grads, leaves))
        if cross_pod_mesh is not None:
            grads, loss, aux = reduce(grads, loss, aux)
        if clip_norm:
            grads, gnorm = opt_lib.clip_by_global_norm(grads, clip_norm)
        else:
            gnorm = opt_lib.global_norm(grads)
        updates, opt_state = optimizer.update(grads, opt_state, leaves)
        del grads
        params = tree_with_leaves(params,
                                  opt_lib.apply_updates(leaves, updates))
        return params, opt_state, {"loss": loss, "aux": aux,
                                   "grad_norm": gnorm}

    return train_step


def place_params(cfg: ArchConfig, params, mesh, rules) -> transformer.ParamTree:
    """The parameter tree placed on `mesh`: each leaf a DTensor holding
    this rank's slice under the entries its logical axes
    (`transformer.param_logical`) resolve to by `rules` (every rank holds
    the same global tree, or fake tensors of it)."""
    from repro_torch.dist import sharding as sh
    logical = transformer.param_logical(cfg)

    def walk(mod, lg):
        out = {}
        for name, p in mod.named_parameters(recurse=False):
            out[name] = sh.distribute_tensor(p.detach(), lg[name], mesh,
                                             rules)
        for name, child in mod.named_children():
            out[name] = ([walk(c, x) for c, x in zip(child, lg[name],
                                                     strict=True)]
                         if isinstance(child, torch.nn.ModuleList)
                         else walk(child, lg[name]))
        return out
    return transformer.ParamTree(walk(params, logical))


def place_opt_state(cfg: ArchConfig, optimizer, state, mesh, rules):
    """The optimizer's `state` placed on `mesh` as the JAX package's
    `specs.opt_shardings` places it: each moment on its parameter's
    placements (a state initialised over placed parameters already is;
    it is checked), the step count replicated. A plain leaf is this
    rank's copy of the global value (`sh.from_global`)."""
    from repro_torch.dist import placed
    from repro_torch.dist import sharding as sh
    from repro_torch.launch import specs
    want = specs.opt_shardings(cfg, optimizer, mesh, rules)

    def put(t, entries):
        if t is None:
            return None
        to = sh.placements(entries, mesh)
        if not placed.is_placed(t):
            return sh.from_global(t, mesh, to)
        if list(t.placements) != to:
            raise ValueError(f"an optimizer leaf placed {t.placements}, "
                             f"its parameter {to}")
        return t

    return type(state)(*(
        tuple(map(put, leaf, entries)) if isinstance(leaf, tuple)
        else put(leaf, entries) for leaf, entries in zip(state, want)))


def place_batch(batch: dict, mesh, rules) -> dict:
    """A global data batch (every rank's copy of the same dict) placed on
    `mesh` by its logical axes (`specs.INPUT_LOGICAL`: tokens and labels
    by ("batch", "seq"), Whisper's frames and InternVL2's patches by
    ("batch", None, None)): each rank keeps its rows."""
    from repro_torch.dist import sharding as sh
    from repro_torch.launch import specs
    return {k: sh.distribute_tensor(v, specs.INPUT_LOGICAL[k], mesh, rules)
            for k, v in batch.items()}


def make_prefill_step(cfg: ArchConfig, *, max_len: int) -> Callable:
    """(params, batch) -> (last logits, ServeState)."""
    @torch.inference_mode()
    def prefill_step(params, batch):
        return transformer.forward_prefill(cfg, params, batch["tokens"],
                                           max_len=max_len, **_inputs(batch))
    return prefill_step


def serve_state_spec(cfg: ArchConfig, batch: int, seq_len: int,
                     param_spec, *, device="cpu"):
    """The ServeState after a `seq_len` prefill, for decode dry runs: the
    port's prefill step run under `FakeTensorMode` on fake parameters of
    `param_spec`'s shapes and dtypes (a tree of meta tensors,
    `launch.specs.param_specs`), so its leaves are fake tensors on
    `device` and nothing is allocated. The prompt is one token a row, in
    caches `seq_len` wide: every leaf has the shape and dtype it has
    after a `seq_len` prompt (the JAX package's `serve_state_zeros` fixes
    its tree the same way), and the trace does not walk `seq_len`
    positions through every layer."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch import specs
    with FakeTensorMode():
        params = transformer.ParamTree(specs.map_tree(
            lambda t: torch.empty(t.shape, dtype=t.dtype, device=device),
            param_spec))
        inputs = {"tokens": torch.zeros((batch, 1), dtype=torch.int32,
                                        device=device)}
        if cfg.encoder_layers:
            inputs["frames"] = torch.zeros(
                (batch, cfg.encoder_frames, cfg.d_model), device=device)
        if cfg.patch_tokens:
            inputs["patches"] = torch.zeros(
                (batch, cfg.patch_tokens, cfg.d_model), device=device)
        _, state = make_prefill_step(cfg, max_len=seq_len)(params, inputs)
    return state


def _inputs(batch) -> dict:
    """The prefill's frames and patches, where the batch has them."""
    return {"frames": batch.get("frames"), "patches": batch.get("patches")}


def make_decode_step(cfg: ArchConfig) -> Callable:
    """(params, token, state) -> (logits, state'); the caches of `state`
    are updated in place."""
    @torch.inference_mode()
    def decode_step(params, token, state):
        return transformer.forward_decode(cfg, params, token, state)
    return decode_step


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for key in sorted(tree):
            yield from _leaves(tree[key])
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            yield from _leaves(x)


def write_state_slot(full, one, index):
    """Write a batch-1 ServeState into row `index` of a batch-wide state,
    in place; returns `full`.

    Every tensor of the batch-1 tree is copied into the batch-wide tree
    along the one axis where their shapes differ (the batch axis: 0 for
    pos, 1 for the (L, B, ...) caches and their (L, B, Hkv, W, 1) scales,
    SSM / RG-LRU states and cross keys and values). Equal
    shapes mean a single-slot engine: the row is the whole state."""
    index = int(index)
    for f, o in zip(_leaves(full), _leaves(one), strict=True):
        diff = [a for a, (fd, od) in enumerate(zip(f.shape, o.shape))
                if fd != od]
        if not diff:
            f.copy_(o)
            continue
        if len(diff) != 1 or o.shape[diff[0]] != 1:
            raise ValueError(f"cannot write a {tuple(o.shape)} row into "
                             f"{tuple(f.shape)}")
        f.narrow(diff[0], index, 1).copy_(o)
    return full


def make_slot_prefill_step(cfg: ArchConfig, *, max_len: int) -> Callable:
    """(params, batch, length, slot, state) -> (last logits, state).

    Prefills ONE request (batch-1 `batch["tokens"]`, optionally padded to
    a bucket with `length` real tokens) into a fresh width-max_len state
    and copies it into row `slot` of the engine's batch-wide state."""
    @torch.inference_mode()
    def slot_prefill_step(params, batch, length, slot, state):
        logits, one = transformer.forward_prefill(
            cfg, params, batch["tokens"], max_len=max_len, length=length,
            **_inputs(batch))
        return logits, write_state_slot(state, one, slot)
    return slot_prefill_step


def make_masked_decode_step(cfg: ArchConfig) -> Callable:
    """(params, token, state, active) -> (logits, state').

    One decode step over every slot; `active` (B,) bool marks the slots
    that hold live requests. Inactive slots still run (the batch keeps its
    shape) but their pos is frozen; the key written into their row is
    garbage that the next prefill into the slot overwrites before it can
    become visible."""
    @torch.inference_mode()
    def masked_decode_step(params, token, state, active):
        logits, new = transformer.forward_decode(cfg, params, token, state,
                                                 token_mask=active)
        pos = torch.where(active, new.pos, state.pos)
        return logits, new._replace(pos=pos)
    return masked_decode_step


def serve_state_zeros(cfg: ArchConfig, params, slots: int,
                      max_len: int) -> transformer.ServeState:
    """All-zero batch-wide ServeState for an engine with `slots` cache
    rows, on the parameters' device: the structure a prefill of that
    batch builds, without running one (the cross keys and values of an
    encoder-decoder model over `cfg.encoder_frames` frames, in the dtype
    float32 frames promote to with the parameters': float32, as JAX's
    `serve_state_zeros` over float32 frame specs)."""
    device = params.embed.device
    caches = transformer.init_cache(cfg, slots, max_len, device=device,
                                    dtype=params.embed.dtype)
    return transformer.ServeState(
        caches=caches, cross=_cross_zeros(cfg, params, slots),
        pos=torch.zeros((slots,), dtype=torch.int32, device=device))


def _cross_zeros(cfg, params, slots: int) -> list:
    return transformer.init_cross(
        cfg, slots, cfg.encoder_frames,
        dtype=torch.promote_types(torch.float32, params.embed.dtype),
        device=params.embed.device)



# ---------------------------------------------------------------------------
# Paged serving steps
# ---------------------------------------------------------------------------

def write_paged_state_slot(full, one, slot, table_row):
    """`write_state_slot` for a paged state, in place: every paged pool
    (GQA or MLA) takes the batch-1 contiguous cache scattered into the
    blocks of `table_row` ((MB,) int); contiguous leaves (windowed caches,
    cross keys and values, pos) take row `slot` as before. Returns
    `full`."""
    for seg_full, seg_one in zip(full.caches, one.caches, strict=True):
        for name, f in seg_full.items():
            if isinstance(f, kvcache.PagedAttnCache):
                kvcache.paged_scatter_attn(f, seg_one[name], table_row)
            elif isinstance(f, kvcache.PagedMLACache):
                kvcache.paged_scatter_mla(f, seg_one[name], table_row)
            else:
                write_state_slot(f, seg_one[name], slot)
    write_state_slot((full.cross, full.pos), (one.cross, one.pos), slot)
    return full


def _state_row(state, j: int):
    """Batch row j of a batch-A contiguous prefill state, keeping the
    batch axis (behind the layer axis of the stacked caches, states and
    cross keys and values)."""
    def row(c):
        # tensors sliced; a cache's `quant` tag (a str or None) kept
        return type(c)(*(x[:, j:j + 1] if isinstance(x, torch.Tensor) else x
                         for x in c))

    def rows(segs):
        return [None if seg is None else
                {name: row(c) for name, c in seg.items()} for seg in segs]

    return transformer.ServeState(caches=rows(state.caches),
                                  cross=rows(state.cross),
                                  pos=state.pos[j:j + 1])


def make_paged_prefill_step(cfg: ArchConfig, *, max_len: int,
                            admit: int) -> Callable:
    """(params, batch, lengths, slots, tables, state) -> (logits, state).

    Batched multi-slot prefill: `batch["tokens"]` is (admit, S), up to
    `admit` same-bucket requests prefilled in ONE forward (one
    flash-attention launch a layer). lengths: (admit,) int on the
    device; slots: (admit,) ints; tables: (admit, max_blocks) int on the
    device. Partial groups pad with dummy rows that the engine orders
    FIRST and points at the first real request's slot with an all-null
    table row: their writes sink into block 0 or are overwritten by the
    real row's, so they never touch live state."""
    @torch.inference_mode()
    def paged_prefill_step(params, batch, lengths, slots, tables, state):
        logits, one = transformer.forward_prefill(
            cfg, params, batch["tokens"], max_len=max_len, length=lengths,
            **_inputs(batch))
        for j in range(admit):
            write_paged_state_slot(state, _state_row(one, j), int(slots[j]),
                                   tables[j])
        return logits, state
    return paged_prefill_step


def make_paged_decode_step(cfg: ArchConfig) -> Callable:
    """(params, token, state, active, block_tables) -> (logits, state').

    `make_masked_decode_step` plus the slots' block tables (B, MB). An
    inactive slot's row is all-null, so its (pos-frozen) write lands in
    the null block 0 instead of a recycled live block."""
    @torch.inference_mode()
    def paged_decode_step(params, token, state, active, block_tables):
        logits, new = transformer.forward_decode(
            cfg, params, token, state, block_tables=block_tables,
            token_mask=active)
        pos = torch.where(active, new.pos, state.pos)
        return logits, new._replace(pos=pos)
    return paged_decode_step


def paged_serve_state_zeros(cfg: ArchConfig, params, slots: int,
                            max_len: int, *, block_size: int,
                            num_blocks: int) -> transformer.ServeState:
    """`serve_state_zeros` with every full-width attention cache replaced
    by a shared block pool with no batch axis: (L, Hkv, num_blocks,
    block_size, hd) in `cfg.kv_cache_dtype` for GQA (a quantised pool with
    its (L, Hkv, num_blocks, block_size, 1) float32 scales), (L,
    num_blocks, block_size, r) float32 and (..., rd) bf16 for MLA. Windowed (`local`) caches and the SSM and
    RG-LRU states stay contiguous per slot, already bounded by their
    window or O(1) a sequence, so a sliding-window model (Mixtral), Mamba 2
    and RecurrentGemma have no pool at all, as in the JAX package: their
    paged engine only books blocks. Whisper's cross keys and values stay
    contiguous per slot too (F rows, whatever the prompt)."""
    transformer.check_supported(cfg)
    device = params.embed.device

    def leaf(ls, repeat):
        if ls.mixer == "attn":
            return kvcache.init_paged_attn_cache(
                cfg.num_kv_heads, num_blocks, block_size,
                cfg.resolved_head_dim, cfg.kv_cache_dtype, stack=repeat,
                device=device)
        if ls.mixer == "mla":
            return kvcache.init_paged_mla_cache(
                num_blocks, block_size, cfg.kv_lora_rank, cfg.qk_rope_dim,
                stack=repeat, device=device)
        return transformer._empty_layer_cache(cfg, ls, slots, max_len,
                                              layers=repeat, device=device,
                                              dtype=params.embed.dtype)

    caches = [{f"l{i}": leaf(ls, seg.repeat)
               for i, ls in enumerate(seg.layers)}
              for seg in transformer.arch_segments(cfg)]
    return transformer.ServeState(
        caches=caches, cross=_cross_zeros(cfg, params, slots),
        pos=torch.zeros((slots,), dtype=torch.int32, device=device))
