"""The LM path's pieces that DTensor cannot place by itself, or would
place badly: the attention launch, the cache writes, the decode
attention over a cache whose sequence is sharded (GQA's and MLA's
absorbed form), the embedding, the weights' FSDP gathers, the loss, and
the helpers the placed MoE block (`models/moe.py`) runs its rows on.

`dist.sharding` places the parameters and activations as DTensors and
constrains them where the JAX package does; DTensor then propagates
through the matmuls, norms and elementwise operators and emits the
collectives. What follows has no DTensor rule, or one that would move
far more than the placement needs; each runs here on the local shards,
the way `local_map` runs a local function, with the collectives it needs
made explicit:

* `attention` (prefill and training): q is placed by heads or, where the
  heads cannot take `model`, by query rows (`ctx`); K and V are whole on
  the sequence. Each rank runs the flash kernel (its plain version on
  the CPU) on its local heads, with its KV heads picked for GQA, and at
  `q_offset` = its first query row (0 where q is whole, as Whisper's
  encoder's). No collective forward; backward, where q is split on a
  mesh dim that K and V are whole on, their gradients are summed over
  it (one all-reduce each, so they leave as whole as they came).
* `cache_write` / `cache_write_at`: the cache is placed batch over
  `data` and its sequence over `model` (SERVE_RULES' `cache_seq`). A
  prefill's keys go to the rank that holds their slots; a decode step's
  one key a row goes to the rank whose slice holds its position (a
  masked write, so every rank makes the same calls).
* `embedding`: the table's vocabulary stays sharded over `model` (its
  `fsdp` columns gathered), each rank looks up its batch rows' tokens
  that fall in its vocabulary slice, and one all-reduce over `model`
  sums the rows (a vocabulary-parallel embedding); DTensor's own rule
  for the lookup gathers the table and the batch whole.
* `learned_positions`: the rows of Whisper's position table (columns
  over `fsdp`) that a step adds, cut from the local shard before they
  are gathered (the first S at prefill and in training, each sequence's
  row at decode), where gathering the table would move all 32,768 rows.
* `gather_fsdp`: a layer's weights come whole on the `fsdp` mesh axes
  when the layer runs (their `tp` shards kept), FSDP's gather; left to
  its cost model, DTensor would rather gather the batch-sharded
  activations over `data` than the weights. The backward pass
  reduce-scatters the gradients over the same axes.
* `log_likelihood`: the cross-entropy's log-softmax over a vocabulary
  that stays sharded over `model` (a maximum and a sum of exponentials
  reduced over it, the label's logit picked by a one-hot product), as
  Megatron's vocabulary-parallel loss; DTensor's own rules would gather
  the (B, S, V) logits whole on every rank.
* `decode_attention`: each rank scores the query against its slice of
  the cache, and the softmax is made whole over `model` with two
  all-reduces of (B, H) statistics (the maximum, the sum of exponentials)
  and one of the (B, H, Dv) partial outputs: the log-sum-exp combine.
  The probabilities are rounded to the cache's dtype as the one-device
  function rounds them, from the same global maximum and sum.
* `mla_decode_attention`: the same combine for MLA's absorbed decode
  over the latent cache (B, W, r), whose W and whose heads both take
  `model`: each rank absorbs its heads' queries, gathers them for every
  head, scores every head against its positions and applies its heads'
  `w_uv` after the combine.
* The MoE block's rows: `local_rows`, `gather_rows` (a group's expert
  choices across the batch shards), `local_param` (a weight whose
  gradient is a partial sum over the batch shards), and `sum_over` /
  `grad_sum_over` (Megatron's g and f: a partial output summed over the
  mesh dims that split the experts, and its replicated inputs'
  gradients summed over the same dims).
* The SSD and RG-LRU mixers (`placed_mixer` in `models/ssm.py` and
  `models/rglru.py`) run on `split_of` (a rank's share of the heads the
  rules split), `local_parts` (a weight's columns or rows that this
  rank's heads or channels read, cut from its own shard where they are
  that shard, else from the weight gathered whole along that dim once)
  and `gather_last` (a serving state's or a product's columns gathered
  whole).
* A cache leaf's sequence is dim 2 for GQA (B, Hkv, W, ...) and dim 1
  for MLA's latent (B, W, ...): the writes take `seq_dim`.

Nothing here runs on a plain tensor: the callers test `is_placed`.
"""
from __future__ import annotations

import torch

from repro_torch.dist import sharding as sh

NEG_INF = -1e30


def is_placed(x) -> bool:
    """Whether `x` is a DTensor (placed over a mesh)."""
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def dim_offset(x, dim: int) -> int:
    """The global index of the first element of `x`'s local shard along
    `dim` (mesh dims that shard it, outermost first)."""
    from torch.distributed.tensor import Shard
    mesh = x.device_mesh
    coord = mesh.get_coordinate()
    index, degree = 0, 1
    for i, p in enumerate(x.placements):
        if isinstance(p, Shard) and p.dim == dim:
            n = mesh.size(i)
            index = index * n + coord[i]
            degree *= n
    return index * (x.shape[dim] // degree)


def wrap(local: torch.Tensor, mesh, placements, shape) -> torch.Tensor:
    """A DTensor of global `shape` from this rank's `local` shard."""
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(local, mesh, list(placements), run_check=False,
                              shape=tuple(shape),
                              stride=sh.contiguous_stride(tuple(shape)))


class _SumOver(torch.autograd.Function):
    """The sum over the mesh dims `dims` of every rank's local term: an
    all-reduce forward; backward, each term's gradient is the whole
    (replicated) upstream gradient, since every rank holds the same
    sum."""

    @staticmethod
    def forward(ctx, local, mesh, dims):
        import torch.distributed._functional_collectives as fc
        out = local
        for i in dims:
            out = fc.wait_tensor(fc.all_reduce(out, "sum",
                                               mesh.get_group(i)))
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None, None


def sum_over(local: torch.Tensor, mesh, dims) -> torch.Tensor:
    """`_SumOver`: this rank's term of a sum over the mesh dims `dims`,
    summed (the identity over no dim)."""
    dims = tuple(dims)
    return _SumOver.apply(local, mesh, dims) if dims else local


class _GradSumOver(torch.autograd.Function):
    """Identity forward; backward, the gradient summed over the mesh dims
    `dims`: a replicated input of a computation split over those dims,
    each rank's gradient its part of the whole (Megatron's f)."""

    @staticmethod
    def forward(ctx, local, mesh, dims):
        ctx.mesh, ctx.dims = mesh, dims
        return local.view_as(local)

    @staticmethod
    def backward(ctx, grad):
        return _SumOver.forward(None, grad, ctx.mesh, ctx.dims), None, None


def grad_sum_over(local: torch.Tensor, mesh, dims) -> torch.Tensor:
    """`local` itself, its gradient summed over the mesh dims `dims`
    (`_GradSumOver`; the identity over no dim)."""
    dims = tuple(dims)
    return _GradSumOver.apply(local, mesh, dims) if dims else local


def split_of(mesh, rules, logical: str, n: int) -> tuple:
    """(mesh dims, first index, count) of this rank's share of a dim of
    `n` entries whose logical axis is `logical`: the rules' split of it
    on `mesh` (outermost mesh dim first), or the whole dim where they
    replicate it."""
    entry = rules.resolve((logical,), mesh, shape=(n,))[0]
    names = list(mesh.mesh_dim_names)
    dims = tuple(names.index(a) for a in sh.entry_axes(entry))
    coord = mesh.get_coordinate()
    index, degree = 0, 1
    for i in dims:
        index = index * mesh.size(i) + coord[i]
        degree *= mesh.size(i)
    return dims, index * (n // degree), n // degree


def local_parts(w, dim: int, ranges, split) -> list:
    """The global slices [start, start + n) of placed `w` along `dim`,
    one for each (start, n) of `ranges`, as local tensors (whole on every
    other dim's fsdp axes as `gather_fsdp` left them). Where `w`'s own
    shard along `dim` is the one range asked for, that shard; otherwise
    `w` gathered whole along `dim` once, then cut. A slice's gradient is
    this rank's term of a sum over the mesh dims `split` (the mesh dims
    the computation is split over: batch rows, heads or channels)."""
    from torch.distributed.tensor import Partial, Shard
    ranges = list(ranges)
    own = ranges == [(dim_offset(w, dim), w.to_local().shape[dim])]
    wk = w if own else _keep(
        w, {i: d for i, d in _shard_dims(w).items() if d != dim})
    local = wk.to_local(grad_placements=[
        Partial() if i in split and not isinstance(p, Shard) else p
        for i, p in enumerate(wk.placements)])
    if own:
        return [local]
    return [local.narrow(dim, start, n) for start, n in ranges]


def gather_last(local: torch.Tensor, mesh, rows, dims, shape) -> torch.Tensor:
    """The whole last dim of a tensor of global `shape` whose rows (dim 0)
    split over the mesh dims `rows` and whose last dim splits over `dims`,
    from this rank's `local` piece: an all-gather over `dims`; its rows
    stay this rank's. Forward only (a serving state's columns)."""
    from torch.distributed.tensor import Replicate, Shard
    last = len(shape) - 1
    pl = [Shard(0) if i in rows else Shard(last) if i in dims
          else Replicate() for i in range(mesh.ndim)]
    return _keep(wrap(local, mesh, pl, shape),
                 {i: 0 for i in rows}).to_local()


def batch_dims(x) -> tuple:
    """The mesh dims that split dim 0 (the batch) of placed `x`."""
    return tuple(i for i, d in _shard_dims(x).items() if d == 0)


def split_dims(w, dims) -> tuple:
    """The mesh dims that split any of the dims `dims` of placed `w`."""
    return tuple(i for i, d in _shard_dims(w).items() if d in dims)


def local_rows(x, rows) -> torch.Tensor:
    """This rank's rows of placed `x`, whole on every other dim: its batch
    shard over the mesh dims `rows`, replicated elsewhere."""
    return _keep(x, {i: 0 for i in rows}).to_local()


def local_param(w, rows) -> torch.Tensor:
    """This rank's shard of a placed weight used on its batch rows only:
    its gradient is this rank's part of a sum over the batch's mesh dims
    `rows` (a partial sum there, the weight's own placement elsewhere)."""
    from torch.distributed.tensor import Partial, Shard
    return w.to_local(grad_placements=[
        Partial() if i in rows and not isinstance(p, Shard) else p
        for i, p in enumerate(w.placements)])


def gather_rows(local: torch.Tensor, mesh, rows, n: int) -> torch.Tensor:
    """The (n, ...) whole of row shards split over the mesh dims `rows`
    (outermost first), on every rank: an all-gather."""
    from torch.distributed.tensor import Replicate, Shard
    placements = [Shard(0) if i in rows else Replicate()
                  for i in range(mesh.ndim)]
    return wrap(local, mesh, placements,
                (n, *local.shape[1:])).full_tensor()


def whole(x) -> torch.Tensor:
    """A placed tensor gathered whole on every rank; a plain one as it is
    (a global value, as DTensor's implicit replication takes it)."""
    return x.full_tensor() if is_placed(x) else x


def _keep(x, keep_dims: dict):
    """`x` redistributed so that mesh dim i keeps `Shard(keep_dims[i])`
    where given and replicates everywhere else."""
    from torch.distributed.tensor import Replicate, Shard
    want = [Shard(keep_dims[i]) if i in keep_dims else Replicate()
            for i in range(x.device_mesh.ndim)]
    return x if list(x.placements) == want else x.redistribute(
        x.device_mesh, want)


def _shard_dims(x) -> dict:
    from torch.distributed.tensor import Shard
    return {i: p.dim for i, p in enumerate(x.placements)
            if isinstance(p, Shard)}


def attention(q, k, v, *, attend, causal: bool, window: int = 0,
              scale=None, q_offset: int = 0):
    """Placed prefill or training attention: `attend(q, k, v, causal=,
    window=, scale=, q_offset=)` (`ops.flash_attention`) on each rank's
    shards. q (B, H, Sq, D) keeps its placement (batch, heads or query
    rows); K and V keep batch and KV-head shards on the mesh dims where
    q has the same, and are gathered whole on every other."""
    mesh = q.device_mesh
    qd = _shard_dims(q)
    kd = _shard_dims(k)
    keep = {i: d for i, d in kd.items() if d in (0, 1) and qd.get(i) == d}
    k, v = _keep(k, keep), _keep(v, keep)
    # K and V are whole on a mesh dim where q is split: each rank's
    # gradient is its part of a sum over that dim, summed there (one
    # all-reduce) so that it leaves as whole as K and V came
    split = tuple(i for i in qd if i not in keep)
    ql = q.to_local()
    kl = grad_sum_over(k.to_local(), mesh, split)
    vl = grad_sum_over(v.to_local(), mesh, split)
    h, hkv = q.shape[1], k.shape[1]
    g = h // hkv
    h0, g0 = dim_offset(q, 1), dim_offset(k, 1)
    hl = ql.shape[1]
    first, last = h0 // g - g0, (h0 + hl - 1) // g - g0
    if hl % g == 0 and h0 % g == 0:
        kl, vl = kl[:, first:last + 1], vl[:, first:last + 1]
    elif first == last:
        kl, vl = kl[:, first:first + 1], vl[:, first:first + 1]
    else:           # a shard splits a KV group: one KV head a query head
        idx = torch.tensor([(h0 + i) // g - g0 for i in range(hl)],
                           device=kl.device)
        kl, vl = kl.index_select(1, idx), vl.index_select(1, idx)
    out = attend(ql, kl, vl, causal=causal, window=window, scale=scale,
                 q_offset=q_offset + dim_offset(q, 2))
    return wrap(out, mesh, q.placements, (*q.shape[:3], v.shape[3]))


def _seq_range(cache_leaf, dim: int) -> tuple:
    """(first global position, positions) of this rank's cache slice."""
    return dim_offset(cache_leaf, dim), cache_leaf.to_local().shape[dim]


def _like_cache(x, cache_leaf, seq_dim: int):
    """`x` (B, Hkv, T, ...) on the cache's batch and head shards, whole
    on the sequence: its local rows are the cache's local rows."""
    keep = {i: d for i, d in _shard_dims(cache_leaf).items()
            if d != seq_dim}
    return _keep(x, keep).to_local()


def cache_write(cache_leaf, payload, start: int, keep: int, width: int,
                seq_dim: int = 2):
    """Prefill: write payload positions 0..keep-1 at slots
    (start + i) % width of the placed cache leaf, whose sequence is dim
    `seq_dim` ((B, Hkv, W, ...) for GQA, (B, W, ...) for MLA's latent),
    in place: each rank writes the slots its slice holds (a static set:
    the positions are known when the program is made)."""
    local = cache_leaf.to_local()
    pay = _like_cache(payload, cache_leaf, seq_dim).to(local.dtype)
    w0, wl = _seq_range(cache_leaf, seq_dim)
    pairs = [(i, (start + i) % width - w0) for i in range(keep)
             if 0 <= (start + i) % width - w0 < wl]
    if not pairs:
        return
    src = [i for i, _ in pairs]
    dst = [j for _, j in pairs]
    if dst == list(range(dst[0], dst[0] + len(dst))) and \
            src == list(range(src[0], src[0] + len(src))):
        local.narrow(seq_dim, dst[0], len(dst)).copy_(
            pay.narrow(seq_dim, src[0], len(src)))
    else:
        dev = local.device
        local.index_copy_(seq_dim, torch.tensor(dst, device=dev),
                          pay.index_select(seq_dim, torch.tensor(
                              src, device=dev)))


def cache_write_at(cache_leaf, payload, slot, seq_dim: int = 2):
    """Decode: write payload row b (one position on dim `seq_dim`) at
    position slot[b] of the placed cache leaf, in place, on the rank whose
    slice holds it (every rank runs the same masked read-modify-write)."""
    local = cache_leaf.to_local()
    pay = _like_cache(payload, cache_leaf, seq_dim).select(seq_dim, 0)
    slot_l = _like_rows(slot, cache_leaf)
    w0, wl = _seq_range(cache_leaf, seq_dim)
    li = slot_l.to(torch.long) - w0
    mine = (li >= 0) & (li < wl)
    li = li.clamp(0, wl - 1)
    rows = torch.arange(local.shape[0], device=local.device)
    at = (rows,) + (slice(None),) * (seq_dim - 1) + (li,)
    old = local[at]
    shape = (-1,) + (1,) * (old.ndim - 1)
    local[at] = torch.where(mine.view(shape), pay.to(local.dtype), old)


def _like_rows(x, cache_leaf):
    """A (B,) placed or plain tensor as this rank's rows of the cache's
    batch."""
    if not is_placed(x):
        b0 = dim_offset(cache_leaf, 0)
        return x[b0:b0 + cache_leaf.to_local().shape[0]]
    keep = {i: 0 for i, d in _shard_dims(cache_leaf).items() if d == 0}
    return _keep(x, keep).to_local()


def decode_attention(q, k, v, *, kv_len, window: int = 0, scale=None):
    """Placed single-step decode: q (B, H, 1, D) against the placed cache
    k, v (B, Hkv, W, D) whose W is sharded; keys at or past kv_len (B,)
    masked. The log-sum-exp combine over the mesh dims that shard W (see
    the module docstring); returns (B, H, 1, Dv) on q's batch shards,
    replicated elsewhere."""
    import torch.distributed._functional_collectives as fc
    mesh = k.device_mesh
    kd = _shard_dims(k)
    seq_mesh_dims = [i for i, d in kd.items() if d == 2]
    batch_keep = {i: 0 for i, d in kd.items() if d == 0}
    ql = _keep(q, batch_keep).to_local()
    kl = _keep(k, {i: d for i, d in kd.items() if d in (0, 2)}).to_local()
    vl = _keep(v, {i: d for i, d in _shard_dims(v).items()
                   if d in (0, 2)}).to_local()
    kv = _like_rows(kv_len, k).to(torch.long)
    b, hq, _, d = ql.shape
    hkv, wl = kl.shape[1], kl.shape[2]
    dv = vl.shape[-1]
    g = hq // hkv
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    w0 = dim_offset(k, 2)
    qg = ql.reshape(b, hkv, g, d).float()
    s = torch.matmul(qg, kl.float().transpose(-1, -2)) * scale
    ik = torch.arange(w0, w0 + wl, device=ql.device)
    mask = ik[None, :] < kv[:, None]
    if window > 0:
        mask = mask & (ik[None, :] > kv[:, None] - 1 - window)
    s = s.masked_fill(~mask[:, None, None], NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    groups = [mesh.get_group(i) for i in seq_mesh_dims]
    for grp in groups:
        m = fc.wait_tensor(fc.all_reduce(m, "max", grp))
    e = torch.exp(s - m)
    total = e.sum(dim=-1, keepdim=True)
    for grp in groups:
        total = fc.wait_tensor(fc.all_reduce(total, "sum", grp))
    p = (e / total).to(vl.dtype)
    out = torch.matmul(p.float(), vl.float())
    for grp in groups:
        out = fc.wait_tensor(fc.all_reduce(out, "sum", grp))
    out = out.reshape(b, hq, 1, dv).to(ql.dtype)
    from torch.distributed.tensor import Replicate, Shard
    placements = [Shard(0) if i in batch_keep else Replicate()
                  for i in range(mesh.ndim)]
    return wrap(out, mesh, placements, (q.shape[0], hq, 1, dv))


def mla_decode_attention(qn, qr, w_uk, w_uv, ckv, krope, *, kv_len,
                         scale: float):
    """Placed absorbed MLA decode: qn (B, 1, H, nd) and qr (B, 1, H, rd)
    against the placed latent cache ckv (B, W, r) and rotary keys krope
    (B, W, rd), whose W is sharded; positions at or past kv_len (B,)
    masked. Each rank maps its heads' queries through its `w_uk` heads
    (r, H, nd), gathers the absorbed queries (B, H, r) over the heads'
    mesh dims, scores every head against its own cache positions in
    float32 and makes the softmax whole over the cache's mesh dims with
    the log-sum-exp combine of `decode_attention` (maximum, sum, and the
    (B, H, r) latent context). `w_uv` is applied to its heads after the
    combine. Returns (B, 1, H·vd) on the cache's batch shards and
    `w_uv`'s head shards."""
    import torch.distributed._functional_collectives as fc
    from torch.distributed.tensor import Replicate, Shard
    mesh = ckv.device_mesh
    cd = _shard_dims(ckv)
    seq_mesh_dims = [i for i, d in cd.items() if d == 1]
    batch = {i: 0 for i, d in cd.items() if d == 0}
    heads = {i: 1 for i, d in _shard_dims(w_uk).items() if d == 1}
    qn_l = _keep(qn, {**batch, **{i: 2 for i in heads}}).to_local()[:, 0]
    qr_l = _keep(qr, batch).to_local()[:, 0].float()        # (B, H, rd)
    wk = w_uk.to_local().float()                            # (r, H_l, nd)
    q_abs = torch.einsum("bhn,rhn->bhr", qn_l.float(), wk)
    b, h = q_abs.shape[0], qn.shape[2]
    hp = [Shard(1) if i in heads else Shard(0) if i in batch
          else Replicate() for i in range(mesh.ndim)]
    q_abs = _keep(wrap(q_abs, mesh, hp, (qn.shape[0], h, q_abs.shape[2])),
                  batch).to_local()                         # (B, H, r)
    ckv_l = ckv.to_local().float()                          # (B, W_l, r)
    kr_l = krope.to_local().float()
    w0, wl = dim_offset(ckv, 1), ckv_l.shape[1]
    scores = (torch.einsum("bhr,bwr->bhw", q_abs, ckv_l)
              + torch.einsum("bhd,bwd->bhw", qr_l, kr_l)) * scale
    kv = _like_rows(kv_len, ckv).to(torch.long)
    mask = torch.arange(w0, w0 + wl, device=ckv_l.device)[None] < kv[:, None]
    scores = scores.masked_fill(~mask[:, None], NEG_INF)
    groups = [mesh.get_group(i) for i in seq_mesh_dims]
    m = scores.amax(dim=-1, keepdim=True)
    for grp in groups:
        m = fc.wait_tensor(fc.all_reduce(m, "max", grp))
    e = torch.exp(scores - m)
    total = e.sum(dim=-1, keepdim=True)
    for grp in groups:
        total = fc.wait_tensor(fc.all_reduce(total, "sum", grp))
    ctx = torch.einsum("bhw,bwr->bhr", e / total, ckv_l)
    for grp in groups:
        ctx = fc.wait_tensor(fc.all_reduce(ctx, "sum", grp))
    h0 = dim_offset(w_uv, 1)
    wv = w_uv.to_local().float()                            # (r, H_l, vd)
    out = torch.einsum("bhr,rhv->bhv", ctx[:, h0:h0 + wv.shape[1]], wv)
    vd = wv.shape[2]
    op = [Shard(2) if i in heads else Shard(0) if i in batch
          else Replicate() for i in range(mesh.ndim)]
    return wrap(out.reshape(b, 1, -1), mesh, op, (qn.shape[0], 1, h * vd))


def embedding(table, tokens):
    """Placed lookup `table[tokens]`: table (V, D), tokens (B, S) ->
    (B, S, D) on the tokens' batch shards, replicated elsewhere (see the
    module docstring). Differentiable: the all-reduce is DTensor's
    redistribution of a partial sum."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = table.device_mesh
    td = _shard_dims(table)
    vocab_dims = [i for i, d in td.items() if d == 0]
    tab = _keep(table, {i: 0 for i in vocab_dims})
    if is_placed(tokens):
        batch_dims = [i for i, d in _shard_dims(tokens).items() if d == 0]
        tok = _keep(tokens, {i: 0 for i in batch_dims}).to_local()
    else:
        batch_dims, tok = [], tokens
    # the table is whole over the batch's mesh dims, and each rank looks
    # up its own rows: its gradient is that rank's term of a sum
    local = tab.to_local(grad_placements=[
        Partial() if i in batch_dims and not isinstance(p, Shard) else p
        for i, p in enumerate(tab.placements)])
    v0, vl = dim_offset(tab, 0), local.shape[0]
    ids = tok.long() - v0
    mine = (ids >= 0) & (ids < vl)
    rows = local[ids.clamp(0, vl - 1)] * mine[..., None].to(local.dtype)
    return wrap(sum_over(rows, mesh, vocab_dims), mesh,
                [Shard(0) if i in batch_dims else Replicate()
                 for i in range(mesh.ndim)],
                (tokens.shape[0], *rows.shape[1:]))


def learned_positions(table, *, n=None, pos=None):
    """Rows of a placed learned-position table (P, D) whose columns split
    over the `fsdp` mesh axes: rows 0..n-1 (prefill and training), cut
    from this rank's column shard and gathered whole, (n, D) replicated;
    or at decode each sequence's row pos[b] (clamped to the table's
    last), looked up for the whole batch in this rank's columns and
    exchanged (an all-to-all) onto `pos`'s batch shards, (B, D). Only
    the rows asked for move, never the table. Differentiable (training
    takes the first branch)."""
    mesh = table.device_mesh
    local = table.to_local()
    if pos is None:
        return _keep(wrap(local[:n], mesh, table.placements,
                          (n, table.shape[1])), {})
    rows = whole(pos).clamp(max=table.shape[0] - 1).long()
    out = wrap(local[rows], mesh, table.placements,
               (rows.shape[0], table.shape[1]))
    return _keep(out, {i: 0 for i in batch_dims(pos)} if is_placed(pos)
                 else {})


def gather_fsdp(x):
    """`x` (a placed tensor, or a parameter tree) with every shard on the
    mesh axes the rules give `fsdp` gathered, the others kept; the
    identity outside a mesh context and on plain tensors. A tree comes
    back as a read-only view whose tensors are gathered on access."""
    ctx = sh.current_context()
    if ctx is None:
        return x
    if isinstance(x, torch.nn.Module):
        return _GatheredTree(x)
    if not is_placed(x):
        return x
    mesh, rules = ctx
    fsdp = set(rules.rules.get("fsdp", ()))
    names = mesh.mesh_dim_names
    return _keep(x, {i: d for i, d in _shard_dims(x).items()
                     if names[i] not in fsdp})


class _GatheredTree:
    """A parameter (sub)tree seen through `gather_fsdp`: attribute access
    returns each tensor gathered, each sub-tree wrapped the same way."""

    def __init__(self, module):
        self._module = module

    def __getattr__(self, name):
        value = getattr(self._module, name)
        if isinstance(value, torch.Tensor):
            return gather_fsdp(value)
        if isinstance(value, torch.nn.Module):
            return _GatheredTree(value)
        return value


def log_likelihood(logits, labels):
    """log softmax(logits)[labels] of placed (B, S, V) logits in float32:
    max(x) + log sum exp(x - max(x)) reduced over the vocabulary shards,
    the label's logit as sum(x · onehot(label)). The maximum is a
    constant of the gradient (as in log_softmax), so it is detached."""
    x = logits.float()
    v = x.shape[-1]
    rows = {i: d for i, d in _shard_dims(x).items() if d in (0, 1)}

    def whole(t):      # the vocabulary's partial sums, all-reduced
        return _keep(t, rows)
    m = whole(x.amax(dim=-1, keepdim=True)).detach()
    lse = torch.log(whole(torch.exp(x - m).sum(dim=-1))) + m[..., 0]
    # the label's logit on the rank whose vocabulary slice holds it
    from torch.distributed.tensor import Replicate, Shard
    xl = x.to_local()
    lab = (_keep(labels, {i: d for i, d in rows.items()}).to_local()
           if is_placed(labels) else labels)
    v0 = dim_offset(x, 2)
    hit = torch.arange(v0, v0 + xl.shape[-1], device=xl.device)
    picked = (xl * (hit == lab.long()[..., None]).to(xl.dtype)).sum(dim=-1)
    vocab = [i for i, d in _shard_dims(x).items() if d == 2]
    placements = [Shard(rows[i]) if i in rows else Replicate()
                  for i in range(x.device_mesh.ndim)]
    del v
    return wrap(sum_over(picked, x.device_mesh, vocab), x.device_mesh,
                placements, x.shape[:2]) - lse


def state_zeros(meta_state, mesh, rules: sh.ShardingRules, device):
    """A serving state of zeros placed by `launch.specs.cache_entries`:
    `meta_state` (per segment, NamedTuple caches or `CrossKV`s of meta
    tensors, as `init_cache` and `init_cross` build them on the meta
    device; None for a segment without any) -> the same tree of
    DTensors, each rank allocating its slice only."""
    from repro_torch.launch import specs

    def leaf(c, field, t):
        if t is None:
            return None
        entries = rules.resolve(specs.leaf_logical(c, field, t), mesh,
                                shape=tuple(t.shape))
        return wrap(torch.zeros(sh.local_shape(t.shape, entries, mesh),
                                dtype=t.dtype, device=device),
                    mesh, sh.placements(entries, mesh), t.shape)

    def cache(c):
        return type(c)(**{f: (getattr(c, f) if f == "quant"
                              else leaf(c, f, getattr(c, f)))
                          for f in c._fields})
    return [None if seg is None else
            {name: cache(c) for name, c in seg.items()}
            for seg in meta_state]
