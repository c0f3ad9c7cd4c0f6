"""Plain PyTorch versions of every hand-written kernel (port of
`repro/kernels/ref.py`).

Each function computes what its kernel computes, with ordinary tensor
ops, on any device. The tests hold them against the JAX package; on the
CPU the kernel wrappers run them as the implementation; on the GPU
`chip_smoke.py` holds each kernel against its plain version, bit for bit
for the integer kernels and within a stated tolerance for attention.
Nothing on the main path calls them for a CUDA tensor.
"""
from __future__ import annotations

import torch


def as_int32_words(words: torch.Tensor) -> torch.Tensor:
    """uint32 bitplanes -> the same bits as int32 (torch has few uint32
    ops). `(w >> s) & 1` extracts bit s correctly under the arithmetic
    shift int32 gives, so nothing downstream needs unsigned words."""
    return words.view(torch.int32) if words.dtype == torch.uint32 else words


def h3_hash_ref(tuples: torch.Tensor, params: torch.Tensor) -> torch.Tensor:
    """tuples: (B, N_f, n) int {0,1}; params: (k, n) int -> (B, N_f, k)."""
    sel = torch.where(tuples[..., None, :] != 0, params.to(torch.int32), 0)
    h = torch.zeros(sel.shape[:-1], dtype=torch.int32, device=tuples.device)
    for i in range(sel.shape[-1]):            # torch has no XOR reduction
        h = h ^ sel[..., i]
    return h


def _popcount_scores(resp: torch.Tensor, mask: torch.Tensor,
                     bias: torch.Tensor) -> torch.Tensor:
    """resp (M, B, N_f, k) looked-up bits -> scores (B, M) int32: AND over
    k (min of {0,1}), survive iff mask nonzero, popcount over N_f, bias."""
    resp = torch.amin(resp, dim=-1)
    resp = resp * (mask != 0).to(torch.int32)[:, None, :]
    return (torch.sum(resp, dim=-1, dtype=torch.int32).T
            + bias.to(torch.int32)[None, :])


def fused_wnn_ref(tuples: torch.Tensor, params: torch.Tensor,
                  table: torch.Tensor, mask: torch.Tensor,
                  bias: torch.Tensor) -> torch.Tensor:
    """Gather formulation of the fused kernel: table (M, N_f, E) int8
    {0,1} -> scores (B, M) int32."""
    hashes = h3_hash_ref(tuples, params)                      # (B, N_f, k)
    f_idx = torch.arange(table.shape[1], device=table.device)[None, :, None]
    vals = table[:, f_idx, hashes.long()].to(torch.int32)     # (M, B, N_f, k)
    return _popcount_scores(vals, mask, bias)


def packed_wnn_ref(tuples: torch.Tensor, params: torch.Tensor,
                   words: torch.Tensor, mask: torch.Tensor,
                   bias: torch.Tensor) -> torch.Tensor:
    """Packed-domain formulation: gather the (hash >> 5) word of the
    (M, N_f, W) bitplanes and extract bit (hash & 31) — never builds an
    int8 table. Exactly score-equal to `fused_wnn_ref` on the unpacked
    table."""
    hashes = h3_hash_ref(tuples, params)                      # (B, N_f, k)
    words = as_int32_words(words)
    f_idx = torch.arange(words.shape[1], device=words.device)[None, :, None]
    w = words[:, f_idx, (hashes >> 5).long()]                 # (M, B, N_f, k)
    return _popcount_scores((w >> (hashes & 31)[None]) & 1, mask, bias)


def packed_wnn_tenant_ref(bits: torch.Tensor, tids: torch.Tensor,
                          perms: torch.Tensor, params: torch.Tensor,
                          words: torch.Tensor,
                          mask: torch.Tensor) -> torch.Tensor:
    """Tenant-indexed packed-domain scores: every batch row carries a
    tenant id and is scored against THAT tenant's stacked tables (its
    permutation, H3 parameters, word plane and mask are row-gathered), so
    one fixed-shape call serves the whole fleet.

    bits: (B, total_bits) {0,1}; tids: (B,) integer in [0, T); perms:
    (T, N_f, n); params: (T, k, n); words: (T, M, N_f, W) uint32
    bitplanes (or their int32 bit patterns); mask: (T, M, N_f) ->
    (B, M) int32 partial scores WITHOUT bias (the caller adds each
    tenant's). Row r is score-equal to `packed_wnn_ref` on tenant
    tids[r]'s slice: the same fold, word gather and bit extract, only
    indexed per row. No Pallas kernel exists for it in the JAX package
    either; it is tensor code on every device."""
    b = bits.shape[0]
    t, m, n_f, w_cnt = words.shape
    n = perms.shape[-1]
    tids = tids.long()
    perm_row = perms[tids].reshape(b, n_f * n).long()         # (B, N_f·n)
    tuples = torch.gather(bits.to(torch.int8), 1, perm_row).reshape(
        b, n_f, n)
    del perm_row
    h3_row = params[tids].to(torch.int32)                     # (B, k, n)
    hashes = torch.zeros((b, n_f, h3_row.shape[1]), dtype=torch.int32,
                         device=bits.device)
    for i in range(n):                        # torch has no XOR reduction
        hashes ^= torch.where(tuples[:, :, i, None] != 0,
                              h3_row[:, None, :, i], 0)
    # (T, M, N_f, W) -> (T·N_f·W, M): one gather fetches a row's addressed
    # word for every class at once
    wt = as_int32_words(words).permute(0, 2, 3, 1).reshape(t * n_f * w_cnt, m)
    rows = ((tids[:, None, None] * n_f
             + torch.arange(n_f, device=bits.device)[None, :, None]) * w_cnt
            + (hashes >> 5))
    vals = (wt[rows] >> (hashes & 31)[..., None]) & 1          # (B, N_f, k, M)
    resp = torch.amin(vals, dim=2)                             # AND for {0,1}
    # survive iff nonzero (core/bloom.py::apply_mask)
    surv = (mask[tids] != 0).to(torch.int32)                   # (B, M, N_f)
    return torch.sum(resp.transpose(1, 2) * surv, dim=-1, dtype=torch.int32)


def _unsigned(words: torch.Tensor) -> torch.Tensor:
    """Class words (uint8, or uint16/uint32 as int16/int32 bit patterns)
    -> int64 holding their unsigned values."""
    from repro_torch.kernels.wnn_ensemble import element_bits
    return words.to(torch.int64) & ((1 << element_bits(words.dtype)) - 1)


def wnn_ensemble_ref(bits: torch.Tensor, perms, h3s, slices, masks,
                     bias: torch.Tensor) -> torch.Tensor:
    """The class-sliced formulation of the whole ensemble (what
    csrc/wnn.cu computes in one launch).

    bits: (B, total_bits) {0,1}; per submodel perms (N_f, n), h3s (k, n),
    class slices (N_f, E) (or (N_f, E, P) uint32 planes) whose entry
    [f, h] holds bit m of class m's table entry h ((N_f, E / epb) bytes of
    1, 2 or 4-bit entries for M <= 4), mask words (N_f) (or (N_f, P));
    bias (M,) int32 -> scores (B, M) int32:

        resp[b, f] = mask[f] & AND_j slices[f, h_j(bits[b, perm[f, :]])]
        scores[b, m] = bias[m] + sum_{s, f} bit m of resp_s[b, f]

    A hash at or past E (only from malformed parameters) answers 0, as
    the per-class kernels' lookups do."""
    m = bias.shape[0]
    scores = torch.zeros((bits.shape[0], m), dtype=torch.int32,
                         device=bits.device)
    from repro_torch.kernels.wnn_ensemble import unpack_entries
    for perm, h3, sl, mk in zip(perms, h3s, slices, masks):
        if sl.ndim == 2:
            sl = unpack_entries(sl, m)
        n_f, entries = sl.shape[0], sl.shape[1]
        words = _unsigned(sl).reshape(n_f, entries, -1)        # (N_f, E, P)
        hashes = h3_hash_ref(bits[:, perm.long()], h3).long()  # (B, N_f, k)
        live = (hashes >= 0) & (hashes < entries)
        f_idx = torch.arange(n_f, device=bits.device)[None, :, None]
        vals = words[f_idx, hashes.clamp(0, entries - 1)]     # (B, N_f, k, P)
        vals = torch.where(live[..., None], vals, 0)
        resp = _unsigned(mk).reshape(n_f, -1)[None].expand(
            vals.shape[0], -1, -1)                             # (B, N_f, P)
        for j in range(vals.shape[2]):       # torch has no AND reduction
            resp = resp & vals[:, :, j]
        for c in range(m):
            scores[:, c] += torch.sum((resp[..., c // 32] >> (c % 32)) & 1,
                                      dim=1, dtype=torch.int32)
    return scores + bias.to(torch.int32)[None, :]


def thermometer_ref(x: torch.Tensor, thresholds: torch.Tensor) -> torch.Tensor:
    """x: (B, F) f32; thresholds: (F, T) f32 -> bits (B, F, T) int8."""
    return (x[:, :, None] > thresholds[None]).to(torch.int8)


def decompress_ref(counts: torch.Tensor, bits: int) -> torch.Tensor:
    """counts: (B, F) uint8 -> unary bits (B, F, T) int8 (t < count)."""
    iota = torch.arange(bits, dtype=torch.int32, device=counts.device)
    return (iota[None, None, :] < counts[..., None].to(torch.int32)
            ).to(torch.int8)


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0,
                  scale: float | None = None,
                  q_offset: int = 0) -> torch.Tensor:
    """Naive softmax attention in float32. q: (B, H, Sq, D); k: (B, Hkv,
    Sk, D); v: (B, Hkv, Sk, Dv), GQA by repeating each KV head H // Hkv
    times -> (B, H, Sq, Dv) in q's dtype (Dv may differ from D, as MLA's
    prefill has it); `scale` defaults to 1/sqrt(D). Query row i sits at position i + q_offset;
    `causal` keeps keys j <= i + q_offset, `window > 0` keeps
    j > i + q_offset - window. A row with no visible key averages all Sk
    keys (every score is -1e30), as the JAX package's `attention_ref`
    does."""
    h, sq, d = q.shape[1], q.shape[2], q.shape[3]
    hkv, sk = k.shape[1], k.shape[2]
    if hkv != h:
        k = k.repeat_interleave(h // hkv, dim=1)
        v = v.repeat_interleave(h // hkv, dim=1)
    scale = d ** -0.5 if scale is None else scale
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    iq = q_offset + torch.arange(sq, device=q.device)[:, None]
    ik = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (ik <= iq)
    if window > 0:
        mask = mask & (ik > iq - window)
    s = torch.where(mask, s, torch.tensor(-1e30, device=q.device))
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p, v.float()).to(q.dtype)


# scores of the query rows one step of `attention_backward_ref` holds
BACKWARD_SCORE_BYTES = 1 << 28


def attention_backward_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           dout: torch.Tensor, *, causal: bool = True,
                           window: int = 0, scale: float | None = None,
                           q_offset: int = 0,
                           block_rows: int | None = None) -> tuple:
    """The gradients (dq, dk, dv) of `attention_ref` at (q, k, v) for the
    output gradient `dout` (B, H, Sq, Dv), in the inputs' dtypes.

    Autograd through `attention_ref`, recomputed one block of query rows
    at a time so that only that block's (B, H, rows, Sk) float32 scores
    are alive: `block_rows` rows (by default as many as fit in
    BACKWARD_SCORE_BYTES). Rows are independent, so a block's row i sits
    at position q_offset + i0 + i. dk and dv sum over the blocks in
    float32 (or the inputs' wider type) and, through the repeated KV
    heads, over each KV head's query group."""
    b, h, sq, _ = q.shape
    sk = k.shape[2]
    if block_rows is None:
        block_rows = max(1, BACKWARD_SCORE_BYTES // max(1, 4 * b * h * sk))
    kd = k.detach().requires_grad_()
    vd = v.detach().requires_grad_()
    acc = torch.promote_types(k.dtype, torch.float32)
    dq, dk, dv = [], None, None
    with torch.enable_grad():
        for i0 in range(0, sq, block_rows):
            qb = q[:, :, i0:i0 + block_rows].detach().requires_grad_()
            out = attention_ref(qb, kd, vd, causal=causal, window=window,
                                scale=scale, q_offset=q_offset + i0)
            gq, gk, gv = torch.autograd.grad(
                out, (qb, kd, vd), dout[:, :, i0:i0 + block_rows])
            dq.append(gq)
            dk = gk.to(acc) if dk is None else dk + gk.to(acc)
            dv = gv.to(acc) if dv is None else dv + gv.to(acc)
    return torch.cat(dq, dim=2), dk.to(k.dtype), dv.to(v.dtype)
