"""The flash kernels' host-side plan, on the CPU: the tiles chosen per
(D, type, Sq), the shared-memory and register budget each plan states,
and the TMA tensor maps and cp.async checks of the model's own q, k and v
views. The kernels themselves run only on the card
(`tests/test_torch_cuda.py`); what the C side takes is decided here.
"""
import importlib

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import layers  # noqa: E402

fa = importlib.import_module("repro_torch.kernels.flash_attention")
PORTED_CONFIGS = ("llama3p2_3b", "qwen2p5_14b", "minitron_8b")
SHAPES = [(4, 24, 1024), (1, 24, 128), (1, 24, 256), (1, 24, 512),
          (1, 24, 1024), (1, 40, 65), (2, 8, 1), (8, 32, 4096)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", fa.HEAD_DIMS)
def test_every_plan_fits_its_budget(dtype, d):
    """Shared memory within what a block may opt in to, registers within
    the SM's file and 255 a thread, at least one resident block, tiles the
    C side instantiates, and a grid that covers Sq."""
    for b, h, sq in SHAPES:
        p = fa.plan(dtype, d, batch=b, heads=h, sq=sq)
        assert p.route == fa.ROUTES[dtype] and p.d == d
        assert p.smem_bytes <= fa.SMEM_PER_BLOCK
        assert p.regs_per_block <= fa.REGS_PER_SM
        assert all(r <= fa.MAX_REGS_PER_THREAD for _, r in p.regs)
        assert sum(n for n, _ in p.regs) == p.threads
        assert p.blocks_per_sm >= 1
        assert p.grid == (h, b, -(-sq // p.block_q))
        assert p.grid[2] * p.block_q >= sq > (p.grid[2] - 1) * p.block_q
        if dtype == torch.float32:
            block_k, max_warps, _ = fa.f32_tiles(d)
            assert p.block_k == block_k and p.block_k % 8 == 0
            assert p.block_q % 16 == 0 and p.threads == 2 * p.block_q
            assert p.block_q // 16 in (1, 2, 4, 8)[:max_warps.bit_length()]
        else:
            block_k, consumers = fa.bf16_tiles(d)
            assert p.block_k == block_k and p.block_k % 16 == 0
            assert p.block_q in (64, 128)[:consumers]
            assert p.threads == 128 * (p.block_q // 64 + 1)
            # with two consumers setmaxnreg moves registers from the
            # producer to the consumers: what they gain the producer gives
            # up from the launch bound's 168
            launch_cap = min(fa.MAX_REGS_PER_THREAD,
                             fa.REGS_PER_SM // p.threads // 8 * 8)
            (nc, rc), (npr, rp) = p.regs
            assert nc == p.block_q * 2 and npr == 128
            if p.block_q == 128:
                assert launch_cap == 168
            assert nc * (rc - launch_cap) <= npr * (launch_cap - rp)


@pytest.mark.parametrize("d", (16, 32, 64, 128))
def test_full_query_tiles_keep_eight_warps_or_a_pipeline_per_sm(d):
    """At the prefill shape (B 4, 24 heads, 1024 tokens) the float32 route
    keeps eight warps on every SM (two blocks of four below D = 128, one
    of eight at D = 128, whose 64-key ring fills shared memory); the bf16
    route one block of a producer and two consumer warpgroups."""
    f32 = fa.plan(torch.float32, d, batch=4, heads=24, sq=1024)
    _, max_warps, min_blocks = fa.f32_tiles(d)
    assert f32.block_q == 16 * max_warps
    assert f32.blocks_per_sm >= min_blocks
    assert f32.blocks_per_sm * f32.threads // 32 >= 8
    bf16 = fa.plan(torch.bfloat16, d, batch=4, heads=24, sq=1024)
    assert bf16.block_q == 128 and bf16.threads == 384
    assert bf16.blocks_per_sm >= 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sq", (128, 256, 512, 1024))
def test_short_prompts_take_smaller_query_tiles(dtype, sq):
    """The Engine prefills one request at a time (B 1, 24 heads): float32
    takes the most warps whose grid reaches half the SMs, bf16 two
    consumer warpgroups only where the grid reaches every SM."""
    p = fa.plan(dtype, 128, batch=1, heads=24, sq=sq)
    if dtype == torch.float32:
        smallest, largest, reach = 16, 128, fa.H100_SMS / 2
    else:
        smallest, largest, reach = 64, 128, fa.H100_SMS
    if p.block_q > smallest:
        assert p.blocks >= reach
    if p.block_q < largest:
        assert 24 * -(-sq // (2 * p.block_q)) < reach
    # a card with fewer SMs fills with larger tiles
    assert fa.plan(dtype, 128, batch=1, heads=24, sq=sq,
                   n_sms=8).block_q >= p.block_q


def _model_views(arch, dtype, batch=2, seq=16):
    """q, k, v as `attn_mixer` hands them to the kernel: projections
    viewed (B, S, H, hd), RoPE on q and k, then (B, H, S, hd) views."""
    cfg = get_config(arch)
    hd, h, hkv = cfg.resolved_head_dim, cfg.num_heads, cfg.num_kv_heads
    gen = torch.Generator().manual_seed(0)
    q = torch.randn((batch, seq, h * hd), generator=gen).to(dtype)
    k = torch.randn((batch, seq, hkv * hd), generator=gen).to(dtype)
    v = torch.randn((batch, seq, hkv * hd), generator=gen).to(dtype)
    q, k, v = (q.view(batch, seq, h, hd), k.view(batch, seq, hkv, hd),
               v.view(batch, seq, hkv, hd))
    pos = torch.arange(seq)
    q = layers.apply_rope(q, pos, cfg.rope_theta)
    k = layers.apply_rope(k, pos, cfg.rope_theta)
    return cfg, q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)


@pytest.mark.parametrize("arch", PORTED_CONFIGS)
def test_model_views_qualify_for_tma(arch):
    """The bf16 route's tensor maps of the ported configs' views: dims
    (D, S, H, B) and byte strides of the (B, S, H, D) layout, no copy."""
    cfg, q, k, v = _model_views(arch, torch.bfloat16)
    hd, h, hkv = cfg.resolved_head_dim, cfg.num_heads, cfg.num_kv_heads
    p = fa.plan(torch.bfloat16, hd, batch=2, heads=h, sq=16)
    for t, heads, rows in ((q, h, p.block_q), (k, hkv, p.block_k),
                           (v, hkv, p.block_k)):
        m = fa.tensor_map(t, rows)
        assert m.dims == (hd, 16, heads, 2)
        assert m.strides == (heads * hd * 2, hd * 2, 16 * heads * hd * 2)
        assert m.box == (min(hd, 64), rows, 1, 1)
        assert m.swizzle == 2 * min(hd, 64)


@pytest.mark.parametrize("arch", PORTED_CONFIGS)
def test_model_views_qualify_for_cp_async(arch):
    _, q, k, v = _model_views(arch, torch.float32)
    for t in (q, k, v):
        fa.check_cp_async(t)


@pytest.mark.parametrize("d,swizzle", [(16, 32), (32, 64), (64, 128),
                                       (128, 128), (256, 128)])
def test_tensor_map_swizzle_follows_the_row(d, swizzle):
    """A panel's row is min(D, 64) bf16 values; the swizzle is as wide:
    D = 16 rows are 32 bytes, which TMA takes with a 32-byte swizzle."""
    t = torch.zeros((1, 2, 8, d), dtype=torch.bfloat16)
    m = fa.tensor_map(t, 64)
    assert m.swizzle == swizzle and m.box[0] * 2 == swizzle
    assert m.dims == (d, 8, 2, 1)
    # a batch of 1 has no batch step; it gets S·H·D, a 16-byte multiple
    assert m.strides == (d * 2, 8 * d * 2, 8 * 2 * d * 2)


def test_tensor_map_refuses_what_tma_cannot_take():
    rows_144b = torch.zeros((1, 4, 9, 72), dtype=torch.bfloat16)[..., :16]
    assert fa.tensor_map(rows_144b, 64).strides == (144, 9 * 144,
                                                    9 * 4 * 16 * 2)
    odd = torch.zeros((1, 4, 9, 20), dtype=torch.bfloat16)[..., 2:18]
    with pytest.raises(ValueError, match="aligned base"):
        fa.tensor_map(odd, 64)
    narrow = torch.zeros((1, 4, 9, 17), dtype=torch.bfloat16)[..., :16]
    with pytest.raises(ValueError, match="row stride"):
        fa.tensor_map(narrow, 64)
    with pytest.raises(ValueError, match="contiguous"):
        fa.tensor_map(torch.zeros((1, 4, 16, 9),
                                  dtype=torch.bfloat16).transpose(2, 3), 64)
    with pytest.raises(ValueError, match="1-256 rows"):
        fa.tensor_map(torch.zeros((1, 1, 8, 16), dtype=torch.bfloat16), 512)


def test_cp_async_check_refuses_unaligned_rows():
    fa.check_cp_async(torch.zeros((1, 2, 8, 16)))
    with pytest.raises(ValueError, match="multiples of 16 bytes"):
        fa.check_cp_async(torch.zeros((1, 2, 8, 18))[..., :16])
    with pytest.raises(ValueError, match="aligned base"):
        fa.check_cp_async(torch.zeros((1, 2, 8, 20))[..., 1:17])


def test_plan_refuses_what_no_route_takes():
    with pytest.raises(ValueError, match="head dim"):
        fa.plan(torch.float32, 48, batch=1, heads=1, sq=1)
    with pytest.raises(TypeError):
        fa.plan(torch.float16, 64, batch=1, heads=1, sq=1)
