"""The port's CUDA kernels against their plain versions, on the card.

Every test here carries the `cuda` marker and skips where no CUDA device
is present (decided inside the fixture, never at import). The module
imports only torch and numpy, so it runs on a GPU machine without JAX:

    python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import kernels  # noqa: E402
from repro_torch.core import export  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.launch.scheduler import WnnBatcher  # noqa: E402
from repro_torch.packed import layout  # noqa: E402

pytestmark = pytest.mark.cuda
GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.parametrize("b,n_f,n,m,log2e,k", [
    (1, 1, 1, 1, 3, 1), (37, 45, 7, 10, 3, 1), (300, 77, 12, 10, 4, 4),
    (129, 172, 32, 10, 9, 2), (65, 33, 64, 33, 10, 8),
    (257, 196, 32, 32, 15, 2),
    (19, 1025, 32, 10, 6, 2),      # N_f·n = 32800 bits: four tile windows
    (33, 21, 12, 150, 5, 2)])      # 150 classes: two class groups
def test_wnn_kernels_equal_plain_versions(gen, b, n_f, n, m, log2e, k):
    e = 2 ** log2e
    tuples = torch.randint(0, 2, (b, n_f, n), generator=gen, device="cuda",
                           dtype=torch.int8)
    params = torch.randint(0, e, (k, n), generator=gen, device="cuda",
                           dtype=torch.int32)
    table = (torch.rand((m, n_f, e), generator=gen, device="cuda") < 0.3
             ).to(torch.int8)
    mask = torch.randint(0, 3, (m, n_f), generator=gen, device="cuda",
                         dtype=torch.int8)
    bias = torch.randint(-5, 6, (m,), generator=gen, device="cuda",
                         dtype=torch.int32)
    words = layout.pack_words(table)
    before = kernels.launch_counts()
    got_p = kernels.packed_wnn(tuples, params, words, mask, bias)
    got_f = kernels.fused_wnn(tuples, params, table, mask, bias)
    torch.cuda.synchronize()
    after = kernels.launch_counts()
    assert after["packed_wnn"] == before["packed_wnn"] + 1
    assert after["fused_wnn"] == before["fused_wnn"] + 1
    assert torch.equal(got_p, ref.packed_wnn_ref(tuples, params, words,
                                                 mask, bias))
    assert torch.equal(got_f, ref.fused_wnn_ref(tuples, params, table, mask,
                                                bias))


@pytest.mark.parametrize("b,n_f,n,k", [
    (1, 1, 1, 1), (37, 45, 7, 2), (300, 458, 12, 2), (129, 172, 32, 9),
    (65, 33, 100, 8), (17, 3, 1500, 9)])
def test_h3_hash_kernel_equals_plain_version(gen, b, n_f, n, k):
    """k = 9 (the runtime-k pass), n = 100, and k·n words past the 48 KB
    of shared memory (parameters read from global memory)."""
    tuples = torch.randint(0, 2, (b, n_f, n), generator=gen, device="cuda",
                           dtype=torch.int8)
    params = torch.randint(0, 2 ** 15, (k, n), generator=gen, device="cuda",
                           dtype=torch.int32)
    before = kernels.h3_hash.launches
    got = kernels.h3_hash(tuples, params)
    torch.cuda.synchronize()
    assert kernels.h3_hash.launches == before + 1
    assert torch.equal(got, ref.h3_hash_ref(tuples, params))


@pytest.mark.parametrize("b,f,t", [
    (1, 1, 1), (3, 5, 2), (1027, 784, 7),
    (3, 5, 17),          # B·F·T = 255: a ragged last 16 bytes, run-time T
    (1, 784, 7),         # a single row
    (37, 29, 16), (11, 13, 33), (129, 61, 1),
    (5, 1600, 7),        # F·T = 11200: thresholds past the staged ring
    (2, 3001, 5)])       # F·T = 15005: unstaged, off every 4-float boundary
def test_front_end_kernels_equal_plain_versions(gen, b, f, t):
    """NaN features, ±inf thresholds and counts past T included."""
    x = torch.randn((b, f), generator=gen, device="cuda")
    x[::2, ::3] = float("nan")
    thr = torch.randn((f, t), generator=gen, device="cuda")
    thr[0, -1] = float("inf")
    thr[-1, 0] = float("-inf")
    x[-1, 0] = float("inf")
    counts = torch.randint(0, t + 3, (b, f), generator=gen, device="cuda",
                           dtype=torch.uint8)
    counts[0, 0] = 255
    before = kernels.launch_counts()
    got_e = kernels.thermometer_encode(x, thr)
    got_d = kernels.thermometer_decompress(counts, t)
    torch.cuda.synchronize()
    after = kernels.launch_counts()
    assert after["thermometer_encode"] == before["thermometer_encode"] + 1
    assert after["thermometer_decompress"] == \
        before["thermometer_decompress"] + 1
    assert torch.equal(got_e, ref.thermometer_ref(x, thr))
    assert torch.equal(got_d, ref.decompress_ref(counts, t))


def test_front_end_kernels_refuse_column_slices(gen):
    """The kernels read x and counts as flat arrays: a column slice of a
    wider tensor raises before a launch."""
    x = torch.randn((9, 40), generator=gen, device="cuda")
    counts = torch.zeros((9, 40), dtype=torch.uint8, device="cuda")
    with pytest.raises(ValueError, match="contiguous"):
        kernels.thermometer_encode(x[:, 3:30],
                                   torch.zeros((27, 7), device="cuda"))
    with pytest.raises(ValueError, match="contiguous"):
        kernels.thermometer_decompress(counts[:, :20], 7)


@pytest.mark.parametrize("backend", ["gather", "fused", "packed", "auto"])
def test_golden_scores_on_the_card(gen, backend):
    art = export.load(os.path.join(GOLDEN_DIR, "uln_s_artifact.npz"))
    z = np.load(os.path.join(GOLDEN_DIR, "uln_s_golden.npz"))
    got = export.artifact_scores(art, z["bits"], backend=backend)
    assert got.is_cuda
    np.testing.assert_array_equal(got.cpu().numpy(), z["scores"])


def test_batcher_launches_one_shape_on_the_card(gen):
    art = export.load(os.path.join(GOLDEN_DIR, "uln_s_artifact.npz"))
    z = np.load(os.path.join(GOLDEN_DIR, "uln_s_golden.npz"))
    eng = WnnBatcher(art, slots=16)
    before = kernels.packed_wnn.launches
    for row in z["bits"][:40]:
        eng.submit(row)
    got = np.stack([r.scores for r in eng.drain()])
    np.testing.assert_array_equal(got, z["scores"][:40])
    assert eng.stats()["traces"] == 1
    # three batches, one launch each for the whole ensemble
    assert kernels.packed_wnn.launches == before + 3


def seeded_artifact(seed, m, subs, total_bits, mask_kind="random"):
    """A seeded artifact drawn with numpy; subs as (n, log2 E, k), perms
    wrapped with repeated indices where N_f·n passes total_bits."""
    rng = np.random.default_rng(seed)
    out = []
    for n, log2e, k in subs:
        e, n_f = 2 ** log2e, -(-total_bits // n)
        perm = np.concatenate([rng.permutation(total_bits),
                               rng.integers(0, total_bits, n_f * n)])
        mask = (np.zeros((m, n_f), bool) if mask_kind == "zeros"
                else rng.random((m, n_f)) < 0.8)
        out.append(export.SubmodelArtifact(
            packed=export.pack_table(rng.random((m, n_f, e)) < 0.3),
            mask=mask, perm=perm[:n_f * n].reshape(n_f, n).astype(np.int32),
            h3=rng.integers(0, e, (k, n)).astype(np.uint32), entries=e,
            inputs_per_filter=n, num_hashes=k))
    return export.InferenceArtifact(
        submodels=out, bias=rng.integers(-5, 6, m).astype(np.int32),
        num_classes=m, total_bits=total_bits, bits_per_input=1)


ULN_L = ((12, 6, 2), (16, 7, 2), (20, 7, 2), (24, 8, 2), (28, 8, 2),
         (32, 9, 2))


@pytest.mark.parametrize("m,subs,total_bits,b,mask_kind", [
    (10, ULN_L, 5488, 1031, "random"),                  # ULN-L, six submodels
    (32, ((16, 11, 2), (24, 13, 2), (32, 15, 2)), 6272, 257, "random"),  # XL
    (1, ((7, 3, 1),), 50, 6, "random"),
    (8, ((5, 4, 1), (12, 6, 2), (9, 5, 3), (16, 7, 4)), 100, 9, "random"),
    (33, ((64, 10, 8), (6, 3, 5)), 200, 5, "random"),
    (40, ((13, 8, 6), (11, 5, 7)), 1001, 4099, "random"),  # odd row bytes
    (10, ((10, 5, 2),), 80, 5, "zeros"),
    (10, ((7, 4, 2), (30, 9, 2)), 333, 1, "random"),
    (10, ((16, 7, 2), (12, 6, 2)), 40001, 37, "random"),   # five windows
    (12, ((32, 9, 2),), 65536, 9, "random"),     # the last uint16 index
    (129, ((12, 6, 2), (20, 7, 3)), 784, 37, "random"),   # two class groups
    (200, ((16, 7, 2), (9, 4, 1)), 500, 21, "random"),   # 7 words: 4 + 3
    (10, ((16, 7, 2), (24, 8, 2)), 65537, 19, "random"),  # int32 perms
    (10, ((64, 6, 2),), 250000, 5, "random"),             # global gather
    (150, ((48, 6, 4),), 70001, 11, "random"),            # both at once
])
def test_wnn_ensemble_kernel_equals_plain_version(gen, m, subs, total_bits,
                                                  b, mask_kind):
    """The whole-ensemble kernel on both table layouts, bit-equal to the
    plain version, one launch a call, on the route the wrapper names:
    uint16 perms through the shared tile up to 65,536 input bits, int32
    perms gathered from global memory past that; any class count (class
    groups of 128 past 4 words an entry)."""
    art = seeded_artifact(m * 7 + b, m, subs, total_bits, mask_kind)
    bits = torch.randint(0, 2, (b, total_bits), generator=gen,
                         device="cuda", dtype=torch.int8)
    pt = export.prepare_artifact(art, backend="auto")
    pf = export.prepare_artifact(art, backend="fused")
    for args in (pt.kernel_args, pf.kernel_args):
        assert args.columns == total_bits
        assert args.route == ("shared_tile" if total_bits <= 65536
                              else "global_gather")
        assert args.planes == (-(-m // 32) if m > 16 else 1)
    want = ref.wnn_ensemble_ref(bits, pt.perms, pt.h3s, pt.slices,
                                pt.class_masks, pt.bias)
    before = kernels.launch_counts()
    got_p = kernels.packed_wnn_ensemble(bits, pt)
    got_f = kernels.fused_wnn_ensemble(bits.view(torch.uint8), pf)
    torch.cuda.synchronize()
    after = kernels.launch_counts()
    assert after["packed_wnn"] == before["packed_wnn"] + 1
    assert after["fused_wnn"] == before["fused_wnn"] + 1
    assert torch.equal(got_p, want)
    assert torch.equal(got_f, want)


@pytest.mark.parametrize("route_bits", [6272, 70001])
@pytest.mark.parametrize("m", [1, 2, 3, 4, 5])
def test_wnn_ensemble_kernel_sub_byte_classes_equal_plain_version(
        gen, m, route_bits):
    """Up to 4 classes an entry takes 1, 2 or 4 bits (5 classes: a byte):
    bit-equal to the plain version on both routes, the global gather at
    the first shapes past 65,536 columns, at the ULN-XL ensemble's
    submodel geometry a class-sharded rank of 2 classes holds."""
    subs = ((16, 11, 2), (24, 13, 2), (32, 15, 2))
    art = seeded_artifact(m * 13 + route_bits, m, subs, route_bits)
    bits = torch.randint(0, 2, (133, route_bits), generator=gen,
                         device="cuda", dtype=torch.int8)
    pt = export.prepare_artifact(art, backend="auto")
    args = pt.kernel_args
    assert args.route == ("shared_tile" if route_bits <= 65536
                          else "global_gather")
    epb = {1: 8, 2: 4, 3: 2, 4: 2, 5: 1}[m]
    assert [s_.shape[1] for s_ in pt.slices] == [
        2 ** log2e // epb for _, log2e, _ in subs]
    want = ref.wnn_ensemble_ref(bits, pt.perms, pt.h3s, pt.slices,
                                pt.class_masks, pt.bias)
    before = kernels.launch_counts()["packed_wnn"]
    got = kernels.packed_wnn_ensemble(bits, pt)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["packed_wnn"] == before + 1
    assert torch.equal(got, want)


def test_wnn_ensemble_kernel_reads_rows_wider_than_its_perms(gen):
    """Rows may run past the last input the perms read (here past the
    65536 columns a tile holds): the kernel stages only those columns."""
    art = seeded_artifact(5, 10, ((16, 7, 2),), 3000)
    pt = export.prepare_artifact(art, backend="auto")
    bits = torch.randint(0, 2, (21, 70001), generator=gen, device="cuda",
                         dtype=torch.int8)
    got = kernels.packed_wnn_ensemble(bits, pt)
    want = ref.wnn_ensemble_ref(bits[:, :3000], pt.perms, pt.h3s, pt.slices,
                                pt.class_masks, pt.bias)
    assert torch.equal(got, want)


@pytest.mark.parametrize("backend,kernel", [("auto", "packed_wnn"),
                                            ("fused", "fused_wnn")])
def test_served_path_is_one_launch_without_tuples(gen, backend, kernel):
    """`artifact_scores` on the card: one launch a batch, and no
    (B, N_f, n) tuple tensor (one submodel's would be 4096 × 5488 bytes)."""
    art = seeded_artifact(3, 10, ULN_L, 5488)
    bits = torch.randint(0, 2, (4096, 5488), generator=gen, device="cuda",
                         dtype=torch.int8)
    want = export.artifact_scores(art, bits[:8], backend="gather")
    export.prepare_artifact(art, backend=backend)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    before = getattr(kernels, kernel).launches
    got = export.artifact_scores(art, bits, backend=backend)
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated() - base < 4096 * 5488 // 4
    assert getattr(kernels, kernel).launches == before + 1
    assert torch.equal(got[:8], want)


@pytest.fixture
def full_fp32_matmul(gen):
    """The plain version's float32 products in full float32 (no TF32),
    restored afterwards."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield gen
    torch.backends.cuda.matmul.allow_tf32 = old


@pytest.mark.parametrize("b,h,hkv,sq,sk,d,causal,window,q_offset,dtype", [
    (2, 24, 8, 256, 256, 128, True, 0, 0, "float32"),   # llama 3.2 3B heads
    (2, 24, 8, 256, 256, 128, True, 0, 0, "bfloat16"),
    (1, 24, 8, 256, 256, 128, True, 0, 0, "float32"),   # Engine, batch 1
    (1, 24, 8, 130, 130, 64, True, 0, 0, "float32"),    # ragged, D = 64
    (2, 4, 2, 200, 200, 64, True, 48, 0, "float32"),    # sliding window
    (2, 4, 2, 200, 200, 64, True, 48, 0, "bfloat16"),
    (1, 4, 4, 70, 50, 32, True, 0, 0, "float32"),       # Sq > Sk, ragged
    (1, 4, 1, 32, 96, 16, False, 0, 0, "float32"),      # non-causal, MQA
    (1, 8, 2, 96, 96, 16, True, 0, 0, "bfloat16"),      # 32-byte rows
    (1, 8, 2, 96, 96, 32, True, 0, 0, "bfloat16"),      # 64-byte rows
    (1, 24, 8, 100, 400, 128, True, 0, 300, "float32"),  # past a prefix
    (1, 24, 8, 100, 400, 128, True, 0, 300, "bfloat16"),
    (2, 8, 8, 128, 128, 64, True, 0, 0, "bfloat16"),    # GQA group 1
    (2, 32, 4, 128, 128, 64, True, 0, 0, "bfloat16"),   # GQA group 8
    (1, 4, 2, 1, 1, 128, True, 0, 0, "float32"),        # Sq = 1
    (1, 4, 2, 1, 1, 128, True, 0, 0, "bfloat16"),
    (1, 4, 2, 65, 65, 128, True, 0, 0, "float32"),      # one row past 64
    (1, 4, 2, 65, 65, 128, True, 0, 0, "bfloat16"),
    (1, 2, 1, 100, 100, 256, True, 0, 0, "float32"),    # D = 256
    (1, 2, 1, 100, 100, 256, True, 0, 0, "bfloat16"),
    # grids large enough for two bf16 consumer warpgroups a block
    (4, 24, 8, 300, 300, 128, True, 96, 0, "bfloat16"),   # window, ragged
    (2, 24, 8, 300, 812, 128, True, 0, 512, "bfloat16"),  # past a prefix
    (4, 24, 8, 200, 333, 64, False, 0, 0, "bfloat16"),    # non-causal
])
def test_flash_attention_kernel_equals_plain_version(full_fp32_matmul, b, h,
                                                     hkv, sq, sk, d, causal,
                                                     window, q_offset,
                                                     dtype):
    """The flash kernel against `ref.attention_ref` on the card, through
    both routes and both bf16 block shapes (one or two consumers): GQA
    groups 1, 3, 4 and 8, windows, rows past a cached prefix, ragged
    tiles, Sq = 1, every head width; q enters as the model's transposed
    (B, S, H, D) view."""
    gen = full_fp32_matmul
    dt = getattr(torch, dtype)
    q = torch.randn((b, sq, h, d), generator=gen, device="cuda").to(dt)
    q = q.transpose(1, 2)                      # strided, as attn_mixer has it
    k = torch.randn((b, hkv, sk, d), generator=gen, device="cuda").to(dt)
    v = torch.randn((b, hkv, sk, d), generator=gen, device="cuda").to(dt)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    before = kernels.flash_attention.launches
    got = kernels.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert kernels.flash_attention.launches == before + 1
    want = ref.attention_ref(q, k, v, **kw)
    assert got.shape == want.shape and got.dtype == dt
    # float32: the kernel's running softmax rounds otherwise than one
    # softmax; bf16: one rounding of the output (2^-8) on values below 4
    tol = 2e-2 if dt == torch.bfloat16 else 2e-5
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("b,h,sq,sk,causal,window,q_offset", [
    (4, 16, 1024, 1024, True, 0, 0),      # DeepSeek-V2-Lite prefill
    (1, 16, 777, 777, True, 0, 0),        # ragged query and key tiles
    (2, 16, 300, 300, True, 96, 0),       # windowed
    (1, 16, 100, 400, True, 0, 300),      # past a cached prefix
    (1, 16, 1, 1, True, 0, 0),            # Sq = 1
    (2, 4, 200, 333, False, 0, 0),        # non-causal
])
def test_flash_attention_mla_head_dims_equal_plain_version(
        full_fp32_matmul, b, h, sq, sk, causal, window, q_offset):
    """The float32 route at (D_qk, D_v) = (192, 128), the first shape past
    the square head dims: q as MLA's concatenated (B, S, H, 192) view, k
    contiguous, v (B, Hkv, Sk, 128), within the float32 tolerance of
    `ref.attention_ref` at MLA's scale 1/sqrt(192)."""
    gen = full_fp32_matmul
    q = torch.randn((b, sq, h, 192), generator=gen,
                    device="cuda").transpose(1, 2)
    k = torch.randn((b, h, sk, 192), generator=gen, device="cuda")
    v = torch.randn((b, sk, h, 128), generator=gen,
                    device="cuda").transpose(1, 2)
    kw = dict(causal=causal, window=window, q_offset=q_offset,
              scale=192 ** -0.5)
    before = kernels.flash_attention.launches
    got = kernels.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert kernels.flash_attention.launches == before + 1
    want = ref.attention_ref(q, k, v, **kw)
    assert got.shape == want.shape == (b, h, sq, 128)
    torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)


def test_flash_attention_bf16_refuses_mla_head_dims(gen):
    """The bf16 route takes MLA's (192, 128) and no other unequal pair: the
    swapped (128, 192) and a narrower value (192, 64) raise a ValueError
    naming the pair, before any launch, and nothing pads them."""
    before = kernels.flash_attention.launches
    for d, dv in ((128, 192), (192, 64)):
        q = torch.randn((1, 4, 64, d), generator=gen,
                        device="cuda").bfloat16()
        v = torch.randn((1, 4, 64, dv), generator=gen,
                        device="cuda").bfloat16()
        with pytest.raises(ValueError, match=rf"\({d}, {dv}\)"):
            kernels.flash_attention(q, q, v)
    assert kernels.flash_attention.launches == before


@pytest.mark.parametrize("b,h,sq,sk,causal,window,q_offset", [
    (4, 16, 1024, 1024, True, 0, 0),      # DeepSeek-V2-Lite prefill
    (1, 16, 777, 777, True, 0, 0),        # ragged query and key tiles
    (2, 16, 300, 300, True, 96, 0),       # windowed
    (1, 16, 100, 400, True, 0, 300),      # past a cached prefix
    (1, 16, 1, 1, True, 0, 0),            # Sq = 1
    (2, 4, 200, 333, False, 0, 0),        # non-causal
    (1, 4, 130, 130, True, 0, 0),         # one consumer warpgroup a block
])
def test_flash_attention_bf16_mla_head_dims_equal_plain_version(
        full_fp32_matmul, b, h, sq, sk, causal, window, q_offset):
    """The bf16 route at (D_qk, D_v) = (192, 128): Q and K in three
    64-column panels, V in two under its own 128-wide tensor map, 64-key
    tiles, one or two consumers; q as MLA's (B, S, H, 192) view, k
    contiguous, v (B, Hkv, Sk, 128); within the bf16 tolerance (one
    rounding of P and of the output) of `ref.attention_ref`."""
    gen = full_fp32_matmul
    q = torch.randn((b, sq, h, 192), generator=gen,
                    device="cuda").bfloat16().transpose(1, 2)
    k = torch.randn((b, h, sk, 192), generator=gen, device="cuda").bfloat16()
    v = torch.randn((b, sk, h, 128), generator=gen,
                    device="cuda").bfloat16().transpose(1, 2)
    kw = dict(causal=causal, window=window, q_offset=q_offset,
              scale=192 ** -0.5)
    before = kernels.flash_attention.launches
    got = kernels.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert kernels.flash_attention.launches == before + 1
    want = ref.attention_ref(q, k, v, **kw)
    assert got.shape == want.shape == (b, h, sq, 128)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                               rtol=2e-2)


@pytest.mark.parametrize("b,h,hkv,s,d,dv,dtype", [
    (2, 24, 8, 1024, 128, 128, "float32"),   # Llama 3.2 3B's train shape
    (2, 24, 8, 1024, 128, 128, "bfloat16"),
    (2, 16, 16, 1024, 192, 128, "bfloat16"),  # DeepSeek MLA, bf16
])
def test_flash_attention_backward_on_the_card(full_fp32_matmul, b, h, hkv,
                                              s, d, dv, dtype):
    """`ops.flash_attention` under autograd on the card: the forward
    launches the kernel once, and dq, dk and dv (the plain backward,
    summed over each KV head's query group) equal autograd through
    `ref.attention_ref` — float32 within 1e-5 (the same products), bf16
    within one bf16 step (2^-7 relative, 1e-2 absolute: a float32 sum
    of the group's rows rounded once)."""
    from repro_torch.kernels import ops
    gen = full_fp32_matmul
    dt = getattr(torch, dtype)
    q = torch.randn((b, s, h, d), generator=gen, device="cuda").to(dt)
    q = q.transpose(1, 2).requires_grad_()
    k = torch.randn((b, hkv, s, d), generator=gen,
                    device="cuda").to(dt).requires_grad_()
    v = torch.randn((b, hkv, s, dv), generator=gen,
                    device="cuda").to(dt).requires_grad_()
    dout = torch.randn((b, h, s, dv), generator=gen, device="cuda").to(dt)
    scale = d ** -0.5
    before = kernels.flash_attention.launches
    out = ops.flash_attention(q, k, v, causal=True, scale=scale)
    got = torch.autograd.grad(out, (q, k, v), dout)
    torch.cuda.synchronize()
    assert kernels.flash_attention.launches == before + 1
    want = torch.autograd.grad(
        ref.attention_ref(q, k, v, causal=True, scale=scale), (q, k, v),
        dout)
    tol = (dict(atol=1e-5, rtol=1e-5) if dt == torch.float32
           else dict(atol=1e-2, rtol=2 ** -7))
    for g, w in zip(got, want):
        assert g.dtype == dt and g.shape == w.shape
        torch.testing.assert_close(g.float(), w.float(), **tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_long_band_equals_plain_version(full_fp32_matmul,
                                                        dtype):
    """Mixtral's banded prefill in small: a window of 512 over 1500 keys,
    so query tiles start past the first key tile and skip the tiles
    outside their band."""
    gen = full_fp32_matmul
    dt = getattr(torch, dtype)
    q = torch.randn((1, 1500, 8, 128), generator=gen,
                    device="cuda").to(dt).transpose(1, 2)
    k = torch.randn((1, 1500, 2, 128), generator=gen,
                    device="cuda").to(dt).transpose(1, 2)
    v = torch.randn((1, 1500, 2, 128), generator=gen,
                    device="cuda").to(dt).transpose(1, 2)
    got = kernels.flash_attention(q, k, v, causal=True, window=512)
    want = ref.attention_ref(q, k, v, causal=True, window=512)
    tol = 2e-2 if dt == torch.bfloat16 else 2e-5
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


def test_flash_attention_recurrentgemma_local_shape(full_fp32_matmul):
    """RecurrentGemma 2B's local layers at prefill: MQA (10 query heads
    over one KV head) at head dim 256, a window of 2048 over 4096 tokens,
    float32 through the 16-key tiles of the `mma_3xtf32` route."""
    gen = full_fp32_matmul
    b, h, s, d = 2, 10, 4096, 256
    q = torch.randn((b, s, h, d), generator=gen,
                    device="cuda").transpose(1, 2)
    k = torch.randn((b, s, 1, d), generator=gen,
                    device="cuda").transpose(1, 2)
    v = torch.randn((b, s, 1, d), generator=gen,
                    device="cuda").transpose(1, 2)
    before = kernels.flash_attention.launches
    got = kernels.flash_attention(q, k, v, causal=True, window=2048)
    torch.cuda.synchronize()
    assert kernels.flash_attention.launches == before + 1
    want = ref.attention_ref(q, k, v, causal=True, window=2048)
    torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("arch,n_tokens", [("mamba2_2p7b", 1024),
                                           ("recurrentgemma_2b", 4096)])
def test_recurrent_layer_prefill_equals_its_decode_steps(full_fp32_matmul,
                                                         arch, n_tokens):
    """One full-width Mamba 2 (SSD) or RG-LRU layer on the card: the
    prefill's outputs and final state against the same tokens stepped
    one at a time through the decode recurrence from a zero state,
    within 1e-3 x (1 + |prefill|) (a chunked or log-depth sum against a
    sequential one in float32)."""
    from repro_torch.configs import get_config
    from repro_torch.models import rglru, ssm, transformer
    cfg = get_config(arch)
    gen = full_fp32_matmul
    bld = transformer.Builder(gen, device="cuda")
    if cfg.family == "ssm":
        p = transformer.ParamTree(transformer._ssd_params(bld, cfg))
        block, step, zero = (ssm.mamba2_block, ssm.mamba2_decode,
                             ssm.init_ssm_state)
    else:
        p = transformer.ParamTree(transformer._rec_params(bld, cfg))
        block, step, zero = (rglru.recurrent_block,
                             rglru.recurrent_block_decode,
                             rglru.init_rg_state)
    x = torch.randn((1, n_tokens, cfg.d_model), generator=gen,
                    device="cuda")
    with torch.inference_mode():
        out, want = block(cfg, p, x, return_state=True)
        st = zero(cfg, 1, device="cuda")
        ys = []
        for i in range(n_tokens):
            y, st = step(cfg, p, x[:, i:i + 1], st)
            ys.append(y)
    for got, ref_ in ((torch.cat(ys, dim=1), out), *zip(st, want)):
        assert bool(((got - ref_).abs() <= 1e-3 * (1 + ref_.abs())).all())


@pytest.mark.parametrize("b,h,hkv,sq,sk,d,causal,kv", [
    (8, 6, 6, 1500, 1500, 64, False, "transposed"),   # 6d: Whisper encoder
    (8, 6, 6, 224, 1500, 64, False, "contiguous"),    # 6e: cross, prefill
    (8, 6, 6, 224, 1500, 64, False, "transposed"),
    (8, 6, 6, 1, 1500, 64, False, "contiguous"),      # 6e': cross, decode
    (8, 6, 6, 1, 1500, 64, False, "transposed"),
    (4, 48, 8, 1280, 1280, 128, True, "transposed"),  # 6f: InternVL2
    (4, 40, 40, 1024, 1024, 128, True, "transposed"),  # 6g: Qwen 1.5
], ids=["6d", "6e", "6e_strided", "6e_decode", "6e_decode_strided", "6f",
        "6g"])
def test_flash_attention_encdec_and_patch_shapes(full_fp32_matmul, b, h, hkv,
                                                 sq, sk, d, causal, kv):
    """The float32 route at the shapes the Whisper, InternVL2 and Qwen 1.5
    paths give it: 1500 keys (the last of 24 key tiles holds 28), one
    query row against a 16-row query tile (a decode step's cross
    attention), keys and values contiguous as the cross cache keeps them
    or as transposed (B, S, H, D) projections, 1280 causal rows at 48/8
    heads, and 1024 causal rows multi-head (40/40, group 1)."""
    gen = full_fp32_matmul
    q = torch.randn((b, sq, h, d), generator=gen,
                    device="cuda").transpose(1, 2)
    k, v = (torch.randn((b, sk, hkv, d), generator=gen,
                        device="cuda").transpose(1, 2) for _ in range(2))
    if kv == "contiguous":
        k, v = k.contiguous(), v.contiguous()
    before = kernels.flash_attention.launches
    key = (b, h, hkv, sq, sk, d, d, causal, 0, 0)
    at_shape = kernels.flash_attention.shapes[key]
    got = kernels.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert kernels.flash_attention.launches == before + 1
    assert kernels.flash_attention.shapes[key] == at_shape + 1
    want = ref.attention_ref(q, k, v, causal=causal)
    assert got.shape == want.shape == (b, h, sq, d)
    torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("quant", ["int8", "int4"])
def test_kv_quantisation_on_the_card_equals_the_cpu(gen, quant):
    """`_quantize`, the int4 packing and a quantised cache's write and
    dequantised read (contiguous and paged) at Qwen's 40 heads of 128:
    bit-equal on the card and on the CPU."""
    from repro_torch.models import kvcache
    x = torch.randn((4, 40, 96, 128), generator=gen, device="cuda") * 3
    q, s = kvcache._quantize(x, quant)
    qc, sc = kvcache._quantize(x.cpu(), quant)
    assert int((s.cpu() != sc).sum()) == 0, "scales differ"
    assert int((q.cpu() != qc).sum()) == 0, "payloads differ"
    if quant == "int4":
        packed = kvcache.pack_int4(q)
        assert torch.equal(packed.cpu(), kvcache.pack_int4(qc))
        assert torch.equal(kvcache.unpack_int4(packed), q)
    for dev in ("cuda", "cpu"):
        c = kvcache.init_attn_cache(4, 40, 128, 128, quant, device=dev)
        kvcache.cache_write(c, x[:, :, :64].to(dev), x[:, :, 32:].to(dev),
                            torch.arange(0, 128, 2, device=dev))
        kvcache.cache_write_at(c, x[:, :, :1].to(dev), x[:, :, 1:2].to(dev),
                               torch.tensor([1, 3, 5, 7], device=dev))
        pool = kvcache.init_paged_attn_cache(40, 9, 16, 128, quant, stack=1,
                                             device=dev)
        # eight distinct blocks: a block written twice in one scatter
        # (the null block's collisions) may keep either write on the card
        table = torch.tensor([3, 5, 7, 1, 4, 6, 2, 8], device=dev)
        kvcache.paged_scatter_attn(
            pool, kvcache.AttnCache(*(t[None, :1] for t in c[:4]),
                                    quant=quant), table)
        got = (kvcache.cache_read(c),
               kvcache.paged_gather(pool.layer(0), table[None]))
        if dev == "cuda":
            on_card = [t.cpu() for pair in got for t in pair]
    on_cpu = [t for pair in got for t in pair]
    for a, b in zip(on_card, on_cpu, strict=True):
        assert a.dtype == torch.bfloat16 and torch.equal(a, b)


def test_flash_launches_counted_by_shape_until_reset(gen):
    """`flash_attention.shapes` counts each launch under its (B, H, Hkv,
    Sq, Sk, D, Dv, causal, window, q_offset); a reset clears it with the
    totals."""
    q = torch.randn((2, 4, 8, 64), generator=gen, device="cuda")
    k = torch.randn((2, 2, 12, 64), generator=gen, device="cuda")
    kernels.reset_launch_counts()
    for _ in range(2):
        kernels.flash_attention(q, k, k, causal=False)
    kernels.flash_attention(q, k, k, causal=True, q_offset=4)
    assert dict(kernels.flash_attention.shapes) == {
        (2, 4, 2, 8, 12, 64, 64, False, 0, 0): 2,
        (2, 4, 2, 8, 12, 64, 64, True, 0, 4): 1}
    kernels.reset_launch_counts()
    assert not kernels.flash_attention.shapes
    assert kernels.flash_attention.launches == 0


def test_whisper_layers_on_the_card_equal_the_cpu(full_fp32_matmul):
    """Whisper tiny at full width on the card against the CPU (the plain
    attention): the encoder over 1500 frames, then the prefill and two
    decode steps of a two-layer decoder with its cross attention. The
    prefill's logits and cross keys within atol = rtol = 1e-4 (float32
    products summed in another order); the decode steps' within 1e-3,
    each side reading its own bf16 cache (an entry that rounds to the
    other bf16 neighbour moves a logit by up to 2.5e-4 here); flash
    launched once a layer a prefill (encoder, self and cross) and once a
    cross layer a decode step."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import transformer
    cfg = dataclasses.replace(get_config("whisper_tiny"), num_layers=2,
                              encoder_layers=2)
    gen = torch.Generator().manual_seed(4)
    params = transformer.init_params(cfg, gen, device="cpu")
    frames = torch.randn((2, cfg.encoder_frames, cfg.d_model),
                         generator=gen) * 0.02
    toks = torch.randint(0, cfg.vocab_size, (2, 40), generator=gen)
    steps_in = torch.randint(0, cfg.vocab_size, (2, 2, 1), generator=gen,
                             dtype=torch.int32)
    outs = []
    for dev in ("cpu", "cuda"):
        p = params if dev == "cpu" else params.cuda()
        before = kernels.flash_attention.launches
        with torch.inference_mode():
            logits, st = transformer.forward_prefill(
                cfg, p, toks.to(dev), max_len=48, frames=frames.to(dev))
            got = [logits]
            for tok in steps_in.to(dev):
                logits, st = transformer.forward_decode(cfg, p, tok, st)
                got.append(logits)
        if dev == "cuda":
            torch.cuda.synchronize()
            assert kernels.flash_attention.launches == before + 6 + 2 * 2
        outs.append([g.cpu() for g in got] + [st.cross[0]["l0"].k.cpu()])
    for i, (got, want) in enumerate(zip(outs[1], outs[0])):
        tol = 1e-3 if i in (1, 2) else 1e-4       # the decode steps
        torch.testing.assert_close(got, want, atol=tol, rtol=tol)


def _mla_moe_config():
    """DeepSeek's smoke config with the full-width MLA head dims (128 + 64
    over 128), so the prefill takes the kernel's (192, 128) route."""
    import dataclasses

    from repro_torch.configs import get_config
    return dataclasses.replace(
        get_config("deepseek_v2_lite_16b", smoke=True), qk_nope_dim=128,
        qk_rope_dim=64, v_head_dim=128)


def test_mla_mixer_prefill_and_decode_on_the_card_equal_the_cpu(
        full_fp32_matmul):
    """`mla_mixer` on the card (prefill through the flash kernel) against
    the same layer on the CPU (the plain attention), then one absorbed
    decode step from each side's cache: atol = rtol = 1e-4 (float32
    products summed in another order)."""
    from repro_torch.models import kvcache, transformer
    cfg = _mla_moe_config()
    gen = torch.Generator().manual_seed(3)
    params = transformer.init_params(cfg, gen, device="cpu")
    lp_cpu = params.segments[0].l0[0].mixer
    lp_gpu = transformer.ParamTree(
        {n: p.data.cuda() for n, p in lp_cpu.named_parameters()})
    x = torch.randn((2, 40, cfg.d_model), generator=gen)
    outs = []
    for dev, lp in (("cpu", lp_cpu), ("cuda", lp_gpu)):
        cache = kvcache.init_mla_cache(2, 48, cfg.kv_lora_rank,
                                       cfg.qk_rope_dim, device=dev)
        before = kernels.flash_attention.launches
        y = transformer.mla_mixer(cfg, lp, x.to(dev),
                                  torch.arange(40, device=dev),
                                  mode="prefill", cache=cache)
        if dev == "cuda":
            assert kernels.flash_attention.launches == before + 1
        pos = torch.full((2,), 40, dtype=torch.int32, device=dev)
        yd = transformer.mla_mixer(cfg, lp, x[:, :1].to(dev) * 0.5,
                                   pos[:, None], mode="decode",
                                   cache=cache, pos=pos)
        outs.append((y.cpu(), yd.cpu(), cache.ckv.cpu()))
    for got, want in zip(outs[1], outs[0]):
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


def test_moe_dispatches_agree_on_the_card(full_fp32_matmul):
    """Both dispatches of `moe_block` on the card, with and without a
    token mask, against each other and against the CPU: the sorted
    dispatch's indexed write takes each kept slot once."""
    import dataclasses

    from repro_torch.models import moe, transformer
    cfg = _mla_moe_config()
    gen = torch.Generator().manual_seed(4)
    params = transformer.init_params(cfg, gen, device="cpu")
    ffn_cpu = params.segments[1].l0[0].ffn
    x = torch.randn((4, 160, cfg.d_model), generator=gen)
    mask = torch.rand((4, 160), generator=gen) < 0.7
    ffn_gpu = transformer.ParamTree(
        {n: p.data.cuda() for n, p in ffn_cpu.named_parameters()})
    for m in (None, mask):
        outs = {}
        for dispatch in ("sorted", "einsum"):
            c = dataclasses.replace(cfg, moe_dispatch=dispatch)
            outs[dispatch] = moe.moe_block(
                c, ffn_gpu, x.cuda(), None if m is None else m.cuda())[0]
            want = moe.moe_block(c, ffn_cpu, x, m)[0]
            torch.testing.assert_close(outs[dispatch].cpu(), want,
                                       atol=1e-4, rtol=1e-4)
        torch.testing.assert_close(outs["sorted"], outs["einsum"],
                                   atol=1e-4, rtol=1e-4)


def test_flash_attention_takes_fused_projection_slices(gen):
    """q, k and v sliced out of one (B, S, (H + 2 Hkv) D) projection: rows
    (H + 2 Hkv) D apart, neither contiguous nor a plain transpose."""
    b, s, h, hkv, d = 2, 96, 8, 2, 64
    for dt in (torch.float32, torch.bfloat16):
        qkv = torch.randn((b, s, (h + 2 * hkv) * d), generator=gen,
                          device="cuda").to(dt)
        q = qkv[..., :h * d].view(b, s, h, d).transpose(1, 2)
        k = qkv[..., h * d:(h + hkv) * d].view(b, s, hkv, d).transpose(1, 2)
        v = qkv[..., (h + hkv) * d:].view(b, s, hkv, d).transpose(1, 2)
        got = kernels.flash_attention(q, k, v)
        want = ref.attention_ref(q, k, v)
        tol = 2e-2 if dt == torch.bfloat16 else 2e-5
        torch.testing.assert_close(got.float(), want.float(), atol=tol,
                                   rtol=tol)


def test_flash_attention_kernel_rejects_what_it_cannot_take(gen):
    q = torch.randn((1, 4, 8, 48), generator=gen, device="cuda")
    with pytest.raises(ValueError, match="head dim"):
        kernels.flash_attention(q, q, q)
    q = torch.randn((1, 4, 8, 64), generator=gen, device="cuda")
    with pytest.raises(ValueError, match="no visible key"):
        kernels.flash_attention(q, q[:, :, :2], q[:, :, :2], window=2)
    with pytest.raises(TypeError):
        kernels.flash_attention(q.half(), q.half(), q.half())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_rejects_strides_its_route_cannot_take(gen, dtype):
    """Rows 17 elements apart (not a multiple of 16 bytes) and a base 2
    elements past an aligned one: TMA (bf16) and 16-byte cp.async
    (float32) take neither, and the wrapper says so before any launch."""
    dt = getattr(torch, dtype)
    buf = torch.randn((1, 4, 32, 17), generator=gen, device="cuda").to(dt)
    narrow = buf[..., :16]
    ok = torch.randn((1, 4, 32, 16), generator=gen, device="cuda").to(dt)
    before = kernels.flash_attention.launches
    with pytest.raises(ValueError, match="16 bytes"):
        kernels.flash_attention(narrow, ok, ok)
    shifted = torch.randn((1, 4, 32, 20), generator=gen,
                          device="cuda").to(dt)[..., 2:18]
    with pytest.raises(ValueError, match="aligned base"):
        kernels.flash_attention(ok, shifted, ok)
    assert kernels.flash_attention.launches == before


@pytest.mark.parametrize("hidden_dim", [32, 3072])
def test_head_deployed_scores_bit_equal_across_backends_on_the_card(
        gen, hidden_dim):
    """A UleenHead at a small width and at Llama 3.2 3B's (12,288 input
    bits): fused, packed and auto launch the WNN kernel, and their int32
    scores equal the plain gather formulation's."""
    from repro_torch.core import head
    from repro_torch.core.model import SubmodelSpec
    cfg = head.UleenHeadConfig(num_classes=4, hidden_dim=hidden_dim,
                               submodels=(SubmodelSpec(8, 6),
                                          SubmodelSpec(16, 6)))
    state = head.init_head(gen, cfg)
    state = state._replace(params=state.params._replace(tables=tuple(
        torch.rand(t.shape, generator=gen, device="cuda") * 2 - 1
        for t in state.params.tables)))
    h = torch.randn((67, hidden_dim), generator=gen, device="cuda")
    want = head.apply_head(cfg, state, h, backend="gather")
    for backend in ("fused", "packed", "auto"):
        before = kernels.launch_counts()
        got = head.apply_head(cfg, state, h, backend=backend)
        after = kernels.launch_counts()
        assert got.is_cuda and got.dtype == torch.int32
        assert torch.equal(got, want), backend
        assert sum(after[k] - before[k]
                   for k in ("packed_wnn", "fused_wnn")) == 2, backend


def test_stacked_tenant_scores_equal_the_wnn_kernel_on_the_card(gen):
    """Tenant-stacked scores of a ULN-S-shaped fleet, row by row equal to
    each tenant's own artifact scored by the WNN kernel."""
    from repro_torch.packed import runtime
    subs = ((12, 6, 2), (16, 6, 2), (20, 6, 2))
    arts = [seeded_artifact(40 + t, 10, subs, 1568) for t in range(6)]
    st = export.prepare_tenants(arts)
    bits = torch.randint(0, 2, (301, 1568), generator=gen, device="cuda",
                         dtype=torch.int8)
    tids = torch.randint(0, 6, (301,), generator=gen, device="cuda")
    scores, preds = runtime.stacked_predict(st, bits, tids)
    assert scores.is_cuda and scores.dtype == torch.int32
    before = kernels.packed_wnn.launches
    for t in range(6):
        sel = (tids == t).nonzero().squeeze(1)
        want = export.artifact_scores(arts[t], bits[sel], backend="packed")
        assert torch.equal(scores[sel], want), t
    assert kernels.packed_wnn.launches == before + 6
    assert torch.equal(preds.long(), torch.argmax(scores, -1))


def test_distributed_uleen_step_on_the_card_equals_the_blocked_step(gen):
    """Two gloo ranks sharing the card take one exact distributed step of
    the smoke problem; both hold the single-device blocked step's
    parameters on the card, bit for bit."""
    import test_torch_dist_ranks as ranks
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch import train as train_mod
    spec, statics, bits, labels = train_mod.uleen_smoke_problem(
        0, 1024, device="cuda")
    ref = train_mod.uleen_reference_params(spec, statics, bits, labels,
                                           steps=1, device="cuda")[-1]
    want = [t.cpu().numpy() for t in (*ref.tables, ref.bias)]
    outs = mesh_mod.spawn_ranks(ranks.cuda_exact_step, 2, backend="gloo",
                                timeout_s=300)
    for rank, got in enumerate(outs):
        for i, (g, w) in enumerate(zip(got, want)):
            assert np.array_equal(g, w), f"rank {rank} leaf {i}"


def _fake_like(mode, tensors):
    return [mode.from_tensor(t) for t in tensors]


@pytest.mark.parametrize("kernel", ["packed_wnn", "fused_wnn"])
def test_wnn_operator_equals_its_direct_launch_and_its_fake(gen, kernel):
    """`repro_torch::wnn_ensemble` on a ULN-L-shaped ensemble equals the
    direct `ctypes` launch bit for bit, counts one launch on its wrapper
    (none under a fake trace), and its fake output has the real one's
    shape and dtype."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.kernels import wnn_ensemble
    n_f, n, e, m, k = 458, 12, 64, 10, 2
    perm = torch.randperm(n_f * n, generator=gen, device="cuda").view(n_f, n)
    h3 = torch.randint(0, e, (k, n), generator=gen, device="cuda",
                       dtype=torch.int32)
    table = (torch.rand((m, n_f, e), generator=gen, device="cuda") < 0.3
             ).to(torch.int8)
    mask = torch.ones((m, n_f), dtype=torch.int8, device="cuda")
    args = wnn_ensemble.ensemble_args(
        [perm], [h3], [layout.class_slices_from_table(table)],
        [layout.class_mask_words(mask)], m)
    bias = torch.zeros((m,), dtype=torch.int32, device="cuda")
    bits = torch.randint(0, 2, (1031, n_f * n), generator=gen,
                         device="cuda", dtype=torch.int8)
    tensors = (bits, args.perms, args.params, args.slices, args.masks,
               args.desc, bias)
    extra = wnn_ensemble.op_arguments(args)
    counter = getattr(kernels, kernel)
    before = counter.launches
    got = torch.ops.repro_torch.wnn_ensemble(*tensors, *extra, kernel)
    assert counter.launches == before + 1
    want = torch.empty_like(got)
    wnn_ensemble.launch_direct(*tensors, want, args.columns, args.chunks,
                               args.planes, args.max_hashes)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    with FakeTensorMode() as mode:
        fake = torch.ops.repro_torch.wnn_ensemble(
            *_fake_like(mode, tensors), *extra, kernel)
    assert counter.launches == before + 1
    assert (tuple(fake.shape), fake.dtype) == (tuple(got.shape), got.dtype)


def test_h3_operator_equals_its_direct_launch_and_its_fake(gen):
    import importlib
    from torch._subclasses.fake_tensor import FakeTensorMode
    # the package's `h3_hash` is the wrapper; its module holds the launch
    h3_mod = importlib.import_module("repro_torch.kernels.h3_hash")
    tuples = torch.randint(0, 2, (4099, 229, 24), generator=gen,
                           device="cuda", dtype=torch.int8)
    params = torch.randint(0, 256, (9, 24), generator=gen, device="cuda",
                           dtype=torch.int32)
    before = kernels.h3_hash.launches
    got = torch.ops.repro_torch.h3_hash(tuples, params)
    assert kernels.h3_hash.launches == before + 1
    want = torch.empty_like(got)
    h3_mod.launch_direct(tuples, params, want)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(got, ref.h3_hash_ref(tuples, params))
    with FakeTensorMode() as mode:
        fake = torch.ops.repro_torch.h3_hash(*_fake_like(mode,
                                                         (tuples, params)))
    assert kernels.h3_hash.launches == before + 1
    assert (tuple(fake.shape), fake.dtype) == (tuple(got.shape), got.dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_operator_equals_its_direct_launch_and_its_fake(gen, dtype):
    """`repro_torch::flash_attention` at a Llama 3.2 3B prefill shape (24
    query heads over 8 KV heads, D 128) equals the direct `ctypes` launch
    bit for bit, counts one launch (none under a fake trace), and its
    fake has the real output's shape and dtype."""
    import importlib
    from torch._subclasses.fake_tensor import FakeTensorMode
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    dt = getattr(torch, dtype)
    q = torch.randn((2, 24, 1024, 128), generator=gen, device="cuda").to(dt)
    k = torch.randn((2, 8, 1024, 128), generator=gen, device="cuda").to(dt)
    v = torch.randn((2, 8, 1024, 128), generator=gen, device="cuda").to(dt)
    before = kernels.flash_attention.launches
    got = torch.ops.repro_torch.flash_attention(q, k, v, True, 0,
                                                128 ** -0.5, 0)
    assert kernels.flash_attention.launches == before + 1
    want = torch.empty_like(got)
    fa.launch_direct(q, k, v, want, True, 0, 128 ** -0.5, 0)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    with FakeTensorMode() as mode:
        fake = torch.ops.repro_torch.flash_attention(
            *_fake_like(mode, (q, k, v)), True, 0, 128 ** -0.5, 0)
    assert kernels.flash_attention.launches == before + 1
    assert (tuple(fake.shape), fake.dtype) == (tuple(got.shape), got.dtype)


def test_flash_ctx_shard_with_q_offset_equals_rows_of_the_full_call(gen):
    """A query-sequence shard (the `ctx` placement: 24 heads cannot split
    over 16) attends over the whole K and V from its offset: each of 4
    shards' rows equal the same rows of the full call, bit for bit (the
    kernel's tiles see the same keys in the same order)."""
    q = torch.randn((1, 24, 2048, 128), generator=gen, device="cuda")
    k = torch.randn((1, 8, 2048, 128), generator=gen, device="cuda")
    v = torch.randn((1, 8, 2048, 128), generator=gen, device="cuda")
    full = kernels.flash_attention(q, k, v, causal=True)
    n = 2048 // 4
    for c in range(4):
        part = kernels.flash_attention(q[:, :, c * n:(c + 1) * n].contiguous(),
                                       k, v, causal=True, q_offset=c * n)
        torch.cuda.synchronize()
        assert torch.equal(part, full[:, :, c * n:(c + 1) * n]), c


@pytest.mark.parametrize("b,s", [(2, 8192), (1, 4096)])
def test_flash_bf16_window_at_mixtral_rank_shard(gen, b, s):
    """The bf16 route with Mixtral's sliding window of 4096 at one rank's
    shard of the placed prefill and train cells (`dist.placed.attention`:
    32 heads over `model` = 16, the 8 KV heads replicated): 2 query heads
    over the one KV head they share, D 128, q a head slice of the
    (B, S, H, hd) projection and K, V one head of the (B, S, 8, hd) keys
    (transposed views, as the rank hands them over); within the bf16
    tolerance of `ref.attention_ref`."""
    q = torch.randn((b, s, 2, 128), generator=gen,
                    device="cuda").bfloat16().transpose(1, 2)
    k, v = (torch.randn((b, s, 8, 128), generator=gen,
                        device="cuda").bfloat16().transpose(1, 2)[:, 3:4]
            for _ in range(2))
    before = kernels.flash_attention.launches
    got = kernels.flash_attention(q, k, v, causal=True, window=4096)
    torch.cuda.synchronize()
    assert kernels.flash_attention.launches == before + 1
    want = ref.attention_ref(q, k, v, causal=True, window=4096)
    assert got.shape == want.shape == (b, 2, s, 128)
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                               rtol=2e-2)


@pytest.mark.parametrize("b,s", [(2, 8192), (1, 4096)])
def test_flash_bf16_mla_at_deepseek_rank_shard(gen, b, s):
    """The bf16 (192, 128) route at one DeepSeek head, a rank's shard of
    the placed prefill and train cells (16 heads over `model` = 16): q
    and k the rank's (B, S, 1, 192) concatenations, v its (B, S, 1, 128)
    values, transposed; within the bf16 tolerance of
    `ref.attention_ref`."""
    q, k = (torch.randn((b, s, 1, 192), generator=gen,
                        device="cuda").bfloat16().transpose(1, 2)
            for _ in range(2))
    v = torch.randn((b, s, 1, 128), generator=gen,
                    device="cuda").bfloat16().transpose(1, 2)
    before = kernels.flash_attention.launches
    got = kernels.flash_attention(q, k, v, causal=True, scale=192 ** -0.5)
    torch.cuda.synchronize()
    assert kernels.flash_attention.launches == before + 1
    want = ref.attention_ref(q, k, v, causal=True, scale=192 ** -0.5)
    assert got.shape == want.shape == (b, 1, s, 128)
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                               rtol=2e-2)


@pytest.mark.parametrize("b,sq,q_offset,sk", [(2, 2048, 30720, 32768),
                                               (1, 256, 3840, 4096)])
def test_flash_bf16_local_mqa_at_recurrentgemma_rank_shard(gen, b, sq,
                                                          q_offset, sk):
    """The bf16 route at D 256 with RecurrentGemma's local MQA (10 query
    heads over one KV head, a window of 2048) at one rank's shard of the
    placed prefill and train cells: the 10 heads cannot take `model`, so
    a rank holds S / 16 query rows (`ctx`) at `q_offset` = its first row,
    past the window, against every key (the last rank of prefill_32k and
    of train_4k); q a row block of the (B, S, 10, 256) projection and K,
    V the (B, S, 1, 256) keys, transposed views as the rank hands them
    over; within the bf16 tolerance of `ref.attention_ref`."""
    s = q_offset + sq
    assert s == sk and q_offset > 2048
    q = torch.randn((b, s, 10, 256), generator=gen,
                    device="cuda").bfloat16()[:, q_offset:].transpose(1, 2)
    k, v = (torch.randn((b, sk, 1, 256), generator=gen,
                        device="cuda").bfloat16().transpose(1, 2)
            for _ in range(2))
    kw = dict(causal=True, window=2048, q_offset=q_offset)
    before = kernels.flash_attention.launches
    got = kernels.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert kernels.flash_attention.launches == before + 1
    want = ref.attention_ref(q, k, v, **kw)
    assert got.shape == want.shape == (b, 10, sq, 256)
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                               rtol=2e-2)


def test_flash_bf16_at_whisper_decoder_rank_shard(gen):
    """The bf16 route at D 64 with Whisper's decoder self-attention at the
    last rank's shard of the placed prefill_32k (6l): 6 heads cannot take
    `model`, so the rank's 2048 query rows (`ctx`) start at 30,720,
    causal against all 32,768 keys; q a row block of the (2, S, 6, 64)
    projection, K and V the whole projections, transposed views as the
    rank hands them over; within the bf16 tolerance of
    `ref.attention_ref`."""
    b, sq, q_offset, sk = 2, 2048, 30720, 32768
    q = torch.randn((b, sk, 6, 64), generator=gen,
                    device="cuda").bfloat16()[:, q_offset:].transpose(1, 2)
    k, v = (torch.randn((b, sk, 6, 64), generator=gen,
                        device="cuda").bfloat16().transpose(1, 2)
            for _ in range(2))
    key = (b, 6, 6, sq, sk, 64, 64, True, 0, q_offset)
    at_shape = kernels.flash_attention.shapes[key]
    got = kernels.flash_attention(q, k, v, causal=True, q_offset=q_offset)
    torch.cuda.synchronize()
    assert kernels.flash_attention.shapes[key] == at_shape + 1
    want = ref.attention_ref(q, k, v, causal=True, q_offset=q_offset)
    assert got.shape == want.shape == (b, 6, sq, 64)
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                               rtol=2e-2)


def test_flash_f32_at_whisper_cross_rank_shard(full_fp32_matmul):
    """The float32 route at Whisper's cross attention in a rank's shard of
    the placed prefill_32k (6m): the bf16 queries promoted to float32
    (a row block of 2048 of the (2, S, 6, 64) projection, transposed)
    over the float32 keys and values of the 1500 frames, gathered whole
    and contiguous as the cross state keeps them, non-causal; within the
    float32 tolerance of `ref.attention_ref`."""
    gen = full_fp32_matmul
    b, sq, sk = 2, 2048, 1500
    q = torch.randn((b, 2 * sq, 6, 64), generator=gen, device="cuda"
                    ).bfloat16().float()[:, sq:].transpose(1, 2)
    k, v = (torch.randn((b, 6, sk, 64), generator=gen, device="cuda")
            for _ in range(2))
    key = (b, 6, 6, sq, sk, 64, 64, False, 0, 0)
    at_shape = kernels.flash_attention.shapes[key]
    got = kernels.flash_attention(q, k, v, causal=False)
    torch.cuda.synchronize()
    assert kernels.flash_attention.shapes[key] == at_shape + 1
    want = ref.attention_ref(q, k, v, causal=False)
    assert got.shape == want.shape == (b, 6, sq, 64)
    torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)


def test_thermometer_operators_equal_their_direct_launches_and_fakes(gen):
    import importlib
    from torch._subclasses.fake_tensor import FakeTensorMode
    th = importlib.import_module("repro_torch.kernels.thermometer")
    x = torch.rand((4099, 784), generator=gen, device="cuda")
    thr = torch.sort(torch.rand((784, 7), generator=gen, device="cuda"),
                     dim=1).values
    counts = torch.randint(0, 8, (4099, 784), generator=gen, device="cuda",
                           dtype=torch.uint8)
    b_enc = kernels.thermometer_encode.launches
    b_dec = kernels.thermometer_decompress.launches
    enc = torch.ops.repro_torch.thermometer_encode(x, thr)
    dec = torch.ops.repro_torch.thermometer_decompress(counts, 7)
    assert kernels.thermometer_encode.launches == b_enc + 1
    assert kernels.thermometer_decompress.launches == b_dec + 1
    want_enc, want_dec = torch.empty_like(enc), torch.empty_like(dec)
    th.encode_direct(x, thr, want_enc)
    th.decompress_direct(counts, want_dec)
    torch.cuda.synchronize()
    assert torch.equal(enc, want_enc) and torch.equal(dec, want_dec)
    assert torch.equal(enc, ref.thermometer_ref(x, thr))
    assert torch.equal(dec, ref.decompress_ref(counts, 7))
    with FakeTensorMode() as mode:
        f_enc = torch.ops.repro_torch.thermometer_encode(
            *_fake_like(mode, (x, thr)))
        f_dec = torch.ops.repro_torch.thermometer_decompress(
            *_fake_like(mode, (counts,)), 7)
    assert kernels.thermometer_encode.launches == b_enc + 1
    assert kernels.thermometer_decompress.launches == b_dec + 1
    for f, r in ((f_enc, enc), (f_dec, dec)):
        assert (tuple(f.shape), f.dtype) == (tuple(r.shape), r.dtype)


def test_fused_wnn_reads_no_perm_and_stays_bit_equal_at_uln_l(gen):
    """`fused_wnn` passes its identity perm's reach to `ensemble_args`
    (no host read of the perm): at every ULN-L geometry it equals the
    launch built the old way (the perm read on the host) and the plain
    version, bit for bit."""
    from repro_torch.kernels import wnn_ensemble
    for n, log2e in ((12, 6), (16, 7), (20, 7), (24, 8), (28, 8), (32, 9)):
        n_f, e, m, k, b = -(-784 * 7 // n), 2 ** log2e, 10, 2, 4096
        tuples = torch.randint(0, 2, (b, n_f, n), generator=gen,
                               device="cuda", dtype=torch.int8)
        params = torch.randint(0, e, (k, n), generator=gen, device="cuda",
                               dtype=torch.int32)
        table = (torch.rand((m, n_f, e), generator=gen, device="cuda") < 0.3
                 ).to(torch.int8)
        mask = torch.randint(0, 3, (m, n_f), generator=gen, device="cuda",
                             dtype=torch.int8)
        bias = torch.randint(-5, 6, (m,), generator=gen, device="cuda",
                             dtype=torch.int32)
        got = kernels.fused_wnn(tuples, params, table, mask, bias)
        perm = torch.arange(n_f * n, device="cuda").view(n_f, n)
        old = wnn_ensemble.ensemble_args(
            [perm], [params], [layout.class_slices_from_table(table)],
            [layout.class_mask_words(mask)], m)
        assert old.columns == n_f * n
        before = wnn_ensemble.launch_ensemble(
            "fused_wnn", tuples.view(b, n_f * n), old, bias)
        torch.cuda.synchronize()
        assert torch.equal(got, before), n
        assert torch.equal(got, ref.fused_wnn_ref(tuples, params, table,
                                                  mask, bias)), n
