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
    (257, 196, 32, 32, 15, 2)])
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


@pytest.mark.parametrize("b,f,t", [(1, 1, 1), (3, 5, 2), (1027, 784, 7)])
def test_front_end_kernels_equal_plain_versions(gen, b, f, t):
    x = torch.randn((b, f), generator=gen, device="cuda")
    x[::2, ::3] = float("nan")
    thr = torch.randn((f, t), generator=gen, device="cuda")
    counts = torch.randint(0, t + 1, (b, f), generator=gen, device="cuda",
                           dtype=torch.uint8)
    assert torch.equal(kernels.thermometer_encode(x, thr),
                       ref.thermometer_ref(x, thr))
    assert torch.equal(kernels.thermometer_decompress(counts, t),
                       ref.decompress_ref(counts, t))


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
    assert kernels.packed_wnn.launches == before + 3 * len(art.submodels)


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
