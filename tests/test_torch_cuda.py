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
