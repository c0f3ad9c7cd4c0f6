"""The port's plain kernel versions against the JAX package.

Each plain version in `repro_torch.kernels.ref` is held bit-exactly
against `repro.kernels.ref` and against the Pallas kernel it stands for,
run in interpret mode as `tests/test_kernels.py` runs it. Inputs are
drawn once with numpy from a seed and handed to both packages. On CPU
tensors the port's kernel wrappers run these plain versions; the CUDA
kernels themselves are held against them on the card by `chip_smoke.py`
and `tests/test_torch_cuda.py`.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import export as jexport  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.fused_wnn import fused_wnn as jfused_wnn  # noqa: E402
from repro.kernels.packed_wnn import packed_wnn as jpacked_wnn  # noqa: E402
from repro.kernels.thermometer import (  # noqa: E402
    thermometer_decompress as jdecompress, thermometer_encode as jencode)
from repro.packed import layout as jlayout  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.packed import layout  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def wnn_inputs(seed, b, n_f, n, m, log2e, k, mask_kind="random"):
    """numpy (tuples int8, params int32, table bool, mask int8, bias int32)."""
    rng = np.random.default_rng(seed)
    e = 2 ** log2e
    tuples = (rng.random((b, n_f, n)) < 0.5).astype(np.int8)
    params = rng.integers(0, e, (k, n)).astype(np.int32)
    table = rng.random((m, n_f, e)) < 0.3
    if mask_kind == "zeros":
        mask = np.zeros((m, n_f), np.int8)
    else:                       # values > 1 must not scale the response
        mask = rng.integers(0, 4, (m, n_f)).astype(np.int8)
    bias = rng.integers(-5, 6, m).astype(np.int32)
    return tuples, params, table, mask, bias


def port_args(tuples, params, table, mask, bias):
    return (torch.from_numpy(tuples), torch.from_numpy(params),
            torch.from_numpy(table.astype(np.int8)), torch.from_numpy(mask),
            torch.from_numpy(bias))


def port_words(table):
    return torch.from_numpy(jexport.pack_table(table).view(np.int32))


# k ∈ {1, 2, 4}, E ∈ {8, 16, 64, 1024}, N_f and B off every block size
WNN_CASES = [
    # b,  n_f, n,  m, log2e, k, mask
    (5, 13, 7, 3, 3, 1, "random"),
    (16, 40, 12, 10, 4, 2, "random"),
    (9, 33, 20, 4, 6, 4, "random"),
    (3, 21, 16, 2, 10, 2, "random"),
    (7, 17, 9, 5, 6, 2, "zeros"),
    (130, 300, 28, 10, 8, 2, "random"),
    (1, 1, 64, 33, 5, 8, "random"),
]


@pytest.mark.parametrize("b,n_f,n,m,log2e,k,mask_kind", WNN_CASES)
def test_wnn_plain_versions_match_jax_ref(b, n_f, n, m, log2e, k, mask_kind):
    tuples, params, table, mask, bias = wnn_inputs(
        b * 7 + n_f, b, n_f, n, m, log2e, k, mask_kind)
    expect = np.asarray(jref.fused_wnn_ref(
        jnp.asarray(tuples), jnp.asarray(params),
        jnp.asarray(table, jnp.int8), jnp.asarray(mask), jnp.asarray(bias)))
    t_tuples, t_params, t_table, t_mask, t_bias = port_args(
        tuples, params, table, mask, bias)
    fused = ref.fused_wnn_ref(t_tuples, t_params, t_table, t_mask, t_bias)
    packed = ref.packed_wnn_ref(t_tuples, t_params, port_words(table),
                                t_mask, t_bias)
    np.testing.assert_array_equal(fused.numpy(), expect)
    np.testing.assert_array_equal(packed.numpy(), expect)
    jpacked = jref.packed_wnn_ref(
        jnp.asarray(tuples), jnp.asarray(params),
        jnp.asarray(jexport.pack_table(table)), jnp.asarray(mask),
        jnp.asarray(bias))
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jpacked))


# interpret-mode Pallas is slow: keep these tiny (B <= 16, N_f <= 40)
INTERPRET_CASES = [
    (5, 13, 7, 3, 3, 1, "random"),
    (16, 40, 12, 10, 4, 2, "random"),
    (9, 33, 20, 4, 6, 4, "random"),
    (3, 21, 16, 2, 10, 2, "zeros"),
]


@pytest.mark.parametrize("b,n_f,n,m,log2e,k,mask_kind", INTERPRET_CASES)
def test_packed_plain_version_matches_pallas_interpret(b, n_f, n, m, log2e,
                                                       k, mask_kind):
    tuples, params, table, mask, bias = wnn_inputs(
        b + 31 * n_f, b, n_f, n, m, log2e, k, mask_kind)
    expect = jpacked_wnn(jnp.asarray(tuples), jnp.asarray(params),
                         jnp.asarray(jexport.pack_table(table)),
                         jnp.asarray(mask), jnp.asarray(bias), interpret=True)
    t_tuples, t_params, _, t_mask, t_bias = port_args(
        tuples, params, table, mask, bias)
    got = kernels.packed_wnn(t_tuples, t_params, port_words(table), t_mask,
                             t_bias)
    np.testing.assert_array_equal(got.numpy(), np.asarray(expect))


@pytest.mark.parametrize("b,n_f,n,m,log2e,k,mask_kind", INTERPRET_CASES)
def test_fused_plain_version_matches_pallas_interpret(b, n_f, n, m, log2e,
                                                      k, mask_kind):
    tuples, params, table, mask, bias = wnn_inputs(
        b + 17 * n_f, b, n_f, n, m, log2e, k, mask_kind)
    expect = jfused_wnn(jnp.asarray(tuples), jnp.asarray(params),
                        jnp.asarray(table, jnp.int8), jnp.asarray(mask),
                        jnp.asarray(bias), interpret=True)
    got = kernels.fused_wnn(*port_args(tuples, params, table, mask, bias))
    np.testing.assert_array_equal(got.numpy(), np.asarray(expect))


@pytest.mark.parametrize("b,n_f,n,k", [(4, 9, 12, 1), (11, 37, 30, 4),
                                       (2, 5, 64, 8)])
def test_h3_hash_plain_version_matches_jax(b, n_f, n, k):
    rng = np.random.default_rng(b * n)
    tuples = (rng.random((b, n_f, n)) < 0.5).astype(np.int8)
    params = rng.integers(0, 2 ** 15, (k, n)).astype(np.int32)
    expect = jref.h3_hash_ref(jnp.asarray(tuples), jnp.asarray(params))
    got = ref.h3_hash_ref(torch.from_numpy(tuples), torch.from_numpy(params))
    np.testing.assert_array_equal(got.numpy(), np.asarray(expect))


def thermometer_inputs(seed, b, f, t):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, f)).astype(np.float32)
    x[::3, ::5] = np.nan                      # NaN > thr is False: zeros
    thr = np.sort(rng.standard_normal((f, t)), axis=1).astype(np.float32)
    x[1, :] = thr[:, 0]                       # ties: `>` is strict
    counts = rng.integers(0, t + 1, (b, f)).astype(np.uint8)
    return x, thr, counts


@pytest.mark.parametrize("b,f,t", [(5, 7, 3), (13, 40, 7), (2, 1, 1)])
def test_thermometer_plain_versions_match_jax(b, f, t):
    x, thr, counts = thermometer_inputs(b * f, b, f, t)
    tx, tthr, tcounts = (torch.from_numpy(a) for a in (x, thr, counts))
    np.testing.assert_array_equal(
        ref.thermometer_ref(tx, tthr).numpy(),
        np.asarray(jref.thermometer_ref(jnp.asarray(x), jnp.asarray(thr))))
    np.testing.assert_array_equal(
        ref.decompress_ref(tcounts, t).numpy(),
        np.asarray(jref.decompress_ref(jnp.asarray(counts), t)))


@pytest.mark.parametrize("b,f,t", [(5, 7, 3), (13, 40, 7)])
def test_front_end_plain_versions_match_pallas_interpret(b, f, t):
    x, thr, counts = thermometer_inputs(b + f, b, f, t)
    got = kernels.thermometer_encode(torch.from_numpy(x),
                                     torch.from_numpy(thr))
    expect = jencode(jnp.asarray(x), jnp.asarray(thr), interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(expect))
    got = kernels.thermometer_decompress(torch.from_numpy(counts), t)
    expect = jdecompress(jnp.asarray(counts), t, interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(expect))


def test_cpu_wrappers_count_no_launches():
    """CPU tensors run the plain versions: no kernel launch is counted."""
    kernels.reset_launch_counts()
    tuples, params, table, mask, bias = wnn_inputs(3, 4, 9, 12, 3, 6, 2)
    args = port_args(tuples, params, table, mask, bias)
    kernels.fused_wnn(*args)
    kernels.packed_wnn(args[0], args[1], port_words(table), *args[3:])
    x, thr, counts = thermometer_inputs(3, 4, 5, 3)
    kernels.thermometer_encode(torch.from_numpy(x), torch.from_numpy(thr))
    kernels.thermometer_decompress(torch.from_numpy(counts), 3)
    kernels.h3_hash(args[0], args[1])
    q = torch.zeros((1, 2, 3, 16))
    kernels.flash_attention(q, q, q)
    assert kernels.launch_counts() == {
        "packed_wnn": 0, "fused_wnn": 0, "thermometer_encode": 0,
        "thermometer_decompress": 0, "h3_hash": 0, "flash_attention": 0}


def test_wrappers_refuse_tensors_on_other_devices():
    """A tensor that is neither on the CPU nor on CUDA is refused; the
    plain version is never a fallback for it."""
    tuples, params, table, mask, bias = wnn_inputs(5, 4, 9, 12, 3, 6, 2)
    meta = [a.to("meta") for a in port_args(tuples, params, table, mask,
                                            bias)]
    with pytest.raises(ValueError, match="CUDA"):
        kernels.fused_wnn(*meta)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.thermometer_encode(torch.zeros((2, 3), device="meta"),
                                   torch.zeros((3, 2), device="meta"))
    with pytest.raises(ValueError, match="CUDA"):
        kernels.thermometer_decompress(
            torch.zeros((2, 3), dtype=torch.uint8, device="meta"), 2)


@pytest.mark.parametrize("kernel", ["packed_wnn", "fused_wnn"])
@pytest.mark.parametrize("bad,shape,match", [
    ("params", (9, 12), "k=9 outside"), ("tuples", (5, 4, 65), "n=65 outside"),
    ("mask", (3, 3), "mask has shape"), ("bias", (4,), "bias has shape")])
def test_wnn_wrappers_check_the_shapes_their_kernel_reads(kernel, bad, shape,
                                                          match):
    """A WNN kernel reads raw pointers: its wrapper refuses shapes that
    disagree with each other or pass the kernel's bounds, before a launch
    (here on meta tensors, which reach the checks and no kernel)."""
    tuples, params, table, mask, bias = wnn_inputs(5, 5, 4, 12, 3, 6, 2)
    args = dict(zip(("tuples", "params", "table", "mask", "bias"),
                    port_args(tuples, params, table, mask, bias)))
    if kernel == "packed_wnn":
        args["table"] = port_words(table)
    args = {k: v.to("meta") for k, v in args.items()}
    args[bad] = torch.zeros(shape, dtype=args[bad].dtype, device="meta")
    with pytest.raises(ValueError, match=match):
        getattr(kernels, kernel)(*args.values())


@pytest.mark.parametrize("tuples,params,error,match", [
    ((4, 5, 12), (2, 12), ValueError, "takes CUDA tensors"),
    ((4, 5, 12), (2, 11), ValueError, "params has shape"),
    ((4, 60), (2, 12), ValueError, "expected tuples"),
    ((4, 5, 12), (9, 12, 1), ValueError, "expected tuples"),
])
def test_h3_hash_wrapper_checks_its_arguments(tuples, params, error, match):
    """The hash kernel reads raw pointers: its wrapper refuses shapes that
    disagree and tensors off the CPU and CUDA before a launch (here on
    meta tensors, which reach the checks and no kernel)."""
    t = torch.zeros(tuples, dtype=torch.int8, device="meta")
    p = torch.zeros(params, dtype=torch.int32, device="meta")
    with pytest.raises(error, match=match):
        kernels.h3_hash(t, p)


def test_h3_hash_wrapper_checks_dtypes():
    with pytest.raises(TypeError, match="tuples must be torch.int8"):
        kernels.h3_hash(torch.zeros((2, 3, 4), dtype=torch.int32,
                                    device="meta"),
                        torch.zeros((2, 4), dtype=torch.int32, device="meta"))


@pytest.mark.parametrize("log2e", [3, 4, 5, 6, 10])
def test_pack_words_matches_jax_and_round_trips(log2e):
    rng = np.random.default_rng(log2e)
    table = rng.random((3, 11, 2 ** log2e)) < 0.5
    got = layout.pack_words(torch.from_numpy(table))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  jexport.pack_table(table))
    np.testing.assert_array_equal(
        got.numpy().view(np.uint32),
        np.asarray(jlayout.pack_words(jnp.asarray(table))))
    np.testing.assert_array_equal(
        layout.unpack_words(got, 2 ** log2e).numpy(), table.astype(np.int8))
