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
    (3, 9, 8, 129, 4, 2, "random"),     # past 128 classes: two groups
    (2, 5, 6, 200, 3, 3, "random"),     # seven class words, two groups
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


def _decompress_word(T, ta, ca, cb):
    """csrc/thermometer.cu's four decompressed bytes at once (3 <= T <=
    16): bits ta + k (less T past the boundary s = T - ta), counts
    clamped to 127, tk < c iff bit 7 of 0x80 + tk - c is clear."""
    full = 0xFFFFFFFF
    nxt = 0 if T - ta >= 4 else (full << (8 * (T - ta))) & full
    tk = (ta * 0x01010101 + 0x03020100 - (nxt & (T * 0x01010101))) & full
    c4 = ((min(int(ca), 127) * 0x01010101) & ~nxt & full) | \
        ((min(int(cb), 127) * 0x01010101) & nxt)
    return (~((tk | 0x80808080) - c4) & full) >> 7 & 0x01010101


def emulate_front_end(x, thr, counts, t_bits, blocks):
    """csrc/thermometer.cu's walk, in Python over the flat arrays: each of
    `blocks` starts at its 16 KB tile with the cursor (q = o / T,
    t = o mod T, r = o mod F·T) and advances it by the grid's step with
    carries; the tile's inputs are features q .. q + hi (hi clamped to the
    last); warp w's chunk j lies d = (8 j + w)·512 bytes in, its
    thresholds from (r + d) mod F·T; lane l builds words l + 32 i, byte k
    from feature (t + d + off + k) / T (T <= 2) or from the pair qa,
    qa + 1 picked by ta + k >= T, each clamped to hi (decompression at
    3 <= T <= 16: the word at once, `_decompress_word`); thresholds from
    the ring (thr_flat and its first 512 repeated) or the wrapped global
    index. Encodes when `thr` is given, else decompresses. Returns the
    flat output bytes."""
    from repro_torch.kernels import thermometer as th
    warps, chunk, tile, T = 8, th.CHUNK, th.TILE, t_bits
    src = x if thr is not None else counts
    total = src.size * T
    row = thr.size if thr is not None else T
    staged = thr is not None and th.thresholds_staged(row // T, T)
    ring = (np.concatenate([thr, np.resize(thr, chunk)]) if staged
            else None)
    last = total // T - 1
    out = np.full(total, -1, np.int64)
    step = blocks * tile
    dq, dt, dr = step // T, step % T, step % row
    for o in range(0, step, tile):
        q, t, r = o // T, o % T, o % row
        for o in range(o, total, step):
            hi = min(q + (t + tile - 1) // T, last) - q
            for j in range(tile // (warps * chunk)):
                for w in range(warps):
                    d = (j * warps + w) * chunk
                    rc = (r + d) % row
                    for lane in range(32):
                        for i in range(4):
                            off = 4 * (lane + 32 * i)
                            n0 = t + d + off
                            qa, ta = n0 // T, n0 % T
                            if thr is None and 3 <= T <= 16:
                                word = _decompress_word(
                                    T, ta, counts[q + min(qa, hi)],
                                    counts[q + min(qa + 1, hi)])
                            for k in range(4):
                                if o + d + off + k >= total:
                                    continue
                                if T <= 2:
                                    f, bit = (n0 + k) // T, (n0 + k) % T
                                else:
                                    nxt = ta + k >= T
                                    f = qa + nxt
                                    bit = ta + k - T if nxt else ta + k
                                f = q + min(f, hi)
                                if thr is None and 3 <= T <= 16:
                                    val = (word >> (8 * k)) & 1
                                elif thr is None:
                                    val = int(bit < counts[f])
                                elif staged:
                                    val = int(x[f] > ring[rc + off + k])
                                else:
                                    rr = rc + off + k
                                    val = int(x[f] > thr[rr - row
                                                         if rr >= row
                                                         else rr])
                                out[o + d + off + k] = val
            t, q = t + dt, q + dq
            if t >= T:
                t, q = t - T, q + 1
            r = r + dr - (row if r + dr >= row else 0)
    return out


@pytest.mark.parametrize("b,f,t,blocks", [
    (3, 5, 1, 1), (2, 50, 2, 1), (7, 13, 3, 2), (9, 300, 7, 1),
    (2, 33, 16, 1), (31, 41, 17, 1), (40, 41, 33, 2),
    (3, 700, 17, 1)])       # F·T = 11900: thresholds past the staged ring
def test_front_end_kernel_walk_matches_plain_versions(b, f, t, blocks):
    """The kernels' tile walk (cursor carries over grid steps, the tile's
    clamped inputs, the word's feature pair, the threshold ring and its
    wrap, the ragged last chunk) covers every output byte with what the
    plain versions compute."""
    from repro_torch.kernels import thermometer as th
    x, thr, counts = thermometer_inputs(b * f + t, b, f, t)
    counts[0, 0] = 255                      # a count past T: all ones
    thr[0, -1] = np.inf
    thr[-1, 0] = -np.inf
    assert th.thresholds_staged(f, t) == (f * t <= th.STAGED_FLOATS - 512)
    want = ref.thermometer_ref(torch.from_numpy(x), torch.from_numpy(thr))
    got = emulate_front_end(x.reshape(-1), thr.reshape(-1), None, t, blocks)
    np.testing.assert_array_equal(got, want.numpy().reshape(-1))
    want = ref.decompress_ref(torch.from_numpy(counts), t)
    got = emulate_front_end(x.reshape(-1), None, counts.reshape(-1), t,
                            blocks)
    np.testing.assert_array_equal(got, want.numpy().reshape(-1))


def _cpu_prep():
    """The class-sliced tables of a one-submodel ensemble on the CPU."""
    from repro_torch.kernels import wnn_ensemble
    rng = np.random.default_rng(1)
    perm = torch.from_numpy(rng.integers(0, 96, (8, 12)))
    h3 = torch.from_numpy(rng.integers(0, 64, (2, 12)).astype(np.int32))
    sl = layout.class_slices_from_table(torch.from_numpy(
        rng.random((3, 8, 64)) < 0.3))
    cm = layout.class_mask_words(torch.ones((3, 8)))
    return type("Tables", (), dict(
        perms=(perm,), h3s=(h3,), bias=torch.zeros(3, dtype=torch.int32),
        kernel_args=wnn_ensemble.ensemble_args([perm], [h3], [sl], [cm],
                                               3)))()


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
    prep = _cpu_prep()
    bits = torch.zeros((2, 96), dtype=torch.int8)
    kernels.packed_wnn_ensemble(bits, prep)
    kernels.fused_wnn_ensemble(bits, prep)
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


# ---------------------------------------------------------------------------
# The class-sliced layout and the ensemble kernel's flat arguments
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m,log2e,dtype,planes", [
    (1, 3, torch.uint8, 1), (8, 6, torch.uint8, 1), (9, 5, torch.int16, 1),
    (10, 7, torch.int16, 1), (16, 4, torch.int16, 1), (17, 6, torch.int32, 1),
    (32, 5, torch.int32, 1), (33, 6, torch.int32, 2), (40, 8, torch.int32, 2),
    (100, 3, torch.int32, 4), (2, 5, torch.uint8, 1), (3, 4, torch.uint8, 1),
    (4, 6, torch.uint8, 1), (1, 2, torch.uint8, 1)])
def test_class_slices_from_words_and_tables_agree_and_invert(m, log2e, dtype,
                                                             planes):
    """Built from an int8 table and from its JAX-packed words, the class
    slices are the same narrowest words, hold bit m = table[m, f, h], and
    turn back into the table and its planes. Up to 4 classes an entry is
    1, 2 or 4 bits (8 / bits entries a byte, the last byte padded with
    zero entries where E is smaller)."""
    from repro_torch.kernels import wnn_ensemble
    rng = np.random.default_rng(m * 31 + log2e)
    e = 2 ** log2e
    table = rng.random((m, 13, e)) < 0.4
    from_table = layout.class_slices_from_table(torch.from_numpy(table))
    from_words = layout.class_slices_from_words(port_words(table), e)
    assert from_table.dtype == dtype and from_words.dtype == dtype
    epb = wnn_ensemble.entries_per_element(m)
    bits = wnn_ensemble.entry_bits(m)
    assert bits == (8 * from_table.element_size() if m > 4
                    else {1: 1, 2: 2, 3: 4, 4: 4}[m])
    want_shape = ((13, -(-e // epb)) if planes == 1
                  else (13, e, planes))
    assert tuple(from_table.shape) == want_shape
    assert torch.equal(from_table, from_words)
    raw = from_table.numpy().astype(np.int64)
    if epb > 1:
        raw = (raw[..., None] >> (np.arange(epb) * bits)) & ((1 << bits) - 1)
        raw = raw.reshape(13, -1)
        assert not raw[:, e:].any()          # padding entries hold 0
        raw = raw[:, :e]
    words = raw.reshape(13, e, planes)
    words &= (1 << min(bits, 8 * from_table.element_size())) - 1
    for c in range(m):
        np.testing.assert_array_equal((words[..., c // 32] >> (c % 32)) & 1,
                                      table[c])
    back = layout.table_from_class_slices(from_words, m, e)
    np.testing.assert_array_equal(back.numpy(), table.astype(np.int8))
    np.testing.assert_array_equal(
        layout.pack_words(back).numpy().view(np.uint32),
        jexport.pack_table(table))


@pytest.mark.parametrize("m", [1, 10, 33])
def test_class_mask_words_keep_every_nonzero_flag(m):
    rng = np.random.default_rng(m)
    mask = rng.integers(0, 4, (m, 21)).astype(np.int8)   # values > 1 survive
    got = layout.class_mask_words(torch.from_numpy(mask))
    back = layout.table_from_class_slices(got[:, None], m)[:, :, 0]
    np.testing.assert_array_equal(back.numpy(), (mask != 0).astype(np.int8))


def emulate_wnn_ensemble(bits, args, bias):
    """csrc/wnn.cu's addressing, walked in numpy over the flat arguments
    of `wnn_ensemble.ensemble_args`: class group y -> words
    [P_b·y, P_b·y + P_b) of an entry (P_b = min(P, GROUP_PLANES)) and
    classes from 32·P_b·y; chunk g -> submodel by `chunk_begin`, lane ->
    filter, the transposed perm (uint16 on the shared-tile route, int32
    on the global-gather route), params row j, slice word
    (f·E + h)·P + P_b·y + p, mask word f·P + P_b·y + p; for M <= 4 the
    sub-byte slices: byte f·E/epb + h/epb, bits (h % epb)·bits, with E
    the descriptor's padded entries."""
    from repro_torch.kernels import wnn_ensemble
    desc = args.desc.numpy()
    index = np.uint16 if args.route == "shared_tile" else np.int32
    perms = args.perms.numpy().view(index).astype(np.int64)
    params = args.params.numpy().astype(np.int64)
    planes, m = args.planes, args.num_classes
    block = min(planes, wnn_ensemble.GROUP_PLANES)
    width = wnn_ensemble.element_bits(args.slices.dtype)
    slices = args.slices.numpy().astype(np.int64) & ((1 << width) - 1)
    masks = args.masks.numpy().astype(np.int64) & ((1 << width) - 1)
    epb = wnn_ensemble.entries_per_element(m)
    if epb > 1:     # one element per entry, as the kernel's shifts read it
        bits_e = 8 // epb
        slices = ((slices[:, None] >> (np.arange(epb) * bits_e))
                  & ((1 << bits_e) - 1)).reshape(-1)
    out = np.zeros((bits.shape[0], m), np.int64)
    for y in range(-(-planes // block)):
        w0 = block * y
        words = np.arange(w0, min(w0 + block, planes))
        for g in range(args.chunks):
            s = max(i for i in range(len(desc)) if desc[i, 8] <= g)
            n_f, n, k, e, p_off, a_off, s_off, m_off, c0 = desc[s]
            for f in range((g - c0) * 32, min((g - c0 + 1) * 32, n_f)):
                h = np.zeros((bits.shape[0], k), np.int64)
                for i in range(n):
                    col = bits[:, perms[p_off + i * n_f + f]] != 0
                    for j in range(k):
                        h[:, j] ^= np.where(col, params[a_off + j * n + i], 0)
                resp = np.tile(masks[m_off + f * planes + words],
                               (bits.shape[0], 1))
                for j in range(k):
                    at = s_off * epb + (f * e + h[:, j])[:, None] * planes
                    resp &= slices[at + words[None]]
                for c in range(32 * w0, min(m, 32 * (w0 + block))):
                    out[:, c] += (resp[:, c // 32 - w0] >> (c % 32)) & 1
    return out + bias.numpy()[None].astype(np.int64)


@pytest.mark.parametrize("m,subs,total_bits,b", [
    (10, ((7, 3, 1), (12, 6, 2)), 97, 5),
    (40, ((64, 5, 8), (5, 4, 3)), 300, 3),
    (1, ((9, 4, 2),), 40, 4),
    (17, ((4, 3, 4), (33, 6, 2)), 70, 2),
    (8, ((3, 2, 1),), 40000, 2),       # indices past 32767: uint16 perms
    (129, ((5, 3, 2), (9, 4, 1)), 60, 3),    # two class groups
    (200, ((6, 3, 3),), 50, 2),              # seven words, groups of 4 + 3
    (10, ((4, 3, 2), (7, 4, 2)), 70000, 2),  # past 65536: int32 perms
    (130, ((8, 4, 2),), 250000, 2),          # both at once
    (2, ((7, 3, 1), (12, 6, 2)), 97, 5),     # sub-byte: 2 bits an entry
    (3, ((9, 4, 2),), 70000, 2),             # 4 bits, global gather
    (4, ((5, 2, 3), (6, 1, 1)), 40, 3)])     # E = 4 and 2: padded bytes
def test_ensemble_args_address_what_the_plain_version_reads(m, subs,
                                                            total_bits, b):
    """The flat arguments one launch takes (transposed perms, descriptor
    offsets, chunk map, class groups, the route's index type) read
    exactly what the plain ensemble version computes from the
    per-submodel tensors."""
    from repro_torch.kernels import wnn_ensemble
    rng = np.random.default_rng(total_bits + m)
    perms, h3s, slices, masks = [], [], [], []
    for n, log2e, k in subs:
        n_f = min(-(-total_bits // n), 40)
        perms.append(torch.from_numpy(rng.integers(0, total_bits, (n_f, n))))
        h3s.append(torch.from_numpy(
            rng.integers(0, 2 ** log2e, (k, n)).astype(np.int32)))
        slices.append(layout.class_slices_from_table(torch.from_numpy(
            rng.random((m, n_f, 2 ** log2e)) < 0.3)))
        masks.append(layout.class_mask_words(torch.from_numpy(
            rng.integers(0, 3, (m, n_f)))))
    bias = torch.from_numpy(rng.integers(-5, 6, m).astype(np.int32))
    bits = torch.from_numpy((rng.random((b, total_bits)) < 0.5)
                            .astype(np.int8))
    args = wnn_ensemble.ensemble_args(perms, h3s, slices, masks, m)
    assert args.columns == 1 + max(int(p.max()) for p in perms)
    wide = args.columns > wnn_ensemble.TILE_COLUMNS
    assert args.route == ("global_gather" if wide else "shared_tile")
    assert args.perms.dtype == (torch.int32 if wide else torch.int16)
    assert args.chunks == sum(-(-p.shape[0] // 32) for p in perms)
    want = ref.wnn_ensemble_ref(bits, perms, h3s, slices, masks, bias)
    np.testing.assert_array_equal(emulate_wnn_ensemble(bits.numpy(), args,
                                                       bias), want.numpy())
    got_slices, got_masks = args.submodel_slices()
    for got, sl in zip(got_slices + got_masks, slices + masks):
        assert torch.equal(got, sl)


@pytest.mark.parametrize("top,ok", [(65535, True), (65536, False)])
def test_ensemble_args_take_uint16_indices(top, ok):
    """Perm indices travel as uint16 while the last one read is 65535 (the
    shared-tile route); one past it, they travel as int32 and the
    wrapper names the global-gather route."""
    from repro_torch.kernels import wnn_ensemble
    perm = torch.tensor([[0, top], [32767, 32768]])
    h3 = torch.ones((1, 2), dtype=torch.int32)
    sl = layout.class_slices_from_table(torch.ones((3, 2, 4)))
    cm = layout.class_mask_words(torch.ones((3, 2)))
    args = wnn_ensemble.ensemble_args([perm], [h3], [sl], [cm], 3)
    assert args.columns == top + 1
    assert args.route == ("shared_tile" if ok else "global_gather")
    index = np.uint16 if ok else np.int32
    assert args.perms.numpy().view(index).tolist() == [0, 32767, top, 32768]
    with pytest.raises(ValueError, match="int32"):
        wnn_ensemble.ensemble_args([perm + 2 ** 31 - top], [h3], [sl],
                                   [cm], 3)


def _meta_ensemble(m, total_bits, n=12, log2e=6, k=2, n_f=9):
    """Flat launch arguments built on the CPU and moved to meta tensors,
    which reach the wrapper's checks and no kernel."""
    import dataclasses

    from repro_torch.kernels import wnn_ensemble
    rng = np.random.default_rng(m)
    args = wnn_ensemble.ensemble_args(
        [torch.from_numpy(rng.integers(0, total_bits, (n_f, n)))],
        [torch.from_numpy(rng.integers(0, 2 ** log2e, (k, n))
                          .astype(np.int32))],
        [layout.class_slices_from_table(torch.from_numpy(
            rng.random((m, n_f, 2 ** log2e)) < 0.3))],
        [layout.class_mask_words(torch.ones((m, n_f)))], m)
    moved = {f.name: getattr(args, f.name).to("meta")
             for f in dataclasses.fields(args)
             if isinstance(getattr(args, f.name), torch.Tensor)}
    return (dataclasses.replace(args, **moved),
            torch.zeros((m,), dtype=torch.int32, device="meta"))


@pytest.mark.parametrize("entry", ["packed_wnn_ensemble",
                                   "fused_wnn_ensemble"])
@pytest.mark.parametrize("m,bits,error,match", [
    (10, ((4, 300), torch.int32), TypeError, "bits must be torch.int8"),
    (10, ((1200,), torch.int8), ValueError, "bits must be"),
    (10, ((4, 100), torch.int8), ValueError, "permutations read bit"),
    (10, ((4, 20000), torch.uint8), ValueError, "CUDA tensors"),
    (129, ((4, 300), torch.bool), ValueError, "CUDA tensors"),
])
def test_ensemble_wrappers_check_what_the_kernel_reads(entry, m, bits,
                                                       error, match):
    """The ensemble kernel reads raw pointers: its wrappers refuse rows
    of the wrong type, rank or width before a launch; rows of any width
    past the perms' reach and any class count (129: two class groups)
    pass those checks (then meta tensors stop at the device check)."""
    args, bias = _meta_ensemble(m, 300)
    tables = type("Tables", (), {"kernel_args": args, "bias": bias})()
    shape, dtype = bits
    with pytest.raises(error, match=match):
        getattr(kernels, entry)(torch.zeros(shape, dtype=dtype,
                                            device="meta"), tables)
