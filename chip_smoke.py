#!/usr/bin/env python3
"""Drive the PyTorch port's serve path on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root

Builds the hand-written CUDA kernels from `src/repro_torch/kernels/csrc`,
holds each against its plain PyTorch version on the card (bit-equal),
serves the golden ULN-S artifact through every backend, then runs the main
path at full width: a seeded ULN-L artifact (784 features x 7 thermometer
bits, six submodels, M = 10) saved and loaded back, 65536 rows of raw
features through the thermometer and decompression kernels, scoring
through the packed and fused kernels, and 4096+ requests through
`WnnBatcher` per backend. Every phase prints one JSON line; any mismatch
raises, so the exit code is nonzero. The last line is
`{"ok": true, "device": {...}}`; the line before it is the card's name
and power limit as `nvidia-smi` reports them.

Times are CUDA-event medians after warm-up. Each kernel's bound is the
larger of its bytes (each input read once, each output written once) over
3.35 TB/s and its operations over the card's lane rate for their type;
both are computed from this run's shapes. NVIDIA's published non-tensor
float32 rate, 67 TFLOP/s, counts a fused multiply-add as two operations:
one operation per fp32 lane per clock is 33.5 T/s. A Hopper SM has half
as many int32 lanes as fp32 lanes, so integer work (the WNN kernels'
hash folds, shifts, masks, ANDs and votes; decompression's compares)
issues at most 16.75 T/s. Each thermometer kernel's `library_ms` is one
broadcasting PyTorch compare (`torch.gt`, `torch.lt`) whose bool output
is viewed as int8; no single PyTorch call computes an H3-hashed Bloom
lookup, so the WNN kernels' is null.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3
FP32_OPS_PER_S = 67e12 / 2       # one op per fp32 lane per clock
INT32_OPS_PER_S = 67e12 / 4      # half as many int32 lanes as fp32 lanes

ULN_L = dict(num_classes=10, features=784, bits_per_input=7, num_hashes=2,
             submodels=((12, 6), (16, 7), (20, 7), (24, 8), (28, 8), (32, 9)))
ULN_XL_LARGEST = dict(n=32, log2_entries=15, num_classes=32,
                      total_bits=784 * 8)      # ULN-XL ensemble, E = 2^15
INFER_BATCH = 65536
PLAIN_CHUNK = 4096   # the plain WNN versions run in row chunks: their
#                      (M, B, N_f, k) gather intermediates at B = 65536
#                      would need tens of GB
SERVE_REQUESTS = 4096
SERVE_SLOTS = 256

KERNEL_INFO = {
    "packed_wnn": ("src/repro_torch/kernels/csrc/wnn.cu",
                   "src/repro/kernels/packed_wnn.py:113"),
    "fused_wnn": ("src/repro_torch/kernels/csrc/wnn.cu",
                  "src/repro/kernels/fused_wnn.py:110"),
    "thermometer_encode": ("src/repro_torch/kernels/csrc/thermometer.cu",
                           "src/repro/kernels/thermometer.py:24"),
    "thermometer_decompress": ("src/repro_torch/kernels/csrc/thermometer.cu",
                               "src/repro/kernels/thermometer.py:59"),
}


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median milliseconds of `fn()` over `reps` CUDA-event timed calls."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def chunked(fn, n_rows: int, *args):
    """fn over row chunks of the first argument, concatenated."""
    first, rest = args[0], args[1:]
    return torch.cat([fn(first[i:i + PLAIN_CHUNK], *rest)
                      for i in range(0, n_rows, PLAIN_CHUNK)])


def bound(bytes_moved: float, ops: float,
          ops_per_s: float) -> tuple[float, str]:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def assert_equal(what: str, got: torch.Tensor, want: torch.Tensor) -> int:
    """The max |got - want|; raises unless it is 0 (bit-equal)."""
    if got.shape != want.shape:
        raise AssertionError(f"{what}: shape {tuple(got.shape)} != "
                             f"{tuple(want.shape)}")
    diff = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
    if diff:
        raise AssertionError(f"{what}: not bit-equal (max |diff| {diff})")
    return diff


# ---------------------------------------------------------------------------
# Phase 3: every kernel against its plain version on the card
# ---------------------------------------------------------------------------

def wnn_case(gen, *, batch, n_f, n, log2_entries, m, k, mask_kind="random"):
    dev = "cuda"
    e = 2 ** log2_entries
    tuples = torch.randint(0, 2, (batch, n_f, n), generator=gen, device=dev,
                           dtype=torch.int8)
    params = torch.randint(0, e, (k, n), generator=gen, device=dev,
                           dtype=torch.int32)
    table = (torch.rand((m, n_f, e), generator=gen, device=dev) < 0.3
             ).to(torch.int8)
    if mask_kind == "zeros":
        mask = torch.zeros((m, n_f), dtype=torch.int8, device=dev)
    else:     # values in {0, 1, 2}: a filter survives iff its mask != 0
        mask = torch.randint(0, 3, (m, n_f), generator=gen, device=dev,
                             dtype=torch.int8)
    bias = torch.randint(-5, 6, (m,), generator=gen, device=dev,
                         dtype=torch.int32)
    return tuples, params, table, mask, bias


def wnn_cost(batch, n_f, n, m, k, table_bytes):
    bytes_moved = (batch * n_f * n + k * n * 4 + table_bytes + m * n_f
                   + m * 4 + batch * m * 4)
    # per (b, f): n·k hash select-and-XORs; per (b, m, f): k bit lookups
    # (load, shift, mask) and the AND, plus the vote
    ops = batch * n_f * n * k * 2 + batch * m * n_f * (3 * k + 1)
    return bytes_moved, ops


def check_wnn_kernels(gen, packed_layout, ref, packed_wnn, fused_wnn):
    cases = []
    for n, log2e in ULN_L["submodels"]:
        total_bits = ULN_L["features"] * ULN_L["bits_per_input"]
        cases.append(dict(name=f"uln_l_n{n}_e{2 ** log2e}", main=True,
                          batch=INFER_BATCH, n_f=math.ceil(total_bits / n),
                          n=n, log2_entries=log2e, m=ULN_L["num_classes"],
                          k=ULN_L["num_hashes"]))
    xl = ULN_XL_LARGEST
    cases += [
        dict(name="uln_xl_ensemble_n32_e32768", batch=INFER_BATCH,
             n_f=math.ceil(xl["total_bits"] / xl["n"]), n=xl["n"],
             log2_entries=xl["log2_entries"], m=xl["num_classes"], k=2),
        dict(name="e8_k1_odd_n", batch=4099, n_f=101, n=7, log2_entries=3,
             m=10, k=1),
        dict(name="e16_k4", batch=4097, n_f=77, n=12, log2_entries=4, m=10,
             k=4),
        dict(name="m40_k8_n64", batch=1031, n_f=45, n=64, log2_entries=10,
             m=40, k=8),
        dict(name="zero_mask", batch=2053, n_f=229, n=24, log2_entries=8,
             m=10, k=2, mask_kind="zeros"),
    ]
    rows = []
    # per kernel, over the six ULN-L geometries one served batch launches
    totals = {k: dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, bytes=0, ops=0,
                      max_abs_err=0) for k in ("packed_wnn", "fused_wnn")}
    for case in cases:
        name, main = case.pop("name"), case.pop("main", False)
        tuples, params, table, mask, bias = wnn_case(gen, **case)
        words = packed_layout.pack_words(table)
        b = case["batch"]
        got_p = packed_wnn(tuples, params, words, mask, bias)
        got_f = fused_wnn(tuples, params, table, mask, bias)
        want_p = chunked(ref.packed_wnn_ref, b, tuples, params, words, mask,
                         bias)
        want_f = chunked(ref.fused_wnn_ref, b, tuples, params, table, mask,
                         bias)
        torch.cuda.synchronize()
        errs = {"packed_wnn": assert_equal(f"packed_wnn[{name}]", got_p,
                                           want_p),
                "fused_wnn": assert_equal(f"fused_wnn[{name}]", got_f,
                                          want_f)}
        assert_equal(f"packed_wnn vs fused_wnn[{name}]", got_p, got_f)
        for kname, err in errs.items():
            totals[kname]["max_abs_err"] = max(totals[kname]["max_abs_err"],
                                               err)
        row = {"case": name, "batch": b, "n_f": case["n_f"], "n": case["n"],
               "entries": 2 ** case["log2_entries"], "m": case["m"],
               "k": case["k"]}
        for kname, kern, plain, tab in (
                ("packed_wnn", packed_wnn, ref.packed_wnn_ref, words),
                ("fused_wnn", fused_wnn, ref.fused_wnn_ref, table)):
            ms = cuda_ms(lambda: kern(tuples, params, tab, mask, bias), 20)
            plain_ms = cuda_ms(lambda: chunked(plain, b, tuples, params, tab,
                                               mask, bias), 3, warmup=1)
            bytes_moved, ops = wnn_cost(b, case["n_f"], case["n"], case["m"],
                                        case["k"], tab.numel()
                                        * tab.element_size())
            bms, by = bound(bytes_moved, ops, INT32_OPS_PER_S)
            row[kname] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
                          "bound_by": by, "bytes": bytes_moved, "ops": ops}
            if main:
                for key, v in (("ms", ms), ("plain_ms", plain_ms),
                               ("bytes", bytes_moved), ("ops", ops)):
                    totals[kname][key] += v
        rows.append(row)
        del tuples, params, table, words, mask, bias
    emit("wnn_kernels", cases=rows)
    for t in totals.values():
        t["bound_ms"], t["bound_by"] = bound(t["bytes"], t["ops"],
                                             INT32_OPS_PER_S)
        t["library_ms"] = None
    return totals


def check_front_end_kernels(gen, ref, thermometer_encode,
                            thermometer_decompress):
    dev = "cuda"
    b, f, t = INFER_BATCH, ULN_L["features"], ULN_L["bits_per_input"]
    x = torch.randn((b, f), generator=gen, device=dev)
    x[::97, ::13] = float("nan")                  # NaN encodes to zeros
    thr = torch.sort(torch.randn((f, t), generator=gen, device=dev),
                     dim=1).values
    counts = torch.randint(0, t + 1, (b, f), generator=gen, device=dev,
                           dtype=torch.uint8)
    iota = torch.arange(t, dtype=torch.uint8, device=dev)

    # one PyTorch call each: a broadcasting compare; its bool output has
    # the kernel's {0, 1} bytes, so viewing it as int8 costs nothing
    def encode_library(x, thr):
        return torch.gt(x[:, :, None], thr[None]).view(torch.int8)

    def decompress_library(counts, t):
        return torch.lt(iota, counts[..., None]).view(torch.int8)

    out = {}
    for name, kern, plain, library, args, bytes_moved, ops_per_s in (
            ("thermometer_encode", thermometer_encode, ref.thermometer_ref,
             encode_library, (x, thr), b * f * 4 + f * t * 4 + b * f * t,
             FP32_OPS_PER_S),
            ("thermometer_decompress", thermometer_decompress,
             ref.decompress_ref, decompress_library, (counts, t),
             b * f + b * f * t, INT32_OPS_PER_S)):
        got = kern(*args)
        err = assert_equal(name, got, plain(*args))
        assert_equal(f"{name} vs one PyTorch call", got, library(*args))
        ms = cuda_ms(lambda: kern(*args), 20)
        plain_ms = cuda_ms(lambda: plain(*args), 20)
        library_ms = cuda_ms(lambda: library(*args), 20)
        # one compare per output bit
        bms, by = bound(bytes_moved, b * f * t, ops_per_s)
        out[name] = {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                     "bound_ms": bms, "bound_by": by, "bytes": bytes_moved,
                     "ops": b * f * t, "max_abs_err": err}
    # odd shapes: a ragged last block, T = 1, a single row
    for shape, tt in (((3, 5), 1), ((1, 784), 7), ((1027, 33), 9)):
        xs = torch.randn(shape, generator=gen, device=dev)
        ts = torch.randn((shape[1], tt), generator=gen, device=dev)
        cs = torch.randint(0, tt + 1, shape, generator=gen, device=dev,
                           dtype=torch.uint8)
        assert_equal(f"thermometer_encode{shape}",
                     thermometer_encode(xs, ts), ref.thermometer_ref(xs, ts))
        assert_equal(f"thermometer_decompress{shape}",
                     thermometer_decompress(cs, tt),
                     ref.decompress_ref(cs, tt))
    emit("front_end_kernels", **out)
    return out


# ---------------------------------------------------------------------------
# Phase 5: the main path at full width
# ---------------------------------------------------------------------------

def uln_l_artifact(export, seed: int):
    """A seeded ULN-L artifact: table fill ~0.3, mask ~0.8, random perm,
    H3 params in [0, E), integer bias — random weights at full width."""
    rng = np.random.default_rng(seed)
    m = ULN_L["num_classes"]
    total_bits = ULN_L["features"] * ULN_L["bits_per_input"]
    subs = []
    for n, log2e in ULN_L["submodels"]:
        e = 2 ** log2e
        n_f = math.ceil(total_bits / n)
        perm = rng.permutation(total_bits)
        if n_f * n > total_bits:           # classic WiSARD wrap padding
            perm = np.concatenate(
                [perm, rng.integers(0, total_bits, n_f * n - total_bits)])
        subs.append(export.SubmodelArtifact(
            packed=export.pack_table(rng.random((m, n_f, e)) < 0.3),
            mask=rng.random((m, n_f)) < 0.8,
            perm=perm[:n_f * n].reshape(n_f, n).astype(np.int32),
            h3=rng.integers(0, e, (ULN_L["num_hashes"], n)).astype(np.uint32),
            entries=e, inputs_per_filter=n, num_hashes=ULN_L["num_hashes"]))
    return export.InferenceArtifact(
        submodels=subs, bias=rng.integers(-5, 6, m).astype(np.int32),
        num_classes=m, total_bits=total_bits,
        bits_per_input=ULN_L["bits_per_input"])


def serve(WnnBatcher, art, bits_host, want, backend):
    # one warm-up step on a throwaway batcher: the allocator's first
    # (slots, ...) buffers and the kernel lookup are set-up, not serving
    warm = WnnBatcher(art, slots=SERVE_SLOTS, backend=backend)
    warm.submit(bits_host[0])
    warm.drain()
    eng = WnnBatcher(art, slots=SERVE_SLOTS, backend=backend)
    t0 = time.perf_counter()
    for row in bits_host:
        eng.submit(row)
    results = eng.drain()
    wall = time.perf_counter() - t0
    got = np.stack([r.scores for r in results])
    if not np.array_equal(got, want):
        raise AssertionError(f"WnnBatcher[{backend}] scores != direct scores")
    if [r.pred for r in results] != list(np.argmax(want, -1)):
        raise AssertionError(f"WnnBatcher[{backend}] preds != argmax")
    st = eng.stats()
    if st["traces"] != 1:
        raise AssertionError(f"WnnBatcher[{backend}] launched "
                             f"{st['traces']} batch shapes, not 1")
    return {"backend": backend, "requests_per_s": len(results) / wall,
            "wall_s": wall, **st}


def main_path(export, ops, fit_gaussian_thermometer, WnnBatcher, kernels):
    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(20260)
    art = uln_l_artifact(export, seed=20260)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        path = str(Path(tmp) / "uln_l_artifact.npz")
        export.save(art, path)
        loaded = export.load(path)
    for a, b in zip(art.submodels, loaded.submodels):
        for field in ("packed", "mask", "perm", "h3"):
            if not np.array_equal(getattr(a, field), getattr(b, field)):
                raise AssertionError(f"save/load changed {field}")
    art = loaded
    f, t = ULN_L["features"], ULN_L["bits_per_input"]
    # synthetic features: per-feature offsets and scales, fitted on a
    # separate training draw
    centre = torch.randn((f,), generator=gen, device=dev)
    scale = torch.rand((f,), generator=gen, device=dev) + 0.5
    x_train = centre + scale * torch.randn((8192, f), generator=gen,
                                           device=dev)
    x = centre + scale * torch.randn((INFER_BATCH, f), generator=gen,
                                     device=dev)
    enc = fit_gaussian_thermometer(x_train, t)

    kernels.reset_launch_counts()          # the main path's run starts here
    t0 = time.perf_counter()
    bits3 = ops.thermometer(x, enc.thresholds)                 # kernel #3
    bits4 = ops.decompress(enc.encode_counts(x), t)            # kernel #4
    bits = bits3.reshape(INFER_BATCH, f * t)
    s_auto = export.artifact_scores(art, bits, backend="auto")     # #1
    s_fused = export.artifact_scores(art, bits, backend="fused")   # #2
    torch.cuda.synchronize()
    direct_s = time.perf_counter() - t0
    bits_host = bits[:SERVE_REQUESTS].cpu().numpy()
    want = s_auto[:SERVE_REQUESTS].cpu().numpy()
    served = [serve(WnnBatcher, art, bits_host, want, b)
              for b in ("auto", "fused")]
    launches = kernels.launch_counts()     # ... and ends here

    # where a served batch's device time goes: the whole scoring call
    # (per-submodel permutation gathers + kernels) beside its kernels alone
    scores_ms = {b: cuda_ms(lambda: export.artifact_scores(
        art, bits, backend=b), 5) for b in ("auto", "fused")}
    front_end_ms = cuda_ms(lambda: ops.thermometer(x, enc.thresholds), 5)

    assert_equal("decompress(encode_counts(x)) vs thermometer(x)", bits4,
                 bits3)
    assert_equal("thermometer kernel vs encoder.encode",
                 bits.bool(), enc.encode(x))
    s_gather = chunked(lambda rows: export.artifact_scores(
        art, rows, backend="gather"), INFER_BATCH, bits)
    assert_equal("artifact_scores auto vs gather", s_auto, s_gather)
    assert_equal("artifact_scores fused vs gather", s_fused, s_gather)
    if s_auto.shape != (INFER_BATCH, ULN_L["num_classes"]):
        raise AssertionError(f"scores shape {tuple(s_auto.shape)}")
    preds = torch.argmax(s_auto, -1)
    idle = [k for k, v in launches.items() if v == 0]
    if idle:
        raise AssertionError(f"main path never launched {idle}")
    emit("main_path", model="ULN-L", total_bits=f * t,
         submodels=len(art.submodels), batch=INFER_BATCH,
         direct_s=direct_s, bits_set_share=float(bits3.float().mean()),
         pred_histogram=torch.bincount(preds, minlength=10).tolist(),
         packed_table_kib=art.packed_size_kib,
         artifact_scores_ms=scores_ms, thermometer_ms=front_end_ms,
         serve=served,
         launches=launches)
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "drives the port on an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import kernels
    from repro_torch.core import export
    from repro_torch.core.encoding import fit_gaussian_thermometer
    from repro_torch.kernels import build, ops, ref
    from repro_torch.launch.scheduler import WnnBatcher
    from repro_torch.packed import layout as packed_layout

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi_line()
    emit("device", name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda)

    t0 = time.perf_counter()
    build.build_all()
    ptxas = [ln.strip() for src in build.SOURCES
             for ln in build.build_log(src).splitlines()
             if "registers" in ln or "spill" in ln]
    emit("build", seconds=time.perf_counter() - t0, ptxas=ptxas)

    gen = torch.Generator(device="cuda").manual_seed(0)
    wnn = check_wnn_kernels(gen, packed_layout, ref, kernels.packed_wnn,
                            kernels.fused_wnn)
    front = check_front_end_kernels(gen, ref, kernels.thermometer_encode,
                                    kernels.thermometer_decompress)
    torch.cuda.empty_cache()

    golden = export.load(str(ROOT / "tests/golden/uln_s_artifact.npz"))
    with np.load(ROOT / "tests/golden/uln_s_golden.npz") as z:
        gbits, gscores = z["bits"], z["scores"]
    for backend in ("gather", "fused", "packed", "auto"):
        got = export.artifact_scores(golden, gbits, backend=backend)
        if not np.array_equal(got.cpu().numpy(), gscores):
            raise AssertionError(f"golden scores differ for {backend}")
    emit("golden", artifact="uln_s", rows=int(gbits.shape[0]),
         backends=["gather", "fused", "packed", "auto"], exact=True)

    launches = main_path(export, ops, fit_gaussian_thermometer, WnnBatcher,
                         kernels)

    rows = []
    for name, timing in {**wnn, **front}.items():
        source, replaces = KERNEL_INFO[name]
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": launches[name],
                     "max_abs_err": timing["max_abs_err"], "ms": timing["ms"],
                     "plain_ms": timing["plain_ms"],
                     "bound_ms": timing["bound_ms"],
                     "bound_by": timing["bound_by"],
                     "bytes": timing["bytes"], "ops": timing["ops"],
                     "library_ms": timing["library_ms"]})
    print(json.dumps({"kernels": rows}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
