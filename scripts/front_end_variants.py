#!/usr/bin/env python3
"""Where the front-end kernels' time goes: time variants of
`src/repro_torch/kernels/csrc/thermometer.cu` on one GPU.

    python3 scripts/front_end_variants.py    # from the repository root

Each variant is the kernels' source built with the port's nvcc flags and
one preprocessor switch (`FRONT_END_ABLATE` in thermometer.cu), bound
with ctypes and timed on the same inputs: 65536 ULN-L rows (784 features,
T = 7), thresholds sorted per feature, counts in [0, T]. Device time is
the median of CUDA-graph replays (`chip_smoke.graph_ms`) into one output
tensor. The committed variant is held bit-equal to the plain versions;
the ablations drop a part of the work and are timing only:

* `committed`   the kernels as they are;
* `no_inputs`   no input copies: the words' arithmetic and the stores;
* `no_compare`  no arithmetic (each word holds its offset): the input
                copies and the stores.

Beside them, two PyTorch calls on the same (B, F, T) int8 output give
the card's rates for this many bytes: `zero_()` (writes only) and
`copy_()` from another such tensor (reads and writes). Prints one JSON
line per variant and the card's name and power limit. Needs a CUDA
device and nvcc; builds into build/front_end_variants/.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

VARIANTS = {
    "committed": [],
    "no_inputs": ["-DFRONT_END_ABLATE=1"],
    "no_compare": ["-DFRONT_END_ABLATE=2"],
}
ROWS, FEATURES, BITS = 65536, 784, 7


def build_variants(build, thermometer) -> dict:
    """{variant: (encode, decompress) ctypes entry points}, built in
    parallel."""
    out_dir = ROOT / "build" / "front_end_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {name: subprocess.Popen(
        [build.nvcc_path(), *build.NVCC_FLAGS, *defines,
         "-o", str(out_dir / f"lib_{name}.so"),
         str(build.CSRC / "thermometer.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, defines in VARIANTS.items()}
    fns = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"variant {name} did not build:\n{log[-4000:]}")
        lib = ctypes.CDLL(str(out_dir / f"lib_{name}.so"))
        encode = lib.thermometer_encode_launch
        encode.argtypes = thermometer._ENCODE_ARGTYPES
        decompress = lib.thermometer_decompress_launch
        decompress.argtypes = thermometer._DECOMPRESS_ARGTYPES
        encode.restype = decompress.restype = ctypes.c_int
        fns[name] = (encode, decompress)
    return fns


def main() -> int:
    if not torch.cuda.is_available():
        print("front_end_variants: needs a CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.kernels import build, ref, thermometer
    fns = build_variants(build, thermometer)
    gen = torch.Generator(device="cuda").manual_seed(16)
    b, f, t = ROWS, FEATURES, BITS
    x = torch.randn((b, f), generator=gen, device="cuda")
    thr = torch.sort(torch.randn((f, t), generator=gen, device="cuda"),
                     dim=1).values
    counts = torch.randint(0, t + 1, (b, f), generator=gen, device="cuda",
                           dtype=torch.uint8)
    out = torch.empty((b, f, t), dtype=torch.int8, device="cuda")
    other = torch.empty_like(out)
    want = {"encode": ref.thermometer_ref(x, thr),
            "decompress": ref.decompress_ref(counts, t)}

    def stream():
        return torch.cuda.current_stream().cuda_stream

    for name, (encode, decompress) in fns.items():
        calls = {
            "encode": lambda: encode(x.data_ptr(), thr.data_ptr(),
                                     out.data_ptr(), b * f, f, t, stream()),
            "decompress": lambda: decompress(counts.data_ptr(),
                                             out.data_ptr(), b * f, t,
                                             stream())}
        row = {"variant": name}
        for kind, call in calls.items():
            if call():
                raise RuntimeError(f"{name} {kind}: launch failed")
            torch.cuda.synchronize()
            equal = bool(torch.equal(out, want[kind]))
            if name == "committed" and not equal:
                raise AssertionError(f"{kind} not bit-equal")
            row[f"{kind}_device_ms"] = cs.graph_ms(call)
            row[f"{kind}_bit_equal"] = equal
        print(json.dumps(row), flush=True)
    print(json.dumps({
        "variant": "pytorch_yardsticks", "bytes": out.numel(),
        "zero_device_ms": cs.graph_ms(out.zero_),
        "copy_device_ms": cs.graph_ms(lambda: out.copy_(other))}),
        flush=True)
    print(cs.nvidia_smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
