#!/usr/bin/env python3
"""Where the WNN ensemble kernel's time goes: time variants of
`src/repro_torch/kernels/csrc/wnn.cu` on one GPU.

    python3 scripts/wnn_variants.py          # from the repository root

Each variant is the kernel's source built with the port's nvcc flags and
one preprocessor switch (`WNN_ABLATE`, `WNN_WARPS` in wnn.cu), bound
with ctypes and timed on the same inputs: 65536 rows of the ULN-L
ensemble (six submodels, M = 10) and of the ULN-XL ensemble (three
submodels up to E = 2^15, M = 32). Device time is the median of
CUDA-graph replays (`chip_smoke.graph_ms`). Variants that keep the
kernel's arithmetic are held bit-equal to the plain version; the
ablations (which drop a part of the work) are timing only:

* `committed`      the kernel as it is;
* `warps_8`        8 warps a block instead of 16;
* `probes_hit_l1`  every probe reads entry 0 or 1 of its filter's slice:
                   the probes' cost with their cache misses removed;
* `no_hash_fold`   the gather and H3 fold skipped (every hash is 0);
* `skeleton_only`  no votes, so the compiler drops hash and probes too:
                   the tile copy, transpose and score stores alone;
* `byte_entries`   (M <= 4 only) the slices a byte an entry, the layout
                   before the sub-byte one, on the same rows and tables:
                   the class-sharded rank of the ULN-XL ensemble (2 of
                   its 32 classes, `uln_xl_ens_rank`) in both layouts.

Prints one JSON line per (case, variant) and the card's name and power
limit. Needs a CUDA device and nvcc; builds into build/wnn_variants/.
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
    "warps_8": ["-DWNN_WARPS=8"],
    "probes_hit_l1": ["-DWNN_ABLATE=1"],
    "no_hash_fold": ["-DWNN_ABLATE=2"],
    "skeleton_only": ["-DWNN_ABLATE=3"],
    "byte_entries": ["-DWNN_SUB_BYTE=0"],
}
EXACT = ("committed", "warps_8", "byte_entries")
SUB_BYTE_ONLY = ("byte_entries",)
CASES = {"uln_l": dict(m=10, subs=None, total_bits=784 * 7),
         "uln_xl_ensemble": dict(m=32, subs=((16, 11, 2), (24, 13, 2),
                                             (32, 15, 2)),
                                 total_bits=784 * 8),
         "uln_xl_ens_rank": dict(m=2, subs=((16, 11, 2), (24, 13, 2),
                                            (32, 15, 2)),
                                 total_bits=784 * 8)}
ROWS = 65536


def build_variants(build) -> dict:
    """{variant: its ctypes entry point}, built in parallel."""
    out_dir = ROOT / "build" / "wnn_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, defines in VARIANTS.items():
        procs[name] = subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, *defines,
             "-o", str(out_dir / f"lib_{name}.so"),
             str(build.CSRC / "wnn.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    from repro_torch.kernels import wnn_ensemble
    fns = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"variant {name} did not build:\n{log[-4000:]}")
        fn = ctypes.CDLL(str(out_dir / f"lib_{name}.so")).wnn_ensemble_launch
        fn.argtypes = wnn_ensemble._ARGTYPES
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def main() -> int:
    if not torch.cuda.is_available():
        print("wnn_variants: needs a CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.core import export
    from repro_torch.kernels import build, ref
    fns = build_variants(build)
    gen = torch.Generator(device="cuda").manual_seed(15)
    for case, spec in CASES.items():
        art = cs.seeded_artifact(export, 15, m=spec["m"],
                                 subs=spec["subs"] or cs.ULN_L_SUBS,
                                 total_bits=spec["total_bits"])
        pt = export.prepare_artifact(art, backend="auto")
        args = pt.kernel_args
        bits = torch.randint(0, 2, (ROWS, spec["total_bits"]), generator=gen,
                             device="cuda", dtype=torch.int8)
        want = cs.chunked(lambda r: ref.wnn_ensemble_ref(
            r, pt.perms, pt.h3s, pt.slices, pt.class_masks, pt.bias),
            ROWS, bits)
        out = torch.empty((ROWS, spec["m"]), dtype=torch.int32,
                          device="cuda")
        byte_args = None
        if spec["m"] <= 4:      # the same tables a byte an entry
            from repro_torch.kernels import wnn_ensemble
            byte_args = wnn_ensemble.ensemble_args(
                pt.perms, pt.h3s,
                [wnn_ensemble.unpack_entries(s_, spec["m"])[:, :e]
                 for s_, e in zip(pt.slices, pt.entries)],
                pt.class_masks, 5, columns=args.columns)
        for name, fn in fns.items():
            if name in SUB_BYTE_ONLY and byte_args is None:
                continue
            a = byte_args if name in SUB_BYTE_ONLY else args

            def call(fn=fn, a=a):
                rc = fn(bits.data_ptr(), ROWS, spec["total_bits"],
                        a.columns, a.perms.data_ptr(),
                        a.params.data_ptr(),
                        a.slices.data_ptr(), a.masks.data_ptr(),
                        a.desc.data_ptr(), a.desc.shape[0],
                        a.chunks, pt.bias.data_ptr(), out.data_ptr(),
                        spec["m"], a.slices.element_size(), a.planes,
                        a.max_hashes, a.perms.element_size(),
                        torch.cuda.current_stream().cuda_stream)
                if rc:
                    raise RuntimeError(f"{name}: launch failed ({rc})")
            call()
            torch.cuda.synchronize()
            equal = bool(torch.equal(out, want))
            if name in EXACT and not equal:
                raise AssertionError(f"{name}[{case}] not bit-equal")
            print(json.dumps({"case": case, "variant": name,
                              "bit_equal": equal,
                              "slice_bytes": a.slices.numel(),
                              "device_ms": cs.graph_ms(call),
                              "ms": cs.cuda_ms(call, 20)}), flush=True)
    print(cs.nvidia_smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
