"""Build the port's CUDA kernels and bind them to Python.

Each `csrc/*.cu` file exposes a plain C interface, so it compiles with
`nvcc` alone in seconds (no PyTorch headers) into a shared library that
`ctypes` loads. Wrappers pass `tensor.data_ptr()` and the current CUDA
stream as integers. Libraries go to `build/torch_ext/` at the repository
root, named by a digest of their source and flags, so an edited source
rebuilds and an unchanged one is reused. The first call that needs a
kernel builds every source, one `nvcc` process per file, all started
together; a failed build raises with the compiler's output.

Nothing here runs at import time: the CPU tests import every module on a
machine with no `nvcc`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("wnn.cu", "thermometer.cu", "h3_hash.cu", "flash_attention.cu")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_ext"
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOCK = threading.Lock()
_LIBS: dict = {}
_FNS: dict = {}


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the "
                       "port's CUDA kernels are built with it at first use")


def library_path(source: str) -> Path:
    """The library of `source`, named by a digest of the source, the
    shared headers (`csrc/*.cuh`) and the flags."""
    src = CSRC / source
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src.read_bytes() + headers
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{src.stem}-{digest}.so"


def build_log(source: str) -> str:
    """The compiler's output (ptxas register and spill report included)
    from the build of `source`, or "" when it was not built here."""
    log = library_path(source).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def build_all() -> dict:
    """Compile every source whose library is missing, in parallel; return
    {source: library path}. Raises RuntimeError naming each failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = None
    running = []
    for source in SOURCES:
        out = library_path(source)
        if out.exists():
            continue
        nvcc = nvcc or nvcc_path()
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        log = open(out.with_suffix(".log"), "w")
        proc = subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / source)],
            stdout=log, stderr=subprocess.STDOUT)
        running.append((source, proc, tmp, out, log))
    failed = []
    for source, proc, tmp, out, log in running:
        rc = proc.wait()
        log.close()
        if rc == 0:
            os.replace(tmp, out)
        else:
            failed.append(f"{source} (nvcc exit {rc}):\n{build_log(source)}")
    if failed:
        raise RuntimeError("CUDA kernel build failed: " + "\n".join(failed))
    return {source: library_path(source) for source in SOURCES}


def kernel_function(source: str, symbol: str, argtypes):
    """The C entry point `symbol` of `source`'s library, built on first
    use, with its ctypes signature declared (returns a CUDA error code).
    Bound once per symbol: wrappers call this on every launch."""
    fn = _FNS.get((source, symbol))
    if fn is not None:
        return fn
    with _LOCK:
        lib = _LIBS.get(source)
        if lib is None:
            lib = _LIBS[source] = ctypes.CDLL(str(build_all()[source]))
        fn = getattr(lib, symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _FNS[(source, symbol)] = fn
    return fn


def check_launch(symbol: str, rc: int) -> None:
    """Raise if a C entry point reports a failed launch: a refused launch
    never runs, and a later synchronize would not report it."""
    if rc != 0:
        raise RuntimeError(f"{symbol}: CUDA launch failed with error {rc}")


def ptxas_report(log: str, name_of=lambda mangled: mangled) -> list:
    """Registers, stack and spills of each kernel instantiation in a
    `-Xptxas -v` build log (`build_log`), named by `name_of(mangled
    name)`."""
    out = []
    for ln in log.splitlines():
        hit = re.search(r"Compiling entry function '(\S+)'", ln)
        if hit:
            out.append({"kernel": name_of(hit.group(1))})
            continue
        if not out:
            continue
        spill = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads", ln)
        if spill:
            out[-1].update(stack=int(spill[1]), spill_stores=int(spill[2]),
                           spill_loads=int(spill[3]))
        regs = re.search(r"Used (\d+) registers", ln)
        if regs:
            out[-1]["registers"] = int(regs[1])
    return out
