"""PyTorch observability signals — the port's `obs/jaxhooks.py`.

* `counted(fn, counts, key)`: shape counting for eager PyTorch.
* `record_device_memory()`: allocated and reserved bytes and live blocks
  of each visible CUDA device as gauges.
* `profile_trace(log_dir)`: an opt-in `torch.profiler` trace behind
  `serve.py --profile`, written as a Chrome trace.

`counted`, in full:

Under `jax.jit` a function's Python body runs once per trace, i.e. once
per distinct input shape, so a counter bumped in the body counts
compilations. PyTorch runs eagerly and never traces; what a fixed-shape
serve path must still keep at one is the set of distinct input shapes
it launches (each would be its own CUDA-graph capture or kernel
specialisation). `counted` bumps its counter the first time each
distinct signature of tensor shapes, dtypes and devices reaches the
wrapped function, and never again for that signature. Tensors inside
dicts, lists, tuples and the public fields of dataclasses (a batch dict,
a serve state, a stacked tenant fleet) count as arguments too; other
objects (a parameter module) do not.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import os

import torch

from repro_torch.obs import registry as _registry


def _tensors(v):
    if isinstance(v, torch.Tensor):
        yield v
    elif isinstance(v, dict):
        for k in sorted(v):
            yield from _tensors(v[k])
    elif isinstance(v, (list, tuple)):
        for x in v:
            yield from _tensors(x)
    elif dataclasses.is_dataclass(v) and not isinstance(v, type):
        for f in dataclasses.fields(v):
            if not f.name.startswith("_"):
                yield from _tensors(getattr(v, f.name))


def _signature(args, kwargs) -> tuple:
    vals = list(args) + [kwargs[k] for k in sorted(kwargs)]
    return tuple((tuple(t.shape), t.dtype, t.device) for t in _tensors(vals))


def counted(fn, counts, key, *, prefix: str = "torch.shape", agg_key=None):
    """Wrap `fn` so each new tensor-shape signature bumps `counts[key]`
    and the global recorder counter `{prefix}.{key}`. Calls with a
    signature already seen count nothing, so a steady-state serve loop
    stays at 1. `key` may be a callable of the call's arguments for
    shape-dependent keys (`prefill_{width}`); `agg_key` additionally bumps
    a stable recorder counter `{prefix}.{agg_key}` across all of them, as
    the JAX package's `jaxhooks.counted` does."""
    seen = set()

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        sig = _signature(args, kwargs)
        if sig not in seen:
            seen.add(sig)
            k = key(*args, **kwargs) if callable(key) else key
            counts[k] += 1
            rec = _registry.get_recorder()
            rec.counter(f"{prefix}.{k}").inc()
            if agg_key is not None and agg_key != k:
                rec.counter(f"{prefix}.{agg_key}").inc()
        return fn(*args, **kwargs)
    return wrapped


def record_device_memory(rec=None) -> None:
    """Set device-memory gauges on `rec` (default: the global recorder — a
    no-op when observability is off): for each visible CUDA device i,
    `torch.cuda{i}.bytes_allocated` and `.bytes_reserved` (the caching
    allocator's `memory_allocated` and `memory_reserved`) and
    `.live_blocks` (`memory_stats()["active.all.current"]`, the live
    allocations: the counterpart of JAX's live buffers). On the CPU there
    is no CUDA device and no gauge is recorded."""
    rec = rec if rec is not None else _registry.get_recorder()
    if not rec.enabled or not torch.cuda.is_available():
        return
    for i in range(torch.cuda.device_count()):
        pre = f"torch.cuda{i}"
        rec.gauge(f"{pre}.bytes_allocated").set(
            float(torch.cuda.memory_allocated(i)))
        rec.gauge(f"{pre}.bytes_reserved").set(
            float(torch.cuda.memory_reserved(i)))
        stats = torch.cuda.memory_stats(i)
        rec.gauge(f"{pre}.live_blocks").set(
            float(stats.get("active.all.current", 0)))


@contextlib.contextmanager
def profile_trace(log_dir, *, enabled: bool = True):
    """Wrap a region in a `torch.profiler` trace of the host and, where
    there is one, the CUDA device, written on exit as a Chrome trace
    (`trace_<pid>.json`, viewable in Perfetto or chrome://tracing) into
    `log_dir`; yields the profiler (its `key_averages()` hold the device
    kernels' times). With `enabled=False` or a falsy `log_dir` it is a
    no-op that yields None, so call sites can pass the CLI flag straight
    through. Never on by default: the profiler's own host work would
    stretch the latencies it records."""
    if not enabled or not log_dir:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(
            os.path.join(str(log_dir), f"trace_{os.getpid()}.json"))
