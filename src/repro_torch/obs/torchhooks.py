"""Shape counting for eager PyTorch — the port's `obs/jaxhooks.py::counted`.

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

import dataclasses
import functools

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
