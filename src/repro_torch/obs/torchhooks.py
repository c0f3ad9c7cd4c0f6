"""Shape counting for eager PyTorch — the port's `obs/jaxhooks.py::counted`.

Under `jax.jit` a function's Python body runs once per trace, i.e. once
per distinct input shape, so a counter bumped in the body counts
compilations. PyTorch runs eagerly and never traces; what a fixed-shape
serve path must still keep at one is the set of distinct input shapes
it launches (each would be its own CUDA-graph capture or kernel
specialisation). `counted` bumps its counter the first time each
distinct signature of tensor shapes, dtypes and devices reaches the
wrapped function, and never again for that signature.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.obs import registry as _registry


def _signature(args, kwargs) -> tuple:
    vals = list(args) + [kwargs[k] for k in sorted(kwargs)]
    return tuple((tuple(v.shape), v.dtype, v.device) for v in vals
                 if isinstance(v, torch.Tensor))


def counted(fn, counts, key, *, prefix: str = "torch.shape"):
    """Wrap `fn` so each new tensor-shape signature bumps `counts[key]`
    and the global recorder counter `{prefix}.{key}`. Calls with a
    signature already seen count nothing, so a steady-state serve loop
    stays at 1."""
    seen = set()

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        sig = _signature(args, kwargs)
        if sig not in seen:
            seen.add(sig)
            counts[key] += 1
            _registry.get_recorder().counter(f"{prefix}.{key}").inc()
        return fn(*args, **kwargs)
    return wrapped
