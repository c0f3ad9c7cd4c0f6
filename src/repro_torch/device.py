"""The one place the port turns a `device=` argument into a torch.device.

Entry points default to `"cuda"`. A CUDA request on a machine with no
CUDA device raises: the port never falls back to the CPU on its own —
running there is the caller's explicit choice (`device="cpu"`). The one
exception is a trace with fake tensors (`launch.graph_cost.trace`, the
dry run): nothing is allocated or run there, so "cuda" names card 0
whether or not a card is present.
"""
from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def fake_trace_active() -> bool:
    """Whether a `FakeTensorMode` is active on this thread (a dry-run
    trace): tensors made now are fake, on any device, with no storage."""
    return torch._C._get_dispatch_mode(
        torch._C._TorchDispatchModeKey.FAKE) is not None


def resolve_device(device=DEFAULT_DEVICE) -> torch.device:
    """`device` (str or torch.device) -> torch.device, checked to exist.
    A bare "cuda" becomes the current card's index, so it compares equal
    to the device of the tensors it places (caches key on it)."""
    dev = torch.device(device)
    if dev.type == "cuda" and fake_trace_active():
        return torch.device("cuda", 0 if dev.index is None else dev.index)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch versions on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type not in ("cpu", "meta"):
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    return dev
