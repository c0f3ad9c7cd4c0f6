"""Step-atomic checkpoints for fault-tolerant training (port of
`repro/train/checkpoint.py`).

Layout:  <dir>/step_<10 digits>/arrays.npz + tree.json + DONE
Writes go to a temp dir that is then renamed, so a preempted write never
corrupts the latest checkpoint; `all_steps` trusts only `step_<digits>`
directories that hold the DONE marker. `arrays.npz` is laid out as the
JAX package lays it out (`a<i>` for leaf i, None leaves absent); the
metadata is JSON (`num_leaves`, `none_leaves`, `dtypes`, `step`, `time`,
`metadata`) where the JAX package writes msgpack, which the port does
not need.

A checkpoint holds *logical* tensors: the whole replicated parameters and
optimizer state, written once (by one rank of a distributed run), so a
restart may use another mesh (elastic resume) or another device.

Trees are flattened in a fixed order: tuples and lists element by
element, NamedTuples (`UleenParams`, `AdamState`, `SGDState`) field by
field, dicts by sorted key, a `transformer.ParamTree` in
`steps.tree_leaves` order; `None` is a leaf that stays None, and every
tensor (or numpy array) is a leaf. bf16 tensors are stored as their
int16 bit patterns (numpy has no bf16) and `dtypes` says so.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
import time
from typing import Any, Optional

import numpy as np
import torch

DONE = "DONE"


def _is_leaf(x) -> bool:
    return x is None or isinstance(x, (torch.Tensor, np.ndarray))


def flatten(tree: Any) -> list:
    """The leaves of `tree` (tensors, numpy arrays and Nones) in the fixed
    order of the module docstring."""
    if _is_leaf(tree):
        return [tree]
    if isinstance(tree, torch.nn.Module):
        return list(tree.parameters())
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in flatten(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for item in tree for x in flatten(item)]
    raise TypeError(f"cannot checkpoint a leaf of type {type(tree).__name__}")


def unflatten(like: Any, leaves) -> Any:
    """A tree of `like`'s structure holding `leaves` (in `flatten` order)."""
    it = iter(leaves)

    def build(node):
        if _is_leaf(node):
            return next(it)
        if isinstance(node, torch.nn.Module):
            from repro_torch.launch import steps
            return steps.tree_with_leaves(
                node, [next(it) for _ in node.parameters()])
        if isinstance(node, dict):
            built = {k: build(node[k]) for k in sorted(node)}
            return {k: built[k] for k in node}
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return type(node)(*(build(x) for x in node))
        return type(node)(build(x) for x in node)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree has")
    return out


def _to_numpy(x) -> tuple:
    """(numpy array, dtype name) of one leaf."""
    if isinstance(x, np.ndarray):
        return x, str(x.dtype)
    x = x.detach().cpu()
    if x.dtype == torch.bfloat16:
        return x.view(torch.int16).numpy(), "bfloat16"
    return x.numpy(), str(x.dtype).replace("torch.", "")


def save(directory: str, step: int, tree: Any, *, keep: int = 3,
         metadata: Optional[dict] = None) -> str:
    """Atomically write the checkpoint of `step`; prune to `keep` newest."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:010d}")
    tmp = tempfile.mkdtemp(dir=directory, prefix=".tmp_ckpt_")
    try:
        leaves = flatten(tree)
        arrays, dtypes = {}, []
        for i, x in enumerate(leaves):
            if x is None:
                dtypes.append(None)
                continue
            arrays[f"a{i}"], dt = _to_numpy(x)
            dtypes.append(dt)
        np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
        meta = {"num_leaves": len(leaves),
                "none_leaves": [i for i, x in enumerate(leaves) if x is None],
                "dtypes": dtypes, "step": step, "time": time.time(),
                "metadata": metadata or {}}
        with open(os.path.join(tmp, "tree.json"), "w") as f:
            json.dump(meta, f)
        with open(os.path.join(tmp, DONE), "w") as f:
            f.write(str(step))
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    _prune(directory, keep)
    return final


def _prune(directory: str, keep: int) -> None:
    for s in all_steps(directory)[:-keep]:
        shutil.rmtree(os.path.join(directory, f"step_{s:010d}"),
                      ignore_errors=True)


def all_steps(directory: str) -> list:
    """Completed steps, ascending. Only `step_<digits>` directories with the
    DONE marker count: a stray `step_backup/` or a torn write is "not a
    checkpoint", never a crash of a restarting worker's restore."""
    if not os.path.isdir(directory):
        return []
    out = []
    for name in os.listdir(directory):
        if not name.startswith("step_"):
            continue
        suffix = name.split("_", 1)[1]
        if suffix.isdigit() and os.path.exists(
                os.path.join(directory, name, DONE)):
            out.append(int(suffix))
    return sorted(out)


def latest_step(directory: str) -> Optional[int]:
    steps = all_steps(directory)
    return steps[-1] if steps else None


def _leaf_from(arr: np.ndarray, dtype_name: Optional[str], like):
    if dtype_name == "bfloat16":
        t = torch.from_numpy(np.array(arr)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr))
    if isinstance(like, np.ndarray):
        return t.numpy().astype(like.dtype)
    if isinstance(like, torch.Tensor):
        return t.to(device=like.device, dtype=like.dtype)
    return t


def restore(directory: str, step: int, like: Any) -> Any:
    """The checkpoint of `step` in the structure of `like`, each leaf on
    the dtype and device of `like`'s leaf (a None in `like` takes the
    stored array as a CPU tensor)."""
    path = os.path.join(directory, f"step_{step:010d}")
    with open(os.path.join(path, "tree.json")) as f:
        meta = json.load(f)
    leaves = flatten(like)
    if len(leaves) != meta["num_leaves"]:
        raise ValueError(f"checkpoint has {meta['num_leaves']} leaves, the "
                         f"target {len(leaves)}")
    nones = set(meta["none_leaves"])
    out = []
    with np.load(os.path.join(path, "arrays.npz")) as z:
        for i, leaf in enumerate(leaves):
            out.append(None if i in nones else
                       _leaf_from(z[f"a{i}"], meta["dtypes"][i], leaf))
    return unflatten(like, out)


def restore_latest(directory: str, like: Any):
    """(tree, step) of the newest checkpoint, or (None, None)."""
    step = latest_step(directory)
    if step is None:
        return None, None
    return restore(directory, step, like), step
