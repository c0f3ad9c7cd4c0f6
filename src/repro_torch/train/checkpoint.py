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

A checkpoint holds *logical* tensors: the whole parameters and
optimizer state, written once (by one rank of a distributed run), so a
restart may use another mesh (elastic resume) or another device. A tree
whose leaves are DTensors (a placed LM run) is saved by every rank of
its mesh: each leaf is gathered whole on the mesh's first rank (every
rank sends it its shard, one leaf at a time, so that it never holds two
whole leaves on the device, and no other rank holds one), which alone
writes the same layout a one-process save writes, and the ranks meet
at a barrier before the call returns. `restore` puts each stored array
onto the mesh and placements of the `like` tree's leaf (this rank's
slice, read from the file as far as it is used), as the JAX package's
`restore(shardings=)` does: a checkpoint from one mesh restores on any
other, or in one process.

Trees are flattened in a fixed order: tuples and lists element by
element, NamedTuples (`UleenParams`, `AdamState`, `SGDState`) field by
field, dicts by sorted key, a `transformer.ParamTree` in
`steps.tree_leaves` order; `None` is a leaf that stays None, and every
tensor (or numpy array) is a leaf. bf16 tensors are stored as their
int16 bit patterns (numpy has no bf16) and `dtypes` says so.
"""
from __future__ import annotations

import json
import math
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


def _is_placed(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def _mesh_of(leaves):
    """The DeviceMesh of the first placed leaf, or None."""
    return next((x.device_mesh for x in leaves if _is_placed(x)), None)


def _barrier(mesh) -> None:
    """Every rank of `mesh` waits for all the others: one barrier on each
    mesh dim's group, every rank in the same order. A rank leaves the
    last only once each rank has entered the first, as a reduction over
    the dims in turn depends on every rank's input."""
    import torch.distributed as dist
    for i in range(mesh.ndim):
        dist.barrier(group=mesh.get_group(i))


def _gather_to(x, writer: int):
    """DTensor `x` whole on global rank `writer` (a CPU tensor; None on the
    other ranks): every rank sends its shard there (`dist.gather`; a host
    copy under gloo, which stages collectives on the host), which puts
    each at its slice. Each shard crosses once, where `full_tensor` (an
    all-gather) would send it to every rank. The mesh is the whole world
    (`launch.mesh.make_mesh`)."""
    import torch.distributed as dist
    from repro_torch.dist.collectives import host_staged
    from repro_torch.dist.sharding import shard_slices
    mesh, me = x.device_mesh, dist.get_rank()
    local = x.to_local().detach().contiguous()
    if all(p.is_replicate() for p in x.placements):
        return local.cpu() if me == writer else None
    if host_staged(None):
        local = local.cpu()
    parts = ([torch.empty_like(local) for _ in range(dist.get_world_size())]
             if me == writer else None)
    dist.gather(local, parts, dst=writer)
    if parts is None:
        return None
    whole = torch.empty(tuple(x.shape), dtype=local.dtype)
    for rank, part in enumerate(parts):
        coord = [int(i) for i in (mesh.mesh == rank).nonzero()[0]]
        whole[shard_slices(tuple(x.shape), mesh, x.placements, coord)] = part
    return whole


def save(directory: str, step: int, tree: Any, *, keep: int = 3,
         metadata: Optional[dict] = None) -> Optional[str]:
    """Atomically write the checkpoint of `step`; prune to `keep` newest.
    Returns its path. A tree of DTensors is saved by every rank of their
    mesh (the module docstring); the mesh's first rank writes, and every
    rank returns once the write is done (the others get None)."""
    leaves = flatten(tree)
    mesh = _mesh_of(leaves)
    if mesh is None:
        return _write(directory, step, leaves, keep, metadata)
    writer = int(mesh.mesh.flatten()[0])

    def whole(x):         # every rank takes part, one leaf at a time
        return _gather_to(x, writer) if _is_placed(x) else x
    path = None
    if any(mesh.get_coordinate()):
        for x in leaves:
            whole(x)
    else:
        path = _write(directory, step, leaves, keep, metadata, whole)
    _barrier(mesh)
    return path


def _write(directory, step, leaves, keep, metadata,
           whole=lambda x: x) -> str:
    """Write `leaves` as the checkpoint of `step`, each made whole
    (`whole(leaf)`) when its turn comes, so that one whole leaf is held at
    a time: `arrays.npz` as `np.savez` lays it out (an uncompressed zip
    of `a<i>.npy`), then `tree.json` and DONE."""
    import zipfile
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:010d}")
    tmp = tempfile.mkdtemp(dir=directory, prefix=".tmp_ckpt_")
    try:
        dtypes = []
        with zipfile.ZipFile(os.path.join(tmp, "arrays.npz"), "w",
                             zipfile.ZIP_STORED, allowZip64=True) as zf:
            for i, x in enumerate(leaves):
                if x is None:
                    dtypes.append(None)
                    continue
                arr, dt = _to_numpy(whole(x))
                dtypes.append(dt)
                with zf.open(f"a{i}.npy", "w", force_zip64=True) as f:
                    np.lib.format.write_array(f, arr, allow_pickle=False)
                del arr
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


def stored_arrays(directory: str, step: int) -> dict:
    """{"a<i>": array} of the checkpoint of `step`, each array mapped from
    `arrays.npz` (copy-on-write) rather than read: a leaf is read only as
    far as it is used, so a rank that restores its shard reads its slice.
    `np.savez` stores the members uncompressed; this skips the CRC pass
    that `np.load` makes over every byte (DONE and the atomic rename
    guard against a torn write)."""
    import struct
    import zipfile
    path = os.path.join(directory, f"step_{step:010d}", "arrays.npz")
    out = {}
    with zipfile.ZipFile(path) as zf, open(path, "rb") as f:
        for info in zf.infolist():
            if info.compress_type != zipfile.ZIP_STORED:
                raise ValueError(f"{path}: {info.filename} is compressed")
            f.seek(info.header_offset + 26)      # the local header's sizes
            n_name, n_extra = struct.unpack("<HH", f.read(4))
            f.seek(info.header_offset + 30 + n_name + n_extra)
            header = {(1, 0): np.lib.format.read_array_header_1_0,
                      (2, 0): np.lib.format.read_array_header_2_0}[
                          np.lib.format.read_magic(f)]
            shape, fortran, dtype = header(f)
            name = info.filename.removesuffix(".npy")
            if math.prod(shape) == 0:
                out[name] = np.empty(shape, dtype)
            else:
                out[name] = np.memmap(path, dtype=dtype, mode="c",
                                      offset=f.tell(), shape=shape,
                                      order="F" if fortran else "C")
    return out


def _leaf_from(arr: np.ndarray, dtype_name: Optional[str], like):
    """A stored array as `like`'s leaf: a copy on its device and dtype, or
    this rank's slice on its mesh and placements (only the slice is
    read), or a numpy array of its dtype."""
    t = torch.from_numpy(arr)
    if dtype_name == "bfloat16":
        t = t.view(torch.bfloat16)
    if isinstance(like, np.ndarray):
        return t.numpy().astype(like.dtype)
    if _is_placed(like):
        from repro_torch.dist.sharding import from_global
        return from_global(t.to(like.dtype), like.device_mesh,
                           like.placements, device=like.to_local().device)
    if isinstance(like, torch.Tensor):
        return t.to(device=like.device, dtype=like.dtype, copy=True)
    return t.clone()


def restore(directory: str, step: int, like: Any) -> Any:
    """The checkpoint of `step` in the structure of `like`, each leaf on
    the dtype and device of `like`'s leaf, or, where that leaf is a
    DTensor, on its mesh and placements (this rank's slice); a None in
    `like` takes the stored array as a CPU tensor."""
    path = os.path.join(directory, f"step_{step:010d}")
    with open(os.path.join(path, "tree.json")) as f:
        meta = json.load(f)
    leaves = flatten(like)
    if len(leaves) != meta["num_leaves"]:
        raise ValueError(f"checkpoint has {meta['num_leaves']} leaves, the "
                         f"target {len(leaves)}")
    nones = set(meta["none_leaves"])
    stored = stored_arrays(directory, step)
    out = [None if i in nones else
           _leaf_from(stored[f"a{i}"], meta["dtypes"][i], leaf)
           for i, leaf in enumerate(leaves)]
    return unflatten(like, out)


def restore_latest(directory: str, like: Any):
    """(tree, step) of the newest checkpoint, or (None, None)."""
    step = latest_step(directory)
    if step is None:
        return None, None
    return restore(directory, step, like), step
