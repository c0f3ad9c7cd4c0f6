"""The explicit collectives of the sharded serve paths and of the
distributed trainers, over the axes of a
`torch.distributed.device_mesh.DeviceMesh`.

The JAX package declares placement and lets GSPMD or `shard_map` insert
its one collective; the port runs SPMD — every rank makes the same calls
on the same host inputs and holds only its slice — and calls the
collective itself: an all-gather of score columns (class sharding), of
rows (the batch axes), or one sum of ownership-masked scores (tenant
sharding); the trainers gather per-block gradients (bit-preserving: no
arithmetic on the wire), agree on one int8 scale with a MAX all-reduce,
gather int8 payloads as int8, and sum gradients, losses and accuracies.

An axis of size 1 needs no collective and gets none (so a one-process
`launch.mesh.make_host_mesh()` passes through every function here). An
entry over several mesh axes is reduced one axis at a time, innermost
first: the mesh is row-major, so gathering along the innermost axis and
then the next puts the blocks in the entry's linear shard order, which
is the order `axis_index` assigns.

The backend decides where a collective runs, by its name: NCCL works on
the card's tensors; under gloo (the CPU, and several ranks sharing one
card) the collective runs on a host copy, because gloo's CUDA support is
partial, and the result goes back to the tensor's device.
"""
from __future__ import annotations

import warnings

import torch
import torch.distributed as dist

from repro_torch.dist.sharding import mesh_sizes


def axis_index(mesh, axes) -> int:
    """This rank's linear shard index over `axes` (outermost first): the
    slice order of the dimension those axes partition."""
    sizes = mesh_sizes(mesh)
    idx = 0
    for ax in axes:
        if sizes[ax] > 1:
            idx = idx * sizes[ax] + mesh.get_local_rank(ax)
    return idx


def host_staged(group) -> bool:
    """Whether collectives on `group` run on host copies (gloo)."""
    return dist.get_backend(group) == "gloo"


def _gather_one(x: torch.Tensor, group, n: int, dim: int) -> torch.Tensor:
    """`x` of every rank of `group`, concatenated along `dim`. The bytes
    cross as they are, in `x`'s dtype (an int8 payload as int8)."""
    dev = x.device
    if host_staged(group):
        x = x.cpu()
    x = x.contiguous()
    # (n, *x.shape) filled in group-rank order, seen flat by the call:
    # both backends accept the concatenated (n * d0, ...) form
    out = torch.empty((n, *x.shape), dtype=x.dtype, device=x.device)
    with warnings.catch_warnings():
        # all_gather_into_tensor warns of a successor in newer torch; the
        # successor is not in every torch the port runs on
        warnings.simplefilter("ignore", FutureWarning)
        dist.all_gather_into_tensor(out.view(n * x.shape[0], *x.shape[1:]),
                                    x, group=group)
    shape = list(x.shape)
    shape[dim] *= n
    return out.movedim(0, dim).reshape(shape).to(dev)


def all_gather(x: torch.Tensor, mesh, axes, dim: int) -> torch.Tensor:
    """Concatenate every shard's `x` along `dim`, over the mesh `axes`,
    in linear shard order; the result is the same on every rank."""
    sizes = mesh_sizes(mesh)
    for ax in reversed(tuple(axes)):
        if sizes[ax] > 1:
            x = _gather_one(x, mesh.get_group(ax), sizes[ax], dim)
    return x


def _all_reduce(x: torch.Tensor, mesh, axes, op) -> torch.Tensor:
    dev = x.device
    sizes = mesh_sizes(mesh)
    for ax in tuple(axes):
        if sizes[ax] == 1:
            continue
        group = mesh.get_group(ax)
        x = x.cpu() if host_staged(group) else x.clone()
        dist.all_reduce(x, op=op, group=group)
    return x.to(dev)


def all_reduce_sum(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """The elementwise sum of every shard's `x` over the mesh `axes`.
    Integer sums are exact; a float sum's order is the backend's, and
    gloo's and NCCL's ring all-reduces reduce each chunk once and pass it
    on, so every rank holds the same bits."""
    return _all_reduce(x, mesh, axes, dist.ReduceOp.SUM)


def all_reduce_max(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """The elementwise maximum of every shard's `x` over the mesh `axes`:
    exact, and the same on every rank."""
    return _all_reduce(x, mesh, axes, dist.ReduceOp.MAX)


def sum_over(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """The sum of every shard's float `x` over the mesh `axes`, in a fixed
    order: the shards gathered in linear shard order and added left to
    right on each rank. Only where the bits must be those of a one-device
    fold in that order: the compressed ULEEN step's sum over `data`, which
    is held bit for bit to its one-device emulation
    (`launch.train.uleen_reference_params(compress_mesh=)`). It sends
    (n - 1) copies of `x`; other float sums take `all_reduce_sum`."""
    stack = all_gather(x[None], mesh, axes, dim=0)
    total = stack[0]
    for part in stack[1:]:
        total = total + part
    return total


_STAGED_OPS = []     # the Library objects that hold the routes (kept alive)


def stage_cuda_gathers_on_host() -> None:
    """Give DTensor's all-gathers of CUDA tensors over gloo a route that
    gloo takes, for ranks that share one card on a "cuda" DeviceMesh.

    DTensor runs its collectives as PyTorch's functional collectives.
    Under gloo, on CUDA tensors (torch 2.11 on an H100,
    `scripts/gloo_cuda_probe.py`), the functional all-reduce,
    reduce-scatter and all-to-all run, and so does every
    `torch.distributed` call, but the functional all-gather
    (`_c10d_functional::all_gather_into_tensor`: every gather DTensor
    makes, `full_tensor`, a redistribution to `Replicate`, FSDP's weight
    gathers) ends the process with a segmentation fault. The route
    registers a CUDA kernel of that operator that makes the same gather
    with `torch.distributed.all_gather_into_tensor` on the same tensors:
    gloo's CUDA path, which stages them through pinned host memory
    itself (faster than a copy to the host and the functional operator
    there, the probe's timings). The shards and all arithmetic stay on
    the card. The kernel holds for the whole process (an operator's
    kernel is process-wide), so it is installed only where every group
    is gloo (`launch.mesh.make_mesh`), and raises on a group of another
    backend. Installing it twice is a no-op."""
    if _STAGED_OPS:
        return
    from torch.distributed.distributed_c10d import _resolve_process_group

    def gather(x, group_size, group_name):
        group = _resolve_process_group(group_name)
        if not host_staged(group):
            raise RuntimeError(f"the host-staged gather runs over gloo, not "
                               f"{dist.get_backend(group)}")
        x = x.contiguous()
        out = x.new_empty((group_size * x.shape[0], *x.shape[1:]))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", FutureWarning)
            dist.all_gather_into_tensor(out, x, group=group)
        return out

    lib = torch.library.Library("_c10d_functional", "IMPL")
    lib.impl("all_gather_into_tensor", gather, "CUDA")
    _STAGED_OPS.append(lib)


def row_slice(n_rows: int, mesh, axes) -> slice:
    """The rows [lo, hi) this rank holds of `n_rows` split over `axes`
    (the caller resolved `axes` with the divisibility sanitizer)."""
    sizes = mesh_sizes(mesh)
    degree = 1
    for ax in axes:
        degree *= sizes[ax]
    if n_rows % degree:
        raise ValueError(f"{n_rows} rows do not split over {axes} "
                         f"(degree {degree})")
    per = n_rows // degree
    lo = axis_index(mesh, axes) * per
    return slice(lo, lo + per)
