"""The explicit collectives of the sharded serve paths, over the axes of a
`torch.distributed.device_mesh.DeviceMesh`.

The JAX package declares placement and lets GSPMD or `shard_map` insert
its one collective; the port runs SPMD — every rank makes the same calls
on the same host inputs and holds only its slice — and calls the
collective itself: an all-gather of score columns (class sharding), of
rows (the batch axes), or one sum of ownership-masked scores (tenant
sharding).

An entry over several mesh axes is reduced one axis at a time, innermost
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
        idx = idx * sizes[ax] + mesh.get_local_rank(ax)
    return idx


def host_staged(group) -> bool:
    """Whether collectives on `group` run on host copies (gloo)."""
    return dist.get_backend(group) == "gloo"


def _gather_one(x: torch.Tensor, group, n: int, dim: int) -> torch.Tensor:
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
        x = _gather_one(x, mesh.get_group(ax), sizes[ax], dim)
    return x


def all_reduce_sum(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """The elementwise sum of every shard's `x` over the mesh `axes`;
    integer sums are exact, so the order does not matter."""
    dev = x.device
    for ax in tuple(axes):
        group = mesh.get_group(ax)
        x = x.cpu() if host_staged(group) else x.clone()
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return x.to(dev)


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
