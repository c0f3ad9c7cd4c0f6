"""Logical-axis sharding rules -> per-dimension mesh-axis entries (port of
`repro/dist/sharding.py`).

Every tensor is annotated with *logical* axis names ("batch", "classes",
"tenants", ...), never with mesh axes. One rule table per execution mode
(`TRAIN_RULES` / `SERVE_RULES`) maps each logical name to an ordered
preference of mesh axes, and `ShardingRules.resolve` turns a logical tuple
into one entry per dimension for a concrete mesh:

* divisibility sanitizer — when the shape is known, a mesh axis is taken
  only if the cumulative device count still divides the dimension (24
  heads over model=16 -> replicated; 32 -> sharded);
* multi-axis rules with subset fallback — `batch: ("pod", "data")` shards
  over both axes when the dimension allows, degrading left to right;
* no axis reuse — dims resolve left to right; an axis an earlier dim
  consumed is skipped;
* adaptive yield — later dims pick up axes earlier dims could not use;
* size-1 mesh axes never appear in an entry, so a one-process mesh
  resolves everything to replication.

An entry is None (replicated), one axis name, or a tuple of names; the
JAX package wraps the same entries in a `PartitionSpec`, the port returns
the plain tuple. A mesh is read through two attributes only: its axis
names (`mesh_dim_names`) and its shape (`shape`), so a
`torch.distributed.device_mesh.DeviceMesh` and a plain stand-in with the
same two attributes (`launch.mesh.make_host_mesh`, or one a test builds)
resolve alike, with no process group.

The JAX module's placement APIs — `shard_map`, `named_sharding`,
`logical_constraint` and `tree_shardings` — have no counterpart here.
PyTorch has no compiler that places arrays by annotation: the port's
sharded paths run SPMD on `torch.distributed` (every rank makes the same
calls, holds its own slice, and calls the one collective itself;
`dist.collectives`), and use the resolved entries only to decide who
holds what.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Optional


def mesh_sizes(mesh) -> dict:
    """{axis name: size} of a mesh (a DeviceMesh or a stand-in)."""
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """Immutable logical-axis -> mesh-axis-preference table."""

    rules: dict   # {logical_name: tuple[mesh_axis, ...]}

    def resolve(self, logical_axes, mesh, shape: Optional[tuple] = None):
        """One entry per dimension of a tensor whose dims carry
        `logical_axes` names (None = never sharded): None, a mesh axis
        name, or a tuple of them. `shape` (optional concrete dims) turns
        on the divisibility sanitizer."""
        logical_axes = tuple(logical_axes)
        if shape is not None and len(shape) != len(logical_axes):
            raise ValueError(
                f"shape {shape} has {len(shape)} dims but logical axes "
                f"{logical_axes} name {len(logical_axes)}")
        sizes = mesh_sizes(mesh)
        used: set = set()
        entries = []
        for i, name in enumerate(logical_axes):
            if name is None:
                entries.append(None)
                continue
            if name not in self.rules:
                raise ValueError(
                    f"unknown logical axis {name!r}; known: "
                    f"{sorted(self.rules)}")
            taken = []
            degree = 1
            for ax in self.rules[name]:
                if ax not in sizes or ax in used or sizes[ax] == 1:
                    continue
                if shape is not None and shape[i] % (degree * sizes[ax]):
                    continue
                taken.append(ax)
                degree *= sizes[ax]
            used.update(taken)
            if not taken:
                entries.append(None)
            elif len(taken) == 1:
                entries.append(taken[0])
            else:
                entries.append(tuple(taken))
        return tuple(entries)


# Mesh axes (launch/mesh.py): pod -> data -> model, outermost first.
TRAIN_RULES = ShardingRules(rules={
    # activations
    "batch": ("pod", "data"),
    "seq": (),
    "ctx": ("model",),            # query seq: context parallelism, yields
                                  # to "heads" via no-reuse
    "heads": ("model",),
    "kv_heads": ("model",),
    "ffn": ("model",),
    "vocab": ("model",),
    "cache_seq": (),              # caches only shard while serving
    # parameters
    "fsdp": ("data",),
    "tp": ("model",),
    "experts": ("model",),
    "expert_ffn": ("model",),
    "classes": (),                # the training ensemble is tiny: replicate
    "tenants": (),                # training is single-tenant
})

# Serving: the KV cache's sequence takes `model`; ULEEN tables shard over
# `model` by class (per-class discriminators are independent until the
# final argmax, so the only cross-device step is the (B, M) score gather)
# and a stacked fleet by tenant (whole tenants are independent: one sum of
# ownership-masked scores). No-reuse means a fleet sharded by tenant leaves
# its classes replicated.
SERVE_RULES = ShardingRules(rules={
    **TRAIN_RULES.rules,
    "kv_heads": (),
    "cache_seq": ("model",),
    "classes": ("model",),
    "tenants": ("model",),
})


def entry_axes(entry) -> tuple:
    """The mesh axes of one entry, outermost first (() for None)."""
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def spec_degree(mesh, entry) -> int:
    """Shard count one entry implies on `mesh` (None -> 1)."""
    sizes = mesh_sizes(mesh)
    degree = 1
    for ax in entry_axes(entry):
        degree *= sizes[ax]
    return degree


def class_partition(mesh, num_classes: int,
                    rules: Optional[ShardingRules] = None):
    """(entry, degree) of the `classes` axis of an M-class ensemble on
    `mesh`; (None, 1) — replication — whenever M does not divide the mesh
    axis, so callers never special-case awkward class counts."""
    rules = rules if rules is not None else SERVE_RULES
    entry = rules.resolve(("classes",), mesh, shape=(num_classes,))[0]
    return entry, spec_degree(mesh, entry)


def tenant_partition(mesh, num_tenants: int,
                     rules: Optional[ShardingRules] = None):
    """(entry, degree) of the `tenants` axis of a T-artifact fleet on
    `mesh`; (None, 1) when T does not divide the mesh axis."""
    rules = rules if rules is not None else SERVE_RULES
    entry = rules.resolve(("tenants",), mesh, shape=(num_tenants,))[0]
    return entry, spec_degree(mesh, entry)


def strip_axis(rules: ShardingRules, axis: str) -> ShardingRules:
    """Rules with one mesh axis removed from every preference tuple."""
    return ShardingRules(rules={
        k: tuple(a for a in v if a != axis) for k, v in rules.rules.items()})


def rules_key(rules: ShardingRules) -> tuple:
    """A hashable key of a rule table's content (caches key on it, not on
    the object's identity)."""
    return tuple(sorted((k, tuple(v)) for k, v in rules.rules.items()))


# ---------------------------------------------------------------------------
# Mesh context
# ---------------------------------------------------------------------------

_STATE = threading.local()


@contextlib.contextmanager
def use_mesh(mesh, rules: ShardingRules):
    """Activate (mesh, rules) on this thread for `current_context`."""
    prev = getattr(_STATE, "ctx", None)
    _STATE.ctx = (mesh, rules)
    try:
        yield mesh
    finally:
        _STATE.ctx = prev


def current_context():
    """(mesh, rules) of the innermost `use_mesh`, or None."""
    return getattr(_STATE, "ctx", None)
