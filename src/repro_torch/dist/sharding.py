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

Placement (the LM family's tensor and data parallelism) rides on
`torch.distributed.tensor` (DTensor): `placements` turns one tensor's
resolved entries into DTensor placements on a `DeviceMesh` (`Shard(dim)`
on each mesh dim an entry names, `Replicate()` elsewhere);
`distribute_tree` wraps each leaf of a tree as a DTensor from this
rank's slice (`DTensor.from_local`, no collective); and
`logical_constraint` — JAX's, inside `use_mesh` — redistributes a
DTensor to the placements its logical axes resolve to (DTensor's
propagation then emits the collectives, as GSPMD does for the JAX
package). Outside a mesh context, or on a plain tensor, it is the
identity, so the one-device paths run exactly as before. The entries
always come from these rules and their divisibility sanitizer: DTensor
never shards a dim the rules replicate, and never unevenly. A model
constrains a tensor before a view that splits a sharded flat dim (the
(B, S, H·hd) -> (B, S, H, hd) reshape of q, k and v): DTensor refuses to
unflatten a dim sharded unevenly across the new dims, where GSPMD
propagates through. The ULEEN sharded paths run SPMD on
`torch.distributed` as before (every rank holds its own slice and calls
the one collective itself, `dist.collectives`), and use the resolved
entries only to decide who holds what.
"""
from __future__ import annotations

import contextlib
import dataclasses
import types
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

# process-wide, not a thread's: the autograd engine runs a backward pass
# (and the forward a checkpointed segment recomputes there) on its own
# device threads, which must see the placement the forward ran under
_STATE = types.SimpleNamespace(ctx=None)


@contextlib.contextmanager
def use_mesh(mesh, rules: ShardingRules):
    """Activate (mesh, rules) for `current_context` (process-wide)."""
    prev = getattr(_STATE, "ctx", None)
    _STATE.ctx = (mesh, rules)
    try:
        yield mesh
    finally:
        _STATE.ctx = prev


def current_context():
    """(mesh, rules) of the innermost `use_mesh`, or None."""
    return getattr(_STATE, "ctx", None)


# ---------------------------------------------------------------------------
# Placement (DTensor)
# ---------------------------------------------------------------------------

def placements(entries, mesh) -> list:
    """DTensor placements of a tensor whose dims resolved to `entries` on
    `mesh` (a DeviceMesh): `Shard(d)` on every mesh dim that dim d's
    entry names, `Replicate()` on the others. A dim sharded over several
    mesh dims splits over them outermost first, as a JAX multi-axis entry
    does."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh.mesh_dim_names)
    out = [Replicate() for _ in names]
    for dim, entry in enumerate(entries):
        for ax in entry_axes(entry):
            out[names.index(ax)] = Shard(dim)
    return out


def local_shape(shape, entries, mesh) -> tuple:
    """The shape of one rank's slice of a global `shape` under
    `entries` (the rules' entries divide every sharded dim)."""
    return tuple(n // spec_degree(mesh, e) for n, e in zip(shape, entries))


def shard_slices(shape, mesh, placements_, coord=None) -> tuple:
    """The slices of a global tensor of `shape` that the rank at mesh
    coordinate `coord` (this rank's by default) holds under
    `placements_`. A dim sharded over several mesh dims splits over them
    outermost first, as DTensor reads such placements (and as a JAX
    multi-axis entry splits)."""
    from torch.distributed.tensor import Shard
    coord = mesh.get_coordinate() if coord is None else coord
    lo, n = [0] * len(shape), list(shape)
    for i, p in enumerate(placements_):
        if not isinstance(p, Shard):
            continue
        parts = mesh.size(i)
        if n[p.dim] % parts:
            raise ValueError(f"dim {p.dim} of {tuple(shape)} does not "
                             f"split evenly over mesh dim {i} ({parts})")
        n[p.dim] //= parts
        lo[p.dim] += coord[i] * n[p.dim]
    return tuple(slice(a, a + b) for a, b in zip(lo, n))


def from_global(t, mesh, placements_, device=None):
    """`t` (the global tensor, the same on every rank; real or fake) as a
    DTensor of `placements_` on `mesh`: this rank's slice
    (`shard_slices`) cut from it locally, with no collective; given a
    `device`, a copy of the slice there (only the slice is read)."""
    from torch.distributed.tensor import DTensor
    local = t[shard_slices(tuple(t.shape), mesh, placements_)]
    if device is not None:
        local = local.to(device, copy=True)
    return DTensor.from_local(
        local.contiguous(), mesh, list(placements_), run_check=False,
        shape=tuple(t.shape), stride=contiguous_stride(tuple(t.shape)))


def distribute_tensor(t, logical, mesh, rules: ShardingRules):
    """`t` (this rank's copy of the global tensor, real or fake) as a
    DTensor on `mesh`: its slice under the entries `logical` resolves to
    on t's shape (`from_global`)."""
    entries = rules.resolve(logical, mesh, shape=tuple(t.shape))
    return from_global(t, mesh, placements(entries, mesh))


def contiguous_stride(shape: tuple) -> tuple:
    """The strides of a contiguous tensor of `shape`."""
    stride, acc = [], 1
    for n in reversed(shape):
        stride.append(acc)
        acc *= n
    return tuple(reversed(stride))


def distribute_tree(tree, logical_tree, mesh, rules: ShardingRules):
    """A tree of nested dicts and lists whose leaves are global tensors
    (each rank's copy, or fake ones), with `logical_tree` (the same
    structure, logical tuples at the leaves) -> the same tree of DTensors,
    each holding this rank's slice (`distribute_tensor`)."""
    if isinstance(tree, dict):
        return {k: distribute_tree(v, logical_tree[k], mesh, rules)
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [distribute_tree(v, lg, mesh, rules)
                for v, lg in zip(tree, logical_tree, strict=True)]
    return distribute_tensor(tree, logical_tree, mesh, rules)


@contextlib.contextmanager
def use_placement(mesh, rules: ShardingRules):
    """`use_mesh` for a placed program: (mesh, rules) active, and plain
    tensors that meet DTensors (positions, masks, constants) taken as
    replicated (DTensor's `implicit_replication`)."""
    from torch.distributed.tensor.experimental import implicit_replication
    with use_mesh(mesh, rules), implicit_replication():
        yield mesh


def logical_constraint(x, logical):
    """JAX's `logical_constraint`: inside `use_mesh` and on a DTensor,
    `x` redistributed to the placements its logical axes resolve to on
    its shape (DTensor emits the collectives); the identity otherwise,
    so one-device code is unchanged."""
    ctx = current_context()
    if ctx is None:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    mesh, rules = ctx
    entries = rules.resolve(logical, mesh, shape=tuple(x.shape))
    want = placements(entries, mesh)
    if list(x.placements) == want:
        return x
    return x.redistribute(mesh, want)
