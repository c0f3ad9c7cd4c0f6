"""Program facts the invariant rules read from a traced per-rank program
(the port's `repro/analysis/hlo_rules.py`).

Everything here comes from one `launch.graph_cost.trace`: its graph (the
operator nodes, each with its fake output in `meta["val"]`), its inputs
(this rank's arguments, by path) and the host round trips the tracer
recorded. The cost model reads the same graph through the same walker,
so the rules and the roofline see one program.

A per-rank program's shapes are this rank's, as the JAX package's
SPMD-partitioned HLO shapes are per device: an input that lost its
sharding arrives at global size, and an intermediate that did shows up
at global size too — the two facts `sharding-coverage` checks.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.analysis import graph_walk

_WIDE = (torch.float64, torch.complex128)
_COPIES = ("aten::_to_copy", "aten::copy_", "aten::to", "aten::_copy_from")


def collective_counts(gm) -> dict:
    """kind -> `c10d` nodes over the whole program."""
    from repro_torch.launch import graph_cost
    return graph_cost.collective_counts(gm)


def f64_values(gm) -> list:
    """(node, value) for every float64/complex128 value in the program."""
    return graph_walk.find_values(gm, lambda t: t.dtype in _WIDE)


def cpu_copies(gm) -> list:
    """Nodes that copy a value from the card to the host: a copy whose
    output lies on the CPU while an input lies on another device."""
    out = []
    for node in graph_walk.all_nodes(gm):
        if graph_walk.op_name(node) not in _COPIES:
            continue
        outs = list(graph_walk.tensors(node.meta.get("val")))
        ins = [t for a in node.args if isinstance(a, torch.fx.Node)
               for t in graph_walk.tensors(a.meta.get("val"))]
        if any(t.device.type == "cpu" for t in outs) and \
                any(t.device.type != "cpu" for t in ins):
            out.append(node)
    return out


@dataclasses.dataclass(frozen=True)
class InputShard:
    """One input of a rank's program: its bytes on this rank, the bytes
    of the global array it is a shard of, and the shard count."""
    path: str
    bytes: int
    global_bytes: int
    degree: int

    @property
    def replicated(self) -> bool:
        return self.degree == 1


def oversized_values(gm, limit_bytes: float) -> list:
    """(node, bytes) for every operator output above `limit_bytes` (inputs
    are `InputShard`s, checked on their own)."""
    out = []
    for node in graph_walk.all_nodes(gm):
        if node.op != "call_function":
            continue
        b = sum(t.numel() * t.element_size()
                for t in graph_walk.tensors(node.meta.get("val")))
        if b > limit_bytes:
            out.append((node, b))
    return out
