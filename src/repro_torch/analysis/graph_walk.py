"""Walking a traced program: the one walker every invariant check and the
cost model share (port of `repro/analysis/jaxpr_walk.py`).

A dry-run trace (`launch.graph_cost.trace`) is a `torch.fx.GraphModule`
made by `make_fx` over fake tensors: one node an operator call, the fake
tensor it produced in `node.meta["val"]` (shape, dtype, device; no
storage). A graph may hold nested `GraphModule`s as attributes (the
bodies of higher-order operators such as `cond` or a checkpointed
region); the walker descends into every one, so a rule that asks "does
any value in this program look like an unpacked table" means the whole
program. The CUDA kernels are opaque operator nodes
(`repro_torch::wnn_ensemble`, `repro_torch::h3_hash`): their fake output
is what a rule sees of them.
"""
from __future__ import annotations

from typing import Iterator

import torch


def all_graphs(gm) -> Iterator:
    """`gm`'s graph plus every nested GraphModule's graph (pre-order)."""
    if gm is None:
        return
    yield gm.graph
    for node in gm.graph.nodes:
        if node.op == "get_attr":
            sub = getattr(gm, node.target, None)
            if isinstance(sub, torch.fx.GraphModule):
                yield from all_graphs(sub)


def all_nodes(gm) -> Iterator:
    """Every node of the program, nested graphs included."""
    for g in all_graphs(gm):
        yield from g.nodes


def tensors(val) -> Iterator:
    if isinstance(val, torch.Tensor):
        yield val
    elif isinstance(val, (list, tuple)):
        for v in val:
            yield from tensors(v)


def all_values(gm) -> Iterator:
    """(node, fake tensor) for every tensor a node binds: inputs
    (placeholders) and every operator's outputs, at every depth."""
    for node in all_nodes(gm):
        for t in tensors(node.meta.get("val")):
            yield node, t


def op_name(node) -> str:
    """'namespace::op' of an operator node ('aten::index', 'c10d::
    allreduce_', 'repro_torch::wnn_ensemble'), '' for any other node."""
    target = node.target
    if node.op != "call_function" or not hasattr(target, "_schema"):
        return ""
    return target._schema.name


def op_names(gm) -> set:
    """Names of every operator the program calls, at any depth."""
    return {n for n in map(op_name, all_nodes(gm)) if n}


def find_values(gm, predicate) -> list:
    """(node, value) for every value matching `predicate`, deduplicated by
    (shape, dtype)."""
    seen, out = set(), []
    for node, t in all_values(gm):
        key = (tuple(t.shape), str(t.dtype))
        if key in seen or not predicate(t):
            continue
        seen.add(key)
        out.append((node, t))
    return out
