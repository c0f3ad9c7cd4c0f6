"""`wnnlint` for the port: program invariants checked over traced cells.

The invariants the JAX package's PR 1–5 set — no unpacked table in a
packed program, no float64, one collective in a sharded serve step, no
host round trip while serving, kernel launches that fit the card, and
big inputs partitioned — as a registry of named rules evaluated over
the per-rank graphs `launch.graph_cost.trace` makes with fake tensors.
Entry points: `python -m repro_torch.analysis.cli` and
`python -m repro_torch.launch.dryrun --analyze`.
"""
from repro_torch.analysis.graph_walk import (all_graphs, all_nodes,
                                             all_values, find_values,
                                             op_names)
from repro_torch.analysis.registry import (RULES, CellProgram, Finding,
                                           KernelGeometry, Rule,
                                           analyze_program, render_findings,
                                           report_json, summarize)

__all__ = [
    "all_graphs", "all_nodes", "all_values", "find_values", "op_names",
    "RULES", "CellProgram", "Finding", "KernelGeometry", "Rule",
    "analyze_program", "render_findings", "report_json", "summarize",
]
