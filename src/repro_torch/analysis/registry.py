"""Rule registry and structured findings: the core of the port's `wnnlint`
(port of `repro/analysis/registry.py`).

A `CellProgram` is one traced cell's evidence: its per-rank graph and
trace (`launch.graph_cost.trace`: the operator nodes with their fake
values, this rank's inputs, the host round trips) and the static facts a
rule needs to hold the program to the cell's intent (which shapes would
be an unpacked table, the collective budget, the kernels' launch
geometries, the byte thresholds of sharding coverage). Rules are small
named checks with a severity and the PR of the JAX package that set their
invariant; `analyze_program` runs every rule that applies and returns
`Finding`s, which `report_json` gathers into the ANALYSIS.json that
`scripts/diff_dryrun.py` reads (schema `wnnlint/v1`, as the JAX
package's).

The rules keep their JAX names, severities and PRs, but one:
`smem-budget` stands for `vmem-budget`. A Hopper kernel has no VMEM
block plan; what must fit is the WNN kernel's dynamic shared memory a
block (`kernels.wnn_ensemble.shared_bytes` at the launch geometry)
within the card's opt-in 227 KB, and, where the build log is at hand,
no register spills in the instantiation the cell launches.

Adding a rule: write `check(prog) -> list[Finding]`, decorate it with
`@rule(name=..., severity=..., established=..., applies=...)`, and add a
deliberately broken program it must flag to
`tests/test_torch_analysis.py`.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

from repro_torch.analysis import graph_rules, graph_walk

SCHEMA = "wnnlint/v1"
SEVERITIES = ("error", "warning", "info")
# The H100's opt-in dynamic shared memory a block (cudaDevAttr
# MaxSharedMemoryPerBlockOptin: 227 KB of the SM's 228 KB).
SMEM_LIMIT_BYTES = 227 * 1024


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation (or notable fact) in one cell's program."""
    rule: str
    severity: str
    cell: str
    message: str
    detail: dict = dataclasses.field(default_factory=dict)

    def to_json(self) -> dict:
        return {"rule": self.rule, "severity": self.severity,
                "cell": self.cell, "message": self.message,
                "detail": self.detail}


@dataclasses.dataclass(frozen=True)
class KernelGeometry:
    """One WNN kernel launch of a cell: the input columns its perms read,
    its class count and hashes, and its route — what `smem-budget`
    evaluates without a card."""
    columns: int
    m: int
    k: int
    route: str = "shared_tile"
    label: str = ""

    def shared_bytes(self) -> int:
        from repro_torch.kernels import wnn_ensemble
        return wnn_ensemble.shared_bytes(self.columns, self.m, self.route)

    def instantiation(self) -> str:
        """The `csrc/wnn.cu` instantiation this launch runs (the name
        `wnn_ensemble.instantiation_name` gives a ptxas report's entry)."""
        from repro_torch.kernels import wnn_ensemble
        return wnn_ensemble.instantiation_for(self.m, self.k, self.route)


@dataclasses.dataclass
class CellProgram:
    """Everything the rules may inspect about one traced cell."""
    name: str
    kind: str = "infer"                  # "train" | "infer"
    graph: Any = None                    # torch.fx.GraphModule
    traced: Any = None                   # launch.graph_cost.Traced
    packed: bool = False                 # packed-domain program
    sharded: bool = False                # partitioned serve program
    serving: bool = True                 # deployed-path program
    # no-unpacked-table: the (M, N_f, E) extents that must not exist
    unpacked_table_shapes: frozenset = frozenset()
    # smem-budget: the WNN launches' geometries, and the build's ptxas
    # report ([{kernel, registers, spill_stores, ...}]) where one exists
    kernel_geometries: tuple = ()
    ptxas: tuple = ()
    # collective-budget: kind -> max node count (absent kinds: 0)
    collective_budget: Optional[dict] = None
    # sharding-coverage: thresholds (per-rank bytes) and this rank's
    # inputs (`graph_rules.InputShard`)
    big_param_bytes: Optional[float] = None
    max_intermediate_bytes: Optional[float] = None
    inputs: tuple = ()


@dataclasses.dataclass(frozen=True)
class Rule:
    name: str
    severity: str
    established: str     # the JAX package's PR whose invariant this encodes
    doc: str
    applies: Callable[[CellProgram], bool]
    check: Callable[[CellProgram], list]


RULES: dict = {}


def rule(name: str, severity: str, established: str,
         applies: Callable[[CellProgram], bool]):
    """Register a check function as a named rule."""
    if severity not in SEVERITIES:
        raise ValueError(f"severity {severity!r} not in {SEVERITIES}")

    def deco(fn):
        RULES[name] = Rule(name=name, severity=severity,
                           established=established,
                           doc=(fn.__doc__ or "").strip(),
                           applies=applies, check=fn)
        return fn
    return deco


def _f(prog: CellProgram, name: str, message: str, **detail) -> Finding:
    return Finding(rule=name, severity=RULES[name].severity,
                   cell=prog.name, message=message, detail=detail)


@rule("no-unpacked-table", "error", "PR 4",
      applies=lambda p: p.packed and p.graph is not None
      and bool(p.unpacked_table_shapes))
def check_no_unpacked_table(prog: CellProgram) -> list:
    """No value anywhere in a packed-path program has the unpacked
    (M, N_f, E) table extent. A CUDA kernel's body is opaque to the
    trace: its operator's fake output, and the smem-budget rule on its
    launch, stand for what the JAX rule sees inside `pallas_call`."""
    shapes = {tuple(s) for s in prog.unpacked_table_shapes}
    hits = graph_walk.find_values(prog.graph,
                                  lambda t: tuple(t.shape) in shapes)
    return [_f(prog, "no-unpacked-table",
               f"unpacked table value {tuple(t.shape)} ({t.dtype}) from "
               f"{graph_walk.op_name(node) or node.op} in the packed-path "
               "program", shape=list(t.shape), dtype=str(t.dtype),
               node=node.name)
            for node, t in hits]


@rule("no-f64", "error", "PR 1",
      applies=lambda p: p.graph is not None)
def check_no_f64(prog: CellProgram) -> list:
    """No float64/complex128 value in the traced program: doubled-width
    arithmetic is never intended here (serve math is int32/bf16/float32)
    and doubles every byte the roofline charges."""
    return [_f(prog, "no-f64",
               f"64-bit value {tuple(t.shape)} {t.dtype} from "
               f"{graph_walk.op_name(node) or node.op} in the traced "
               "program", shape=list(t.shape), dtype=str(t.dtype),
               node=node.name)
            for node, t in graph_rules.f64_values(prog.graph)]


@rule("collective-budget", "error", "PR 5",
      applies=lambda p: p.sharded and p.graph is not None
      and p.collective_budget is not None)
def check_collective_budget(prog: CellProgram) -> list:
    """The sharded serve program's only cross-rank traffic is its one
    collective: `c10d` nodes by kind within the cell's budget (one score
    gather for class sharding, one sum for tenant sharding) and none of
    any other kind. The tables never move."""
    from repro_torch.launch import graph_cost
    budget = prog.collective_budget
    colls = graph_cost.collectives(prog.graph)
    counts = graph_rules.collective_counts(prog.graph)
    out = []
    for kind, count in sorted(counts.items()):
        allowed = budget.get(kind, 0)
        if count > allowed:
            of_kind = [c for c in colls if c.kind == kind]
            out.append(_f(
                prog, "collective-budget",
                f"{count} {kind} node(s), budget {allowed}",
                kind=kind, count=count, allowed=allowed,
                operand_bytes=[c.operand_bytes for c in of_kind],
                output_bytes=[c.output_bytes for c in of_kind]))
    return out


@rule("no-host-callback", "error", "PR 2",
      applies=lambda p: p.serving and p.traced is not None)
def check_no_host_callback(prog: CellProgram) -> list:
    """A serving step never waits on the host mid-program: no read of a
    device value on the host (`.item()`, `int()`/`bool()`/`float()` of a
    tensor, `aten::_local_scalar_dense`), no operator whose output shape
    depends on the data, and on the card no copy to the CPU. Each is a
    sync that serialises the batch behind the host."""
    out = [_f(prog, "no-host-callback",
              f"host read {r.op} at {r.where}"
              if r.kind == "host_read" else
              f"data-dependent output shape ({r.op}) at {r.where}",
              op=r.op, where=r.where, kind=r.kind)
           for r in prog.traced.host_reads]
    if prog.graph is not None and prog.traced.device.type != "cpu":
        for node in graph_rules.cpu_copies(prog.graph):
            out.append(_f(prog, "no-host-callback",
                          f"copy to the CPU ({graph_walk.op_name(node)}, "
                          f"node {node.name}) in the card's program",
                          op=graph_walk.op_name(node), node=node.name,
                          kind="cpu_copy"))
    return out


@rule("smem-budget", "error", "PR 4",
      applies=lambda p: bool(p.kernel_geometries))
def check_smem_budget(prog: CellProgram) -> list:
    """Every WNN kernel launch the cell makes fits the card: its dynamic
    shared memory a block (`wnn_ensemble.shared_bytes` at the launch's
    columns, classes and route, evaluated without a card) within the
    227 KB a block may opt in to, and, where the build's ptxas report is
    at hand, no register spills in the instantiation it runs. The
    counterpart of the JAX package's `vmem-budget`."""
    out = []
    report = {e.get("kernel"): e for e in prog.ptxas}
    for g in prog.kernel_geometries:
        need = g.shared_bytes()
        if need > SMEM_LIMIT_BYTES:
            out.append(_f(
                prog, "smem-budget",
                f"WNN launch {g.label or ''} ({g.route}, {g.columns} "
                f"columns, M={g.m}) needs {need} B of shared memory a "
                f"block > {SMEM_LIMIT_BYTES} B",
                label=g.label, columns=g.columns, m=g.m, route=g.route,
                shared_bytes=need, limit_bytes=SMEM_LIMIT_BYTES))
        entry = report.get(g.instantiation())
        if entry and entry.get("spill_stores", 0):
            out.append(_f(
                prog, "smem-budget",
                f"{g.instantiation()} spills {entry['spill_stores']} B "
                f"({entry.get('registers')} registers)",
                label=g.label, kernel=g.instantiation(),
                registers=entry.get("registers"),
                spill_stores=entry["spill_stores"]))
    return out


@rule("sharding-coverage", "error", "PR 5",
      applies=lambda p: p.sharded and p.graph is not None
      and p.big_param_bytes is not None)
def check_sharding_coverage(prog: CellProgram) -> list:
    """Every input of a rank above the cell's byte threshold is a shard:
    partitioned (not replicated), at most global/degree bytes. Inside
    the program a per-rank size ceiling stands in for coverage: an
    intermediate whose sharding was lost materialises at global size and
    trips it."""
    out = []
    for inp in prog.inputs:
        if inp.bytes < prog.big_param_bytes:
            continue
        if inp.replicated or inp.bytes > inp.global_bytes // inp.degree:
            what = ("replicated" if inp.replicated else
                    f"{inp.bytes} B, above its share "
                    f"{inp.global_bytes // inp.degree} B of "
                    f"{inp.global_bytes} B over {inp.degree}")
            out.append(_f(
                prog, "sharding-coverage",
                f"input {inp.path} ({inp.bytes / 2**20:.2f} MiB a rank) is "
                f"{what}, above the {prog.big_param_bytes / 2**20:.2f} MiB "
                "threshold", param=inp.path, bytes=inp.bytes,
                global_bytes=inp.global_bytes, degree=inp.degree))
    if prog.max_intermediate_bytes is not None:
        for node, b in graph_rules.oversized_values(
                prog.graph, prog.max_intermediate_bytes):
            out.append(_f(
                prog, "sharding-coverage",
                f"intermediate {node.name} ({graph_walk.op_name(node)}) "
                f"materialises {b / 2**20:.2f} MiB a rank, above the "
                f"{prog.max_intermediate_bytes / 2**20:.2f} MiB ceiling — "
                "sharding lost upstream",
                instruction=node.name, op=graph_walk.op_name(node), bytes=b))
    return out


# ---------------------------------------------------------------------------
# Evaluation and report
# ---------------------------------------------------------------------------

def analyze_program(prog: CellProgram, rules=None) -> list:
    """Evaluate every applicable rule; findings sorted error-first."""
    todo = [RULES[r] for r in rules] if rules is not None \
        else list(RULES.values())
    findings = []
    for r in todo:
        if r.applies(prog):
            findings.extend(r.check(prog))
    order = {s: i for i, s in enumerate(SEVERITIES)}
    findings.sort(key=lambda f: (order[f.severity], f.rule))
    return findings


def count(findings, severity: str) -> int:
    return sum(1 for f in findings if f.severity == severity)


def summarize(findings) -> dict:
    return {"errors": count(findings, "error"),
            "warnings": count(findings, "warning"),
            "findings": [f.to_json() for f in findings]}


def report_json(cell_summaries: dict) -> dict:
    """{cell tag -> summarize(findings)} -> the ANALYSIS.json document."""
    cells = dict(sorted(cell_summaries.items()))
    return {
        "schema": SCHEMA,
        "rules": {r.name: {"severity": r.severity,
                           "established": r.established,
                           "doc": r.doc.splitlines()[0] if r.doc else ""}
                  for r in RULES.values()},
        "errors": sum(c["errors"] for c in cells.values()),
        "warnings": sum(c["warnings"] for c in cells.values()),
        "cells": cells,
    }


def render_findings(per_cell: dict, *, verbose: bool = False) -> str:
    """Human-readable lint output (the CLI and `dryrun --analyze` print)."""
    lines = []
    for tag, findings in sorted(per_cell.items()):
        errs, warns = count(findings, "error"), count(findings, "warning")
        status = "FAIL" if errs else "ok"
        lines.append(f"[wnnlint] {tag}: {status} "
                     f"({errs} error(s), {warns} warning(s))")
        for f in findings:
            if f.severity != "info" or verbose:
                lines.append(f"  {f.severity.upper()} {f.rule}: {f.message}")
    return "\n".join(lines)
