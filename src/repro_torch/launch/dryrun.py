"""Dry run of the ULEEN cells on the production meshes (the ULEEN half of
`repro/launch/dryrun.py`).

For each cell the JAX package lowers and compiles the step on 256 or 512
placeholder devices and reads the compiled module. The port traces
instead: this process becomes rank 0 of a fake world of 256 (16 x 16
`data` x `model`) or 512 (2 x 16 x 16 `pod` x `data` x `model`) ranks
(`launch.mesh.fake_world`), builds that rank's inputs at its shard's
shapes as fake tensors, and traces its step (`launch.graph_cost.trace`):
the card's program by default — fake `cuda:0` tensors, the kernels as
their operators, the collectives as `c10d` nodes — or the CPU's with
`--device cpu`. From the trace: memory (args, output, temp, alias, peak
a rank), the roofline's three terms and, with `--analyze`, the
`wnnlint` rules (`repro_torch.analysis`). Nothing is allocated on any
device and no kernel is built. One JSON record a cell goes to `--out`;
`python -m repro_torch.launch.report` renders them and
`scripts/diff_dryrun.py` diffs two sweeps.

    python -m repro_torch.launch.dryrun --arch uleen --mesh both --analyze \\
        --out build/dryrun

`train_host_exec` is the one cell that runs: its compressed distributed
step is traced on a fake (pod 2, data 4) mesh, then the parity probe
(2 steps against the single-device blocked reference) and 3 compressed
`train.train_uleen` steps run on 8 real gloo ranks, on the card (or the
CPU with `--device cpu`); the cell is ok only with parity 0.0 and
finite losses.

A torch built without CUDA cannot run autograd on fake CUDA tensors, so
there the two training cells trace the CPU program and their records say
so (`traced_device`, `note`). `--rank-run` runs rank 0's program of each
chosen cell for real on the card at its single-pod shard shapes (the
fake group makes the collectives no-ops), for the card's check of the
records' memory and kernel launches (`chip_smoke.py`).

The LM cells (the JAX `lower_cell`) of every family of the zoo
(`PLACED_ARCHS`: the dense Llama 3.2 3B, Qwen 2.5 14B, Minitron 8B and
Qwen 1.5 32B, the MoE Mixtral 8x7B and DeepSeek-V2-Lite, the SSM Mamba 2
2.7B, the hybrid RecurrentGemma 2B, the encoder-decoder Whisper tiny and
the patch model InternVL2 26B) trace the same way, placed on DTensor
(`dist.sharding`, `dist.placed`, the MoE block in `models/moe.py`, the
SSD and RG-LRU mixers' `placed_mixer`):
`trace_lm_cell` makes this rank's shards of the step's arguments as fake
tensors (`launch/specs.py`: parameters, AdamW state, inputs, the decode
state after a `seq_len` prefill), wraps them as DTensors inside the step
and traces train (AdamW(1e-4), `microbatches_for`, float32 masters),
prefill (bf16, the cache pinned to `cache_entries`) or decode (bf16, on
the token alone, as JAX's `lower_cell` lowers it).
Records keep JAX's keys, with `trace_s`, `traced_device`, `layers`
(and `encoder_layers` for Whisper, whose encoder a cut keeps whole) and
`args_bytes_by_kind`; `--layers N` cuts the decoder's depth (to whole
repeats of the block pattern). `--rank-run --arch A` runs rank 0's
program of A's single-pod cells for real on the card.
`launch/sweep.py` runs one process a cell.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys
import time
import traceback

import torch

from repro_torch.configs.base import ARCH_IDS
from repro_torch.dist import sharding as sh
from repro_torch.obs import registry as obs_registry
from repro_torch.obs import torchhooks as obs_torchhooks

ULEEN_SHAPES = ("train_mnist_scale", "train_host_exec", "infer_mnist_scale",
                "infer_packed_scale", "infer_sharded_scale",
                "infer_multitenant_scale")
RANK = 0            # the rank whose program a cell traces
# the archs whose placement the port has: every arch of the zoo (the
# dense GQA family; the MoE family: Mixtral's tensor-parallel experts and
# banded window, DeepSeek-V2-Lite's expert-parallel experts and MLA; the
# SSM and hybrid families: Mamba 2's SSD mixer by heads, RecurrentGemma's
# RG-LRU by channels and its local MQA by query rows; Whisper's encoder
# whole over `model`, its cross attention over gathered keys and values;
# InternVL2's patch rows ahead of the prompt)
PLACED_ARCHS = ("llama3p2_3b", "qwen2p5_14b", "minitron_8b", "qwen1p5_32b",
                "mixtral_8x7b", "deepseek_v2_lite_16b", "mamba2_2p7b",
                "recurrentgemma_2b", "whisper_tiny", "internvl2_26b")
EXEC_STEPS, PARITY_STEPS = 3, 2
RANK_TIMEOUT_S = 900
_EXEC_RUNS: dict = {}     # rank device -> (first tag, the ranks' results)


def _arch_tag(shape: str) -> str:
    return {"infer_multitenant_scale": "uleen_uln_s_fleet",
            "infer_sharded_scale": "uleen_uln_xl_ens",
            "infer_packed_scale": "uleen_uln_xl"}.get(shape, "uleen_uln_l")


def _mesh_name(mesh) -> str:
    return "x".join(str(d) for d in tuple(mesh.shape))


def _write(out_dir, tag: str, record: dict) -> None:
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, tag + ".json"), "w") as f:
            json.dump(record, f, indent=1)


def analyze_traced(record: dict, prog) -> None:
    """Run the wnnlint rules over one cell's program and fold the findings
    into its record (`record["analysis"]`, the per-cell shape of
    ANALYSIS.json). Error-severity findings flip `ok` to False."""
    from repro_torch.analysis import registry
    findings = registry.analyze_program(prog)
    record["analysis"] = registry.summarize(findings)
    print(registry.render_findings({prog.name: findings}))
    if record["analysis"]["errors"]:
        record["ok"] = False
        lint = (f"wnnlint: {record['analysis']['errors']} error-severity "
                "finding(s)")
        record["error"] = "; ".join(e for e in (record.get("error"), lint)
                                    if e)


def _ptxas() -> tuple:
    """The WNN kernel's ptxas report where this checkout built it."""
    from repro_torch.kernels import build, wnn_ensemble
    return tuple(build.ptxas_report(build.build_log("wnn.cu"),
                                    wnn_ensemble.instantiation_name))


def _trace_record(shape: str, mesh, traced, roof, *, backend, resolved,
                  trace_s: float, device) -> dict:
    from repro_torch.launch import graph_cost
    infer = not shape.startswith("train")
    ops = {k: v for k, v in traced.op_counts().items()
           if k.startswith("repro_torch::")}
    return {
        "arch": _arch_tag(shape).replace("_", "-"), "shape": shape,
        "kind": "infer" if infer else "train",
        "backend": backend if infer else None,
        "backend_resolved": resolved if infer else None,
        "kernel_mode": ("cuda" if ops else "plain") if infer else None,
        "mesh": _mesh_name(mesh), "chips": math.prod(tuple(mesh.shape)),
        "ok": traced.error is None,
        "lower_s": 0.0, "compile_s": round(trace_s, 2),
        "memory": graph_cost.memory_gib(traced.memory),
        "roofline": roof.summary(),
        "rank": RANK, "device": str(torch.device(device)),
        "traced_device": str(traced.device),
        "op_nodes": ops,
        "host_reads": [r.to_json() for r in traced.host_reads],
    }


def _words_bytes(spec, m: int) -> int:
    from repro_torch.packed.layout import word_count
    return sum(m * spec.num_filters(sm) * word_count(sm.entries) * 4
               for sm in spec.submodels)


def _sharding(record: dict, spec, mesh, args_bytes: int) -> None:
    """JAX's `sharding` fields of the class-sharded cell and its two
    checks, on the measured argument bytes of the rank."""
    from repro_torch.launch import uleen_cell
    entry, degree = sh.class_partition(mesh, spec.num_classes,
                                       sh.SERVE_RULES)
    rep_bytes = _words_bytes(spec, spec.num_classes)
    model_axis = sh.spec_degree(mesh, "model")
    batch_entry = sh.SERVE_RULES.resolve(
        ("batch",), mesh, shape=(uleen_cell.INFER_BATCH,))[0]
    bits_bytes = (uleen_cell.INFER_BATCH
                  // sh.spec_degree(mesh, batch_entry) * spec.total_bits)
    record["sharding"] = {
        "classes": spec.num_classes,
        "class_axis": entry if entry is None or isinstance(entry, str)
        else list(entry),
        "class_shards": degree, "model_axis": model_axis,
        "table_bytes_replicated": rep_bytes,
        "table_bytes_per_device": rep_bytes // degree,
        "args_bytes_per_device_measured": args_bytes,
        "args_bytes_bound": rep_bytes // model_axis + bits_bytes + (4 << 20),
    }
    assert record["sharding"]["table_bytes_per_device"] \
        <= rep_bytes // model_axis, (
            "class sharding fell back to replication on the production "
            "mesh — the sharded-scale cell must partition")
    assert args_bytes <= rep_bytes // model_axis + bits_bytes + (4 << 20), (
        f"measured args {args_bytes} B/device exceed sharded tables "
        f"({rep_bytes // model_axis} B) + batch shard ({bits_bytes} B): the "
        "rank holds more than its share of the tables")


def _tenancy(record: dict, spec, mesh, args_bytes: int) -> None:
    """JAX's `tenancy` fields of the fleet cell and its two checks."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.launch import uleen_cell
    tenants = uleen_cell.MULTITENANT_TENANTS
    entry, degree = sh.tenant_partition(mesh, tenants, sh.SERVE_RULES)
    with FakeTensorMode():
        st = uleen_cell.stacked_table_specs(spec, tenants, device="cpu")
        fleet_bytes, table_bytes = st.nbytes(), st.table_bytes()
    batch_entry = sh.SERVE_RULES.resolve(
        ("batch",), mesh, shape=(uleen_cell.INFER_BATCH,))[0]
    b_loc = uleen_cell.INFER_BATCH // sh.spec_degree(mesh, batch_entry)
    bits_bytes = b_loc * spec.total_bits + b_loc * 4
    record["tenancy"] = {
        "tenants": tenants,
        "tenant_axis": entry if entry is None or isinstance(entry, str)
        else list(entry),
        "tenant_shards": degree, "tenants_per_device": tenants // degree,
        "words_bytes_per_tenant": table_bytes // tenants,
        "fleet_bytes_global": fleet_bytes,
        "fleet_bytes_per_device": fleet_bytes // degree,
        "args_bytes_per_device_measured": args_bytes,
        "args_bytes_bound": fleet_bytes // degree + bits_bytes + (4 << 20),
    }
    assert degree > 1, ("tenant sharding fell back to replication on the "
                        "production mesh — the multitenant-scale cell must "
                        "partition the fleet")
    assert args_bytes <= fleet_bytes // degree + bits_bytes + (4 << 20), (
        f"measured args {args_bytes} B/device exceed fleet shard "
        f"({fleet_bytes // degree} B) + batch shard ({bits_bytes} B): the "
        "rank holds more than its share of the fleet")


def run_uleen_cell(multi_pod: bool, out_dir, *,
                   shape: str = "train_mnist_scale", backend: str = "auto",
                   analyze: bool = False, device="cuda") -> dict:
    """One ULEEN cell traced as rank 0 of the production mesh (the JAX
    `run_uleen_cell`'s cells, records, tags and checks)."""
    from repro_torch.analysis import cells as lint_cells
    from repro_torch.kernels import ops
    from repro_torch.launch import graph_cost, uleen_cell
    from repro_torch.launch import mesh as mesh_mod
    if shape not in ULEEN_SHAPES:
        raise ValueError(f"uleen cells trace only {ULEEN_SHAPES}, "
                         f"got {shape!r}")
    if shape == "train_host_exec":
        return run_uleen_exec_cell(multi_pod, out_dir, analyze=analyze,
                                   device=device)
    spec, kind = lint_cells.ULEEN_CELLS[shape]
    infer = kind == "infer"
    tag = f"{_arch_tag(shape)}.{shape}.{'pod2' if multi_pod else 'pod1'}"
    if infer:
        tag += f".{backend}"
    trace_dev = device
    note = None
    if not infer and not uleen_cell.autograd_traceable(device):
        trace_dev = "cpu"
        note = ("traced as the CPU program: this torch has no CUDA build, "
                "and autograd over fake CUDA tensors needs one")
    resolved = ops.resolve_wnn_backend(
        backend, packed_tables=shape in ("infer_packed_scale",
                                         "infer_sharded_scale",
                                         "infer_multitenant_scale"),
        device=torch.device(trace_dev).type) if infer else None
    world = 512 if multi_pod else 256
    rec = obs_registry.get_recorder()
    batch = uleen_cell.INFER_BATCH if infer else uleen_cell.GLOBAL_BATCH
    try:
        with mesh_mod.fake_world(world, RANK):
            mesh = mesh_mod.make_production_mesh(
                multi_pod, RANK, device_type=torch.device(trace_dev).type)
            with rec.span("dryrun.trace", cell=tag) as sp:
                traced, args = lint_cells.trace_cell(
                    shape, mesh, backend=backend, device=trace_dev)
            rec.counter("dryrun.traces").inc()
            mflops = float(graph_cost.wnn_model_ops(spec) * batch)
            roof = graph_cost.roofline(traced.graph, world, mflops)
            record = _trace_record(shape, mesh, traced, roof,
                                   backend=backend, resolved=resolved,
                                   trace_s=sp.dur_s, device=device)
            if note:
                record["note"] = note
            if traced.error:
                record["error"] = f"trace: {traced.error}"
            prog = (lint_cells.uleen_cell_program(
                shape, mesh, backend=backend, traced=traced, args=args,
                device=trace_dev, ptxas=_ptxas()) if analyze else None)
            try:
                if shape == "infer_multitenant_scale":
                    _tenancy(record, spec, mesh, traced.memory["args"])
                if shape == "infer_sharded_scale":
                    _sharding(record, spec, mesh, traced.memory["args"])
            except AssertionError as e:
                record["ok"] = False
                record["error"] = f"AssertionError: {e}"
            if prog is not None:
                analyze_traced(record, prog)
        roofs = record["roofline"]
        note_s = ""
        if "sharding" in record:
            s = record["sharding"]
            note_s = (f" tables/device={s['table_bytes_per_device'] / 2**20:.2f}"
                      f" MiB (replicated "
                      f"{s['table_bytes_replicated'] / 2**20:.2f} MiB, "
                      f"{s['class_shards']} class shards; args "
                      f"{s['args_bytes_per_device_measured']} B, bound "
                      f"{s['args_bytes_bound']} B)")
        if "tenancy" in record:
            t = record["tenancy"]
            note_s = (f" fleet={t['tenants']} tenants, "
                      f"{t['fleet_bytes_per_device'] / 2**20:.2f} MiB/device"
                      f" ({t['tenant_shards']} tenant shards, "
                      f"{t['tenants_per_device']} tenants each)")
        print(f"[dryrun] {tag}: {'OK' if record['ok'] else 'FAIL'} "
              f"trace={record['compile_s']}s "
              f"peak={record['memory']['peak_gib']:.4f} GiB/rank "
              f"terms(c/m/coll)={roofs['compute_s']:.3e}/"
              f"{roofs['memory_s']:.3e}/{roofs['collective_s']:.3e} "
              f"dominant={roofs['dominant']}{note_s}"
              + (f" error={record['error']}" if not record["ok"] else ""))
    except Exception as e:
        record = {"arch": _arch_tag(shape).replace("_", "-"), "shape": shape,
                  "kind": kind, "backend": backend if infer else None,
                  "backend_resolved": resolved,
                  "kernel_mode": None, "device": str(torch.device(device)),
                  "mesh": "pod2" if multi_pod else "pod1", "ok": False,
                  "error": f"{type(e).__name__}: {e}",
                  "traceback": traceback.format_exc()[-4000:]}
        print(f"[dryrun] {tag}: FAIL {record['error'][:300]}")
    _write(out_dir, tag, record)
    return record


def exec_rank(rank: int, world: int, plan: dict) -> dict:
    """One rank of the executed cell (run by `spawn_ranks`): the parity
    probe, then the compressed steps, on the (pod 2, data 4) mesh."""
    from repro_torch.launch import train as train_mod
    from repro_torch.launch.mesh import make_mesh, rank_device
    torch.set_num_threads(max(1, torch.get_num_threads() // world))
    dev = rank_device(plan["device"])
    mesh = make_mesh((2, 4), ("pod", "data"))
    parity = train_mod.uleen_parity_probe(mesh, steps=PARITY_STEPS,
                                          device=dev)
    problem = train_mod.uleen_smoke_problem(0, n_train=1024, device=dev)
    t0 = time.perf_counter()
    out = train_mod.train_uleen(*problem, steps_total=EXEC_STEPS,
                                global_batch=256, mesh=mesh, compress=True,
                                verbose=False, device=dev)
    return {"rank": rank, "parity": float(parity),
            "losses": [float(h["loss"]) for h in out["history"]],
            "exec_s": time.perf_counter() - t0}


def run_uleen_exec_cell(multi_pod: bool, out_dir, *, analyze: bool = False,
                        device="cuda") -> dict:
    """train_host_exec: the one cell that runs (JAX `run_uleen_exec_cell`).
    Traces the compressed distributed step as rank 0 of a fake (pod 2,
    data 4) world, then runs the parity probe and the compressed steps on
    8 real gloo ranks (`spawn_ranks`). Non-finite losses or any parity
    bit flips the record to ok: false."""
    from repro_torch.analysis import cells as lint_cells
    from repro_torch.launch import graph_cost, uleen_cell
    from repro_torch.launch import mesh as mesh_mod
    spec = uleen_cell.ULEEN_EXEC_SPEC
    tag = f"uleen_exec.train_host_exec.{'pod2' if multi_pod else 'pod1'}"
    rec = obs_registry.get_recorder()
    trace_dev = device if uleen_cell.autograd_traceable(device) else "cpu"
    try:
        with mesh_mod.fake_world(8, RANK):
            from torch.distributed.device_mesh import init_device_mesh
            mesh = init_device_mesh(torch.device(trace_dev).type, (2, 4),
                                    mesh_dim_names=("pod", "data"))
            with rec.span("dryrun.trace", cell=tag) as sp:
                traced, args = lint_cells.trace_cell(
                    "train_host_exec", mesh, device=trace_dev)
            rec.counter("dryrun.traces").inc()
            # paper-style WNN op count, x3 for the STE backward's
            # gather/scatter pair
            mflops = float(graph_cost.wnn_model_ops(spec) * 3
                           * uleen_cell.EXEC_BATCH)
            roof = graph_cost.roofline(traced.graph, 8, mflops)
            prog = (lint_cells.uleen_cell_program(
                "train_host_exec", mesh, traced=traced, args=args,
                device=trace_dev) if analyze else None)
            findings_rec = {}
            if prog is not None:
                analyze_traced(findings_rec, prog)
        # the ranks run on the card, or on the CPU where asked or where
        # no card is present (the trace above is the card's program all
        # the same)
        run_dev = device if torch.device(device).type == "cpu" \
            or torch.cuda.is_available() else "cpu"
        backend = mesh_mod.collective_backend(run_dev, 8)
        key = str(torch.device(run_dev))
        with rec.span("dryrun.exec", cell=tag) as sp_exec:
            if key not in _EXEC_RUNS:   # one run serves both meshes' tags
                _EXEC_RUNS[key] = (tag, mesh_mod.spawn_ranks(
                    exec_rank, 8, {"device": run_dev}, backend=backend,
                    timeout_s=RANK_TIMEOUT_S))
        ran_as, outs = _EXEC_RUNS[key]
        parity = max(o["parity"] for o in outs)
        losses = outs[0]["losses"]
        finite = all(math.isfinite(v) for o in outs for v in o["losses"])
        record = {
            "arch": "uleen-exec", "shape": "train_host_exec",
            "kind": "train", "backend": None, "mesh": "2x4", "chips": 8,
            "ok": bool(finite and parity == 0.0 and traced.error is None),
            "lower_s": 0.0, "compile_s": round(sp.dur_s, 2),
            "memory": graph_cost.memory_gib(traced.memory),
            "roofline": roof.summary(),
            "exec": {"steps": len(losses), "compressed": True,
                     "losses": [round(v, 6) for v in losses],
                     "exec_s": round(sp_exec.dur_s, 2),
                     "parity_max_diff": parity,
                     "parity_steps": PARITY_STEPS,
                     "ranks": 8, "rank_device": key,
                     "collective_backend": backend,
                     "rank_exec_s": max(o["exec_s"] for o in outs),
                     **({"reused_from": ran_as} if ran_as != tag else {})},
            "rank": RANK, "device": str(torch.device(device)),
            "traced_device": str(traced.device),
            "op_nodes": {k: v for k, v in traced.op_counts().items()
                         if k.startswith("repro_torch::")},
            "host_reads": [r.to_json() for r in traced.host_reads],
        }
        if trace_dev != device:
            record["note"] = ("traced as the CPU program: this torch has no "
                              "CUDA build, and autograd over fake CUDA "
                              "tensors needs one")
        if not record["ok"]:
            record["error"] = (f"executed-cell gate: parity={parity} "
                               f"finite={finite} trace={traced.error}")
        if prog is not None:
            record["analysis"] = findings_rec["analysis"]
            if findings_rec.get("error"):
                record["ok"] = False
                record["error"] = findings_rec["error"]
        print(f"[dryrun] {tag}: {'OK' if record['ok'] else 'FAIL'} "
              f"trace={record['compile_s']}s exec={sp_exec.dur_s:.2f}s "
              f"losses={losses[0]:.4f}->{losses[-1]:.4f} "
              f"parity_max_diff={parity}")
    except Exception as e:
        record = {"arch": "uleen-exec", "shape": "train_host_exec",
                  "kind": "train", "backend": None,
                  "mesh": "pod2" if multi_pod else "pod1", "ok": False,
                  "error": f"{type(e).__name__}: {e}",
                  "traceback": traceback.format_exc()[-4000:]}
        print(f"[dryrun] {tag}: FAIL {record['error'][:300]}")
    _write(out_dir, tag, record)
    return record


# ---------------------------------------------------------------------------
# The LM cells (JAX `lower_cell`): the dense and MoE families, placed on
# DTensor
# ---------------------------------------------------------------------------

def _pair_leaves(obj, ent) -> list:
    """(tensor, entries) of every tensor of `obj`, in `graph_cost.flatten`
    order, with `ent` a tree of the same structure whose leaves are
    resolved entries (tuples)."""
    if isinstance(obj, torch.Tensor):
        return [(obj, ent)]
    if isinstance(obj, dict):
        return [x for k, v in obj.items() for x in _pair_leaves(v, ent[k])]
    if isinstance(obj, (list, tuple)):
        return [x for v, e in zip(obj, ent, strict=True)
                for x in _pair_leaves(v, e)]
    return []


class _Placed:
    """One argument of a placed step: this rank's local shards (the
    traced or run arguments) and, per tensor, its global shape and
    entries, to wrap the shards as DTensors inside the step. `spec` is
    the argument with meta (or fake) tensors of the global shapes;
    `make(shape, dtype, path)` makes each local shard."""

    def __init__(self, spec, entries_obj, mesh, make, name: str):
        from repro_torch.launch import graph_cost
        pairs = _pair_leaves(spec, entries_obj)
        paths = [p for p, _ in graph_cost.flatten(spec, name)]
        self.meta = [(tuple(t.shape), e) for t, e in pairs]
        self.local = graph_cost.rebuild(spec, iter(
            make(sh.local_shape(t.shape, e, mesh), t.dtype, path)
            for (t, e), path in zip(pairs, paths, strict=True)))
        self.mesh = mesh

    def wrap(self, local_obj, rows=None):
        """The same object with each local shard wrapped as a DTensor;
        with `rows`, each shard's first `rows` rows (dim 0, sharded or
        not), the global shape cut to match."""
        from repro_torch.dist import placed
        from repro_torch.launch import graph_cost
        leaves = [t for _, t in graph_cost.flatten(local_obj)]

        def one(t, shape, e):
            if rows is not None:
                shape = (shape[0] // t.shape[0] * rows, *shape[1:])
                t = t[:rows]
            return placed.wrap(t, self.mesh, sh.placements(e, self.mesh),
                               shape)
        return graph_cost.rebuild(local_obj, iter(
            one(t, shape, e)
            for t, (shape, e) in zip(leaves, self.meta, strict=True)))


def _unplace(obj):
    """`obj` with every DTensor replaced by its local shard."""
    from repro_torch.launch import graph_cost
    return graph_cost.rebuild(obj, iter(
        t.to_local() if hasattr(t, "to_local") else t
        for _, t in graph_cost.flatten(obj)))


LM_DTYPES = {"train": torch.float32, "prefill": torch.bfloat16,
             "decode": torch.bfloat16}
# microbatches a training cell's memory pass runs (`memory_step`)
MEMORY_MICROBATCHES = 2


def lm_cell_args(cfg, shape, mesh, make):
    """(step, placed arguments, kinds) of one LM cell as this rank of
    `mesh` runs it: the JAX `lower_cell`'s step and arguments, each a
    `_Placed` whose local shards `make(shape, dtype, path)` makes (fake
    tensors for a trace, seeded ones for a run). kinds names each
    argument's part of the memory (params, opt, inputs, state).

    A training step of more than MEMORY_MICROBATCHES microbatches also
    carries `step.memory_step`: the same step on its first
    MEMORY_MICROBATCHES microbatches' rows (views of the batch), for the
    trace's memory pass. Its memory is the whole step's: the gradient
    accumulators exist before the first microbatch, and each microbatch
    then allocates and frees the same tensors in the same order (its
    slice of the batch is a view), so the live bytes after the second
    repeat those of the second at every later one; the optimizer's
    update after the loop does not depend on the count."""
    from repro_torch.launch import specs, steps
    from repro_torch.models import transformer
    from repro_torch.train import optimizer as opt_lib
    train = shape.kind == "train"
    rules = sh.TRAIN_RULES if train else sh.SERVE_RULES
    dtype = LM_DTYPES[shape.kind]
    pmeta = specs.param_specs(cfg, dtype)
    params = _Placed(pmeta, specs.param_shardings(cfg, mesh, rules, dtype),
                     mesh, make, "params")
    inputs = specs.input_specs(cfg, shape)
    entries = specs.input_shardings(cfg, shape, mesh, rules)
    if shape.kind == "decode":
        # JAX's `lower_cell` lowers a decode on the token alone (its
        # `input_specs` lists Whisper's frames there too)
        inputs, entries = {"token": inputs["token"]}, {
            "token": entries["token"]}
    batch = _Placed(inputs, entries, mesh, make, "inputs")
    if train:
        optimizer = opt_lib.adamw(1e-4)
        opt = _Placed(optimizer.init(specs.tree_leaves(pmeta)),
                      specs.opt_shardings(cfg, optimizer, mesh, rules),
                      mesh, make, "opt")
        m = specs.microbatches_for(cfg, shape, mesh)

        def train_run(step, rows=None):
            def run(p, o, b):
                pt = transformer.ParamTree(params.wrap(p))
                new, ostate, metrics = step(pt, opt.wrap(o),
                                            batch.wrap(b, rows))
                return _unplace((dict(new.named_parameters()), ostate,
                                 metrics))
            return run
        run = train_run(steps.make_train_step(cfg, optimizer,
                                              microbatches=m))
        if m > MEMORY_MICROBATCHES:
            # a closure of its own (not one over `run`: a cycle through
            # `run` would keep the arguments alive past the caller's step)
            local_rows = next(iter(batch.local.values())).shape[0]
            run.memory_step = train_run(
                steps.make_train_step(cfg, optimizer,
                                      microbatches=MEMORY_MICROBATCHES),
                rows=local_rows // m * MEMORY_MICROBATCHES)
        return run, (params, opt, batch), ("params", "opt", "inputs")
    if shape.kind == "prefill":
        step = steps.make_prefill_step(cfg, max_len=shape.seq_len)

        def run(p, b):
            return _unplace(step(transformer.ParamTree(params.wrap(p)),
                                 batch.wrap(b)))
        return run, (params, batch), ("params", "inputs")
    gstate = steps.serve_state_spec(cfg, shape.global_batch, shape.seq_len,
                                    pmeta, device="cpu")
    state = _Placed(gstate, specs.cache_entries(cfg, gstate, mesh, rules),
                    mesh, make, "state")
    step = steps.make_decode_step(cfg)

    def run(p, b, st):
        # the state's DTensors made as inference tensors, as a prefill
        # under inference mode leaves them: a view of a normal DTensor
        # cannot share its version counter inside inference mode
        with torch.inference_mode():
            return _unplace(step(transformer.ParamTree(params.wrap(p)),
                                 batch.wrap(b)["token"], state.wrap(st)))
    return run, (params, batch, state), ("params", "inputs", "state")


def trace_lm_cell(cfg, shape, mesh, *, device="cuda"):
    """Trace rank 0's program of one LM cell (`lm_cell_args`) on `mesh`:
    (Traced, {part: argument bytes}, the device it traced). A training
    cell traces the CPU program where this torch cannot run autograd on
    fake CUDA tensors."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.launch import graph_cost, uleen_cell
    dev = uleen_cell._trace_device(device)
    if shape.kind == "train" and not uleen_cell.autograd_traceable(dev):
        dev = torch.device("cpu")
    if dev.type == "cuda":
        graph_cost.ensure_fake_cuda_guard()
    fake = FakeTensorMode()
    with fake:
        step, placed_args, kinds = lm_cell_args(
            cfg, shape, mesh, lambda shp, dt, _: torch.empty(
                shp, dtype=dt, device=dev))
    args = tuple(a.local for a in placed_args)
    by_kind = {k: sum(t.numel() * t.element_size()
                      for _, t in graph_cost.flatten(a))
               for k, a in zip(kinds, args)}
    rules = sh.TRAIN_RULES if shape.kind == "train" else sh.SERVE_RULES

    def fn(*a):
        with sh.use_placement(mesh, rules):
            return step(*a)
    memory_step = getattr(step, "memory_step", None)

    def memory_fn(*a):
        with sh.use_placement(mesh, rules):
            return memory_step(*a)
    traced = graph_cost.trace(fn, args, fake_mode=fake, device=dev,
                              memory_fn=memory_fn if memory_step else None)
    if traced.graph is not None:
        # DTensor works out each operator's global output shape on fake
        # tensors; torch 2.11's `make_fx` records those global-shaped
        # calls as nodes nothing uses, which no rank runs
        traced.graph.graph.eliminate_dead_code()
        traced.graph.recompile()
    return traced, by_kind, dev


def _lm_tag(cfg_name: str, shape_name: str, multi_pod: bool) -> str:
    return f"{cfg_name}.{shape_name}.{'pod2' if multi_pod else 'pod1'}"


def run_lm_cell(arch: str, shape_name: str, multi_pod: bool, out_dir, *,
                analyze: bool = False, device="cuda", cfg=None) -> dict:
    """One LM cell traced as rank 0 of the production mesh: JAX's record
    keys, the port's `trace_s`/`traced_device`, and `args_bytes_by_kind`.
    `cfg` replaces the arch's config (a test's cut depth)."""
    from repro_torch.analysis import cells as lint_cells
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch import graph_cost, uleen_cell
    from repro_torch.launch import mesh as mesh_mod
    cfg = cfg or get_config(arch)
    shape = SHAPES[shape_name]
    tag = _lm_tag(arch, shape_name, multi_pod)
    world = 512 if multi_pod else 256
    rec = obs_registry.get_recorder()
    trace_type = torch.device(device).type
    if shape.kind == "train" and not uleen_cell.autograd_traceable(device):
        trace_type = "cpu"
    try:
        with mesh_mod.fake_world(world, RANK):
            mesh = mesh_mod.make_production_mesh(multi_pod, RANK,
                                                 device_type=trace_type)
            with rec.span("dryrun.trace", cell=tag) as sp:
                traced, by_kind, dev = trace_lm_cell(cfg, shape, mesh,
                                                     device=device)
            rec.counter("dryrun.traces").inc()
            roof = graph_cost.roofline(traced.graph, world,
                                       graph_cost.model_flops_for(cfg, shape),
                                       mesh=mesh)
            record = {
                "arch": arch, "shape": shape_name, "kind": shape.kind,
                "mesh": _mesh_name(mesh), "chips": world,
                "ok": traced.error is None,
                "lower_s": 0.0, "compile_s": round(sp.dur_s, 2),
                "trace_s": round(sp.dur_s, 2),
                "memory": graph_cost.memory_gib(traced.memory),
                "roofline": roof.summary(),
                "layers": cfg.num_layers,
                **({"encoder_layers": cfg.encoder_layers}
                   if cfg.encoder_layers else {}),
                "args_bytes_by_kind": by_kind,
                "rank": RANK, "device": str(torch.device(device)),
                "traced_device": str(dev),
                "op_nodes": {k: v for k, v in traced.op_counts().items()
                             if k.startswith("repro_torch::")},
                "host_reads": [r.to_json() for r in traced.host_reads],
            }
            if dev.type != torch.device(device).type:
                record["note"] = ("traced as the CPU program: this torch "
                                  "has no CUDA build, and autograd over "
                                  "fake CUDA tensors needs one")
            if traced.error:
                record["error"] = f"trace: {traced.error}"
            if analyze and traced.graph is not None:
                analyze_traced(record, lint_cells.graph_cell_program(
                    tag, shape.kind, traced))
        roofs = record["roofline"]
        print(f"[dryrun] {tag}: {'OK' if record['ok'] else 'FAIL'} "
              f"trace={record['trace_s']}s "
              f"peak={record['memory']['peak_gib']:.4f} GiB/rank "
              f"args={record['memory']['args_gib']:.4f} "
              f"terms(c/m/coll)={roofs['compute_s']:.3e}/"
              f"{roofs['memory_s']:.3e}/{roofs['collective_s']:.3e} "
              f"dominant={roofs['dominant']}"
              + (f" error={record['error']}" if not record["ok"] else ""))
    except Exception as e:
        record = {"arch": arch, "shape": shape_name, "kind": shape.kind,
                  "mesh": "pod2" if multi_pod else "pod1", "ok": False,
                  "device": str(torch.device(device)),
                  "error": f"{type(e).__name__}: {e}",
                  "traceback": traceback.format_exc()[-4000:]}
        print(f"[dryrun] {tag}: FAIL {record['error'][:300]}")
    _write(out_dir, tag, record)
    return record


def run_cell(arch: str, shape_name: str, multi_pod: bool, out_dir, *,
             backend: str = "auto", analyze: bool = False,
             device="cuda") -> dict:
    if arch != "uleen":
        return run_lm_cell(arch, shape_name, multi_pod, out_dir,
                           analyze=analyze, device=device)
    return run_uleen_cell(multi_pod, out_dir, shape=shape_name,
                          backend=backend, analyze=analyze, device=device)


RANK_RUN_SHAPES = ("infer_mnist_scale", "infer_packed_scale",
                   "infer_sharded_scale", "train_mnist_scale")


def run_rank_program(shape: str, *, seed: int = 0, device="cuda",
                     multi_pod: bool = False) -> dict:
    """Run rank 0's program of `shape` for real on `device` at its shard's
    shapes, inside a fake world (its collectives move nothing): inputs
    from a seeded generator, one warm-up step, then one step with the
    allocator's peak reset after the inputs exist. Returns the measured
    peak and argument bytes and the kernel launches of the measured
    step."""
    from repro_torch import kernels
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch import uleen_cell
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.analysis import cells as lint_cells
    dev = torch.device(device)
    spec, kind = lint_cells.ULEEN_CELLS[shape]
    world = 512 if multi_pod else 256
    gen = torch.Generator(device=dev).manual_seed(seed)
    with mesh_mod.fake_world(world, RANK):
        mesh = mesh_mod.make_production_mesh(multi_pod, RANK,
                                             device_type=dev.type)
        if shape == "train_mnist_scale":
            ins, _ = uleen_cell.uleen_cell_specs(spec, mesh, device=dev,
                                                 generator=gen)
            optimizer = opt_lib.adam(1e-3)
            opt = optimizer.init(list(ins["params"].tables)
                                 + [ins["params"].bias])
            step = uleen_cell.make_uleen_train_step(spec, optimizer,
                                                    mesh=mesh)
            args = (ins["params"], opt, ins["statics"], ins["bits"],
                    ins["labels"])

            def call():
                return step(*args, uleen_cell.train_generator(
                    mesh, seed, 0, device=dev))
        else:
            specs = {"infer_mnist_scale": uleen_cell.uleen_infer_specs,
                     "infer_packed_scale":
                         uleen_cell.uleen_packed_infer_specs,
                     "infer_sharded_scale":
                         uleen_cell.uleen_sharded_infer_specs}[shape]
            ins, _ = specs(spec, mesh, device=dev, generator=gen)
            if shape == "infer_mnist_scale":
                step = uleen_cell.make_uleen_infer_step(spec, device=dev)
                args = (ins["tables"], ins["masks"], ins["bias"],
                        ins["statics"], ins["bits"])
            elif shape == "infer_packed_scale":
                step = uleen_cell.make_uleen_packed_infer_step(device=dev)
                args = (ins["ptables"], ins["bits"])
            else:
                step = uleen_cell.make_uleen_sharded_infer_step(device=dev)
                args = (ins["ptables"], ins["bits"])

            def call():
                return step(*args)
        del ins
        out = call()                       # warm-up: loads the kernels
        del out
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            args_bytes = torch.cuda.memory_allocated(dev)
        kernels.reset_launch_counts()
        out = call()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        launches = {k: v for k, v in kernels.launch_counts().items() if v}
        result = {"shape": shape, "launches": launches,
                  "mesh": _mesh_name(mesh), "rank": RANK}
        if dev.type == "cuda":
            result.update(peak_bytes=torch.cuda.max_memory_allocated(dev),
                          args_bytes=args_bytes)
        del out
    return result


def run_lm_rank_program(arch: str, shape_name: str, *, cfg=None,
                        seed: int = 0, device="cuda",
                        multi_pod: bool = False) -> dict:
    """Run rank 0's program of one LM cell for real on `device` at its
    shard's shapes, inside a fake world (its collectives move nothing):
    seeded shards (parameters and moments small normals, tokens in the
    vocabulary, the decode state's positions at its last row), one
    warm-up step, then one step with the allocator's peak reset after the
    arguments exist. Returns the measured peak and argument bytes and the
    kernel launches of the measured step. `args_bytes` (allocated when
    the step starts) exceeds `args_alloc_bytes` (what making the
    arguments allocated) by what outlives a step outside the program:
    the BLAS libraries' workspaces (this warm-up's, or an earlier cell's
    in the same process), which no traced operator allocates.
    `args_alloc_bytes` exceeds the arguments' own bytes
    (`arg_tensor_bytes`) by the allocator's slack: 512-byte rounding,
    and a large block's tail below 1 MiB, which it does not split
    off."""
    from repro_torch import kernels
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch import mesh as mesh_mod
    dev = torch.device(device)
    cfg = cfg or get_config(arch)
    shape = SHAPES[shape_name]
    rules = sh.TRAIN_RULES if shape.kind == "train" else sh.SERVE_RULES
    gen = torch.Generator(device=dev).manual_seed(seed)

    def make(shp, dtype, path):
        if dtype.is_floating_point:
            if path.startswith(("opt", "state")):
                return torch.zeros(shp, dtype=dtype, device=dev)
            return (torch.randn(shp, generator=gen, device=dev) * 0.02).to(
                dtype)
        if path.endswith("pos"):
            return torch.full(shp, shape.seq_len - 1, dtype=dtype,
                              device=dev)
        if path.startswith("inputs"):
            return torch.randint(0, cfg.vocab_size, shp, generator=gen,
                                 device=dev, dtype=dtype)
        return torch.zeros(shp, dtype=dtype, device=dev)

    world = 512 if multi_pod else 256
    with mesh_mod.fake_world(world, RANK):
        mesh = mesh_mod.make_production_mesh(multi_pod, RANK,
                                             device_type=dev.type)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            before_args = torch.cuda.memory_allocated(dev)
        step, placed_args, _ = lm_cell_args(cfg, shape, mesh, make)
        args = tuple(a.local for a in placed_args)
        del placed_args
        from repro_torch.launch import graph_cost
        arg_tensor_bytes = sum(t.numel() * t.element_size()
                               for _, t in graph_cost.flatten(args))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            args_alloc_bytes = torch.cuda.memory_allocated(dev) - before_args

        def call():
            with sh.use_placement(mesh, rules):
                return step(*args)
        out = call()                       # warm-up: loads the kernels
        del out
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            args_bytes = torch.cuda.memory_allocated(dev)
        kernels.reset_launch_counts()
        out = call()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        launches = {k: v for k, v in kernels.launch_counts().items() if v}
        # the flash launches by shape: (B, H, Hkv, Sq, Sk, D, Dv, causal,
        # window, q_offset, launches)
        shapes = [[*k, n] for k, n in
                  kernels.flash_attention.shapes.items()]
        result = {"arch": arch, "shape": shape_name, "launches": launches,
                  "flash_shapes": shapes, "layers": cfg.num_layers,
                  "mesh": _mesh_name(mesh), "rank": RANK,
                  "arg_tensor_bytes": arg_tensor_bytes}
        if dev.type == "cuda":
            result.update(peak_bytes=torch.cuda.max_memory_allocated(dev),
                          args_bytes=args_bytes,
                          args_alloc_bytes=args_alloc_bytes)
        del out
    return result


def _cut(cfg, layers):
    """`cfg` cut to its first `layers` layers (None: whole), rounded up
    to whole repeats of its block pattern (RecurrentGemma's (rec, rec,
    local): 2 gives 3, so the cut keeps a local layer). Whisper's
    encoder keeps its `encoder_layers`: a cut is the decoder's."""
    if not layers:
        return cfg
    unit = len(cfg.block_pattern) or 1
    return dataclasses.replace(
        cfg, num_layers=min(cfg.num_layers, -(-layers // unit) * unit))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    from repro_torch.configs import SHAPES, get_config, shapes_for
    ap.add_argument("--arch", choices=ARCH_IDS + ["uleen"])
    ap.add_argument("--shape", choices=list(ULEEN_SHAPES) + list(SHAPES))
    ap.add_argument("--layers", type=int, default=None,
                    help="cut an LM arch to its first N layers, whole "
                         "repeats of its block pattern (full width; an "
                         "encoder stays whole; the record says `layers`)")
    ap.add_argument("--backend", choices=["fused", "gather", "packed", "auto"],
                    default="auto",
                    help="WNN kernel backend for the uleen infer cells")
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--all", action="store_true",
                    help="every cell the port has (the ULEEN cells and "
                         "the placed LM archs' cells)")
    ap.add_argument("--analyze", action="store_true",
                    help="run the wnnlint rules (repro_torch.analysis) over "
                         "every traced cell; error findings flip the cell "
                         "to ok:false and fail the sweep")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="trace the card's program (default) or the CPU's; "
                         "the executed cell runs its ranks there")
    ap.add_argument("--out", default=None, help="JSON output dir")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="the sweep's obsmetrics/v1 METRICS.json (per-cell "
                         "dryrun.trace spans, trace counters). Default: "
                         "<--out>/METRICS.json, or ./METRICS.json")
    ap.add_argument("--rank-run", action="store_true",
                    help="instead of tracing, run rank 0's program of each "
                         f"of {RANK_RUN_SHAPES} (or --shape; an LM arch's "
                         "cells on one pod) for real on --device and print "
                         "one JSON line each")
    args = ap.parse_args(argv)

    lm = args.arch not in (None, "uleen")
    if args.shape and (args.shape in ULEEN_SHAPES) == lm:
        ap.error(f"--shape {args.shape} is not a cell of --arch {args.arch}")
    if args.rank_run:
        if lm:
            cfg = _cut(get_config(args.arch), args.layers)
            for shp in ([args.shape] if args.shape else
                        [s.name for s in shapes_for(cfg)]):
                print(json.dumps(run_lm_rank_program(
                    args.arch, shp, cfg=cfg, device=args.device)),
                    flush=True)
            return 0
        for shape in ([args.shape] if args.shape else RANK_RUN_SHAPES):
            print(json.dumps(run_rank_program(shape, device=args.device)),
                  flush=True)
        return 0
    if args.all:
        print("[dryrun] --all: the ULEEN cells and the LM cells of "
              f"{', '.join(PLACED_ARCHS)}")
        cells = [("uleen", shp) for shp in ULEEN_SHAPES] + [
            (a, s.name) for a in PLACED_ARCHS
            for s in shapes_for(get_config(a))]
    elif lm:
        cells = [(args.arch, args.shape)] if args.shape else [
            (args.arch, s.name) for s in shapes_for(get_config(args.arch))]
    elif args.arch == "uleen" and not args.shape:
        cells = [("uleen", shp) for shp in ULEEN_SHAPES]
    else:
        if not args.shape:
            ap.error("--arch uleen or a placed LM arch (with or without "
                     "--shape), or --all")
        cells = [("uleen", args.shape)]

    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    failures = 0
    records = {}
    with obs_registry.recording() as obs_rec:
        for arch, shp in cells:
            for mp in meshes:
                if arch == "uleen":
                    rec = run_cell(arch, shp, mp, args.out,
                                   backend=args.backend,
                                   analyze=args.analyze, device=args.device)
                else:
                    rec = run_lm_cell(arch, shp, mp, args.out,
                                      analyze=args.analyze,
                                      device=args.device,
                                      cfg=_cut(get_config(arch),
                                               args.layers))
                tag = f"{rec['arch']}.{shp}.{'pod2' if mp else 'pod1'}"
                records[tag] = rec
                failures += 0 if rec.get("ok") else 1
        obs_torchhooks.record_device_memory(obs_rec)
        metrics_path = args.metrics_out or os.path.join(
            args.out if args.out else ".", "METRICS.json")
        if args.out:
            os.makedirs(args.out, exist_ok=True)
        obs_rec.write(metrics_path)
        print(f"[dryrun] metrics: {len(obs_rec.spans)} spans, "
              f"{int(obs_rec.counter('dryrun.traces').value)} traces "
              f"-> {metrics_path}")
    if args.analyze:
        from repro_torch.analysis import registry
        doc = registry.report_json({
            tag: rec["analysis"] for tag, rec in records.items()
            if "analysis" in rec})
        if args.out:
            os.makedirs(args.out, exist_ok=True)
            with open(os.path.join(args.out, "ANALYSIS.json"), "w") as f:
                json.dump(doc, f, indent=1)
        print(f"[dryrun] wnnlint: {doc['errors']} error(s), "
              f"{doc['warnings']} warning(s) across "
              f"{len(doc['cells'])} analyzed cell(s)")
    print(f"[dryrun] done: {len(cells) * len(meshes) - failures} ok, "
          f"{failures} failed")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
