"""CellProgram builders: one evidence bundle per traced ULEEN cell (port of
`repro/analysis/cells.py`).

This is where each cell's intent becomes lintable configuration: which
shapes would be an unpacked table, the collective budget, the kernel
launches that must fit the card, and the byte thresholds of sharding
coverage. The builders trace the same steps `launch/dryrun.py` traces
(`launch.uleen_cell.trace_*`), or take the trace the dry run already
made.

The thresholds come from the geometry:

* `big_param_bytes` is the JAX package's: half the smallest packed words
  plane's global bytes (half the smallest stacked plane's for the
  tenant fleet). Every input a rank may hold whole (perms, H3
  parameters, bias, the kernel's descriptors) lies far below it; a plane
  whose partition was lost lands above it at full size.
* `max_intermediate_bytes` is the port's own: 3x the largest value a
  rank's step legitimately materialises in the port's formulation, which
  is not XLA's. On the card the WNN kernel reads a rank's bits in place
  and writes (B_loc, M_loc) scores, so the largest is the bits shard
  (B_loc x total_bits bytes); the plain program adds its gathered tuples,
  the H3 fold's (B_loc, N_f, k, n) int32 selects and the lookups'
  (M_loc, B_loc, N_f, k) int32 words. The tenant fleet runs the same
  tensor code on both: its (B_loc, N_f, k, M) int32 lookups, its int64
  perm rows (B_loc, N_f·n) and word rows (B_loc, N_f, k), the transposed
  local words and the bits shard. Losing the class or tenant partition
  multiplies the lookups by the shard count (>= 4 on every sharded
  mesh), past the 3x headroom.
"""
from __future__ import annotations

import contextlib
from typing import Optional

from repro_torch.analysis.graph_rules import InputShard
from repro_torch.analysis.registry import CellProgram, KernelGeometry
from repro_torch.dist import sharding as sh
from repro_torch.launch import uleen_cell
from repro_torch.packed.layout import word_count

# shape name -> (spec, kind): launch/dryrun.py's ULEEN cells
ULEEN_CELLS = {
    "train_mnist_scale": (uleen_cell.ULN_L_SPEC, "train"),
    "train_host_exec": (uleen_cell.ULEEN_EXEC_SPEC, "train"),
    "infer_mnist_scale": (uleen_cell.ULN_L_SPEC, "infer"),
    "infer_packed_scale": (uleen_cell.ULN_XL_SPEC, "infer"),
    "infer_sharded_scale": (uleen_cell.ULN_XL_ENSEMBLE_SPEC, "infer"),
    "infer_multitenant_scale": (uleen_cell.ULN_S_SPEC, "infer"),
}
EXEC_MESH = ((2, 4), ("pod", "data"))


def unpacked_table_shapes(spec) -> frozenset:
    """The (M, N_f, E) extents that must never be a value in this
    geometry's packed-path program."""
    return frozenset((spec.num_classes, spec.num_filters(sm), sm.entries)
                     for sm in spec.submodels)


def kernel_geometries(shape: str, spec, mesh, device="cuda") -> tuple:
    """The WNN launches a cell's step makes on the card: one a submodel
    on its tuples (the int8-table cell: `fused_wnn` through
    `tuple_scores`, identity perms), one for the ensemble on the rows
    (the packed and class-sharded cells, perms reaching `total_bits`,
    M/S classes on a shard). The CPU program, the tenant fleet (tensor
    code) and the training cells (the H3 kernel only) launch none."""
    import torch
    from repro_torch.kernels import wnn_ensemble
    if torch.device(device).type != "cuda":
        return ()
    if shape == "infer_mnist_scale":
        out = []
        for i, sm in enumerate(spec.submodels):
            cols = spec.num_filters(sm) * sm.inputs_per_filter
            out.append(KernelGeometry(
                columns=cols, m=spec.num_classes, k=sm.num_hashes,
                route=wnn_ensemble.perm_route(cols), label=f"submodel[{i}]"))
        return tuple(out)
    if shape in ("infer_packed_scale", "infer_sharded_scale"):
        m = spec.num_classes
        if shape == "infer_sharded_scale":
            m //= sh.class_partition(mesh, m, sh.SERVE_RULES)[1]
        return (KernelGeometry(
            columns=spec.total_bits, m=m,
            k=max(sm.num_hashes for sm in spec.submodels),
            route=wnn_ensemble.perm_route(spec.total_bits),
            label="ensemble"),)
    return ()


def _b_loc(mesh, batch: int) -> int:
    return uleen_cell.batch_rows(mesh, sh.SERVE_RULES, batch)[2]


def _coverage_thresholds(spec, mesh, batch: int, device="cuda") -> tuple:
    """(big_param_bytes, max_intermediate_bytes) of the class-sharded cell
    on `mesh` (module docstring)."""
    import torch
    m = spec.num_classes
    words_bytes = [m * spec.num_filters(sm) * word_count(sm.entries) * 4
                   for sm in spec.submodels]
    big_param = min(words_bytes) // 2
    _entry, class_deg = sh.class_partition(mesh, m, sh.SERVE_RULES)
    b_loc = _b_loc(mesh, batch)
    m_loc = -(-m // class_deg)
    legit = max(b_loc * spec.total_bits, b_loc * m * 4)
    if torch.device(device).type != "cuda":
        legit = max(legit, max(max(
            b_loc * spec.num_filters(sm) * sm.inputs_per_filter,
            b_loc * spec.num_filters(sm) * sm.num_hashes
            * sm.inputs_per_filter * 4,
            m_loc * b_loc * spec.num_filters(sm) * sm.num_hashes * 4)
            for sm in spec.submodels))
    return float(big_param), float(3 * legit)


def _mt_coverage_thresholds(spec, mesh, batch: int, tenants: int) -> tuple:
    """(big_param_bytes, max_intermediate_bytes) of the tenant fleet cell
    (module docstring); the same on both devices."""
    m = spec.num_classes
    words_bytes = [tenants * m * spec.num_filters(sm)
                   * word_count(sm.entries) * 4 for sm in spec.submodels]
    big_param = min(words_bytes) // 2
    _entry, deg = sh.tenant_partition(mesh, tenants, sh.SERVE_RULES)
    t_loc = tenants // deg
    b_loc = _b_loc(mesh, batch)
    legit = max(max(
        b_loc * spec.num_filters(sm) * sm.num_hashes * m * 4,
        b_loc * spec.num_filters(sm) * sm.inputs_per_filter * 8,
        b_loc * spec.num_filters(sm) * sm.num_hashes * 8,
        t_loc * m * spec.num_filters(sm) * word_count(sm.entries) * 4,
        b_loc * spec.total_bits) for sm in spec.submodels)
    return float(big_param), float(3 * legit)


def _degree_rule(shape: str, mesh, spec, batch: int):
    """path -> intended shard count of a partitioned cell's inputs: the
    class- or tenant-partitioned leaves of the rank's tables, the rows
    over the batch axes, everything else whole."""
    per_class = (".words", ".masks", ".bias", ".slices")
    if shape == "infer_sharded_scale":
        entry, deg = sh.class_partition(mesh, spec.num_classes,
                                        sh.SERVE_RULES)

        def partitioned(path):
            return any(k in path for k in per_class)
        rows = ("args[1]",)
    else:
        entry, deg = sh.tenant_partition(mesh, uleen_cell.MULTITENANT_TENANTS,
                                         sh.SERVE_RULES)

        def partitioned(path):
            return True
        rows = ("args[1]", "args[2]")
    b_deg = uleen_cell.batch_rows(mesh, sh.SERVE_RULES, batch,
                                  exclude=sh.entry_axes(entry))[1]
    return lambda p: (deg if ".local." in p and partitioned(p)
                      else b_deg if p in rows else 1)


def input_shards(local_args, global_args, degree_of) -> tuple:
    """InputShard per input of a rank's program: its bytes, the bytes of
    the same input unsharded, and its intended shard count."""
    from repro_torch.launch import graph_cost
    glob = dict(graph_cost.flatten(global_args, "args"))
    out = []
    for path, t in graph_cost.flatten(local_args, "args"):
        g = glob.get(path, t)
        out.append(InputShard(path, t.numel() * t.element_size(),
                              g.numel() * g.element_size(), degree_of(path)))
    return tuple(out)


def _global_args(shape: str, spec, mesh, batch: int, device):
    """A partitioned cell's inputs unsharded (fake), in the traced step's
    order."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    kw = dict(global_batch=batch, device=device, global_view=True)
    with FakeTensorMode():
        if shape == "infer_sharded_scale":
            ins, _ = uleen_cell.uleen_sharded_infer_specs(spec, mesh, **kw)
            return (ins["ptables"], ins["bits"])
        ins, _ = uleen_cell.uleen_multitenant_infer_specs(spec, mesh, **kw)
        return (ins["st"], ins["bits"], ins["tids"])


@contextlib.contextmanager
def exec_mesh(mesh):
    """The executed cell's (pod 2, data 4) mesh: `mesh` if it has a `pod`
    axis, else one over the current 8-rank world, else over a fake world
    of 8 started here (the program is a function of its mesh; linting it
    on a pod-less mesh would lint another program)."""
    import torch.distributed as dist
    from repro_torch.launch import mesh as mesh_mod
    if "pod" in tuple(mesh.mesh_dim_names):
        yield mesh
        return
    from torch.distributed.device_mesh import init_device_mesh
    if dist.is_initialized() and dist.get_world_size() == 8:
        yield init_device_mesh("cpu", EXEC_MESH[0],
                               mesh_dim_names=EXEC_MESH[1])
        return
    with mesh_mod.fake_world(8, 0):
        yield init_device_mesh("cpu", EXEC_MESH[0],
                               mesh_dim_names=EXEC_MESH[1])


def trace_cell(shape: str, mesh, *, global_batch: Optional[int] = None,
               backend: str = "auto", device="cuda"):
    """(Traced, args) of one ULEEN cell's step on `mesh` as rank
    `mesh`'s own rank runs it (the dry run's `trace_*` calls)."""
    spec, kind = ULEEN_CELLS[shape]
    train = kind == "train"
    batch = global_batch if global_batch is not None else (
        uleen_cell.GLOBAL_BATCH if train else uleen_cell.INFER_BATCH)
    kw = dict(global_batch=batch, device=device)
    if shape == "train_mnist_scale":
        traced, args = uleen_cell.trace_uleen_cell(mesh, spec=spec, **kw)
    elif shape == "train_host_exec":
        if global_batch is None:
            kw["global_batch"] = uleen_cell.EXEC_BATCH
        traced, args = uleen_cell.trace_uleen_dist_cell(
            mesh, spec=spec, compress=True, **kw)
    elif shape == "infer_mnist_scale":
        traced, args = uleen_cell.trace_uleen_infer_cell(
            mesh, spec=spec, backend=backend, **kw)
    elif shape == "infer_packed_scale":
        traced, args = uleen_cell.trace_uleen_packed_infer_cell(
            mesh, spec=spec, backend=backend, **kw)
    elif shape == "infer_sharded_scale":
        traced, args = uleen_cell.trace_uleen_sharded_infer_cell(
            mesh, spec=spec, backend=backend, **kw)
    else:
        traced, args = uleen_cell.trace_uleen_multitenant_infer_cell(
            mesh, spec=spec, backend=backend, **kw)
    return traced, args


def uleen_cell_program(shape: str, mesh, *,
                       global_batch: Optional[int] = None,
                       backend: str = "auto", traced=None, args=None,
                       device="cuda", with_trace: bool = True,
                       ptxas: tuple = ()) -> CellProgram:
    """The CellProgram of one ULEEN dry-run shape on `mesh`.

    `traced`/`args` reuse a trace the caller made (the dry run);
    otherwise the cell is traced here when `with_trace` (on the card's
    program by default; a training cell on the CPU program where the
    torch build cannot run autograd on fake CUDA tensors)."""
    if shape not in ULEEN_CELLS:
        raise ValueError(f"unknown uleen shape {shape!r}; "
                         f"known: {tuple(ULEEN_CELLS)}")
    spec, kind = ULEEN_CELLS[shape]
    train = kind == "train"
    batch = global_batch if global_batch is not None else (
        uleen_cell.GLOBAL_BATCH if train else uleen_cell.INFER_BATCH)
    if train and not uleen_cell.autograd_traceable(device):
        device = "cpu"
    prog = CellProgram(name=f"uleen.{shape}", kind=kind, serving=not train,
                       ptxas=tuple(ptxas))

    if shape == "train_host_exec":
        if with_trace and traced is None:
            with exec_mesh(mesh) as emesh:
                traced, args = trace_cell(shape, emesh,
                                          global_batch=global_batch,
                                          device=device)
    elif train:
        if with_trace and traced is None:
            traced, args = trace_cell(shape, mesh, global_batch=batch,
                                      device=device)
    else:
        prog.kernel_geometries = kernel_geometries(shape, spec, mesh, device)
        if shape == "infer_multitenant_scale":
            tenants = uleen_cell.MULTITENANT_TENANTS
            prog.packed = True
            # neither the per-tenant (M, N_f, E) table nor its stacked
            # (T, M, N_f, E) fleet form may ever materialise
            prog.unpacked_table_shapes = (
                unpacked_table_shapes(spec)
                | frozenset((tenants,) + s
                            for s in unpacked_table_shapes(spec)))
            _entry, degree = sh.tenant_partition(mesh, tenants,
                                                 sh.SERVE_RULES)
            if degree > 1:   # a trivial mesh has nothing to cover
                prog.sharded = True
                # the ONE sum of ownership-masked partials
                prog.collective_budget = {"all-reduce": 1}
                (prog.big_param_bytes,
                 prog.max_intermediate_bytes) = _mt_coverage_thresholds(
                     spec, mesh, batch, tenants)
        elif shape in ("infer_packed_scale", "infer_sharded_scale"):
            prog.packed = True
            prog.unpacked_table_shapes = unpacked_table_shapes(spec)
            if shape == "infer_sharded_scale":
                _entry, degree = sh.class_partition(mesh, spec.num_classes,
                                                    sh.SERVE_RULES)
                if degree > 1:
                    prog.sharded = True
                    prog.collective_budget = {"all-gather": 1}
                    (prog.big_param_bytes,
                     prog.max_intermediate_bytes) = _coverage_thresholds(
                         spec, mesh, batch, device)
        if with_trace and traced is None:
            traced, args = trace_cell(shape, mesh, global_batch=batch,
                                      backend=backend, device=device)
    if traced is not None:
        prog.traced = traced
        prog.graph = traced.graph
        if prog.sharded and args is not None:
            prog.inputs = input_shards(
                args, _global_args(shape, spec, mesh, batch, traced.device),
                _degree_rule(shape, mesh, spec, batch))
    return prog


def graph_cell_program(name: str, kind: str, traced) -> CellProgram:
    """The program of one LM cell (train, prefill or decode; JAX's
    `hlo_cell_program`): the traced graph alone, a serving program unless
    `kind` is "train". The ULEEN-specific rules (tables, WNN launches,
    budgets, coverage) find nothing of theirs in it; no-f64 and
    no-host-callback read the graph and the trace's host reads."""
    return CellProgram(name=name, kind=kind, serving=kind != "train",
                       traced=traced,
                       graph=traced.graph if traced is not None else None)
