"""The port's `wnnlint` (`repro_torch.analysis`) against the JAX package's.

Two halves, as `tests/test_analysis.py`:

* negative cases — every rule fires on a deliberately broken port
  program (an `unpack_words` in a packed step, an injected float64, an
  extra all-reduce, a second gather, an `.item()` in a serve step, a copy
  to the CPU, a data-dependent shape, an over-budget launch, a spill, a
  replicated big table, an oversized intermediate), traced with fake
  tensors as a card's program or on a fake world's mesh;
* the cells — the six ULEEN cells lint clean on the CLI's (data 2,
  model 4) mesh, and every field of their `CellProgram`s that needs no
  trace, and the coverage thresholds, equal the JAX package's.
"""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.analysis import (RULES, CellProgram,  # noqa: E402
                                  KernelGeometry, analyze_program, cells,
                                  op_names, report_json, summarize)
from repro_torch.analysis import cli  # noqa: E402
from repro_torch.analysis.graph_rules import InputShard  # noqa: E402
from repro_torch.dist import collectives  # noqa: E402
from repro_torch.kernels import wnn_ensemble  # noqa: E402
from repro_torch.launch import graph_cost, uleen_cell  # noqa: E402
from repro_torch.launch import mesh as mesh_mod  # noqa: E402
from repro_torch.packed import layout  # noqa: E402

FakeTensorMode = pytest.importorskip(
    "torch._subclasses.fake_tensor").FakeTensorMode


def _errors(findings, rule=None):
    return [f for f in findings
            if f.severity == "error" and (rule is None or f.rule == rule)]


def _trace(fn, *make, device="cuda"):
    """Trace `fn` over fake tensors built by the `make` callables."""
    fake = FakeTensorMode()
    if torch.device(device).type == "cuda":
        graph_cost.ensure_fake_cuda_guard()
    with fake:
        args = tuple(m() for m in make)
    return graph_cost.trace(fn, args, fake_mode=fake, device=device)


def _prog(traced, **kw):
    return CellProgram(name="broken", graph=traced.graph, traced=traced,
                       **kw)


@pytest.fixture
def world8():
    """A fake world of 8 ranks meshed (data 2, model 4), always torn
    down."""
    from torch.distributed.device_mesh import init_device_mesh
    with mesh_mod.fake_world(8, 0):
        yield init_device_mesh("cuda", (2, 4),
                               mesh_dim_names=("data", "model"))


# ---------------------------------------------------------------------------
# the walker sees the kernels as operator nodes
# ---------------------------------------------------------------------------

def test_walker_sees_the_wnn_kernel_as_one_operator_node():
    spec = uleen_cell.ULN_S_SPEC

    def make_pt():
        return uleen_cell.packed_table_specs(spec, device="cuda")

    def step(pt, bits):
        from repro_torch.packed import runtime
        return runtime.packed_scores(pt, bits, device="cuda")

    traced = _trace(step, make_pt,
                    lambda: torch.empty((64, spec.total_bits),
                                        dtype=torch.bool, device="cuda"))
    assert traced.error is None
    assert "repro_torch::wnn_ensemble" in op_names(traced.graph)
    out = [n for n in traced.graph.graph.nodes if n.op == "output"][0]
    val = out.args[0].meta["val"]
    assert tuple(val.shape) == (64, spec.num_classes)
    assert val.dtype == torch.int32 and val.device.type == "cuda"
    # the flop formula counts what the kernel issues
    geoms = [(spec.num_filters(sm), sm.inputs_per_filter, sm.num_hashes)
             for sm in spec.submodels]
    _, ops = wnn_ensemble.wnn_ensemble_cost(64, spec.total_bits, geoms,
                                            spec.num_classes, 0)
    roof = graph_cost.roofline(traced.graph, 1, 0.0)
    assert roof.ops_by_type["int32"] == sum(ops.values())


# ---------------------------------------------------------------------------
# negative battery: every rule fires on a broken program
# ---------------------------------------------------------------------------

def test_no_unpacked_table_fires_on_unpack_in_packed_path():
    m, n_f, e = 4, 8, 64

    def broken(w):   # the 32x expansion the packed runtime exists to avoid
        return torch.sum(layout.unpack_words(w, e).to(torch.int32))

    traced = _trace(broken, lambda: torch.empty(
        (m, n_f, layout.word_count(e)), dtype=torch.int32, device="cuda"))
    hits = _errors(analyze_program(_prog(
        traced, packed=True, unpacked_table_shapes=frozenset({(m, n_f, e)}))),
        "no-unpacked-table")
    assert hits and hits[0].detail["shape"] == [m, n_f, e]


def test_no_f64_fires_on_injected_float64():
    traced = _trace(lambda x: torch.sum(x.double() * 2.0),
                    lambda: torch.empty((16,), device="cuda"))
    hits = _errors(analyze_program(_prog(traced)), "no-f64")
    assert hits and hits[0].detail["dtype"] == "torch.float64"


def test_collective_budget_fires_on_extra_all_reduce(world8):
    def broken(x):
        cols = collectives.all_gather(x, world8, ("model",), dim=1)
        return collectives.all_reduce_sum(cols, world8, ("data",))

    traced = _trace(broken, lambda: torch.empty((8, 2), dtype=torch.int32,
                                                device="cuda"))
    hits = _errors(analyze_program(_prog(
        traced, sharded=True, collective_budget={"all-gather": 1})),
        "collective-budget")
    assert [f.detail["kind"] for f in hits] == ["all-reduce"]
    assert hits[0].detail["operand_bytes"] == [8 * 8 * 4]


def test_collective_budget_fires_on_a_second_gather(world8):
    """The full serve path's `class_sharded_scores` gathers the columns
    and then the rows: one gather past the cell's budget, which the dry
    run's step (this rank's rows) keeps."""
    from repro_torch.packed import runtime
    spec = uleen_cell.ULN_XL_ENSEMBLE_SPEC
    fake = FakeTensorMode()
    graph_cost.ensure_fake_cuda_guard()
    with fake:
        ins, _ = uleen_cell.uleen_sharded_infer_specs(
            spec, world8, global_batch=64, device="cuda")
        full = torch.empty((64, spec.total_bits), dtype=torch.bool,
                           device="cuda")

    def whole_rows(sp, bits):
        return runtime.packed_scores(sp, bits, device="cuda")

    budget = {"all-gather": 1}
    bad = graph_cost.trace(whole_rows, (ins["ptables"], full),
                           fake_mode=fake, device="cuda")
    hits = _errors(analyze_program(_prog(bad, sharded=True,
                                         collective_budget=budget)),
                   "collective-budget")
    assert hits and hits[0].detail["count"] == 2
    step = uleen_cell.make_uleen_sharded_infer_step(device="cuda")
    ok = graph_cost.trace(step, (ins["ptables"], ins["bits"]),
                          fake_mode=fake, device="cuda")
    assert not analyze_program(_prog(ok, sharded=True,
                                     collective_budget=budget),
                               rules=["collective-budget"])


def test_no_host_callback_fires_on_item_in_a_serve_step():
    def broken(x):
        return x * x.max().item()

    traced = _trace(broken, lambda: torch.empty((4,), device="cuda"))
    assert traced.error is None        # traced on, past the read
    hits = _errors(analyze_program(_prog(traced)), "no-host-callback")
    assert hits and hits[0].detail["op"] == "item"
    assert hits[0].detail["where"].endswith(
        f"test_torch_analysis.py:{broken.__code__.co_firstlineno + 1}")


def test_no_host_callback_names_the_port_line_of_a_perm_read():
    """Perms that arrive from a caller are read and range-checked on the
    host (`ensemble_args` without `columns`): in a step that is the
    finding the card's infer_mnist_scale step carried before
    `tuple_scores` passed its identity perm's reach."""
    def broken(perm, h3, sl, mk):
        return wnn_ensemble.ensemble_args([perm], [h3], [sl], [mk], 10).perms

    traced = _trace(
        broken, lambda: torch.empty((4, 3), dtype=torch.int64,
                                    device="cuda"),
        lambda: torch.empty((2, 3), dtype=torch.int32, device="cuda"),
        lambda: torch.empty((4, 8), dtype=torch.int16, device="cuda"),
        lambda: torch.empty((4,), dtype=torch.int16, device="cuda"))
    hits = _errors(analyze_program(_prog(traced)), "no-host-callback")
    assert [f.detail["op"] for f in hits] == ["__int__", "__int__"]
    assert all(f.detail["where"].startswith(
        "src/repro_torch/kernels/wnn_ensemble.py:") for f in hits)


def test_no_host_callback_fires_on_a_copy_to_the_cpu_and_a_dynamic_shape():
    traced = _trace(lambda x: x.cpu() + 1,
                    lambda: torch.empty((4,), device="cuda"))
    hits = _errors(analyze_program(_prog(traced)), "no-host-callback")
    assert [f.detail["kind"] for f in hits] == ["cpu_copy"]
    # the same copy in the CPU's own program is no round trip
    cpu = _trace(lambda x: x.cpu() + 1, lambda: torch.empty((4,)),
                 device="cpu")
    assert not analyze_program(_prog(cpu), rules=["no-host-callback"])
    dyn = _trace(lambda x: torch.nonzero(x),
                 lambda: torch.empty((4,), device="cuda"))
    hits = _errors(analyze_program(_prog(dyn)), "no-host-callback")
    assert hits and hits[0].detail["kind"] == "data_dependent_shape"
    assert dyn.graph is None and dyn.error


def test_smem_budget_fires_on_over_budget_launch_and_a_spill():
    over = KernelGeometry(columns=250_000, m=10, k=2, route="shared_tile",
                          label="wide")
    hits = _errors(analyze_program(CellProgram(
        name="broken.smem", kernel_geometries=(over,))), "smem-budget")
    assert hits and hits[0].detail["shared_bytes"] > 227 * 1024
    ok = KernelGeometry(columns=784 * 7, m=10, k=2)
    assert not analyze_program(CellProgram(
        name="ok", kernel_geometries=(ok,)), rules=["smem-budget"])
    spill = ({"kernel": ok.instantiation(), "registers": 255,
              "spill_stores": 32},)
    hits = _errors(analyze_program(CellProgram(
        name="broken.spill", kernel_geometries=(ok,), ptxas=spill)),
        "smem-budget")
    assert hits and hits[0].detail["spill_stores"] == 32


def test_sharding_coverage_fires_on_replicated_big_input():
    traced = _trace(lambda x: x * 2, lambda: torch.empty(
        (1 << 18,), device="cuda"))
    prog = _prog(traced, sharded=True, big_param_bytes=float(1 << 19),
                 inputs=(InputShard("args[0]", 1 << 20, 1 << 20, 1),))
    hits = _errors(analyze_program(prog), "sharding-coverage")
    assert hits and hits[0].detail["degree"] == 1
    # a shard above its share is a finding too, a true shard is not
    prog.inputs = (InputShard("args[0]", 1 << 20, 1 << 21, 4),)
    assert _errors(analyze_program(prog), "sharding-coverage")
    prog.inputs = (InputShard("args[0]", 1 << 20, 1 << 22, 4),)
    assert not _errors(analyze_program(prog), "sharding-coverage")


def test_sharding_coverage_fires_on_oversized_intermediate():
    traced = _trace(lambda x: torch.cat([x] * 8), lambda: torch.empty(
        (1 << 16,), device="cuda"))
    prog = _prog(traced, sharded=True, big_param_bytes=float(1 << 30),
                 max_intermediate_bytes=float(1 << 19))
    hits = _errors(analyze_program(prog), "sharding-coverage")
    assert hits and "intermediate" in hits[0].message


# ---------------------------------------------------------------------------
# registry mechanics, against the JAX package's
# ---------------------------------------------------------------------------

def test_registry_has_all_six_rules_at_error_severity():
    from repro.analysis import RULES as JAX_RULES
    expected = {"no-unpacked-table", "no-f64", "collective-budget",
                "no-host-callback", "smem-budget", "sharding-coverage"}
    assert set(RULES) == expected
    for name in expected:
        jax_name = "vmem-budget" if name == "smem-budget" else name
        assert RULES[name].severity == "error"
        assert RULES[name].established == JAX_RULES[jax_name].established
        assert RULES[name].severity == JAX_RULES[jax_name].severity


def test_report_json_document_shape_equals_jax():
    from repro.analysis import registry as jax_registry
    over = KernelGeometry(columns=250_000, m=10, k=2, route="shared_tile")
    findings = analyze_program(CellProgram(name="broken.smem",
                                           kernel_geometries=(over,)))
    doc = report_json({"broken.smem": summarize(findings),
                       "clean.cell": summarize([])})
    jdoc = jax_registry.report_json({"clean.cell":
                                     jax_registry.summarize([])})
    assert set(doc) == set(jdoc)
    assert doc["schema"] == jdoc["schema"] == "wnnlint/v1"
    assert set(doc["rules"]["no-f64"]) == set(jdoc["rules"]["no-f64"])
    assert doc["errors"] == len(findings) > 0
    assert doc["cells"]["clean.cell"] == jdoc["cells"]["clean.cell"]
    f0 = doc["cells"]["broken.smem"]["findings"][0]
    assert set(f0) == {"rule", "severity", "cell", "message", "detail"}


def test_rules_do_not_apply_outside_their_domain():
    traced = _trace(lambda x: x * 2, lambda: torch.empty((4,)),
                    device="cpu")
    prog = CellProgram(name="train.cell", kind="train", serving=False,
                       graph=traced.graph, traced=traced)
    assert [r.name for r in RULES.values() if r.applies(prog)] == ["no-f64"]


# ---------------------------------------------------------------------------
# the cells: clean, and equal to the JAX package's where no trace is needed
# ---------------------------------------------------------------------------

def test_the_six_cells_lint_clean_on_the_cli_mesh(capsys):
    assert cli.main([]) == 0
    out = capsys.readouterr().out
    for shape in cells.ULEEN_CELLS:
        assert f"uleen.{shape}: ok" in out


def test_the_card_step_of_infer_mnist_scale_reads_nothing_on_the_host():
    """The fault the rules found (12 perm reads a step on the card)
    stays repaired: the traced card step has no host read and no
    `_local_scalar_dense`, and launches one WNN kernel a submodel."""
    prog = cells.uleen_cell_program("infer_mnist_scale",
                                    mesh_mod.make_host_mesh(),
                                    global_batch=256)
    assert prog.traced.device.type == "cuda"
    assert prog.traced.host_reads == []
    assert "aten::_local_scalar_dense" not in op_names(prog.graph)
    assert prog.traced.op_counts()["repro_torch::wnn_ensemble"] == \
        len(uleen_cell.ULN_L_SPEC.submodels)
    applicable = {r.name for r in RULES.values() if r.applies(prog)}
    assert {"no-host-callback", "smem-budget", "no-f64"} <= applicable
    assert not _errors(analyze_program(prog))


@pytest.fixture(scope="module")
def jax_programs():
    """JAX's CellProgram of each cell on its 1-device host mesh, no HLO."""
    from repro.analysis import cells as jcells
    from repro.launch.mesh import make_mesh
    jmesh = make_mesh((1, 1), ("data", "model"))
    return {shape: jcells.uleen_cell_program(shape, jmesh,
                                             global_batch=256,
                                             with_hlo=False)
            for shape in jcells.ULEEN_CELLS}


@pytest.mark.parametrize("shape", sorted(cells.ULEEN_CELLS))
def test_cell_program_fields_equal_jax(jax_programs, shape):
    j = jax_programs[shape]
    p = cells.uleen_cell_program(shape, mesh_mod.make_host_mesh(),
                                 global_batch=256, with_trace=False)
    for field in ("name", "kind", "serving", "packed", "sharded",
                  "unpacked_table_shapes", "collective_budget",
                  "big_param_bytes"):
        assert getattr(p, field) == getattr(j, field), field


def _standin(shape, axes):
    """A mesh with what both packages' rules read: JAX's `.axis_names` and
    `.devices.shape`, the port's `.mesh_dim_names` and `.shape`."""
    return types.SimpleNamespace(axis_names=axes, devices=np.empty(shape),
                                 mesh_dim_names=axes, shape=shape)


MESHES = [((2, 4), ("data", "model")), ((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model"))]


@pytest.mark.parametrize("shape,axes", MESHES)
def test_coverage_thresholds_equal_jax(shape, axes):
    """big_param_bytes equals JAX's; max_intermediate_bytes is the
    port's own: 3x the bits shard a rank's card step reads (the WNN
    kernel reads rows in place), and for the tenant fleet 3x the largest
    of its tensor code's values (int64 perm rows at ULN-S)."""
    from repro.analysis import cells as jcells
    mesh = _standin(shape, axes)
    batch = 8192
    spec_x = uleen_cell.ULN_XL_ENSEMBLE_SPEC
    from repro.launch import uleen_cell as juc
    big, inter = cells._coverage_thresholds(spec_x, mesh, batch)
    jbig, _ = jcells._coverage_thresholds(juc.ULN_XL_ENSEMBLE_SPEC, mesh,
                                          batch)
    assert big == jbig
    b_loc = batch // (shape[0] * (shape[1] if len(shape) == 3 else 1))
    assert inter == 3 * b_loc * spec_x.total_bits
    spec_s = uleen_cell.ULN_S_SPEC
    t = uleen_cell.MULTITENANT_TENANTS
    big, inter = cells._mt_coverage_thresholds(spec_s, mesh, batch, t)
    jbig, _ = jcells._mt_coverage_thresholds(juc.ULN_S_SPEC, mesh, batch, t)
    assert big == jbig
    t_loc = t // shape[-1]
    legit = max(max(
        b_loc * spec_s.num_filters(sm) * sm.num_hashes
        * spec_s.num_classes * 4,                      # lookups, int32
        b_loc * spec_s.num_filters(sm) * sm.inputs_per_filter * 8,  # perm rows
        b_loc * spec_s.num_filters(sm) * sm.num_hashes * 8,   # word rows
        t_loc * spec_s.num_classes * spec_s.num_filters(sm) * 2 * 4,
        b_loc * spec_s.total_bits) for sm in spec_s.submodels)
    assert inter == 3 * legit
