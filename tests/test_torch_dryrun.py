"""The port's dry run (`repro_torch.launch.dryrun`, `launch/graph_cost.py`,
the dry-run half of `launch/uleen_cell.py`) against the JAX package's.

One run of the acceptance command (`--arch uleen --mesh both --analyze`,
the card's program traced with no card) feeds most tests: its records
keep JAX's keys and tags, their `sharding` and `tenancy` numbers and
`model_flops` equal JAX's arithmetic on stand-in meshes, the card's
traces hold the kernels' operator nodes, the executed cell's 8 gloo
ranks give parity 0.0, and `scripts/diff_dryrun.py` reads the sweep.
Beside it: a hand-counted program's exact bytes, operations and peak, the
SPMD training step against the one-device step, and every LM arch in
the placed set and the sweep's default.
"""
import dataclasses
import json
import math
import os
import shutil
import subprocess
import sys
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.analysis import cells  # noqa: E402
from repro_torch.launch import dryrun, graph_cost, uleen_cell  # noqa: E402
from repro_torch.launch import mesh as mesh_mod  # noqa: E402

import test_torch_dryrun_ranks as ranks  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FakeTensorMode = pytest.importorskip(
    "torch._subclasses.fake_tensor").FakeTensorMode

# JAX's record keys (src/repro/launch/dryrun.py:352-372, 214-239)
JAX_KEYS = {"arch", "shape", "kind", "backend", "backend_resolved",
            "kernel_mode", "mesh", "chips", "ok", "lower_s", "compile_s",
            "memory", "roofline"}
JAX_EXEC_KEYS = {"arch", "shape", "kind", "backend", "mesh", "chips", "ok",
                 "lower_s", "compile_s", "memory", "roofline", "exec"}
JAX_MEMORY = {"args_gib", "output_gib", "temp_gib", "alias_gib", "peak_gib"}
JAX_TAGS = {
    "uleen_uln_l.train_mnist_scale", "uleen_exec.train_host_exec",
    "uleen_uln_l.infer_mnist_scale.{}.auto",
    "uleen_uln_xl.infer_packed_scale.{}.auto",
    "uleen_uln_xl_ens.infer_sharded_scale.{}.auto",
    "uleen_uln_s_fleet.infer_multitenant_scale.{}.auto"}


@pytest.fixture(scope="module")
def sweep(tmp_path_factory):
    """The acceptance command, once: (out dir, exit code, records)."""
    out = tmp_path_factory.mktemp("dryrun")
    rc = dryrun.main(["--arch", "uleen", "--mesh", "both", "--analyze",
                      "--out", str(out)])
    records = {}
    for name in sorted(os.listdir(out)):
        with open(out / name) as f:
            doc = json.load(f)
        if "ok" in doc:
            records[name[:-5]] = doc
    return out, rc, records


def _standin(shape, axes):
    return types.SimpleNamespace(axis_names=axes, devices=np.empty(shape),
                                 mesh_dim_names=axes, shape=shape)


STANDINS = {"pod1": ((16, 16), ("data", "model")),
            "pod2": ((2, 16, 16), ("pod", "data", "model"))}


def test_sweep_writes_every_record_with_jax_keys_and_tags(sweep):
    out, rc, records = sweep
    want = set()
    for pod in ("pod1", "pod2"):
        for t in JAX_TAGS:
            want.add(t.format(pod) if "{}" in t else f"{t}.{pod}")
    assert set(records) == want and len(records) == 12
    for tag, r in records.items():
        keys = JAX_EXEC_KEYS if r["shape"] == "train_host_exec" else JAX_KEYS
        assert keys <= set(r), (tag, keys - set(r))
        assert set(r["memory"]) == JAX_MEMORY
        from repro.launch.hlo_cost import Roofline
        assert {f.name for f in dataclasses.fields(Roofline)} <= \
            set(r["roofline"])
        assert r["roofline"]["xla_flops_raw"] is None
    assert (out / "METRICS.json").exists() and (out / "ANALYSIS.json").exists()
    with open(out / "ANALYSIS.json") as f:
        doc = json.load(f)
    assert doc["schema"] == "wnnlint/v1" and len(doc["cells"]) == 12
    with open(out / "METRICS.json") as f:
        metrics = json.load(f)
    assert metrics["schema"] == "obsmetrics/v1"
    spans = [s for s in metrics["spans"] if s["name"] == "dryrun.trace"]
    assert len(spans) == 12 and all("cell" in s["attrs"] for s in spans)


def test_sweep_fails_only_on_the_known_layout_fault(sweep):
    """No cell fails any more: the class-sharded rank, which held more
    than JAX's bound before its slices took 2 bits an entry and its words
    were released, now fits it on both meshes. Every record is ok, the
    exit code 0, and the bound is JAX's, unchanged."""
    _, rc, records = sweep
    assert sorted(t for t, r in records.items() if not r["ok"]) == []
    assert rc == 0
    bits = {"pod1": 25_690_112, "pod2": 12_845_056}
    for pod, b in bits.items():
        s = records[f"uleen_uln_xl_ens.infer_sharded_scale.{pod}.auto"][
            "sharding"]
        assert s["args_bytes_bound"] == 2_342_912 + b + (4 << 20)
        assert s["args_bytes_per_device_measured"] <= s["args_bytes_bound"]


@pytest.mark.parametrize("pod", ["pod1", "pod2"])
def test_sharding_and_tenancy_equal_jax_arithmetic(sweep, pod):
    import jax
    from repro.dist import sharding as jsh
    from repro.launch import uleen_cell as juc
    _, _, records = sweep
    mesh = _standin(*STANDINS[pod])
    s = records[f"uleen_uln_xl_ens.infer_sharded_scale.{pod}.auto"][
        "sharding"]
    entry, degree = jsh.class_partition(mesh, 32, jsh.SERVE_RULES)
    rep = juc.packed_table_specs(juc.ULN_XL_ENSEMBLE_SPEC).table_bytes()
    assert (s["class_axis"], s["class_shards"]) == (entry, degree)
    assert s["table_bytes_replicated"] == rep
    assert s["table_bytes_per_device"] == rep // degree
    assert s["model_axis"] == jsh.spec_degree(mesh, "model")
    t = records[f"uleen_uln_s_fleet.infer_multitenant_scale.{pod}.auto"][
        "tenancy"]
    tenants = juc.MULTITENANT_TENANTS
    entry, degree = jsh.tenant_partition(mesh, tenants, jsh.SERVE_RULES)
    st = juc.stacked_table_specs(juc.ULN_S_SPEC, tenants)
    assert (t["tenant_axis"], t["tenant_shards"]) == (entry, degree)
    assert t["tenants_per_device"] == tenants // degree
    assert t["words_bytes_per_tenant"] == st.table_bytes() // tenants
    # the port keeps perms as int64 (torch indexes with int64), JAX as
    # int32: its fleet is 4 bytes an index larger
    jax_fleet = sum(math.prod(x.shape) * x.dtype.itemsize
                    for x in jax.tree.leaves(st))
    perm_elems = sum(math.prod(p.shape) for p in st.perms)
    assert t["fleet_bytes_global"] == jax_fleet + 4 * perm_elems
    b_loc = juc.INFER_BATCH // jsh.spec_degree(
        mesh, jsh.SERVE_RULES.resolve(("batch",), mesh,
                                      shape=(juc.INFER_BATCH,))[0])
    assert t["args_bytes_bound"] == (t["fleet_bytes_global"] // degree
                                     + b_loc * 1568 + b_loc * 4 + (4 << 20))
    assert t["args_bytes_per_device_measured"] <= t["args_bytes_bound"]


def test_model_flops_equal_jax_formula(sweep):
    from repro.launch import uleen_cell as juc
    _, _, records = sweep
    specs = {"train_mnist_scale": (juc.ULN_L_SPEC, juc.GLOBAL_BATCH, 1),
             "infer_mnist_scale": (juc.ULN_L_SPEC, juc.INFER_BATCH, 1),
             "infer_packed_scale": (juc.ULN_XL_SPEC, juc.INFER_BATCH, 1),
             "infer_sharded_scale": (juc.ULN_XL_ENSEMBLE_SPEC,
                                     juc.INFER_BATCH, 1),
             "infer_multitenant_scale": (juc.ULN_S_SPEC, juc.INFER_BATCH, 1),
             "train_host_exec": (juc.ULEEN_EXEC_SPEC, juc.EXEC_BATCH, 3)}
    for tag, r in records.items():
        spec, batch, x = specs[r["shape"]]
        ops = sum(spec.num_filters(sm) * sm.num_hashes
                  * (sm.inputs_per_filter + 1) + spec.num_filters(sm)
                  for sm in spec.submodels) * spec.num_classes * x
        assert r["roofline"]["model_flops"] == float(ops * batch), tag


def test_card_traces_hold_the_kernel_ops_and_cpu_traces_none(sweep):
    _, _, records = sweep
    for pod in ("pod1", "pod2"):
        for shape, n in (("uleen_uln_l.infer_mnist_scale", 6),
                         ("uleen_uln_xl.infer_packed_scale", 1),
                         ("uleen_uln_xl_ens.infer_sharded_scale", 1)):
            r = records[f"{shape}.{pod}.auto"]
            assert r["traced_device"] == "cuda:0"
            assert r["kernel_mode"] == "cuda"
            assert r["op_nodes"] == {"repro_torch::wnn_ensemble": n}
            assert r["host_reads"] == []
        # the fleet is tensor code in both packages: no kernel
        assert records[f"uleen_uln_s_fleet.infer_multitenant_scale.{pod}"
                       ".auto"]["op_nodes"] == {}
    host = mesh_mod.make_host_mesh()
    for shape in ("infer_mnist_scale", "infer_packed_scale",
                  "train_mnist_scale"):
        traced, _ = cells.trace_cell(shape, host, global_batch=64,
                                     device="cpu")
        assert traced.error is None and traced.device.type == "cpu"
        assert not [k for k in traced.op_counts()
                    if k.startswith("repro_torch::")]
    # the hash kernel is an operator node of the card's training step too
    # (its backward needs a torch built with CUDA; the forward does not)
    traced, _ = cells.trace_cell("infer_mnist_scale", host,
                                 global_batch=64, device="cuda")
    assert traced.op_counts()["repro_torch::wnn_ensemble"] == 6
    spec = uleen_cell.ULN_L_SPEC
    fake = FakeTensorMode()
    graph_cost.ensure_fake_cuda_guard()
    with fake:
        statics = uleen_cell._statics(spec, torch.device("cuda", 0), None)
        bits = torch.empty((64, spec.total_bits), dtype=torch.bool,
                           device="cuda")
    from repro_torch.core.model import compute_hashes
    hashed = graph_cost.trace(
        lambda st, b: compute_hashes(spec, st, b, device="cuda"),
        (statics, bits), fake_mode=fake, device="cuda")
    assert hashed.op_counts()["repro_torch::h3_hash"] == len(spec.submodels)


def test_executed_cell_parity_and_finite_losses_on_the_cpu(sweep):
    _, _, records = sweep
    for pod in ("pod1", "pod2"):
        r = records[f"uleen_exec.train_host_exec.{pod}"]
        assert r["ok"] and r["exec"]["parity_max_diff"] == 0.0
        assert r["exec"]["steps"] == 3 and r["exec"]["ranks"] == 8
        assert all(math.isfinite(v) for v in r["exec"]["losses"])
        assert r["exec"]["rank_device"] == (
            "cuda" if torch.cuda.is_available() else "cpu")


def _diff(new, prev):
    return subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts", "diff_dryrun.py"),
         str(new), str(prev)], capture_output=True, text=True, timeout=120)


def test_diff_dryrun_reads_the_port_sweeps(sweep, tmp_path):
    out, _, records = sweep
    prev = tmp_path / "prev"
    shutil.copytree(out, prev)
    res = _diff(out, prev)
    assert res.returncode == 0, res.stdout + res.stderr
    grown = tmp_path / "grown"
    shutil.copytree(out, grown)
    tag = "uleen_uln_xl.infer_packed_scale.pod1.auto"
    rec = dict(records[tag])
    rec["memory"] = dict(rec["memory"],
                         peak_gib=rec["memory"]["peak_gib"] * 1.5)
    with open(grown / f"{tag}.json", "w") as f:
        json.dump(rec, f)
    res = _diff(grown, prev)
    assert res.returncode == 1 and "REGRESSION" in res.stdout


@pytest.mark.parametrize("device,granule", [("cpu", 1), ("cuda", 512)])
def test_hand_counted_program_bytes_operations_and_peak(device, granule):
    """((x * 2) + x).sum() on 1024 float32: mul reads 4096 B and writes
    4096, add reads 8192 and writes 4096, sum reads 4096 and writes 4;
    1024 float32 operations each; live at the add: x, x*2 and the sum of
    the two (12288 B); the output a 4-byte scalar, a 512-byte block on
    the card."""
    fake = FakeTensorMode()
    if device == "cuda":
        graph_cost.ensure_fake_cuda_guard()
    with fake:
        x = torch.empty((1024,), device=device)
    traced = graph_cost.trace(lambda v: ((v * 2) + v).sum(), (x,),
                              fake_mode=fake, device=device)
    roof = graph_cost.roofline(traced.graph, 1, 0.0)
    assert roof.hbm_bytes_read == 4096 + 8192 + 4096
    assert roof.hbm_bytes_written == 4096 + 4096 + 4
    assert roof.ops_by_type == {"float32": 3 * 1024.0}
    out = -(-4 // granule) * granule
    assert traced.memory == {"args": 4096, "output": out, "alias": 0,
                             "peak": 12288, "temp": 12288 - 4096 - out}


@pytest.fixture(scope="module")
def spmd_problem():
    """The executed cell's spec, random tables and rows from a seed."""
    spec = uleen_cell.ULEEN_EXEC_SPEC
    rng = np.random.default_rng(25)
    b, m = 64, spec.num_classes
    plan = {"tables": [], "masks": [], "perms": [], "h3s": [], "keep": []}
    for sm in spec.submodels:
        n_f = spec.num_filters(sm)
        plan["tables"].append(rng.uniform(-1, 0.1, (m, n_f, sm.entries))
                              .astype(np.float32))
        plan["masks"].append(np.ones((m, n_f), np.float32))
        plan["perms"].append(rng.integers(0, spec.total_bits,
                                          (n_f, sm.inputs_per_filter))
                             .astype(np.int32))
        plan["h3s"].append(rng.integers(0, sm.entries,
                                        (sm.num_hashes, sm.inputs_per_filter))
                           .astype(np.int32))
        plan["keep"].append(rng.random((b, m, n_f)) < 0.5)
    plan["bias"] = np.zeros(m, np.float32)
    plan["bits"] = rng.integers(0, 2, (b, spec.total_bits)).astype(np.int8)
    plan["labels"] = rng.integers(0, m, b).astype(np.int64)
    return plan


def test_spmd_train_step_on_one_rank_is_the_one_device_step(spmd_problem):
    one = ranks.run_step(*ranks.problem_tensors(spmd_problem))
    host = ranks.run_step(*ranks.problem_tensors(spmd_problem),
                          mesh=mesh_mod.make_host_mesh(("data",)))
    assert one["loss"] == host["loss"]
    for a, b in zip(one["params"] + one["mu"], host["params"] + host["mu"]):
        assert np.array_equal(a, b)


def test_spmd_train_step_on_two_gloo_ranks_matches_one_rank(spmd_problem):
    """Each rank's half of the rows and of the keep masks; the gradients
    and loss summed over `data` and halved: the one-rank step on all rows
    within float32 all-reduce rounding (the first Adam moment is
    (1 - b1)·g, so it carries the gradient itself)."""
    one = ranks.run_step(*ranks.problem_tensors(spmd_problem))
    outs = mesh_mod.spawn_ranks(ranks.spmd_train_step, 2, spmd_problem,
                                backend="gloo", timeout_s=120)
    for out in outs:
        assert out["loss"] == pytest.approx(one["loss"], rel=1e-6)
        for a, b in zip(out["mu"], one["mu"]):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-9)
        for a, b in zip(out["params"], one["params"]):
            np.testing.assert_allclose(a, b, rtol=0, atol=2e-6)
    for a, b in zip(outs[0]["params"], outs[1]["params"]):
        assert np.array_equal(a, b)


def test_every_lm_arch_is_placed_and_swept(tmp_path, monkeypatch):
    """Every arch of the zoo has its placement (no family waits any
    more), and `launch.sweep` with no `--archs` runs every shape of all
    ten on both meshes (its cells recorded, not traced)."""
    from repro_torch.configs import ARCH_IDS, get_config, shapes_for
    from repro_torch.launch import sweep
    assert sorted(dryrun.PLACED_ARCHS) == sorted(ARCH_IDS)
    assert len(ARCH_IDS) == 10
    ran = []
    monkeypatch.setattr(sweep, "run_one", lambda arch, shape, mesh, args: (
        ran.append((arch, shape, mesh)) or (True, "", 0.0)))
    assert sweep.main(["--out", str(tmp_path)]) == 0
    assert sorted(ran) == sorted(
        (a, s.name, m) for a in ARCH_IDS for s in shapes_for(get_config(a))
        for m in ("single", "multi"))
