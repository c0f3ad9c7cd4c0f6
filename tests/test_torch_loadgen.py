"""The port's load harness (`repro_torch.launch.loadgen`) against the JAX
package's (`repro.launch.loadgen`), on the CPU.

Schema validation mirrors `tests/test_loadgen.py` defect class for defect
class and is held to the JAX function's complaints on the same specs;
the request streams and SLO verdicts equal the JAX package's; `check()`
agrees with JAX's on well-formed and corrupted files; the port's rows
pass the JAX `check()` and `scripts/diff_serve.py`. The golden scenarios
run through the port on the smoke configs (the JAX `Engine` itself does
not run here: its two `paged_mixed` tests are red in this container).
Rows are compared by schema and bookkeeping, not by token: the port
draws its parameters from a `torch.Generator`, JAX from `PRNGKey(0)`.
"""
import copy
import importlib.util
import json
import pathlib
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.base import get_config as jget_config  # noqa: E402
from repro.launch import loadgen as jloadgen  # noqa: E402
from repro_torch.configs.base import ARCH_IDS, get_config  # noqa: E402
from repro_torch.launch import loadgen  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parent.parent
GOLDEN = REPO / "tests" / "golden" / "scenarios"

_spec = importlib.util.spec_from_file_location(
    "diff_serve", REPO / "scripts" / "diff_serve.py")
diff_serve = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(diff_serve)

BASE = {
    "schema": "scenario/v1",
    "name": "t",
    "arch": "llama3p2_3b",
    "engine": {"slots": 2, "max_len": 32, "paged": True, "block_size": 8},
    "workload": {"requests": 2, "seed": 0,
                 "arrival": {"process": "poisson", "rate": 8.0},
                 "prompt_lens": [4, 8], "gen_lens": [2, 4]},
    "slo": {"p99_latency_s": 10.0},
}
_DELETE = object()


def _mutated(path, value):
    spec = copy.deepcopy(BASE)
    node = spec
    for k in path[:-1]:
        node = node[k]
    if value is _DELETE:
        del node[path[-1]]
    else:
        node[path[-1]] = value
    return spec


def test_formats_equal_the_jax_packages():
    assert loadgen.SCHEMA == jloadgen.SCHEMA
    assert loadgen.BENCH_SCHEMA == jloadgen.BENCH_SCHEMA
    assert loadgen.ROW_KEYS == jloadgen.ROW_KEYS
    assert loadgen.SLO_METRICS == jloadgen.SLO_METRICS
    assert loadgen.ARRIVAL_PROCESSES == jloadgen.ARRIVAL_PROCESSES
    public = {n for n in dir(jloadgen) if not n.startswith("_")
              and callable(getattr(jloadgen, n))
              and getattr(getattr(jloadgen, n), "__module__", "")
              == jloadgen.__name__}
    assert public <= set(dir(loadgen)), public - set(dir(loadgen))


def test_the_zoo_is_the_jax_packages():
    """A spec may name any architecture of the zoo, and the port runs
    every one."""
    from repro.configs.base import ARCH_IDS as JAX_IDS
    assert ARCH_IDS == JAX_IDS
    for arch in JAX_IDS:
        assert loadgen.validate_scenario(_mutated(("arch",), arch)) == []


# ---------------------------------------------------------------------------
# Scenario validation
# ---------------------------------------------------------------------------

def test_base_spec_is_valid():
    assert loadgen.validate_scenario(BASE) == []


@pytest.mark.parametrize("path,value,complaint", [
    (("schema",), "scenario/v0", "schema"),
    (("name",), _DELETE, "name"),
    (("arch",), "not_an_arch", "arch"),
    (("engine", "slots"), 0, "engine.slots"),
    (("engine", "max_len"), "long", "engine.max_len"),
    (("engine", "paged"), "yes", "engine.paged"),
    (("engine", "max_len"), 30, "not a multiple"),
    (("engine", "num_blocks"), 1, "engine.num_blocks"),
    (("engine", "bucket"), "pow4", "engine.bucket"),
    (("engine", "mystery"), 1, "unknown keys"),
    (("workload", "requests"), 0, "workload.requests"),
    (("workload", "seed"), 1.5, "workload.seed"),
    (("workload", "arrival", "process"), "burst", "arrival.process"),
    (("workload", "arrival", "rate"), 0, "arrival.rate"),
    (("workload", "prompt_lens"), [], "prompt_lens"),
    (("workload", "gen_lens"), [4, 0], "gen_lens"),
    (("workload", "gen_lens"), [40], "cache rows"),
    (("slo", "p42_latency_s"), 1.0, "unknown target"),
    (("slo", "p99_latency_s"), -1.0, "slo.p99_latency_s"),
    (("engine",), [], "engine: need a mapping"),
    (("workload",), "x", "workload: need a mapping"),
    (("workload", "arrival"), 3, "arrival: need a mapping"),
    (("slo",), [1], "slo: need a mapping"),
    (("extra",), 1, "unknown top-level keys"),
    (("engine", "prefill_batch"), 0, "engine.prefill_batch"),
])
def test_validate_rejects_each_defect_class_as_jax_does(path, value,
                                                        complaint):
    spec = _mutated(path, value)
    defects = loadgen.validate_scenario(spec)
    assert any(complaint in d for d in defects), defects
    # the same complaints as the JAX function's, but for the list of
    # known architectures in the arch complaint (both name the whole zoo)
    jdefects = jloadgen.validate_scenario(spec)
    assert len(defects) == len(jdefects)
    for a, b in zip(defects, jdefects):
        assert a.split(" not in ")[0] == b.split(" not in ")[0]


def test_validate_reports_all_defects_at_once():
    spec = _mutated(("engine", "slots"), 0)
    spec["workload"]["requests"] = 0
    spec["slo"]["p99_latency_s"] = -1
    assert len(loadgen.validate_scenario(spec)) >= 3
    assert loadgen.validate_scenario([1, 2]) == \
        jloadgen.validate_scenario([1, 2]) == \
        ["spec must be a mapping, got list"]


def test_prefill_batch_requires_paged():
    spec = _mutated(("engine", "paged"), False)
    spec["engine"]["prefill_batch"] = 2
    assert any("requires engine.paged" in d
               for d in loadgen.validate_scenario(spec))


def test_json_specs_load_without_yaml(tmp_path, monkeypatch):
    p = tmp_path / "s.json"
    p.write_text(json.dumps(BASE))
    monkeypatch.setattr(loadgen, "yaml", None)
    assert loadgen.load_scenario(p) == BASE
    y = tmp_path / "s.yaml"
    y.write_text("schema: scenario/v1\n")
    with pytest.raises(RuntimeError, match="pyyaml"):
        loadgen.load_scenario(y)


def test_load_scenario_raises_listing_defects(tmp_path):
    p = tmp_path / "bad.json"
    p.write_text(json.dumps(_mutated(("engine", "slots"), 0)))
    with pytest.raises(ValueError, match="engine.slots"):
        loadgen.load_scenario(p)


def _yaml_or_skip():
    if loadgen.yaml is None:
        pytest.skip("pyyaml not installed")


def test_all_golden_scenarios_validate_and_equal_the_jax_parse():
    _yaml_or_skip()
    files = loadgen.scenario_files(GOLDEN)
    assert [p.name for p in files] == [p.name for p in
                                       jloadgen.scenario_files(GOLDEN)]
    assert len(files) >= 4
    for p in files:
        assert loadgen.load_scenario(p) == jloadgen.load_scenario(p)


def test_chip_smoke_scenarios_equal_the_golden_files():
    """The card has no pyyaml: `chip_smoke.py` holds its scenarios as
    dicts, which must stay the golden files' parse."""
    _yaml_or_skip()
    sys.path.insert(0, str(REPO))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(REPO))
    golden = {p.stem for p in loadgen.scenario_files(GOLDEN)}
    assert golden == {"smoke_gqa", "paged_mixed", "paged_mla", "ssm_state"}
    # the golden files, and Qwen 1.5's int8 cache, which is no golden
    # file (the JAX suite globs that directory)
    assert set(chip_smoke.LOADGEN_SCENARIOS) == golden | {"int8_cache"}
    for name in golden:
        assert chip_smoke.LOADGEN_SCENARIOS[name] == loadgen.load_scenario(
            GOLDEN / f"{name}.yaml"), name
    qwen = chip_smoke.LOADGEN_SCENARIOS["int8_cache"]
    assert loadgen.validate_scenario(qwen) == \
        jloadgen.validate_scenario(qwen) == []
    assert qwen["arch"] == "qwen1p5_32b" and qwen["engine"]["paged"]
    # every scenario runs: its architecture is in the port
    assert all(spec["arch"] in ARCH_IDS
               for spec in chip_smoke.LOADGEN_SCENARIOS.values())


# ---------------------------------------------------------------------------
# Workload construction and SLO evaluation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("process", ["poisson", "uniform"])
def test_build_requests_equals_the_jax_stream(process):
    spec = _mutated(("workload", "arrival", "process"), process)
    spec["workload"]["requests"] = 9
    got = loadgen.build_requests(get_config("llama3p2_3b", smoke=True), spec)
    want = jloadgen.build_requests(jget_config("llama3p2_3b", smoke=True),
                                   spec)
    assert [r.arrival for r in got] == [r.arrival for r in want]
    assert [r.max_new for r in got] == [r.max_new for r in want]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.tokens, b.tokens)
    if process == "uniform":
        assert [r.arrival for r in got] == [(i + 1) / 8.0 for i in range(9)]
    else:
        assert [r.arrival for r in got] == sorted(r.arrival for r in got)


@pytest.mark.parametrize("row", [
    {"latency_p99_s": 2.0, "tok_per_s": 5.0, "latency_mean_s": None},
    {"latency_p99_s": 3.0, "tok_per_s": 6.0, "latency_mean_s": 1.0},
    {"latency_p99_s": None, "tok_per_s": 0.0, "latency_mean_s": 0.5},
])
def test_evaluate_slo_equals_jax(row):
    slo = {"p99_latency_s": 3.0, "min_tok_per_s": 6.0,
           "mean_latency_s": 1.0}
    assert loadgen.evaluate_slo(slo, row) == jloadgen.evaluate_slo(slo, row)
    out = loadgen.evaluate_slo(slo, row)
    if row["latency_mean_s"] is None:
        assert out["mean_latency_s"]["pass"] is False


# ---------------------------------------------------------------------------
# BENCH_serve.json check()
# ---------------------------------------------------------------------------

def _row(paged=False):
    return {
        "scenario": "s_paged" if paged else "s_cont",
        "arch": "llama3p2_3b", "slots": 2, "max_len": 32,
        "paged": paged, "block_size": 8 if paged else None,
        "num_blocks": 9 if paged else None, "prefill_batch": 1,
        "requests": 2, "tokens": 12, "tok_per_s": 3.0,
        "latency_mean_s": 1.0, "latency_p50_s": 1.0, "latency_p99_s": 2.0,
        "latency_max_s": 2.5, "queue_wait_mean_s": 0.1, "decode_steps": 6,
        "peak_active": 2, "peak_blocks": 5 if paged else None,
        "peak_cache_rows": 40 if paged else 64,
        "reserved_rows_contiguous": 64,
        "slo": {"p99_latency_s":
                {"target": 10.0, "measured": 2.0, "pass": True}},
        "slo_pass": True, "platform": "gpu",
    }


def _write(tmp_path, doc, name="b.json"):
    p = tmp_path / name
    p.write_text(json.dumps(doc))
    return str(p)


def test_check_accepts_wellformed(tmp_path, capsys):
    doc = {"schema": "bench_serve/v1", "rows": [_row(False), _row(True)]}
    path = _write(tmp_path, doc)
    assert loadgen.check(path) == jloadgen.check(path) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0] == out[1]                       # the same report


@pytest.mark.parametrize("corrupt", [
    lambda d: d.update(schema="bench/v1"),
    lambda d: d.update(rows=[]),
    lambda d: d["rows"][0].pop("latency_p99_s"),
    lambda d: d["rows"][0].update(slo_pass="yes"),
    lambda d: d["rows"][0].update(platform=""),
    lambda d: d["rows"][0].update(paged=1),
    lambda d: d["rows"][0].update(reserved_rows_contiguous=63),
    lambda d: d["rows"][0].update(block_size=8),
    lambda d: d["rows"][0].update(peak_cache_rows=60),
    lambda d: d["rows"][1].update(peak_cache_rows=41),
    lambda d: d["rows"][1].update(peak_blocks=None),
    lambda d: d["rows"][0].update(slo={"p99_latency_s": {"target": 1.0}}),
    lambda d: d["rows"][0].update(slo=[]),
    lambda d: d["rows"][0].update(slo={"p42": {"target": 1.0,
                                               "measured": 1.0,
                                               "pass": True}}),
    lambda d: d["rows"][0].update(latency_p99_s=None),
])
def test_check_rejects_each_corruption_with_jaxs_report(tmp_path, capsys,
                                                        corrupt):
    doc = {"schema": "bench_serve/v1", "rows": [_row(False), _row(True)]}
    corrupt(doc)
    path = _write(tmp_path, doc)
    assert loadgen.check(path) == jloadgen.check(path) == 1
    out = capsys.readouterr().out.splitlines()
    assert out[0] == out[1]


def test_check_unreadable(tmp_path):
    p = tmp_path / "junk.json"
    p.write_text("{nope")
    assert loadgen.check(str(p)) == 1
    assert loadgen.check(str(tmp_path / "absent.json")) == 1


# ---------------------------------------------------------------------------
# The golden scenarios through the port
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def rows():
    """One row per golden scenario the port runs, on the smoke configs."""
    if loadgen.yaml is None:
        pytest.skip("pyyaml not installed")
    return {name: loadgen.run_scenario(
        loadgen.load_scenario(GOLDEN / f"{name}.yaml"), smoke=True,
        verbose=False, device="cpu")
        for name in ("smoke_gqa", "paged_mixed", "paged_mla", "ssm_state")}


@pytest.mark.parametrize("name", ["smoke_gqa", "paged_mixed", "paged_mla",
                                  "ssm_state"])
def test_golden_scenario_rows(rows, name, tmp_path):
    row = rows[name]
    spec = loadgen.load_scenario(GOLDEN / f"{name}.yaml")
    assert set(row) == set(loadgen.ROW_KEYS)
    assert row["scenario"] == name and row["arch"] == spec["arch"]
    assert row["platform"] == "cpu"
    assert row["requests"] == spec["workload"]["requests"]
    reqs = loadgen.build_requests(get_config(spec["arch"], smoke=True), spec)
    assert row["tokens"] == sum(r.max_new for r in reqs)
    assert row["reserved_rows_contiguous"] == \
        spec["engine"]["slots"] * spec["engine"]["max_len"]
    assert isinstance(row["slo_pass"], bool)
    assert set(row["slo"]) == set(spec["slo"])
    if row["paged"]:
        # the memory the paged engine saves: below the worst case
        assert row["peak_cache_rows"] == row["peak_blocks"] * \
            row["block_size"] < row["reserved_rows_contiguous"]
    else:
        assert row["peak_blocks"] is None and row["block_size"] is None
    path = _write(tmp_path, {"schema": "bench_serve/v1", "rows": [row]})
    assert loadgen.check(path) == 0
    assert jloadgen.check(path) == 0              # the JAX reader agrees


def test_port_rows_pass_diff_serve(rows, tmp_path):
    doc = {"schema": "bench_serve/v1", "rows": list(rows.values())}
    new = tmp_path / "new" / "BENCH_serve.json"
    new.parent.mkdir()
    new.write_text(json.dumps(doc))
    assert diff_serve.main([str(new), str(new)]) == 0
    found, _ = diff_serve.find_bench(str(new.parent))
    assert found == doc
    # a paged occupancy that grows is gated without tolerance
    grown = copy.deepcopy(doc)
    for r in grown["rows"]:
        if r["paged"]:
            r["peak_blocks"] += 1
            r["peak_cache_rows"] += r["block_size"]
    old = tmp_path / "old.json"
    old.write_text(json.dumps(grown))
    assert diff_serve.main([str(old), str(new)]) == 1


def test_run_suite_names_the_waiting_scenario(tmp_path):
    """`ssm_state` (Mamba 2) and `chip_smoke.py`'s `int8_cache` (Qwen 1.5
    on its int8 cache, paged, batched prefill) run in one suite: no
    architecture waits any more. Their rows pass the JAX `check()` and
    `scripts/diff_serve.py`; the Qwen row's paged bookkeeping holds."""
    _yaml_or_skip()
    sys.path.insert(0, str(REPO))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(REPO))
    qwen = chip_smoke.LOADGEN_SCENARIOS["int8_cache"]
    src = tmp_path / "int8_cache.json"
    src.write_text(json.dumps(qwen))
    doc = loadgen.run_suite([GOLDEN / "smoke_gqa.yaml",
                             GOLDEN / "ssm_state.yaml", src], verbose=False,
                            device="cpu")
    assert [r["scenario"] for r in doc["rows"]] == ["smoke_gqa", "ssm_state",
                                                   "int8_cache"]
    ssm, row = doc["rows"][1], doc["rows"][2]
    assert ssm["arch"] == "mamba2_2p7b" and not ssm["paged"]
    assert ssm["requests"] == 5 and ssm["platform"] == "cpu"
    assert row["arch"] == "qwen1p5_32b" and row["paged"]
    assert row["requests"] == qwen["workload"]["requests"]
    assert row["prefill_batch"] == qwen["engine"]["prefill_batch"]
    assert row["peak_cache_rows"] < row["reserved_rows_contiguous"]
    path = tmp_path / "new" / "BENCH_serve.json"
    path.parent.mkdir()
    path.write_text(json.dumps(doc))
    assert loadgen.check(str(path)) == jloadgen.check(str(path)) == 0
    assert diff_serve.main([str(path), str(path)]) == 0
    # the depth cut (`layers=`) that the card's run of it takes
    cut = loadgen.run_scenario(qwen, verbose=False, device="cpu", layers=1)
    assert cut["requests"] == row["requests"]


@pytest.mark.parametrize("arch", ["whisper_tiny", "internvl2_26b"])
def test_run_scenario_serves_the_encoder_and_patch_archs(arch, tmp_path):
    """A scenario of Whisper or InternVL2 runs, paged: each request
    carries its frames or patches (`synth_request_stream`), InternVL2's 8
    patch rows take blocks beside the prompt, and the row passes the JAX
    `check()`."""
    spec = copy.deepcopy(BASE)
    spec.update(name=arch, arch=arch)
    row = loadgen.run_scenario(spec, verbose=False, device="cpu")
    assert row["arch"] == arch and row["paged"] and row["requests"] == 2
    reqs = loadgen.build_requests(get_config(arch, smoke=True), spec)
    assert row["tokens"] == sum(r.max_new for r in reqs)
    patches = get_config(arch, smoke=True).patch_tokens
    assert row["peak_cache_rows"] >= max(patches + r.prompt_len + r.max_new
                                         for r in reqs)
    path = _write(tmp_path, {"schema": "bench_serve/v1", "rows": [row]})
    assert loadgen.check(path) == jloadgen.check(path) == 0


def test_main_runs_a_json_scenario_and_checks_it(tmp_path, capsys):
    spec = copy.deepcopy(BASE)
    spec["arch"] = "mixtral_8x7b"
    spec["engine"]["prefill_batch"] = 2
    src = tmp_path / "s.json"
    src.write_text(json.dumps(spec))
    out = tmp_path / "B.json"
    assert loadgen.main(["--scenario", str(src), "--out", str(out),
                         "--device", "cpu"]) == 0
    assert loadgen.main(["--check", str(out)]) == 0
    row = json.loads(out.read_text())["rows"][0]
    assert row["arch"] == "mixtral_8x7b" and row["prefill_batch"] == 2
    strict = copy.deepcopy(spec)
    strict["slo"] = {"min_tok_per_s": 1e12}
    src.write_text(json.dumps(strict))
    assert loadgen.main(["--scenario", str(src), "--out", str(out),
                         "--device", "cpu", "--strict-slo"]) == 1
    assert "SLO misses" in capsys.readouterr().out


def test_run_scenario_runs_on_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("this check is for machines without a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        loadgen.run_scenario(BASE)
