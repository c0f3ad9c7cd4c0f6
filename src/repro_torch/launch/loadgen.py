"""Declarative load harness for the serve engine (port of
`repro/launch/loadgen.py`).

A *scenario* is a small YAML or JSON spec — arrival process, prompt and
generation length mix, engine geometry, SLO targets — validated against
the `scenario/v1` schema and driven through `serve.serve_stream`. Each
run gives one `bench_serve/v1` row: latency p50/p99 from the engine's
histograms, slot and block occupancy, and SLO pass/fail. Rows have the
JAX package's keys and types, so `scripts/diff_serve.py` and the JAX
`check()` read the port's files as they read the JAX package's.

    PYTHONPATH=src python -m repro_torch.launch.loadgen \\
        --scenario tests/golden/scenarios/paged_mixed.yaml \\
        --out build/BENCH_serve.json
    PYTHONPATH=src python -m repro_torch.launch.loadgen --suite \\
        tests/golden/scenarios --out build/BENCH_serve.json --device cpu
    PYTHONPATH=src python -m repro_torch.launch.loadgen \\
        --check build/BENCH_serve.json

Without `--device` the scenarios run on the GPU, and raise when there is
none; `--full` takes the published configs instead of the smoke ones
(`run_scenario(layers=)` cuts a published depth one card cannot hold,
its width kept). YAML specs need `pyyaml`; JSON specs never do. A
scenario may name any architecture of the zoo.

Differences from the JAX module: parameters are drawn from a
`torch.Generator` seeded 0 on the device (not `PRNGKey(0)`), so rows agree
with the JAX package's in schema and bookkeeping, not token for token;
`platform` is "gpu" on the card and "cpu" on the CPU, the names
`jax.default_backend()` gives them.

The point of the paged rows: `peak_cache_rows` (blocks touched ×
block_size) below `reserved_rows_contiguous` (slots × max_len) is the
memory the paged engine saves against the worst-case reservation.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys
from typing import List

from repro_torch.device import DEFAULT_DEVICE

try:                 # pyyaml is optional; JSON specs work without it
    import yaml
except ImportError:  # pragma: no cover - exercised by patching yaml = None
    yaml = None

SCHEMA = "scenario/v1"
BENCH_SCHEMA = "bench_serve/v1"

ARRIVAL_PROCESSES = ("poisson", "uniform")

# bench_serve/v1 row keys: `check()` requires every one on every row
ROW_KEYS = (
    "scenario", "arch", "slots", "max_len", "paged", "block_size",
    "num_blocks", "prefill_batch", "requests", "tokens", "tok_per_s",
    "latency_mean_s", "latency_p50_s", "latency_p99_s", "latency_max_s",
    "queue_wait_mean_s", "decode_steps", "peak_active", "peak_blocks",
    "peak_cache_rows", "reserved_rows_contiguous", "slo", "slo_pass",
    "platform",
)

# slo key -> (bench row metric, direction): "max" means the measured
# value must stay <= the target, "min" means >=
SLO_METRICS = {
    "p50_latency_s": ("latency_p50_s", "max"),
    "p99_latency_s": ("latency_p99_s", "max"),
    "mean_latency_s": ("latency_mean_s", "max"),
    "queue_wait_mean_s": ("queue_wait_mean_s", "max"),
    "min_tok_per_s": ("tok_per_s", "min"),
}


# ---------------------------------------------------------------------------
# Scenario loading and validation
# ---------------------------------------------------------------------------

def load_scenario(path) -> dict:
    """Parse one scenario file (.yaml/.yml needs pyyaml, .json never
    does) and validate it; raises ValueError listing every defect."""
    p = pathlib.Path(path)
    text = p.read_text()
    if p.suffix in (".yaml", ".yml"):
        if yaml is None:
            raise RuntimeError(
                f"{p}: YAML scenario but pyyaml is not installed; use a "
                ".json spec")
        spec = yaml.safe_load(text)
    else:
        spec = json.loads(text)
    defects = validate_scenario(spec)
    if defects:
        raise ValueError(f"{p}: invalid scenario:\n  " +
                         "\n  ".join(defects))
    return spec


def _is_int(v) -> bool:
    return isinstance(v, int) and not isinstance(v, bool)


def _is_number(v) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool)


def validate_scenario(spec) -> List[str]:
    """Every `scenario/v1` defect in `spec` (an empty list: valid), all at
    once, so a malformed spec reports everything wrong with it. `arch`
    may be any architecture of the zoo."""
    from repro_torch.configs.base import ARCH_IDS as zoo
    out: List[str] = []
    if not isinstance(spec, dict):
        return [f"spec must be a mapping, got {type(spec).__name__}"]
    if spec.get("schema") != SCHEMA:
        out.append(f"schema {spec.get('schema')!r} != {SCHEMA!r}")
    if not isinstance(spec.get("name"), str) or not spec.get("name"):
        out.append("name: need a non-empty string")
    if spec.get("arch") not in zoo:
        out.append(f"arch {spec.get('arch')!r} not in {sorted(zoo)}")

    unknown = set(spec) - {"schema", "name", "arch", "engine", "workload",
                           "slo"}
    if unknown:
        out.append(f"unknown top-level keys {sorted(unknown)}")

    eng = spec.get("engine")
    if not isinstance(eng, dict):
        out.append("engine: need a mapping")
        eng = {}
    unknown = set(eng) - {"slots", "max_len", "paged", "block_size",
                          "num_blocks", "prefill_batch", "bucket"}
    if unknown:
        out.append(f"engine: unknown keys {sorted(unknown)}")
    for k in ("slots", "max_len"):
        v = eng.get(k)
        if not _is_int(v) or v < 1:
            out.append(f"engine.{k}: need int >= 1, got {v!r}")
    paged = eng.get("paged", False)
    if not isinstance(paged, bool):
        out.append(f"engine.paged: need bool, got {paged!r}")
        paged = False
    bs = eng.get("block_size", 16)
    if not _is_int(bs) or bs < 1:
        out.append(f"engine.block_size: need int >= 1, got {bs!r}")
    elif paged and _is_int(eng.get("max_len")) and eng["max_len"] % bs:
        out.append(f"engine.max_len {eng['max_len']} not a multiple of "
                   f"block_size {bs}")
    nb = eng.get("num_blocks")
    if nb is not None and (not _is_int(nb) or nb < 2):
        out.append(f"engine.num_blocks: need int >= 2 or null, got {nb!r}")
    pb = eng.get("prefill_batch", 1)
    if not _is_int(pb) or pb < 1:
        out.append(f"engine.prefill_batch: need int >= 1, got {pb!r}")
    elif pb > 1 and not paged:
        out.append("engine.prefill_batch > 1 requires engine.paged: true")
    if eng.get("bucket") not in (None, "pow2"):
        out.append(f"engine.bucket: need null or 'pow2', got "
                   f"{eng.get('bucket')!r}")

    wl = spec.get("workload")
    if not isinstance(wl, dict):
        out.append("workload: need a mapping")
        wl = {}
    unknown = set(wl) - {"requests", "seed", "arrival", "prompt_lens",
                         "gen_lens"}
    if unknown:
        out.append(f"workload: unknown keys {sorted(unknown)}")
    req = wl.get("requests")
    if not _is_int(req) or req < 1:
        out.append(f"workload.requests: need int >= 1, got {req!r}")
    seed = wl.get("seed", 0)
    if not _is_int(seed):
        out.append(f"workload.seed: need int, got {seed!r}")
    arr = wl.get("arrival", {})
    if not isinstance(arr, dict):
        out.append("workload.arrival: need a mapping")
        arr = {}
    if arr.get("process", "poisson") not in ARRIVAL_PROCESSES:
        out.append(f"workload.arrival.process: need one of "
                   f"{ARRIVAL_PROCESSES}, got {arr.get('process')!r}")
    rate = arr.get("rate", 64.0)
    if not _is_number(rate) or rate <= 0:
        out.append(f"workload.arrival.rate: need number > 0, got {rate!r}")
    for k in ("prompt_lens", "gen_lens"):
        v = wl.get(k)
        if (not isinstance(v, list) or not v
                or not all(_is_int(x) and x >= 1 for x in v)):
            out.append(f"workload.{k}: need a non-empty list of ints >= 1")
    # cross-field: the worst-case mix must fit the engine
    lens = [wl.get("prompt_lens"), wl.get("gen_lens")]
    if (isinstance(eng.get("max_len"), int)
            and all(isinstance(v, list) and v for v in lens)
            and all(isinstance(x, int) for v in lens for x in v)):
        worst = max(wl["prompt_lens"]) + max(wl["gen_lens"])
        if worst > eng["max_len"]:
            out.append(f"workload mix needs up to {worst} cache rows, "
                       f"engine.max_len is {eng['max_len']}")

    slo = spec.get("slo", {})
    if not isinstance(slo, dict):
        out.append("slo: need a mapping")
        slo = {}
    for k, v in slo.items():
        if k not in SLO_METRICS:
            out.append(f"slo.{k}: unknown target (known: "
                       f"{sorted(SLO_METRICS)})")
        elif not _is_number(v) or v <= 0:
            out.append(f"slo.{k}: need number > 0, got {v!r}")
    return out


# ---------------------------------------------------------------------------
# Workload construction and scenario execution
# ---------------------------------------------------------------------------

def build_requests(cfg, spec) -> list:
    """The request stream of a validated scenario: Poisson draws
    exponential gaps (`scheduler.synth_request_stream`, the same numpy
    draws as the JAX package's); uniform spaces arrivals exactly 1/rate
    apart, with the same length mix."""
    from repro_torch.launch.scheduler import synth_request_stream
    wl = spec["workload"]
    arr = wl.get("arrival", {})
    rate = float(arr.get("rate", 64.0))
    reqs = synth_request_stream(
        cfg, int(wl["requests"]), rate=rate, seed=int(wl.get("seed", 0)),
        prompt_lens=tuple(wl["prompt_lens"]),
        gen_lens=tuple(wl["gen_lens"]))
    if arr.get("process", "poisson") == "uniform":
        for i, r in enumerate(reqs):
            r.arrival = (i + 1) / rate
    return reqs


def evaluate_slo(slo: dict, row: dict) -> dict:
    """slo target -> {'target', 'measured', 'pass'} per key. A metric that
    is None (no completed request) fails its target: an SLO never
    measured is not met."""
    out = {}
    for k, target in slo.items():
        metric, direction = SLO_METRICS[k]
        v = row.get(metric)
        if v is None:
            ok = False
        elif direction == "max":
            ok = v <= target
        else:
            ok = v >= target
        out[k] = {"target": float(target), "measured": v, "pass": bool(ok)}
    return out


def run_scenario(spec: dict, *, smoke: bool = True, verbose: bool = True,
                 device=DEFAULT_DEVICE, layers=None) -> dict:
    """Drive one validated scenario through the stream engine on `device`
    (all requests queued at once: `realtime=False`); returns its
    bench_serve/v1 row. `layers`: the model's depth, where it must be cut
    below the config's (its width kept)."""
    import dataclasses

    import torch

    from repro_torch.configs.base import get_config
    from repro_torch.device import resolve_device
    from repro_torch.launch import serve as serve_mod
    from repro_torch.models import transformer

    dev = resolve_device(device)
    cfg = get_config(spec["arch"], smoke=smoke)
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=int(layers))
    eng_spec = spec["engine"]
    gen = torch.Generator(device=dev).manual_seed(0)
    params = transformer.init_params(cfg, gen, dtype=torch.float32,
                                     device=dev)
    reqs = build_requests(cfg, spec)
    _, eng = serve_mod.serve_stream(
        cfg, params, reqs, slots=int(eng_spec["slots"]),
        max_len=int(eng_spec["max_len"]),
        paged=bool(eng_spec.get("paged", False)),
        block_size=int(eng_spec.get("block_size", 16)),
        num_blocks=eng_spec.get("num_blocks"),
        prefill_batch=int(eng_spec.get("prefill_batch", 1)),
        bucket=eng_spec.get("bucket"), realtime=False, verbose=verbose,
        device=dev)
    st = eng.stats()
    slots, max_len = int(eng_spec["slots"]), int(eng_spec["max_len"])
    if st["paged"]:
        peak_rows = st["peak_blocks"] * st["block_size"]
    else:
        peak_rows = slots * max_len      # contiguous pins the worst case
    row = {
        "scenario": spec["name"],
        "arch": spec["arch"],
        "slots": slots,
        "max_len": max_len,
        "paged": st["paged"],
        "block_size": st["block_size"],
        "num_blocks": st["num_blocks"],
        "prefill_batch": int(eng_spec.get("prefill_batch", 1)),
        "requests": st["requests"],
        "tokens": st["tokens"],
        "tok_per_s": st["tok_per_s"],
        "latency_mean_s": st["latency_mean_s"],
        "latency_p50_s": st["latency_p50_s"],
        "latency_p99_s": st["latency_p99_s"],
        "latency_max_s": st["latency_max_s"],
        "queue_wait_mean_s": st["queue_wait_mean_s"],
        "decode_steps": st["decode_steps"],
        "peak_active": st["peak_active"],
        "peak_blocks": st["peak_blocks"],
        "peak_cache_rows": peak_rows,
        "reserved_rows_contiguous": slots * max_len,
        "platform": "gpu" if dev.type == "cuda" else "cpu",
    }
    row["slo"] = evaluate_slo(spec.get("slo", {}), row)
    row["slo_pass"] = all(v["pass"] for v in row["slo"].values())
    return row


def run_suite(paths, *, smoke: bool = True, verbose: bool = True,
              device=DEFAULT_DEVICE) -> dict:
    """Run every scenario file; returns the BENCH_serve document."""
    rows = []
    for p in paths:
        spec = load_scenario(p)
        if verbose:
            print(f"[loadgen] scenario {spec['name']} ({spec['arch']}) "
                  f"from {p}")
        row = run_scenario(spec, smoke=smoke, verbose=verbose, device=device)
        if verbose:
            occ = (f"{row['peak_cache_rows']}/"
                   f"{row['reserved_rows_contiguous']} rows"
                   if row["paged"] else "contiguous")
            print(f"[loadgen]   {row['requests']} requests, "
                  f"p99 {row['latency_p99_s']}, {occ}, "
                  f"slo_pass={row['slo_pass']}")
        rows.append(row)
    return {"schema": BENCH_SCHEMA, "rows": rows}


def scenario_files(root) -> list:
    rootp = pathlib.Path(root)
    return sorted(p for p in rootp.iterdir()
                  if p.suffix in (".yaml", ".yml", ".json"))


# ---------------------------------------------------------------------------
# BENCH_serve.json schema check
# ---------------------------------------------------------------------------

def _row_defect(row: dict):
    """The first defect of one bench_serve/v1 row, or None."""
    missing = [k for k in ROW_KEYS if k not in row]
    if missing:
        return f"missing keys {missing}"
    if not isinstance(row["slo_pass"], bool):
        return f"slo_pass={row['slo_pass']!r} (must be bool)"
    if not isinstance(row["platform"], str) or not row["platform"]:
        return f"platform={row['platform']!r}"
    if not isinstance(row["paged"], bool):
        return f"paged={row['paged']!r}"
    if row["requests"] and not (_is_number(row["latency_p99_s"])
                                and row["latency_p99_s"] >= 0):
        return (f"latency_p99_s={row['latency_p99_s']!r} with "
                f"{row['requests']} completed requests")
    reserved = row["slots"] * row["max_len"]
    if row["reserved_rows_contiguous"] != reserved:
        return (f"reserved_rows_contiguous="
                f"{row['reserved_rows_contiguous']} != slots*max_len="
                f"{reserved}")
    if row["paged"]:
        if not _is_int(row["peak_blocks"]) \
                or not _is_int(row["block_size"]):
            return (f"paged but peak_blocks={row['peak_blocks']!r} "
                    f"block_size={row['block_size']!r}")
        if row["peak_cache_rows"] != row["peak_blocks"] * row["block_size"]:
            return (f"peak_cache_rows={row['peak_cache_rows']} != "
                    f"peak_blocks*block_size="
                    f"{row['peak_blocks'] * row['block_size']}")
    else:
        if row["peak_blocks"] is not None or row["block_size"] is not None:
            return (f"contiguous but peak_blocks={row['peak_blocks']!r} "
                    f"block_size={row['block_size']!r} (must be null)")
        if row["peak_cache_rows"] != reserved:
            return (f"contiguous peak_cache_rows={row['peak_cache_rows']} "
                    f"!= reserved {reserved}")
    if not isinstance(row["slo"], dict):
        return f"slo={row['slo']!r}"
    for k, v in row["slo"].items():
        if k not in SLO_METRICS or not isinstance(v, dict) \
                or not {"target", "measured", "pass"} <= set(v):
            return f"malformed slo entry {k!r}: {v!r}"
    return None


def check(path: str) -> int:
    """Validate a BENCH_serve.json: schema string, row keys, types and the
    paged bookkeeping. Returns 0 when well-formed; prints the first
    defect and returns 1 otherwise."""
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, json.JSONDecodeError) as exc:
        print(f"[check] {path}: unreadable/malformed: {exc}")
        return 1
    if doc.get("schema") != BENCH_SCHEMA:
        print(f"[check] {path}: schema {doc.get('schema')!r} != "
              f"{BENCH_SCHEMA!r}")
        return 1
    rows = doc.get("rows")
    if not isinstance(rows, list) or not rows:
        print(f"[check] {path}: no rows")
        return 1
    for i, row in enumerate(rows):
        defect = _row_defect(row)
        if defect:
            print(f"[check] {path}: row {i} {defect}")
            return 1
    print(f"[check] {path}: ok ({len(rows)} rows, "
          f"{sum(r['paged'] for r in rows)} paged, "
          f"{sum(not r['slo_pass'] for r in rows)} SLO failures)")
    return 0


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    mode = ap.add_mutually_exclusive_group(required=True)
    mode.add_argument("--scenario", metavar="FILE",
                      help="run one scenario spec")
    mode.add_argument("--suite", metavar="DIR",
                      help="run every .yaml/.yml/.json scenario in DIR")
    mode.add_argument("--check", metavar="FILE",
                      help="validate an existing BENCH_serve.json and exit")
    ap.add_argument("--out", default="BENCH_serve.json",
                    help="output path (default %(default)s)")
    ap.add_argument("--full", action="store_true",
                    help="full-size configs instead of smoke geometry")
    ap.add_argument("--strict-slo", action="store_true",
                    help="exit 1 when any scenario misses an SLO target")
    ap.add_argument("--device", default=DEFAULT_DEVICE,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    if args.check:
        return check(args.check)

    paths = ([args.scenario] if args.scenario
             else scenario_files(args.suite))
    if not paths:
        print(f"[loadgen] no scenario files under {args.suite}")
        return 1
    doc = run_suite(paths, smoke=not args.full, device=args.device)
    with open(args.out, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
    print(f"[loadgen] wrote {len(doc['rows'])} row(s) -> {args.out}")
    failed = [r["scenario"] for r in doc["rows"] if not r["slo_pass"]]
    if failed:
        print(f"[loadgen] SLO misses: {failed}")
        if args.strict_slo:
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
