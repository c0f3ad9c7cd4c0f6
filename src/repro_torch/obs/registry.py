"""Process-global metrics recorder and the versioned METRICS.json
snapshot (`obsmetrics/v1`).

The PyTorch port's copy of the JAX package's `obs/registry.py`: the
same schema and validation, so `scripts/diff_metrics.py` reads the
port's snapshots unchanged. Two levels:

* **Object-local instruments** (the latency histogram inside
  `WnnBatcher`) are always on — `stats()` works with zero
  configuration.
* **The global recorder** is *opt-in*: the default is `NullRecorder`,
  whose counters/gauges/histograms/spans are all no-ops, so the hot
  paths pay one attribute call per event when observability is off.
  Callers install a real `Recorder` via `recording()`.

`snapshot()` emits a schema-stable document: every counter in
`DEFAULT_COUNTERS` is present (zero-valued if untouched) in every
snapshot, so two snapshots diff field-by-field without existence
checks. `validate_snapshot` is the schema check.
"""
from __future__ import annotations

import contextlib
import json
import os
import threading
import time

from repro_torch.obs import metrics as _metrics
from repro_torch.obs import trace as _trace

SCHEMA = "obsmetrics/v1"

# Counters pre-registered on every real Recorder so snapshots have a
# stable key set (zero until the instrumented path runs). The port
# registers the counters of the paths it serves.
DEFAULT_COUNTERS = (
    "torch.shape.batch_scores",   # WnnBatcher distinct batch shapes
    "prep.cache_hit",             # prepare_artifact memo hits
    "prep.cache_miss",            # prepare_artifact builds
)


class Recorder:
    """Named counters/gauges/histograms plus a span stack, snapshotting
    to `obsmetrics/v1`. `clock` is injectable (tests pass a fake);
    `jsonl_path` optionally streams every span end / event as JSONL;
    `max_spans` bounds snapshot memory — beyond it spans still emit to
    the sink but only `spans_dropped` grows (a long serve run must not
    accumulate unbounded span objects, the same bound-the-host-memory
    rule that moved latencies off raw lists)."""

    enabled = True

    def __init__(self, *, clock=None, jsonl_path=None, max_spans: int = 4096):
        self.clock = clock if clock is not None else time.perf_counter
        self.max_spans = int(max_spans)
        self.counters = {}
        self.gauges = {}
        self.histograms = {}
        self.spans = []
        self.spans_dropped = 0
        self.events_emitted = 0
        self._n_spans = 0
        self._local = threading.local()
        self._sink = _trace.JsonlSink(jsonl_path) if jsonl_path else None
        for name in DEFAULT_COUNTERS:
            self.counter(name)

    # -- instruments ----------------------------------------------------
    def counter(self, name: str) -> _metrics.Counter:
        c = self.counters.get(name)
        if c is None:
            c = self.counters[name] = _metrics.Counter(name)
        return c

    def gauge(self, name: str) -> _metrics.Gauge:
        g = self.gauges.get(name)
        if g is None:
            g = self.gauges[name] = _metrics.Gauge(name)
        return g

    def histogram(self, name: str, **kw) -> _metrics.Histogram:
        h = self.histograms.get(name)
        if h is None:
            h = self.histograms[name] = _metrics.Histogram(**kw)
        return h

    # -- spans / events -------------------------------------------------
    def _stack(self):
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    @contextlib.contextmanager
    def span(self, name: str, **attrs):
        stack = self._stack()
        sp = _trace.Span(
            name=name, t0=self.clock(), attrs=attrs, depth=len(stack),
            index=self._n_spans,
            parent=stack[-1].index if stack else None)
        self._n_spans += 1
        stack.append(sp)
        try:
            yield sp
        finally:
            stack.pop()
            sp.t1 = self.clock()
            if len(self.spans) < self.max_spans:
                self.spans.append(sp)
            else:
                self.spans_dropped += 1
            self._emit({"ev": "span", **sp.to_json()})

    def event(self, name: str, **fields) -> None:
        self._emit({"ev": name, "t": self.clock(), **fields})

    def _emit(self, obj: dict) -> None:
        self.events_emitted += 1
        if self._sink is not None:
            self._sink.emit(obj)

    # -- snapshot -------------------------------------------------------
    def snapshot(self) -> dict:
        doc = {
            "schema": SCHEMA,
            "counters": {k: c.to_json()
                         for k, c in sorted(self.counters.items())},
            "gauges": {k: g.to_json()
                       for k, g in sorted(self.gauges.items())},
            "histograms": {k: h.to_json()
                           for k, h in sorted(self.histograms.items())},
            "spans": [sp.to_json() for sp in self.spans],
            "spans_dropped": self.spans_dropped,
            "events_emitted": self.events_emitted,
        }
        return validate_snapshot(doc)

    def write(self, path) -> dict:
        """Snapshot → validate → write METRICS.json (atomic rename, like
        the checkpoint layer). Returns the document."""
        doc = self.snapshot()
        path = str(path)
        tmp = path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as fh:
            json.dump(doc, fh, indent=2, sort_keys=True)
            fh.write("\n")
        os.replace(tmp, path)
        return doc

    def close(self) -> None:
        if self._sink is not None:
            self._sink.close()


class _NullCounter:
    __slots__ = ()
    value = 0

    def inc(self, n: int = 1) -> None:
        pass


class _NullGauge:
    __slots__ = ()
    value = None

    def set(self, v) -> None:
        pass


class _NullHistogram:
    __slots__ = ()
    count = 0
    sum = 0.0
    min = None
    max = None
    mean = None

    def observe(self, v) -> None:
        pass

    def quantile(self, q):
        return None


class NullRecorder:
    """The disabled default: every instrument is a shared no-op object,
    spans still time (callers read `dur_s`) but nothing is stored or
    emitted. `events_emitted` stays 0 by construction — the overhead
    test asserts exactly that."""

    enabled = False
    events_emitted = 0
    spans_dropped = 0

    _COUNTER = _NullCounter()
    _GAUGE = _NullGauge()
    _HIST = _NullHistogram()

    def counter(self, name: str) -> _NullCounter:
        return self._COUNTER

    def gauge(self, name: str) -> _NullGauge:
        return self._GAUGE

    def histogram(self, name: str, **kw) -> _NullHistogram:
        return self._HIST

    def span(self, name: str, **attrs) -> _trace.NullSpan:
        return _trace.NullSpan()

    def event(self, name: str, **fields) -> None:
        pass

    def snapshot(self) -> dict:
        return validate_snapshot({
            "schema": SCHEMA, "counters": {}, "gauges": {},
            "histograms": {}, "spans": [], "spans_dropped": 0,
            "events_emitted": 0,
        })

    def close(self) -> None:
        pass


_RECORDER = NullRecorder()


def get_recorder():
    """The process-global recorder (NullRecorder unless one was
    installed). Instrumented code calls this per event — never caches it
    across calls — so `recording()` scopes take effect immediately."""
    return _RECORDER


def set_recorder(rec):
    """Install `rec` as the global recorder; returns the previous one."""
    global _RECORDER
    prev = _RECORDER
    _RECORDER = rec
    return prev


@contextlib.contextmanager
def recording(rec: Recorder = None, **kw):
    """Scope a real Recorder as the global one, restoring the previous
    recorder (and closing the scoped one's sink) on exit:

        with obs.recording(jsonl_path=p) as rec:
            ... instrumented run ...
        doc = rec.snapshot()
    """
    rec = rec if rec is not None else Recorder(**kw)
    prev = set_recorder(rec)
    try:
        yield rec
    finally:
        set_recorder(prev)
        rec.close()


def validate_snapshot(doc) -> dict:
    """Schema check for `obsmetrics/v1` documents (the METRICS.json
    analogue of wnnlint's ANALYSIS.json check). Raises ValueError with a
    pinpointed message on any violation; returns `doc` unchanged."""
    if not isinstance(doc, dict):
        raise ValueError("obsmetrics: document is not an object")
    if doc.get("schema") != SCHEMA:
        raise ValueError(
            f"obsmetrics: schema {doc.get('schema')!r} != {SCHEMA!r}")
    for key, typ in (("counters", dict), ("gauges", dict),
                     ("histograms", dict), ("spans", list)):
        if not isinstance(doc.get(key), typ):
            raise ValueError(f"obsmetrics: {key!r} missing or wrong type")
    for key in ("spans_dropped", "events_emitted"):
        v = doc.get(key)
        if not isinstance(v, int) or v < 0:
            raise ValueError(f"obsmetrics: {key!r} must be an int >= 0")
    for name, v in doc["counters"].items():
        if not isinstance(v, int) or v < 0:
            raise ValueError(f"obsmetrics: counter {name!r} = {v!r} "
                             "is not an int >= 0")
    for name, v in doc["gauges"].items():
        if v is not None and not isinstance(v, (int, float)):
            raise ValueError(f"obsmetrics: gauge {name!r} = {v!r} "
                             "is not numeric or None")
    for name, h in doc["histograms"].items():
        _metrics.validate_histogram_json(name, h)
    for i, sp in enumerate(doc["spans"]):
        if not isinstance(sp, dict) or not sp.get("name"):
            raise ValueError(f"obsmetrics: span[{i}] missing name")
        for k in ("t0", "t1", "dur_s", "depth", "index", "parent", "attrs"):
            if k not in sp:
                raise ValueError(f"obsmetrics: span[{i}] missing key {k!r}")
        dur = sp["dur_s"]
        if dur is not None and dur < 0:
            raise ValueError(
                f"obsmetrics: span[{i}] ({sp['name']!r}) has negative "
                f"dur_s {dur} — clock went backwards?")
    return doc


def load_metrics(path) -> dict:
    """Read + validate a METRICS.json file."""
    with open(path, encoding="utf-8") as fh:
        return validate_snapshot(json.load(fh))
