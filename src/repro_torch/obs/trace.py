"""Spans and structured JSONL event emission.

The PyTorch port's copy of the JAX package's `obs/trace.py`. A `Span`
is one timed region — name, start/end from an *injected* clock (the
recorder owns a `clock` callable, tests inject a fake, production
defaults to `time.perf_counter`), nesting depth, parent ordinal, and
free-form `attrs`. Spans read host scalars (shapes, ids, wall time)
only — never a device tensor, which would synchronise the stream — so
an instrumented serve run stays bit-exact with an uninstrumented one.

`JsonlSink` appends one JSON object per line, flushing each write, so a
crash mid-run loses at most the in-flight event.
"""
from __future__ import annotations

import dataclasses
import json
import time


@dataclasses.dataclass
class Span:
    """One timed region. `index` is the recorder-wide ordinal (stable
    across the JSONL stream and the METRICS.json snapshot); `parent` is
    the enclosing span's ordinal or None at top level."""

    name: str
    t0: float
    attrs: dict = dataclasses.field(default_factory=dict)
    t1: float = None
    depth: int = 0
    index: int = 0
    parent: int = None

    @property
    def dur_s(self):
        return None if self.t1 is None else self.t1 - self.t0

    def to_json(self) -> dict:
        return {
            "name": self.name, "t0": self.t0, "t1": self.t1,
            "dur_s": self.dur_s, "depth": self.depth, "index": self.index,
            "parent": self.parent, "attrs": dict(self.attrs),
        }


class NullSpan:
    """Span stand-in returned by the disabled recorder: it still *times*
    (callers like `dryrun.lower_cell` read `sp.dur_s` for their record
    dicts) but records and emits nothing. Uses `time.perf_counter`
    directly — the null recorder has no injected clock, and nothing
    deterministic ever asserts on a null span's duration."""

    __slots__ = ("t0", "t1", "attrs")

    def __init__(self):
        self.t0 = None
        self.t1 = None
        self.attrs = {}

    @property
    def dur_s(self):
        return None if self.t1 is None or self.t0 is None else self.t1 - self.t0

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.t1 = time.perf_counter()
        return False


class JsonlSink:
    """Append-only JSONL event stream. One flush per event: telemetry
    must survive the process dying mid-serve."""

    def __init__(self, path):
        self.path = str(path)
        self._fh = open(self.path, "a", encoding="utf-8")

    def emit(self, obj: dict) -> None:
        self._fh.write(json.dumps(obj, sort_keys=True) + "\n")
        self._fh.flush()

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None


def read_jsonl(path):
    """Parse a JSONL event stream back into a list of dicts (tests and
    `scripts/diff_metrics.py`)."""
    out = []
    with open(path, encoding="utf-8") as fh:
        for line in fh:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out
