"""Counters, gauges, and fixed-bucket latency histograms.

The PyTorch port's copy of the JAX package's `obs/metrics.py`, kept
line-for-line so both packages write the same `obsmetrics/v1`
documents. Stdlib only: `repro_torch.core.export` records into it from
numpy-only code.

Why histograms, not raw samples: a `stats()` surface that keeps a
python list of raw latencies grows with traffic on a long-lived server
and sorts per stats read. A
`Histogram` is a fixed array of log-spaced bucket counts: O(1) memory,
O(1) observe, and p50/p90/p99 derivable by walking cumulative counts.
The price is bucket resolution (`RESOLUTION`, ~12% with the default 20
buckets/decade); `count`/`sum`/`min`/`max` are tracked exactly, so
`mean` and `max` never lose precision and quantiles clamp into
[min, max] (an all-equal sample reports its exact value back).
"""
from __future__ import annotations

import bisect
import math

# default latency bucket range: 1 µs .. 1000 s, 20 buckets per decade
# (each bucket is a 10^(1/20) ≈ 1.122x span — ~12% relative resolution)
DEFAULT_LO = 1e-6
DEFAULT_HI = 1e3
DEFAULT_PER_DECADE = 20
RESOLUTION = 10.0 ** (1.0 / DEFAULT_PER_DECADE)

QUANTILES = (0.5, 0.9, 0.99)


def exact_quantile(sorted_vals, q: float) -> float:
    """Nearest-rank order statistic of an ascending sequence — the oracle
    the histogram's bucket walk is checked against (tests/test_obs.py):
    the element at rank max(1, ceil(q·n)). `Histogram.quantile_bounds(q)`
    must bracket exactly this value whenever it is inside [lo, hi)."""
    n = len(sorted_vals)
    if not n:
        raise ValueError("exact_quantile of an empty sequence")
    if not 0.0 <= q <= 1.0:
        raise ValueError(f"quantile {q} outside [0, 1]")
    return sorted_vals[max(1, math.ceil(q * n)) - 1]


class Counter:
    """Monotonic event count."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0

    def inc(self, n: int = 1) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name}: negative increment {n}")
        self.value += n

    def to_json(self) -> int:
        return self.value


class Gauge:
    """Last-write-wins instantaneous value (None until first set)."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = None

    def set(self, v: float) -> None:
        self.value = float(v)

    def to_json(self):
        return self.value


class Histogram:
    """Fixed log-spaced bucket histogram with derivable quantiles.

    Bucket i spans [edges[i], edges[i+1]) — closed below, open above —
    with dedicated underflow (< edges[0]) and overflow (>= edges[-1])
    counts, so `observe` never loses a sample. `quantile(q)` walks the
    cumulative counts to the bucket holding the rank-max(1, ceil(q·n))
    sample and returns that bucket's upper edge clamped into the exact
    [min, max] envelope: a series of identical values (e.g. the injected
    zero clock in the serve tests) reports its exact value at every
    quantile, and no quantile ever exceeds the true maximum.
    """

    __slots__ = ("lo", "hi", "per_decade", "edges", "buckets", "underflow",
                 "overflow", "count", "sum", "min", "max")

    def __init__(self, *, lo: float = DEFAULT_LO, hi: float = DEFAULT_HI,
                 per_decade: int = DEFAULT_PER_DECADE):
        if not 0 < lo < hi:
            raise ValueError(f"need 0 < lo < hi, got ({lo}, {hi})")
        if per_decade < 1:
            raise ValueError(f"need per_decade >= 1, got {per_decade}")
        n = round(per_decade * math.log10(hi / lo))
        if n < 1:
            raise ValueError(f"({lo}, {hi}) spans no bucket at "
                             f"{per_decade}/decade")
        self.lo, self.hi, self.per_decade = float(lo), float(hi), per_decade
        log_lo = math.log10(lo)
        self.edges = [10.0 ** (log_lo + i / per_decade) for i in range(n + 1)]
        self.edges[0], self.edges[-1] = float(lo), float(hi)  # exact ends
        self.buckets = [0] * n
        self.underflow = 0
        self.overflow = 0
        self.count = 0
        self.sum = 0.0
        self.min = None
        self.max = None

    def bucket_index(self, v: float) -> int:
        """-1 = underflow, len(buckets) = overflow, else the bucket i with
        edges[i] <= v < edges[i+1]."""
        if v < self.edges[0]:
            return -1
        if v >= self.edges[-1]:
            return len(self.buckets)
        return bisect.bisect_right(self.edges, v) - 1

    def observe(self, v: float) -> None:
        v = float(v)
        self.count += 1
        self.sum += v
        self.min = v if self.min is None else min(self.min, v)
        self.max = v if self.max is None else max(self.max, v)
        i = self.bucket_index(v)
        if i < 0:
            self.underflow += 1
        elif i >= len(self.buckets):
            self.overflow += 1
        else:
            self.buckets[i] += 1

    @property
    def mean(self):
        return self.sum / self.count if self.count else None

    def _rank_bucket(self, q: float) -> int:
        """Bucket index (underflow/overflow conventions of bucket_index)
        holding the rank-max(1, ceil(q*count)) sample."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile {q} outside [0, 1]")
        rank = max(1, math.ceil(q * self.count))
        cum = self.underflow
        if rank <= cum:
            return -1
        for i, c in enumerate(self.buckets):
            cum += c
            if rank <= cum:
                return i
        return len(self.buckets)

    def quantile_bounds(self, q: float):
        """(lo, hi) edges of the bucket holding the q-order statistic —
        `exact_quantile(sorted_samples, q)` lies in [lo, hi). None when
        empty. Underflow reports (-inf, lo); overflow (hi, inf)."""
        if not self.count:
            return None
        i = self._rank_bucket(q)
        if i < 0:
            return (-math.inf, self.edges[0])
        if i >= len(self.buckets):
            return (self.edges[-1], math.inf)
        return (self.edges[i], self.edges[i + 1])

    def quantile(self, q: float):
        """Upper edge of the q-order-statistic's bucket, clamped into the
        exact [min, max] envelope; None when empty."""
        if not self.count:
            return None
        i = self._rank_bucket(q)
        upper = self.edges[0] if i < 0 else \
            self.edges[min(i + 1, len(self.edges) - 1)]
        return min(max(upper, self.min), self.max)

    def to_json(self) -> dict:
        doc = {
            "lo": self.lo, "hi": self.hi, "per_decade": self.per_decade,
            "count": self.count, "sum": self.sum,
            "min": self.min, "max": self.max,
            "underflow": self.underflow, "overflow": self.overflow,
            "buckets": {str(i): c for i, c in enumerate(self.buckets) if c},
        }
        for q in QUANTILES:
            doc[f"p{int(q * 100)}"] = self.quantile(q)
        return doc


def validate_histogram_json(name: str, doc) -> None:
    """Raise ValueError unless `doc` is a well-formed Histogram.to_json
    payload (the obsmetrics/v1 schema check leans on this)."""
    if not isinstance(doc, dict):
        raise ValueError(f"histogram {name!r}: not an object")
    for k in ("lo", "hi", "per_decade", "count", "sum", "underflow",
              "overflow", "buckets"):
        if k not in doc:
            raise ValueError(f"histogram {name!r}: missing key {k!r}")
    for q in QUANTILES:
        if f"p{int(q * 100)}" not in doc:
            raise ValueError(f"histogram {name!r}: missing p{int(q * 100)}")
    if not isinstance(doc["buckets"], dict):
        raise ValueError(f"histogram {name!r}: buckets not an object")
    in_range = sum(doc["buckets"].values())
    total = in_range + doc["underflow"] + doc["overflow"]
    if total != doc["count"]:
        raise ValueError(
            f"histogram {name!r}: bucket counts {total} != count "
            f"{doc['count']} — buckets, underflow and overflow must "
            "partition the observations")
    if doc["count"] and (doc["min"] is None or doc["max"] is None):
        raise ValueError(f"histogram {name!r}: non-empty but min/max unset")


def fmt_seconds(v, spec: str = ".3f") -> str:
    """None-safe second formatting for stats prints: the stable stats
    schemas report latencies as None before any request completes, and
    `f"{None:.3f}"` is a TypeError — every CLI print goes through here."""
    return "n/a" if v is None else format(v, spec)
