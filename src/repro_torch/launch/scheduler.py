"""Micro-batching serve path for WNN artifact inference (port of
`repro/launch/scheduler.py::WnnBatcher`).

Requests queue on the host; each `step()` serves up to `slots` of them
through ONE fixed-shape scores launch over the artifact's prepared tables
on the device. The LM serve engine and the multi-tenant and class-sharded
batchers belong to later slices of the port.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import registry as obs_registry
from repro_torch.obs import torchhooks


@dataclasses.dataclass
class WnnResult:
    """One served classification request."""
    rid: int
    scores: np.ndarray                 # (M,) int32 ensemble scores
    pred: int
    t_submit: float
    t_done: Optional[float] = None     # None = queued (a finish at 0.0 counts)

    @property
    def latency(self) -> float:
        return self.t_done - self.t_submit


class WnnBatcher:
    """Requests queue, each `step()` serves up to `slots` of them through
    one fixed-shape scores launch.

    The tables are prepared exactly once (`core.export.prepare_artifact` —
    for the default packed backends the uint32 bitplanes go to the device
    verbatim, never expanded to int8), and every launch has the shape
    `(slots, total_bits)`: partial batches pad with zero rows whose
    outputs are dropped, so admission depth never changes the launch.
    `trace_counts["batch_scores"]` counts the distinct batch shapes
    launched (`obs.torchhooks.counted`), so tests can assert it stays 1.

        batcher = WnnBatcher(artifact, slots=64, backend="auto")
        rid = batcher.submit(encoded_bits_row)
        results = batcher.drain()      # -> [WnnResult]
    """

    def __init__(self, artifact, *, slots: int = 64, backend: str = "auto",
                 device=DEFAULT_DEVICE, clock: Callable = None):
        from repro_torch.core import export as export_mod
        if slots < 1:
            raise ValueError("need slots >= 1")
        self.device = resolve_device(device)
        self.artifact = artifact
        self.slots = slots
        self.backend = backend
        self.total_bits = int(artifact.total_bits)
        self.clock = clock or time.perf_counter
        self._prep = export_mod.prepare_artifact(artifact, backend=backend,
                                                 device=self.device)
        self.trace_counts: collections.Counter = collections.Counter()
        self.lat_hist = obs_metrics.Histogram()

        def _batch_scores(prep, bits):
            # THE serve loop, shared with artifact_scores — semantics
            # cannot drift between the one-shot and batch paths
            scores, _ = export_mod.predict_from_prep(prep, bits,
                                                     backend=backend)
            return scores

        self._scores = torchhooks.counted(_batch_scores, self.trace_counts,
                                          "batch_scores")
        self.queue: collections.deque = collections.deque()
        self.results: dict = {}
        self._next_rid = 0
        self.batches = 0
        self.served = 0

    def submit(self, bits) -> int:
        """Queue one encoded input (total_bits,) {0,1}; returns its rid."""
        bits = np.asarray(bits).reshape(-1)
        if bits.shape[0] != self.total_bits:
            raise ValueError(f"request has {bits.shape[0]} bits, artifact "
                             f"encodes {self.total_bits}")
        rid = self._next_rid
        self._next_rid += 1
        self.results[rid] = WnnResult(rid=rid, scores=None, pred=-1,
                                      t_submit=self.clock())
        self.queue.append((rid, bits.astype(np.uint8)))
        return rid

    def step(self) -> int:
        """Serve up to `slots` queued requests in one fixed-shape launch;
        returns the number served (0 when idle)."""
        if not self.queue:
            return 0
        rec = obs_registry.get_recorder()
        take = min(self.slots, len(self.queue))
        batch = np.zeros((self.slots, self.total_bits), np.uint8)
        rids = []
        for i in range(take):
            rid, bits = self.queue.popleft()
            batch[i] = bits
            rids.append(rid)
        with rec.span("wnn.batch", take=take):
            # .cpu() waits for the device: the span covers the whole launch
            scores = self._scores(
                self._prep, torch.from_numpy(batch).to(self.device)
            ).cpu().numpy()
        t = self.clock()
        lat_hist_global = rec.histogram("serve.wnn.latency_s")
        for i, rid in enumerate(rids):
            res = self.results[rid]
            res.scores = scores[i]
            res.pred = int(np.argmax(scores[i]))   # ties: first class
            res.t_done = t
            self.lat_hist.observe(res.latency)
            lat_hist_global.observe(res.latency)
        self.batches += 1
        self.served += take
        return take

    def drain(self) -> List[WnnResult]:
        """Serve until the queue is empty; results in rid order."""
        while self.queue:
            self.step()
        return [self.results[rid] for rid in sorted(self.results)]

    def stats(self) -> dict:
        """Batch-serving stats; the JAX batcher's stable key set
        (latencies None before any request finishes). Quantiles come from
        the fixed-bucket latency histogram: bucket-resolution p50/p99,
        exact mean/max. `class_shards` is 1: this slice serves on one
        device."""
        done = [r for r in self.results.values() if r.t_done is not None]
        occupancy = self.served / max(1, self.batches * self.slots)
        h = self.lat_hist
        return {"requests": len(done), "batches": self.batches,
                "submitted": self._next_rid, "served": self.served,
                "queued": len(self.queue),
                "class_shards": 1,
                "occupancy": occupancy,
                "traces": int(self.trace_counts["batch_scores"]),
                "latency_mean_s": h.mean,
                "latency_p50_s": h.quantile(0.5),
                "latency_p99_s": h.quantile(0.99),
                "latency_max_s": h.max}
