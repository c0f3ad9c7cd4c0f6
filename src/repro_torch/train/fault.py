"""Fault tolerance for the train loop: preemption handling and straggler
monitoring (a copy of `repro/train/fault.py`; stdlib and the port's own
`obs` only).

* PreemptionGuard — SIGTERM/SIGINT set a flag; the train loop checkpoints
  at the next step boundary and exits cleanly (a restart resumes through
  `checkpoint.restore_latest`).
* StragglerMonitor — per-step wall-time EWMA; steps slower than
  `threshold x` the EWMA are flagged. On a real fleet the launcher feeds
  this into its replacement policy; here it raises structured events the
  trainer logs and tests assert on.
"""
from __future__ import annotations

import dataclasses
import signal
import time
from typing import Callable, Optional

from repro_torch.obs import registry as obs_registry


class PreemptionGuard:
    def __init__(self, signals=(signal.SIGTERM,)):
        self._requested = False
        self._signals = signals
        self._prev = {}

    def __enter__(self):
        for sig in self._signals:
            self._prev[sig] = signal.signal(sig, self._handler)
        return self

    def __exit__(self, *exc):
        for sig, prev in self._prev.items():
            signal.signal(sig, prev)
        return False

    def _handler(self, signum, frame):
        self._requested = True

    @property
    def preempted(self) -> bool:
        return self._requested

    def request(self) -> None:   # test hook
        self._requested = True


@dataclasses.dataclass
class StragglerEvent:
    step: int
    duration: float
    ewma: float
    ratio: float


class StragglerMonitor:
    """Flags steps (or, per-host on a fleet, participants) that run slower
    than `threshold` x the EWMA step time."""

    def __init__(self, threshold: float = 2.0, alpha: float = 0.1,
                 warmup_steps: int = 3,
                 on_straggler: Optional[Callable] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.threshold = threshold
        self.alpha = alpha
        self.warmup = warmup_steps
        self.ewma: Optional[float] = None
        self.events: list = []
        self._on = on_straggler
        self._clock = clock   # injectable: fault-drill tests feed a fake
        self._seen = 0
        self._t0: Optional[float] = None

    def start(self) -> None:
        self._t0 = self._clock()

    def stop(self, step: int) -> Optional[StragglerEvent]:
        dt = self._clock() - self._t0
        self._seen += 1
        ev = None
        if self.ewma is None:
            self.ewma = dt
        else:
            if self._seen > self.warmup and dt > self.threshold * self.ewma:
                ev = StragglerEvent(step=step, duration=dt, ewma=self.ewma,
                                    ratio=dt / self.ewma)
                self.events.append(ev)
                if self._on:
                    self._on(ev)
            self.ewma = (1 - self.alpha) * self.ewma + self.alpha * dt
        # every monitored loop exports the step-time histogram + EWMA
        # gauge for free (DESIGN §12); a NullRecorder makes these no-ops
        rec = obs_registry.get_recorder()
        rec.histogram("train.step_s").observe(dt)
        rec.gauge("train.straggler_ewma_s").set(self.ewma)
        if ev is not None:
            rec.counter("train.straggler_events").inc()
            rec.event("straggler", step=step, duration=dt, ratio=ev.ratio)
        return ev
