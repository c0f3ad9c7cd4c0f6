"""repro_torch.obs — spans, counters and latency histograms.

Stdlib-only copies of the JAX package's `metrics`, `trace` and `registry`
(same `obsmetrics/v1` schema), plus `torchhooks.counted`, the eager
PyTorch counterpart of the JAX package's retrace counter.

    from repro_torch.obs import registry as obs
    with obs.recording() as rec:
        run()
        rec.write("METRICS.json")
"""
from repro_torch.obs.metrics import (Counter, Gauge, Histogram,
                                     exact_quantile, fmt_seconds)
from repro_torch.obs.registry import (SCHEMA, NullRecorder, Recorder,
                                      get_recorder, load_metrics, recording,
                                      set_recorder, validate_snapshot)
from repro_torch.obs.trace import JsonlSink, NullSpan, Span, read_jsonl

__all__ = [
    "Counter", "Gauge", "Histogram", "exact_quantile", "fmt_seconds",
    "SCHEMA", "NullRecorder", "Recorder", "get_recorder", "load_metrics",
    "recording", "set_recorder", "validate_snapshot",
    "JsonlSink", "NullSpan", "Span", "read_jsonl",
]
