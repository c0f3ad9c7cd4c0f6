"""Serving example: every cache family, synchronous and continuous (port
of `examples/serve_lm.py`).

Spins up three smoke-size models with different sequence mixers — the
GQA ring buffer (Mixtral's sliding window), Mamba 2's SSM state and the
RG-LRU's recurrent state — and serves each two ways:

1. one synchronous batch through `serve()` (prefill and lockstep decode);
2. a Poisson request stream through the continuous-batching `Engine`:
   more requests than cache slots, with mixed prompt and generation
   lengths, admitted into freed slots mid-decode.

Greedy decode makes the two paths comparable token for token, so the
example doubles as a service smoke test: every request of the stream must
equal `serve()` of its prompt alone.

    PYTHONPATH=src python -m repro_torch.examples.serve_lm --device cpu

Without `--device` it runs on the GPU, and raises when there is none.
"""
import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.launch.scheduler import Engine, synth_request_stream
from repro_torch.launch.serve import serve
from repro_torch.models import transformer
from repro_torch.obs.metrics import fmt_seconds

ARCHS = ["mixtral_8x7b", "mamba2_2p7b", "recurrentgemma_2b"]
MAX_LEN = 64
SLOTS = 3


def smoke_config(arch: str):
    """The arch's smoke config; an MoE's expert capacity lifted so routing
    never drops a token: capacity is shared by a batch's rows, and a
    dropped token would make batch-1 and batch-4 decode differ."""
    cfg = get_config(arch, smoke=True)
    if cfg.num_experts:
        cfg = dataclasses.replace(cfg, capacity_factor=8.0)
    return cfg


def prompts_for(cfg) -> np.ndarray:
    """Four 24-token prompts, drawn with numpy from seed 1."""
    rng = np.random.default_rng(1)
    return rng.integers(0, cfg.vocab_size, (4, 24), dtype=np.int32)


def serve_arch(cfg, params, prompts: np.ndarray, *, device) -> dict:
    """One model both ways; returns its synchronous tokens (4, 16), each
    stream request's tokens and the engine's stats. Raises if `serve()`
    is not deterministic or a stream request differs from `serve()` of
    its prompt alone."""
    dev = resolve_device(device)
    t0 = time.perf_counter()
    toks = serve(cfg, params, torch.from_numpy(prompts), max_len=MAX_LEN,
                 gen=16).cpu()
    dt = time.perf_counter() - t0
    again = serve(cfg, params, torch.from_numpy(prompts), max_len=MAX_LEN,
                  gen=16).cpu()
    assert torch.equal(toks, again), f"{cfg.name}: serve() not deterministic"
    print(f"{cfg.name:24s} sync   {toks.shape[1]} tokens x "
          f"{toks.shape[0]} requests in {dt:5.2f}s "
          f"| sample: {toks[0, :8].tolist()}")

    # continuous batching: 8 requests > 3 slots, mixed lengths, Poisson
    # arrivals; every request must match the synchronous path
    stream = synth_request_stream(cfg, 8, rate=200.0, seed=2,
                                  prompt_lens=(8, 16, 24),
                                  gen_lens=(6, 12, 16))
    eng = Engine(cfg, params, slots=SLOTS, max_len=MAX_LEN, device=dev)
    t0 = time.perf_counter()
    results = eng.run(stream)
    dt = time.perf_counter() - t0
    for req, res in zip(sorted(stream, key=lambda r: r.arrival), results,
                        strict=True):
        assert len(res.tokens) == req.max_new, (res.rid, res.tokens)
        ref = serve(cfg, params, torch.from_numpy(req.tokens[None]),
                    max_len=MAX_LEN, gen=req.max_new)[0].cpu().tolist()
        assert res.tokens == ref, (f"{cfg.name} engine diverged from sync "
                                   f"serve on rid {res.rid}")
    st = eng.stats()
    # latencies are None until a request completes: format None-safe
    print(f"{cfg.name:24s} stream {st['tokens']} tokens / "
          f"{st['requests']} requests in {dt:5.2f}s "
          f"| {st['decode_steps']} decode steps, peak "
          f"{st['peak_active']}/{SLOTS} slots, mean/p99 latency "
          f"{fmt_seconds(st['latency_mean_s'])}/"
          f"{fmt_seconds(st['latency_p99_s'])}s")
    return {"sync": toks, "stream": [r.tokens for r in results],
            "stats": st}


def main(device=DEFAULT_DEVICE, params_for=None) -> dict:
    """Serve every arch of ARCHS; returns {arch: `serve_arch`'s dict}.
    `params_for(cfg)` gives a model's parameters (drawn on the device
    from seed 0 when None)."""
    dev = resolve_device(device)
    out = {}
    for arch in ARCHS:
        cfg = smoke_config(arch)
        if params_for is None:
            gen = torch.Generator(device=dev).manual_seed(0)
            params = transformer.init_params(cfg, gen, device=dev)
        else:
            params = params_for(cfg)
        out[arch] = serve_arch(cfg, params, prompts_for(cfg), device=dev)
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default=DEFAULT_DEVICE,
                    help="cuda (the default) or cpu")
    main(device=ap.parse_args().device)
