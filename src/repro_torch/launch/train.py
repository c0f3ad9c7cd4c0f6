"""LM training driver (port of `repro/launch/train.py`, the LM archs).

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3p2_3b \\
        --smoke --steps 6 --batch 2 --seq 32 --device cpu

`train()` draws the parameters on the device from a seeded generator,
builds the JAX package's optimizer (AdamW under a warm-up-cosine
schedule, behind global-norm clipping at 1.0) and runs
`steps.make_train_step` (bf16 compute over float32 master weights by
default) over `data_iterator`'s synthetic token stream, with a
`StragglerMonitor` on every step (the `train.step_s` histogram) and the
`train.steps` counter. Without `--device` it runs on the GPU, and raises
when there is none. `--profile DIR` wraps the run in a `torch.profiler`
trace written into DIR; `--metrics-out PATH` writes the run's metrics
and the card's memory gauges.

Checkpoints (`--ckpt-dir`, `--restore`), the production and ULEEN meshes
(`--production-mesh`, `--mesh`), compressed cross-pod reduction
(`--compress`) and the distributed ULEEN trainer (`--arch uleen`) are
the training infrastructure of ROADMAP.md Queue 1 item 5: the port has
not taken them yet, and those flags exit with an error that says so.
"""
from __future__ import annotations

import argparse
import contextlib
import sys

import torch

from repro_torch.configs.base import ARCH_IDS, get_config
from repro_torch.data.synth import make_lm_tokens
from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.launch import steps
from repro_torch.models import transformer
from repro_torch.obs import registry as obs_registry
from repro_torch.obs import torchhooks
from repro_torch.train import fault
from repro_torch.train import optimizer as opt_lib

WARMUP_STEPS = 10
CLIP_NORM = 1.0


def data_iterator(cfg, batch: int, seq: int, seed: int, *,
                  start_step: int = 0, device=DEFAULT_DEVICE):
    """Deterministic synthetic LM stream, restart-safe (seeded by step):
    yields (step, {"tokens", "labels"}) with (batch, seq) int32 tokens and
    their next tokens, and (batch, F, D) `frames` or (batch, P, D)
    `patches` (normal x 0.02) where the model takes them. Step s draws
    its tokens from `data.synth.make_lm_tokens` seeded with
    seed·1,000,003 + s, and its frames or patches from a `torch.Generator`
    on the device with the same seed. The JAX package derives its draws
    from a threefry key of that integer, so the numbers differ from its
    stream; their distributions do not."""
    dev = resolve_device(device)
    n_tok = batch * (seq + 1)
    step = start_step
    while True:
        key = seed * 1_000_003 + step
        toks = make_lm_tokens(key, cfg.vocab_size, n_tok,
                              device=dev).reshape(batch, seq + 1)
        out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        gen = torch.Generator(device=dev).manual_seed(key)
        for name, rows in (("frames", cfg.encoder_layers
                            and cfg.encoder_frames),
                           ("patches", cfg.patch_tokens)):
            if rows:
                out[name] = torch.randn((batch, rows, cfg.d_model),
                                        generator=gen, device=dev) * 0.02
        yield step, out
        step += 1


def train(cfg, *, steps_total: int, batch: int, seq: int, lr: float = 3e-4,
          microbatches: int = 1, seed: int = 0,
          compute_dtype=torch.bfloat16, log_every: int = 10,
          guard: fault.PreemptionGuard | None = None, verbose: bool = True,
          device=DEFAULT_DEVICE) -> dict:
    """Train `cfg` for `steps_total` steps of (batch, seq) tokens on
    `device`: float32 master weights from a generator seeded `seed`,
    `chain_clip(adamw(warmup_cosine_schedule(lr, 10, steps_total)), 1.0)`,
    `compute_dtype` compute (None: float32). Stops early at a step
    boundary once `guard` reports a preemption. Returns {"params",
    "opt_state", "history" (one {"step", "loss", "aux", "grad_norm"} a
    step), "preempted", "straggler_events"}."""
    dev = resolve_device(device)
    optimizer = opt_lib.chain_clip(
        opt_lib.adamw(opt_lib.warmup_cosine_schedule(lr, WARMUP_STEPS,
                                                     steps_total)),
        CLIP_NORM)
    step_fn = steps.make_train_step(cfg, optimizer,
                                    microbatches=microbatches,
                                    compute_dtype=compute_dtype)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = transformer.init_params(cfg, gen, dtype=torch.float32,
                                     device=dev)
    opt_state = optimizer.init(steps.tree_leaves(params))

    rec = obs_registry.get_recorder()
    monitor = fault.StragglerMonitor()
    history = []
    preempted = False
    for step, data in data_iterator(cfg, batch, seq, seed, device=dev):
        if step >= steps_total:
            break
        monitor.start()
        params, opt_state, metrics = step_fn(params, opt_state, data)
        metrics = {k: float(v) for k, v in metrics.items()}  # waits
        ev = monitor.stop(step)   # observes train.step_s
        rec.counter("train.steps").inc()
        history.append({"step": step, **metrics})
        if verbose and (step % log_every == 0 or step == steps_total - 1):
            print(f"[train] step {step}: loss={metrics['loss']:.4f} "
                  f"gnorm={metrics['grad_norm']:.3f}"
                  + (f" STRAGGLER x{ev.ratio:.1f}" if ev else ""))
        if guard is not None and guard.preempted:
            preempted = True
            if verbose:
                print(f"[train] preempted after step {step}")
            break
    return {"params": params, "opt_state": opt_state, "history": history,
            "preempted": preempted,
            "straggler_events": len(monitor.events)}


# flags of the JAX driver that wait for ROADMAP.md Queue 1 item 5, with
# the value each takes when it is not given
ITEM_5_FLAGS = {"ckpt_dir": None, "restore": "auto",
                "production_mesh": False, "mesh": "data=1",
                "compress": False}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", choices=list(ARCH_IDS) + ["uleen"],
                    required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=DEFAULT_DEVICE,
                    help="cuda (default) or cpu")
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="wrap the run in a torch.profiler trace (host and "
                         "CUDA activities) written into DIR as a Chrome "
                         "trace (Perfetto viewable)")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="write an obsmetrics/v1 METRICS.json snapshot of "
                         "the run (step-time histogram, straggler EWMA, "
                         "device memory) to PATH")
    # the JAX driver's training infrastructure: refused below
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--restore", choices=["auto", "none"], default="auto")
    ap.add_argument("--production-mesh", action="store_true")
    ap.add_argument("--mesh", default="data=1")
    ap.add_argument("--compress", action="store_true")
    args = ap.parse_args(argv)

    waiting = [f"--{name.replace('_', '-')}"
               for name, default in ITEM_5_FLAGS.items()
               if getattr(args, name) != default]
    if args.arch == "uleen":
        waiting.insert(0, "--arch uleen")
    if waiting:
        ap.error(f"{', '.join(waiting)}: checkpoints, meshes, compressed "
                 f"reduction and the distributed ULEEN trainer are ROADMAP.md "
                 f"Queue 1 item 5, not in the port yet")

    dev = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)

    def _run() -> int:
        with fault.PreemptionGuard() as guard:
            out = train(cfg, steps_total=args.steps, batch=args.batch,
                        seq=args.seq, lr=args.lr,
                        microbatches=args.microbatches, seed=args.seed,
                        guard=guard, device=dev)
        losses = [h["loss"] for h in out["history"]]
        if losses:
            print(f"[train] done: first loss {losses[0]:.4f} -> "
                  f"last {losses[-1]:.4f} over {len(losses)} steps on {dev}")
        return 0

    with contextlib.ExitStack() as stack:
        rec = None
        if args.metrics_out:
            rec = stack.enter_context(obs_registry.recording())
        stack.enter_context(torchhooks.profile_trace(args.profile))
        rc = _run()
        if rec is not None:
            torchhooks.record_device_memory(rec)
            rec.write(args.metrics_out)
            print(f"[train] metrics: {len(rec.spans)} spans, "
                  f"{sum(c.value for c in rec.counters.values())} counter "
                  f"events -> {args.metrics_out}")
    return rc


if __name__ == "__main__":
    sys.exit(main())
