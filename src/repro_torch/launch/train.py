"""Training driver (port of `repro/launch/train.py`): the LM archs and the
executed distributed ULEEN trainer.

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3p2_3b \\
        --smoke --steps 6 --batch 2 --seq 32 --device cpu --ckpt-dir ckpt

`train()` draws the parameters on the device from a seeded generator,
builds the JAX package's optimizer (AdamW under a warm-up-cosine
schedule, behind global-norm clipping at 1.0) and runs
`steps.make_train_step` (bf16 compute over float32 master weights by
default) over `data_iterator`'s synthetic token stream, with a
`StragglerMonitor` on every step (the `train.step_s` histogram) and the
`train.steps` counter. With a checkpoint directory it writes step-atomic
checkpoints every `ckpt_every` steps, at the end and at a preemption
(SIGTERM, through `PreemptionGuard`), and `restore="auto"` resumes from
the newest one (the `ckpt.save` and `ckpt.restore` spans). Without
`--device` it runs on the GPU, and raises when there is none.
`--profile DIR` wraps the run in a `torch.profiler` trace written into
DIR; `--metrics-out PATH` writes the run's metrics and the card's memory
gauges.

`--arch uleen` runs the paper's own multi-shot STE trainer data-parallel
over a mesh of rank processes (`launch/uleen_cell.py`): a deterministic
blocked gradient fold, bit-equal to the single-device blocked step on any
mesh, with optional int8 cross-pod gradient compression (`--compress`):

    PYTHONPATH=src python -m repro_torch.launch.train --arch uleen \\
        --mesh pod=2,data=4 --steps 12 --batch 256 --ckpt-dir ckpt \\
        --device cpu

The launcher starts prod(mesh) ranks (`launch.mesh.spawn_ranks`): gloo
on the CPU and for ranks that share a card, NCCL with one rank a card.
It forwards SIGTERM to every rank; the ranks agree on a preemption at
each step boundary (a MAX all-reduce of their flags), rank 0 writes the
checkpoint, and every rank resumes from the same newest step, on any
mesh. As in the JAX driver, the LM archs read neither `--mesh` nor
`--compress` (the LM step's compressed cross-pod reduction is
`steps.make_train_step(cross_pod_mesh=)`).

`train(mesh=)` trains an LM arch SPMD on a DeviceMesh of rank processes:
the weights and the AdamW state placed as DTensors by the logical-axis
rules (`dist.sharding.TRAIN_RULES`, the shardings of `launch/specs.py`),
each rank on its rows of every batch, logical checkpoints. `--production-
mesh` runs it on the 16 x 16 (data, model) production mesh, as one of
the 256 ranks that a launcher started, one card a rank:

    torchrun --nnodes 32 --nproc-per-node 8 --rdzv-backend c10d \\
        --rdzv-endpoint HOST:29500 -m repro_torch.launch.train \\
        --arch llama3p2_3b --production-mesh --steps 50 --ckpt-dir ckpt

Without a launcher, or in a world of another size, it exits with code 2
and names the ranks it needs and those it found.
"""
from __future__ import annotations

import argparse
import contextlib
import itertools
import math
import os
import signal
import sys
import time

import numpy as np
import torch

from repro_torch.configs.base import ARCH_IDS, get_config
from repro_torch.data.synth import make_lm_tokens
from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.launch import steps
from repro_torch.models import transformer
from repro_torch.obs import registry as obs_registry
from repro_torch.obs import torchhooks
from repro_torch.train import checkpoint, fault
from repro_torch.train import optimizer as opt_lib

WARMUP_STEPS = 10
CLIP_NORM = 1.0
# seconds a `--arch uleen` rank waits in one collective (its first waits
# for every rank to build its problem) before the run fails; the run
# itself lasts as long as its steps do
ULEEN_COLLECTIVE_TIMEOUT_S = 600.0


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
          microbatches: int = 1, seed: int = 0, mesh=None,
          ckpt_dir: str | None = None, ckpt_every: int = 20,
          restore: str = "auto", keep: int = 3,
          compute_dtype=torch.bfloat16, log_every: int = 10,
          guard: fault.PreemptionGuard | None = None, verbose: bool = True,
          device=DEFAULT_DEVICE) -> dict:
    """Train `cfg` for `steps_total` steps of (batch, seq) tokens on
    `device`: float32 master weights from a generator seeded `seed`,
    `chain_clip(adamw(warmup_cosine_schedule(lr, 10, steps_total)), 1.0)`,
    `compute_dtype` compute (None: float32). With `ckpt_dir`, checkpoints
    (params, opt_state) every `ckpt_every` steps (keeping `keep`), at a
    preemption and at the end, and resumes from the newest one when
    `restore` is "auto". Stops early at a step boundary once `guard`
    reports a preemption. Returns {"params", "opt_state", "history" (one
    {"step", "loss", "aux", "grad_norm"} a step), "preempted",
    "resumed_from", "straggler_events"}.

    `mesh` None or a `launch.mesh.HostMesh` trains in this process. A
    DeviceMesh makes the run SPMD, as the JAX package's `train(mesh=)`:
    every rank of the mesh calls it with the same arguments and `device`
    its own (`launch.mesh.rank_device`); the parameters and the AdamW
    state are placed under TRAIN_RULES (`steps.place_params`,
    `steps.place_opt_state`), every rank draws the same global batch and
    keeps its rows (`steps.place_batch`), the step runs under
    `use_placement`, the metrics are read whole (every rank logs the same
    loss), the ranks agree on a preemption at each step boundary (a MAX
    all-reduce), checkpoints are logical (`train.checkpoint` gathers
    each leaf; one rank writes) and only the mesh's first rank prints.
    The returned parameters and state are placed."""
    from repro_torch.dist import placed as placed_lib
    from repro_torch.dist import sharding as sh
    from repro_torch.launch.mesh import HostMesh
    dev = resolve_device(device)
    on_mesh = mesh is not None and not isinstance(mesh, HostMesh)
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
    rules = sh.TRAIN_RULES
    rank0 = True
    if on_mesh:
        params = steps.place_params(cfg, params, mesh, rules)
        rank0 = _rank0(mesh)
    opt_state = optimizer.init(steps.tree_leaves(params))
    if on_mesh:
        opt_state = steps.place_opt_state(cfg, optimizer, opt_state, mesh,
                                          rules)
    verbose = verbose and rank0

    rec = obs_registry.get_recorder()
    start = 0
    if ckpt_dir and restore == "auto":
        with rec.span("ckpt.restore"):
            restored, at = checkpoint.restore_latest(ckpt_dir,
                                                     (params, opt_state))
        if restored is not None:
            params, opt_state = restored
            start = at
            if verbose:
                print(f"[train] restored step {at} from {ckpt_dir}")

    monitor = fault.StragglerMonitor()
    history = []
    preempted = False
    for step, data in data_iterator(cfg, batch, seq, seed, start_step=start,
                                    device=dev):
        if step >= steps_total:
            break
        monitor.start()
        with (sh.use_placement(mesh, rules) if on_mesh
              else contextlib.nullcontext()):
            if on_mesh:
                data = steps.place_batch(data, mesh, rules)
            params, opt_state, metrics = step_fn(params, opt_state, data)
        metrics = {k: float(placed_lib.whole(v))      # waits
                   for k, v in metrics.items()}
        ev = monitor.stop(step)   # observes train.step_s
        rec.counter("train.steps").inc()
        history.append({"step": step, **metrics})
        if verbose and (step % log_every == 0 or step == steps_total - 1):
            print(f"[train] step {step}: loss={metrics['loss']:.4f} "
                  f"gnorm={metrics['grad_norm']:.3f}"
                  + (f" STRAGGLER x{ev.ratio:.1f}" if ev else ""))
        want_ckpt = ckpt_dir and (step + 1) % ckpt_every == 0
        stop = guard is not None and guard.preempted
        if on_mesh:
            stop = _agree(stop, mesh, dev)
        if stop:
            want_ckpt, preempted = bool(ckpt_dir), True
        if want_ckpt:
            with rec.span("ckpt.save", step=step + 1):
                checkpoint.save(ckpt_dir, step + 1, (params, opt_state),
                                keep=keep)
        if preempted:
            if verbose:
                print(f"[train] preempted after step {step}"
                      + (f"; checkpointed step {step + 1}" if ckpt_dir
                         else ""))
            break
    if ckpt_dir and not preempted and history:
        last = start + len(history)
        with rec.span("ckpt.save", step=last):
            checkpoint.save(ckpt_dir, last, (params, opt_state), keep=keep)
    return {"params": params, "opt_state": opt_state, "history": history,
            "preempted": preempted, "resumed_from": start,
            "straggler_events": len(monitor.events)}


# ---------------------------------------------------------------------------
# The executed distributed ULEEN trainer
# ---------------------------------------------------------------------------

def uleen_problem(spec, seed: int = 0, n_train: int = 2048, *, hw: int = 16,
                  device=DEFAULT_DEVICE):
    """(spec, statics, bits, labels) of a synthetic MNIST-like problem for
    `spec` (hw x hw pixels, spec.bits_per_input thermometer bits a pixel):
    the images, labels and statics are drawn from CPU generators seeded
    `seed` and seed + 1, so every rank and every process, on any device,
    rebuilds the same problem; the Gaussian thermometer is fitted on
    `device` and encodes there (the thermometer kernel on a GPU). The CPU
    work runs on one thread, so that no float of it depends on how many
    threads the building process has or finds free (the images' batched
    product goes to MKL). bits (n_train, total_bits) int8 and labels
    (n_train,) int64 on `device`."""
    from repro_torch.core.encoding import fit_gaussian_thermometer
    from repro_torch.core.model import init_static
    from repro_torch.data.synth import make_mnist_like
    from repro_torch.kernels import ops
    dev = resolve_device(device)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        data = make_mnist_like(torch.Generator().manual_seed(seed),
                               n_train=n_train, n_test=256, hw=hw,
                               device="cpu")
        x = data.x_train.to(dev)
        enc = fit_gaussian_thermometer(x, spec.bits_per_input, device=dev)
        bits = ops.thermometer(x, enc.thresholds, device=dev).reshape(
            n_train, -1)
        statics = init_static(torch.Generator().manual_seed(seed + 1), spec,
                              device=dev)
    finally:
        torch.set_num_threads(threads)
    if bits.shape[1] != spec.total_bits:
        raise ValueError(f"{hw} x {hw} pixels x {spec.bits_per_input} bits "
                         f"is not the spec's {spec.total_bits} bits")
    return spec, statics, bits, data.y_train.to(dev, torch.int64)


def uleen_smoke_problem(seed: int = 0, n_train: int = 2048, *,
                        device=DEFAULT_DEVICE):
    """`uleen_problem` on `uleen_cell.ULEEN_EXEC_SPEC` (16 x 16 pixels x 2
    bits): the deterministic smoke problem of the CLI and the tests."""
    from repro_torch.launch.uleen_cell import ULEEN_EXEC_SPEC
    return uleen_problem(ULEEN_EXEC_SPEC, seed, n_train, hw=16,
                         device=device)


def uleen_batch_indices(seed: int, step: int, n: int, batch: int) -> np.ndarray:
    """Batch row indices of `step`: a pure function of (seed, step), so a
    restored run replays the exact sample order of the run it resumes
    (numpy, as the JAX package draws them: the same rows)."""
    rng = np.random.default_rng(seed * 1_000_003 + step)
    return rng.integers(0, n, size=batch)


def _rank0(mesh) -> bool:
    from repro_torch.dist import collectives
    return collectives.axis_index(mesh, mesh.mesh_dim_names) == 0


def _agree(flag: bool, mesh, dev) -> bool:
    """Whether any rank of `mesh` raised `flag` (a MAX all-reduce: every
    rank gets the same answer; also a barrier over the mesh)."""
    from repro_torch.dist import collectives
    if math.prod(mesh.shape) == 1:
        return flag
    t = torch.tensor(int(flag), dtype=torch.int32, device=dev)
    return bool(collectives.all_reduce_max(t, mesh, mesh.mesh_dim_names))


def train_uleen(spec, statics, bits_train, labels_train, *,
                steps_total: int, global_batch: int = 256,
                lr: float = 1e-3, grad_blocks: int = 8,
                compress: bool = False, seed: int = 0, mesh=None,
                ckpt_dir: str | None = None, ckpt_every: int = 5,
                keep: int = 3, restore: str = "auto",
                guard: fault.PreemptionGuard | None = None,
                monitor: fault.StragglerMonitor | None = None,
                on_step=None, step_delay: float = 0.0,
                time_collectives: bool = False, verbose: bool = True,
                device=DEFAULT_DEVICE) -> dict:
    """Executed distributed multi-shot ULEEN training, SPMD: every rank of
    `mesh` (a DeviceMesh; None: one process, `make_host_mesh(("data",))`)
    calls it with the same arguments and trains on its rows of each
    global batch (`uleen_cell.make_uleen_dist_train_step`).

    Every source of nondeterminism is pinned to (seed, step): the model
    init to `seed` (a CPU generator, so any device starts alike), block
    j's dropout of step s to `multi_shot.block_generator(seed, s, j)`,
    step s's batch rows to `uleen_batch_indices(seed, s, ...)`. With the
    deterministic blocked reduction and logical checkpoints, a run stopped
    at any step boundary and resumed, on the same mesh or another,
    reaches final parameters byte-identical to the uninterrupted run.

    Preemption: at every step boundary the ranks agree (`_agree`) on
    whether any rank's `guard` fired, so all stop after the same step;
    rank 0 writes the checkpoint and every rank waits for it. on_step(step,
    params): test hook after each optimizer step. step_delay: a sleep
    after each step, widening the window a SIGTERM drill aims at.
    time_collectives: each history entry's `collective_s` is the seconds
    that step spent in collectives, the device synchronized around each
    (`make_uleen_dist_train_step`); 0.0 otherwise. Returns {"params",
    "opt_state", "history", "preempted", "resumed_from",
    "straggler_events", "collective_s"}.
    """
    from repro_torch.core import multi_shot
    from repro_torch.core.model import init_params
    from repro_torch.launch import uleen_cell
    from repro_torch.launch.mesh import make_host_mesh

    dev = resolve_device(device)
    mesh = mesh if mesh is not None else make_host_mesh(("data",))
    rank0 = _rank0(mesh)
    optimizer = opt_lib.adam(lr)
    params = init_params(torch.Generator().manual_seed(seed), spec,
                         init_scale=0.1, device=dev)
    opt_state = optimizer.init([*params.tables, params.bias])

    rec = obs_registry.get_recorder()
    start = 0
    if ckpt_dir and restore == "auto":
        with rec.span("ckpt.restore"):
            restored, at = checkpoint.restore_latest(ckpt_dir,
                                                     (params, opt_state))
        if restored is not None:
            params, opt_state = restored
            start = at
            if verbose and rank0:
                print(f"[train] restored step {at} from {ckpt_dir}",
                      flush=True)

    step_fn = uleen_cell.make_uleen_dist_train_step(
        spec, optimizer, mesh, grad_blocks=grad_blocks, compress=compress,
        time_collectives=time_collectives)
    rows = uleen_cell.uleen_dist_specs(spec, mesh, global_batch)
    bits_train = torch.as_tensor(bits_train).to(dev, torch.int8)
    labels_train = torch.as_tensor(labels_train).to(dev, torch.int64)
    n = bits_train.shape[0]
    monitor = monitor or fault.StragglerMonitor()
    history = []
    preempted = False
    last = start

    def save(at):
        if rank0:
            with rec.span("ckpt.save", step=at):
                checkpoint.save(ckpt_dir, at, (params, opt_state), keep=keep)
        _agree(False, mesh, dev)          # every rank waits for the write

    for step in range(start, steps_total):
        idx = uleen_batch_indices(seed, step, n, global_batch)[rows]
        idx = torch.from_numpy(idx).to(dev)
        monitor.start()
        coll_before = step_fn.collective_s
        params, opt_state, loss, acc = step_fn(
            params, opt_state, statics, bits_train[idx], labels_train[idx],
            lambda j, step=step: multi_shot.block_generator(seed, step, j,
                                                            dev))
        loss, acc = float(loss), float(acc)
        ev = monitor.stop(step)   # observes train.step_s + EWMA gauge
        rec.counter("train.steps").inc()
        if step_delay:
            time.sleep(step_delay)
        history.append({"step": step, "loss": loss, "acc": acc,
                        "collective_s": step_fn.collective_s - coll_before})
        last = step + 1
        if verbose and rank0 and (step % 5 == 0 or step == steps_total - 1):
            print(f"[train] step {step}: loss={loss:.4f} acc={acc:.4f}"
                  + (f" STRAGGLER x{ev.ratio:.1f}" if ev else ""),
                  flush=True)
        if on_step is not None:
            on_step(step, params)
        want_ckpt = ckpt_dir and (step + 1) % ckpt_every == 0
        if _agree(guard is not None and guard.preempted, mesh, dev):
            want_ckpt, preempted = bool(ckpt_dir), True
        if want_ckpt:
            save(step + 1)
        if preempted:
            if verbose and rank0:
                print(f"[train] preempted; checkpointed step {step + 1}",
                      flush=True)
            break
    if ckpt_dir and not preempted and last > start:
        save(last)
    return {"params": params, "opt_state": opt_state, "history": history,
            "preempted": preempted, "resumed_from": start,
            "straggler_events": len(monitor.events),
            "collective_s": step_fn.collective_s}


def uleen_reference_params(spec, statics, bits, labels, *, steps: int,
                           global_batch: int = 256, lr: float = 1e-3,
                           grad_blocks: int = 8, seed: int = 0,
                           compress_mesh: tuple | None = None, on_step=None,
                           device=DEFAULT_DEVICE) -> list:
    """The single-device blocked reference of `train_uleen`: the params
    after each of `steps` steps of `multi_shot.make_train_step(
    grad_blocks=)` on the same init, rows and block generators. With
    `compress_mesh` = (shape, axes), the reference of `train_uleen(
    compress=True)` on that mesh instead: the same block gradients,
    reduced as `compressed_grads` emulates. on_step(step, params) is
    called after each step."""
    from repro_torch.core import multi_shot
    from repro_torch.core.model import compute_hashes, init_params
    dev = resolve_device(device)
    optimizer = opt_lib.adam(lr)
    params = init_params(torch.Generator().manual_seed(seed), spec,
                         init_scale=0.1, device=dev)
    opt_state = optimizer.init([*params.tables, params.bias])
    step_fn = multi_shot.make_train_step(spec, optimizer,
                                         grad_blocks=grad_blocks)
    loss_fn = multi_shot.make_loss_fn(spec)
    bits = torch.as_tensor(bits).to(dev, torch.int8)
    labels = torch.as_tensor(labels).to(dev, torch.int64)
    rows = global_batch // grad_blocks
    out = []
    for s in range(steps):
        idx = torch.from_numpy(uleen_batch_indices(
            seed, s, bits.shape[0], global_batch)).to(dev)
        h = compute_hashes(spec, statics, bits[idx], device=dev)
        gens = [multi_shot.block_generator(seed, s, j, dev)
                for j in range(grad_blocks)]
        if compress_mesh is None:
            params, opt_state, _, _ = step_fn(params, opt_state, h,
                                              labels[idx],
                                              block_generators=gens)
        else:
            with multi_shot.deterministic(dev):
                blocks = [multi_shot.block_grads(
                    loss_fn, params, tuple(x[j * rows:(j + 1) * rows]
                                           for x in h),
                    labels[idx][j * rows:(j + 1) * rows],
                    generator=gens[j])[0] for j in range(grad_blocks)]
                params, opt_state = multi_shot.apply_step(
                    params, opt_state, compressed_grads(blocks,
                                                        *compress_mesh),
                    optimizer)
        out.append(params)
        if on_step is not None:
            on_step(s, params)
    return out


def compressed_grads(blocks, shape, axes) -> list:
    """One device's emulation of the gradient reduction of
    `uleen_cell.make_uleen_dist_train_step(compress=True)` on a mesh of
    `shape` over `axes` (`pod`, and `data` or not), from `blocks`, every
    global block's gradient leaves in block order. The rank at (pod p,
    data d), of linear index r in row-major order, sums its blocks
    [r·bpd, (r+1)·bpd); pod p's gradient is its ranks' sums added in
    data order, x npods/S. One scale for all pods, max(largest |entry|
    of any pod's gradient, 1e-12) / 127; each pod's gradient rounded
    onto it (half to even) and clipped to +-127 as int8; the int8s summed
    in int32, x scale / npods. Returns the leaves."""
    sizes = dict(zip(axes, shape))
    if "pod" not in sizes or set(sizes) - {"pod", "data"}:
        raise ValueError(f"compressed_grads emulates a (pod[, data]) mesh, "
                         f"not {axes}")
    bpd = len(blocks) // math.prod(shape)
    npods, ndata = sizes["pod"], sizes.get("data", 1)
    sums = {}
    for r, coords in enumerate(itertools.product(*map(range, shape))):
        at = dict(zip(axes, coords))
        mine = blocks[r * bpd:(r + 1) * bpd]
        sums[at["pod"], at.get("data", 0)] = [
            torch.sum(torch.stack(leaf), 0) for leaf in zip(*mine)]
    pods = []
    for p in range(npods):
        total = sums[p, 0]
        for d in range(1, ndata):
            total = [a + b for a, b in zip(total, sums[p, d])]
        pods.append([x * (npods / len(blocks)) for x in total])
    out = []
    for leaf in zip(*pods):
        absmax = torch.max(torch.stack([torch.max(torch.abs(x))
                                        for x in leaf]))
        scale = torch.clamp(absmax, min=1e-12) / torch.tensor(
            127.0, dtype=torch.float32, device=absmax.device)
        q = [torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
             for x in leaf]
        total = torch.sum(torch.stack(q).to(torch.int32), dim=0)
        out.append(total.to(torch.float32) * scale / torch.tensor(
            float(npods), dtype=torch.float32, device=total.device))
    return out


def max_param_diff(a, b) -> float:
    """max |a - b| over the tables and bias of two `UleenParams`."""
    return max(float(torch.max(torch.abs(x.float() - y.float().to(x.device))))
               for x, y in zip([*a.tables, a.bias], [*b.tables, b.bias]))


def uleen_parity_probe(mesh=None, *, steps: int = 2, global_batch: int = 256,
                       grad_blocks: int = 8, seed: int = 0,
                       n_train: int = 1024, device=DEFAULT_DEVICE) -> float:
    """Max |Δparam| between the distributed (uncompressed) trainer on
    `mesh` and the single-device blocked reference after `steps`
    identical steps, on the smoke problem (SPMD: every rank of `mesh`
    calls it; each runs the reference itself). 0.0 means bit-exact."""
    dev = resolve_device(device)
    spec, statics, bits, labels = uleen_smoke_problem(seed, n_train,
                                                      device=dev)
    out = train_uleen(spec, statics, bits, labels, steps_total=steps,
                      global_batch=global_batch, grad_blocks=grad_blocks,
                      seed=seed, mesh=mesh, verbose=False, device=dev)
    ref = uleen_reference_params(spec, statics, bits, labels, steps=steps,
                                 global_batch=global_batch,
                                 grad_blocks=grad_blocks, seed=seed,
                                 device=dev)
    return max_param_diff(out["params"], ref[-1])


def parse_mesh(text: str) -> tuple:
    """'pod=2,data=4' -> ((2, 4), ("pod", "data")): the mesh's shape and
    axis names, outermost first (the ranks build it: `make_mesh`)."""
    axes, shape = [], []
    for part in text.split(","):
        name, _, size = part.partition("=")
        axes.append(name.strip())
        shape.append(int(size))
    return tuple(shape), tuple(axes)


def _uleen_run(plan, mesh, dev) -> dict:
    """One rank's (or the one process's) `--arch uleen` run."""
    spec, statics, bits, labels = uleen_smoke_problem(plan["seed"],
                                                      device=dev)
    with fault.PreemptionGuard() as guard:
        out = train_uleen(
            spec, statics, bits, labels, steps_total=plan["steps"],
            global_batch=plan["batch"], lr=plan["lr"],
            grad_blocks=plan["grad_blocks"], compress=plan["compress"],
            seed=plan["seed"], mesh=mesh, ckpt_dir=plan["ckpt_dir"],
            ckpt_every=plan["ckpt_every"], restore=plan["restore"],
            guard=guard, step_delay=plan["step_delay"], device=dev)
    return {"losses": [h["loss"] for h in out["history"]],
            "preempted": out["preempted"],
            "resumed_from": out["resumed_from"]}


def uleen_rank(rank, world, plan) -> dict:
    """A rank process of `--arch uleen` (run by `spawn_ranks`)."""
    from repro_torch.launch.mesh import make_mesh, rank_device
    del rank, world
    torch.set_num_threads(max(1, torch.get_num_threads()
                              // max(1, plan["world"])))
    dev = rank_device(plan["device"])
    return _uleen_run(plan, make_mesh(plan["shape"], plan["axes"]), dev)


def _main_uleen(args) -> int:
    from repro_torch.launch.mesh import collective_backend, spawn_ranks
    shape, axes = parse_mesh(args.mesh)
    world = math.prod(shape)
    dev = resolve_device(args.device)
    plan = dict(shape=shape, axes=axes, world=world, device=args.device,
                seed=args.seed, steps=args.steps, batch=args.batch,
                lr=args.lr, grad_blocks=args.grad_blocks,
                compress=args.compress, ckpt_dir=args.ckpt_dir,
                ckpt_every=args.ckpt_every, restore=args.restore,
                step_delay=args.step_delay)
    if world == 1:
        out = _uleen_run(plan, None, dev)
    else:
        out = spawn_ranks(uleen_rank, world, plan,
                          backend=collective_backend(dev, world),
                          timeout_s=ULEEN_COLLECTIVE_TIMEOUT_S,
                          whole_run_deadline=False,
                          forward_signals=(signal.SIGTERM,))[0]
    losses = out["losses"]
    if losses:
        print(f"[train] done: first loss {losses[0]:.4f} -> "
              f"last {losses[-1]:.4f} over {len(losses)} steps"
              + (" (preempted)" if out["preempted"] else ""), flush=True)
    return 0


def production_world_missing(env) -> str | None:
    """Why this process cannot be a rank of the production mesh's world,
    or None: a launcher (torchrun) sets RANK, WORLD_SIZE and MASTER_ADDR,
    and the world must hold the mesh's 256 ranks."""
    from repro_torch.launch.mesh import PRODUCTION_MESHES
    shape, axes = PRODUCTION_MESHES[False]
    need = math.prod(shape)
    mesh = " x ".join(f"{n} {a}" for n, a in zip(shape, axes))
    unset = [k for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR")
             if k not in env]
    if unset:
        found = (f"no launcher ({', '.join(unset)} unset): a world of 1 "
                 f"rank")
    elif int(env["WORLD_SIZE"]) != need:
        found = f"a world of {env['WORLD_SIZE']} ranks (WORLD_SIZE)"
    else:
        return None
    return (f"the production mesh ({mesh}) needs {need} ranks, one card a "
            f"rank, started by a launcher such as torchrun; found {found}")


def _main_production_mesh(cfg, kw: dict, dev) -> int:
    """One rank of `--production-mesh`: joins the launcher's world (env://
    rendezvous; NCCL with one card a rank, gloo on the CPU), builds the
    16 x 16 (data, model) production mesh over it as this rank and runs
    `train(mesh=)`."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_production_mesh, rank_device
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method="env://")
    try:
        dev = rank_device(dev)
        mesh = make_production_mesh(rank=dist.get_rank(),
                                    device_type=dev.type)
        with fault.PreemptionGuard() as guard:
            out = train(cfg, mesh=mesh, guard=guard, device=dev, **kw)
        losses = [h["loss"] for h in out["history"]]
        if losses and dist.get_rank() == 0:
            print(f"[train] done: first loss {losses[0]:.4f} -> last "
                  f"{losses[-1]:.4f} over {len(losses)} steps on "
                  f"{dist.get_world_size()} ranks")
    finally:
        dist.destroy_process_group()
    return 0


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
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=5)
    ap.add_argument("--restore", choices=["auto", "none"], default="auto")
    ap.add_argument("--production-mesh", action="store_true",
                    help="train on the 16x16 (data, model) production mesh: "
                         "this process is one of the 256 ranks a launcher "
                         "such as torchrun started (env:// rendezvous), "
                         "one card a rank under NCCL")
    # --arch uleen (the executed distributed trainer)
    ap.add_argument("--mesh", default="data=1",
                    help="uleen mesh, e.g. pod=2,data=4: that many rank "
                         "processes")
    ap.add_argument("--grad-blocks", type=int, default=8)
    ap.add_argument("--compress", action="store_true",
                    help="int8 cross-pod gradient compression (needs a "
                         "pod axis in --mesh)")
    ap.add_argument("--step-delay", type=float, default=0.0,
                    help="per-step sleep (the SIGTERM drill's kill window)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=DEFAULT_DEVICE,
                    help="cuda (default) or cpu")
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="wrap the run in a torch.profiler trace (host and "
                         "CUDA activities) written into DIR as a Chrome "
                         "trace (Perfetto viewable)")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="write an obsmetrics/v1 METRICS.json snapshot of "
                         "the run (step-time histogram, checkpoint spans, "
                         "straggler EWMA, device memory) to PATH")
    args = ap.parse_args(argv)

    if args.production_mesh:
        if args.arch == "uleen":
            ap.error("--production-mesh trains the LM archs; --arch uleen "
                     "takes --mesh")
        missing = production_world_missing(os.environ)
        if missing:
            ap.error(f"--production-mesh: {missing}")
    if args.arch == "uleen" and args.lr == 3e-4:
        args.lr = 1e-3               # LM default; uleen's paper value
    dev = resolve_device(args.device)

    def _run() -> int:
        if args.arch == "uleen":
            return _main_uleen(args)
        if args.mesh != "data=1" or args.compress:
            print("[train] --mesh and --compress apply to --arch uleen; "
                  "the LM driver runs in one process", file=sys.stderr)
        cfg = get_config(args.arch, smoke=args.smoke)
        kw = dict(steps_total=args.steps, batch=args.batch, seq=args.seq,
                  lr=args.lr, microbatches=args.microbatches, seed=args.seed,
                  ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                  restore=args.restore)
        if args.production_mesh:
            return _main_production_mesh(cfg, kw, dev)
        with fault.PreemptionGuard() as guard:
            out = train(cfg, guard=guard, device=dev, **kw)
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
