"""LM serving drivers: one synchronous batch, or a continuous-batching
stream (port of `repro/launch/serve.py`).

`serve()` prefills one batch and decodes it in lockstep, greedily or
sampling, in one process or SPMD on a mesh of rank processes — the
reference path. `serve_stream()` drains a request stream through
`scheduler.Engine`, which admits queued prompts into KV-cache slots as
they free up mid-decode.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3p2_3b \\
        --smoke --device cpu --batch 4 --prompt-len 32 --gen 16
    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3p2_3b \\
        --smoke --device cpu --stream --requests 16 --rate 64 --slots 4
    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3p2_3b \\
        --smoke --device cpu --stream --paged --block-size 8 \\
        --num-blocks 17 --prefill-batch 2
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mixtral_8x7b \\
        --smoke --device cpu --prompt-len 24
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2_2p7b \\
        --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch recurrentgemma_2b --smoke --device cpu --prompt-len 24
    PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper_tiny \\
        --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch internvl2_26b \\
        --smoke --device cpu --stream --paged
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1p5_32b \\
        --smoke --device cpu --stream --paged --profile build/trace \\
        --metrics-out build/METRICS.json

Without `--device` it runs on the GPU, and raises when there is none.
Whisper's requests carry (F, D) encoder frames and InternVL2's (P, D)
patch rows, normal x 0.02: one batch draws them from a generator on the
device, a stream with its requests (`synth_request_stream`); the patch
rows count in `max_len`.
`--paged` serves the stream from block-granular KV pools (`--block-size`,
`--num-blocks`, `--prefill-batch`). Qwen 1.5 serves from its int8 KV
cache (`kv_cache_dtype` of its config). `--profile DIR` wraps the run in
a `torch.profiler` trace written into DIR (`obs.torchhooks.profile_trace`);
`--metrics-out PATH` writes the run's metrics, the card's memory gauges
(`obs.torchhooks.record_device_memory`) among them.
"""
from __future__ import annotations

import argparse
import contextlib
import sys
import time

import numpy as np
import torch

from repro_torch.configs.base import ARCH_IDS, get_config
from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.launch import steps
from repro_torch.models import transformer
from repro_torch.obs import registry as obs_registry
from repro_torch.obs import torchhooks
from repro_torch.obs.metrics import fmt_seconds as _fmt_s


def serve(cfg, params, prompts, *, max_len: int, gen: int, mesh=None,
          frames=None, patches=None, greedy: bool = True, rng=None,
          temperature: float = 1.0) -> torch.Tensor:
    """prompts: (B, S) int -> tokens (B, gen) int32 on the parameters'
    device (the JAX signature). frames (B, F, D): an encoder-decoder
    model's encoder input; patches (B, P, D): a patch model's rows ahead
    of the prompt (they count in max_len). Greedy, or with `greedy=False`
    sampled from softmax(logits / temperature) with `rng`, a
    `torch.Generator` on the parameters' device (the port's counterpart
    of the JAX key: each step draws from it in turn).

    `mesh` None or a `launch.mesh.HostMesh` serves in this process. On a
    DeviceMesh every rank of the mesh calls it with the same arguments
    (SPMD, as JAX's `serve(mesh=)`): unplaced parameters are placed under
    SERVE_RULES, the prompts, frames and patches by their batch rows, and
    the prefill and decode steps run under `use_placement`. Each step's
    last logits are read whole, so every rank picks the same token (a
    sampling rank draws from the same whole logits with the same
    generator state), and the tokens come back whole on every rank."""
    from repro_torch.dist import placed
    from repro_torch.dist import sharding as sh
    from repro_torch.launch.mesh import HostMesh
    on_mesh = mesh is not None and not isinstance(mesh, HostMesh)
    device = (params.embed.to_local() if placed.is_placed(params.embed)
              else params.embed).device
    prefill = steps.make_prefill_step(cfg, max_len=max_len)
    decode = steps.make_decode_step(cfg)
    batch = {"tokens": torch.as_tensor(prompts).to(device)}
    for name, t in (("frames", frames), ("patches", patches)):
        if t is not None:
            batch[name] = torch.as_tensor(t).to(device)
    rules = sh.SERVE_RULES
    place = contextlib.nullcontext()
    if on_mesh:
        if not placed.is_placed(params.embed):
            params = steps.place_params(cfg, params, mesh, rules)
        place = sh.use_placement(mesh, rules)
        batch = steps.place_batch(batch, mesh, rules)

    def rows(tok):      # a decode step's tokens, placed by batch rows
        return (sh.distribute_tensor(tok, ("batch", None), mesh, rules)
                if on_mesh else tok)

    def pick(logits):
        last = placed.whole(logits[:, -1])
        if greedy:
            return torch.argmax(last, dim=-1)[:, None].to(torch.int32)
        probs = torch.softmax(last.float() / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=rng).to(torch.int32)

    with torch.inference_mode(), place:
        logits, state = prefill(params, batch)
        outs = []
        tok = torch.argmax(placed.whole(logits[:, -1:]), dim=-1).to(
            torch.int32)
        for _ in range(gen):
            outs.append(tok)
            logits, state = decode(params, rows(tok), state)
            tok = pick(logits)
        return torch.cat(outs, dim=1)


def serve_stream(cfg, params, requests, *, slots: int, max_len: int,
                 greedy: bool = True, rng=None, temperature: float = 1.0,
                 realtime: bool = True, verbose: bool = True,
                 paged: bool = False, block_size: int = 16,
                 num_blocks=None, prefill_batch: int = 1, bucket=None,
                 clock=None, seed: int = 0, device=DEFAULT_DEVICE):
    """Drain a request stream (`scheduler.Request`s, see
    `scheduler.synth_request_stream`) through the continuous-batching
    engine; returns (results, engine). The JAX signature: with
    `realtime=True` each request is held back until its arrival, with
    False all are queued at once; `verbose` prints the stats; `bucket` and
    `clock` (a zero-argument float clock, `time.perf_counter` by default)
    pass to the `Engine`, as do `paged`, `block_size`, `num_blocks` and
    `prefill_batch`. `greedy=False` samples at `temperature`; each
    request's generator is seeded from (engine seed, rid), the engine seed
    being `seed` or, given `rng` (a `torch.Generator`, the port's
    counterpart of the JAX key), one draw from it."""
    from repro_torch.launch.scheduler import Engine
    if rng is not None:
        seed = int(torch.randint(0, 2 ** 31 - 1, (1,), generator=rng,
                                 device=rng.device))
    eng = Engine(cfg, params, slots=slots, max_len=max_len, greedy=greedy,
                 seed=seed, temperature=temperature, bucket=bucket,
                 clock=clock, paged=paged, block_size=block_size,
                 num_blocks=num_blocks, prefill_batch=prefill_batch,
                 device=device)
    results = eng.run(requests, realtime=realtime)
    if verbose:
        st = eng.stats()
        # every latency is None until a request completes: the print is
        # None-safe
        print(f"[serve] {cfg.name}: {st['requests']} requests, "
              f"{st['tokens']} tokens in {st['decode_steps']} decode steps "
              f"({st['tok_per_s']:.1f} tok/s, peak {st['peak_active']}/"
              f"{slots} slots)")
        if st["paged"]:
            print(f"[serve] paged: peak {st['peak_blocks']}/"
                  f"{st['num_blocks']} blocks of {st['block_size']} "
                  f"(contiguous worst case would pin "
                  f"{slots * (max_len // st['block_size'])}), "
                  f"{eng.prefill_launches} prefill launches")
        print(f"[serve] latency mean/p50/p99/max = "
              f"{_fmt_s(st['latency_mean_s'])}/"
              f"{_fmt_s(st['latency_p50_s'])}/"
              f"{_fmt_s(st['latency_p99_s'])}/"
              f"{_fmt_s(st['latency_max_s'])} s, queue wait mean = "
              f"{_fmt_s(st['queue_wait_mean_s'])} s")
    return results, eng


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", choices=ARCH_IDS, required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--stream", action="store_true",
                    help="continuous batching: Poisson request stream "
                         "through the slot scheduler instead of one "
                         "synchronous batch")
    ap.add_argument("--requests", type=int, default=16,
                    help="[--stream] number of requests")
    ap.add_argument("--rate", type=float, default=64.0,
                    help="[--stream] Poisson arrival rate, req/s")
    ap.add_argument("--slots", type=int, default=None,
                    help="[--stream] cache slots (default: --batch)")
    ap.add_argument("--paged", action="store_true",
                    help="[--stream] block-granular paged KV: requests "
                         "reserve ceil(need/block-size) blocks instead of "
                         "a worst-case max_len row")
    ap.add_argument("--block-size", type=int, default=16,
                    help="[--paged] tokens per KV block (max_len is rounded "
                         "up to a multiple)")
    ap.add_argument("--num-blocks", type=int, default=None,
                    help="[--paged] pool size; default = contiguous worst "
                         "case + the null block")
    ap.add_argument("--prefill-batch", type=int, default=1,
                    help="[--paged] admit up to this many same-bucket "
                         "requests in one batched prefill launch")
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="wrap the run in a torch.profiler trace (host and "
                         "CUDA activities) written into DIR as a Chrome "
                         "trace (Perfetto viewable)")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="write an obsmetrics/v1 METRICS.json snapshot of "
                         "the run (latency histograms, shape counters, "
                         "prefill/decode spans) to PATH")
    ap.add_argument("--device", default=DEFAULT_DEVICE,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    # independent streams: parameters from a generator on the device,
    # prompts from numpy
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = transformer.init_params(cfg, gen, dtype=torch.float32,
                                     device=dev)

    # patch rows come ahead of the prompt and take cache rows
    max_len = cfg.patch_tokens + args.prompt_len + args.gen + 1

    def _run() -> int:
        if args.stream:
            from repro_torch.launch.scheduler import synth_request_stream
            reqs = synth_request_stream(
                cfg, args.requests, rate=args.rate, seed=args.seed,
                prompt_lens=(max(1, args.prompt_len // 2), args.prompt_len),
                gen_lens=(max(1, args.gen // 2), args.gen))
            width = max_len
            if args.paged and width % args.block_size:
                width += args.block_size - width % args.block_size
            serve_stream(cfg, params, reqs, slots=args.slots or args.batch,
                         max_len=width, seed=args.seed, paged=args.paged,
                         block_size=args.block_size,
                         num_blocks=args.num_blocks,
                         prefill_batch=args.prefill_batch, device=dev)
            return 0
        rng = np.random.default_rng(args.seed)
        prompts = torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (args.batch, args.prompt_len), dtype=np.int32))
        # frames and patches from a generator of their own on the device
        data_gen = torch.Generator(device=dev).manual_seed(args.seed + 1)
        inputs = {}
        for name, rows in (("frames", cfg.encoder_frames),
                           ("patches", cfg.patch_tokens)):
            if rows:
                inputs[name] = torch.randn(
                    (args.batch, rows, cfg.d_model), generator=data_gen,
                    device=dev) * 0.02
        t0 = time.perf_counter()
        toks = serve(cfg, params, prompts, max_len=max_len, gen=args.gen,
                     **inputs)
        toks = toks.cpu()          # waits for the device
        dt = time.perf_counter() - t0
        print(f"[serve] {cfg.name}: generated {tuple(toks.shape)} in "
              f"{dt:.2f}s ({args.batch * args.gen / dt:.1f} tok/s) on {dev}")
        print("[serve] sample:", toks[0, :12].tolist())
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
            print(f"[serve] metrics: {len(rec.spans)} spans, "
                  f"{sum(c.value for c in rec.counters.values())} counter "
                  f"events -> {args.metrics_out}")
    return rc


if __name__ == "__main__":
    sys.exit(main())
