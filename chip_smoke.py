#!/usr/bin/env python3
"""Drive the PyTorch port's serve and train paths on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root

Builds the hand-written CUDA kernels from `src/repro_torch/kernels/csrc`
(the `build` phase lists ptxas's registers and spills of every WNN and
front-end instantiation), holds each against its plain PyTorch version
on the card (the integer kernels bit-equal, the flash-attention kernel
within a stated tolerance; the WNN ensemble kernel on both of its routes
and past 128 classes, each case naming its route),
serves the golden ULN-S artifact through every backend, then runs two
ULEEN paths at full ULN-L width (784 features x 7 thermometer bits, six
submodels, M = 10) and one LM path:

* the serve path: a seeded ULN-L artifact saved and loaded back, 65536
  rows of raw features through the thermometer and decompression kernels,
  scoring through the WNN kernel on either table layout (`auto` and
  `fused`: one launch a batch for the whole ensemble, the permutation
  gather inside), and 4096+ requests through `WnnBatcher` per backend;
* the train path: the JAX package's synthetic MNIST
  (`data.synth.make_mnist_like`, 28 x 28), the Gaussian thermometer fit
  and encode kernel, the hash precompute
  through the `h3_hash` kernel, one-shot counting with bleaching,
  multi-shot STE training (bf16 tables, dropout shared across classes),
  30 % pruning with fine-tuning, export, save/load, and serving the
  exported artifact through the packed kernel;
* the LM serve path: Llama 3.2 3B at full width and depth (28 layers,
  d 3072, 24/8 heads of 128, vocabulary 128 256) with float32 parameters
  drawn on the card from a seeded generator; `serve()` on a batch of 4
  prompts of 1024 tokens for 32 tokens, and the continuous-batching
  `Engine` (8 slots) draining 32 requests of 128-1024 prompt tokens and
  16-64 new tokens. Every prefill's attention runs the flash kernel;
* the head path: a UleenHead (`examples/distill_uleen_head.py`'s task and
  head) trained on mean-pooled embeddings of that full-width backbone
  (the LM path's parameters, not drawn twice), then deployed binarized
  through the gather, fused, packed and auto backends, bit-equal;
* the tenant path: 2048 seeded ULN-S tenants (784 x 2 bits) stacked by
  `prepare_tenants`, `stacked_predict` on 65536 rows (8 tenants held
  bit-equal to the WNN kernel), and `WnnTenantBatcher` (64 resident
  tenants, 256 slots) through 16384 Zipf-distributed requests;
* the paged path: the LM path's backlog again through the paged `Engine`
  (blocks of 16 tokens, a pool of half the contiguous worst case) at
  prefill_batch 1 and 4, held against the contiguous Engine's tokens and
  first-token logits; every batched prefill is one flash launch a layer;
* the sharded path: the ULN-XL ensemble (M = 32, 784 x 8 bits) served
  class-sharded by `WnnBatcher(mesh=)` on 65536 rows at model = 2, 4 and
  data = 2 x model = 2, and the 2048-tenant ULN-S fleet tenant-sharded
  (`make_tenant_sharded_predict`) at model = 2 and 4, in rank processes
  (`launch.mesh.spawn_ranks`) that share the one card under gloo, whose
  collectives run on host copies; with two or more cards, one rank per
  card under NCCL. Every rank's scores are bit-equal to the unsharded
  port's, with one WNN launch a batch on each rank;
* the port's three examples at their own sizes, quickstart last;
* the MoE path: Mixtral 8x7B at full width (d 4096, 32/8 heads of 128,
  8 experts top-2, d_ff 14336, window 4096), depth cut to 4 of 32
  layers: the flash kernel at the banded prefill shape; serve() on 2
  prompts of 6144 tokens (past the window: the banded prefill and the
  ring's wrap) for 32 tokens; an Engine of 4 slots on 8 requests of
  512-6144 prompt tokens; the sorted and einsum dispatches on layer 0's
  input; and the token mask, live rows bit-equal whatever the idle
  slots hold;
* the MLA path: DeepSeek-V2-Lite at full width and depth (27 layers,
  MLA rank 512, 64 routed experts top-6 + 2 shared): the flash kernel at
  (D_qk, D_v) = (192, 128); serve() on 4 x 1024; the LM path's backlog
  through the contiguous Engine and the paged one (the worst-case pool:
  the same schedule, equal tokens; half of it; half at prefill_batch 4);
* the SSM path: Mamba 2 2.7B at full width and depth (64 layers, d 2560,
  80 SSD heads of 64, state 128, chunk 256; no attention, so no kernel
  launch): serve() on 4 x 1024; the LM path's backlog through the
  contiguous Engine (4 slots) and the paged one (no block pool: equal
  tokens); one layer's prefill of 1024 tokens against 1024 decode steps;
* the hybrid path: RecurrentGemma 2B at full width and depth (26 layers,
  (rec, rec, local) x 8 + (rec, rec), RG-LRU width 2560, local MQA 10/1
  heads of 256 over a window of 2048, vocabulary 256 000): the flash
  kernel at the local layers' shape; serve() on 2 x 4096 (past the
  window: the windowed flash kernel and the ring's wrap); 8 requests of
  512-4096 tokens through both engines; one RG-LRU layer's log-depth
  scan over 4096 tokens against 4096 steps;
* the encoder-decoder path: Whisper tiny at full width and depth (4
  encoder and 4 decoder layers, d 384, 6 heads of 64, 1500 frames,
  learned positions, cross attention): the flash kernel at the encoder's
  1500 x 1500 shape and the cross attention's at prefill (224 x 1500)
  and decode (1 x 1500); serve() on 8 x 224 prompts over 8 x 1500
  frames; 32 requests, each with its own frames, through the contiguous
  Engine (8 slots) and the paged one (half and worst-case pools,
  prefill_batch 1 and 4); flash launched 12 times a prefill and 4 times
  a decode step;
* the patch path: InternVL2 26B at full width (48/8 heads of 128, d
  6144, vocabulary 92 553), depth cut to 12 of 48 layers: the flash
  kernel at its prefill shape (256 patch rows + 1024 tokens, causal);
  serve() on 4 x (256 + 1024); 8 requests of 128-1024 tokens behind
  their patches through both engines. Both paths hold the Engine's
  first-token logits to batch-1 prefills, its tokens to a batch-1
  serve() of each request, and one decode step to a prefill over the
  prompt and its token;
* the Qwen path: Qwen 1.5 32B at full width (d 5120, MHA 40/40 heads of
  128 with QKV bias, d_ff 27392, vocabulary 152 064), depth cut to 12 of
  64 layers, on its int8 KV cache: the flash kernel at its prefill shape
  (group 1, 1024 causal); serve() on 4 x 1024; 32 requests of 128-1024
  tokens through the contiguous Engine (8 slots) and the paged ones;
  serve() and the contiguous Engine again on the int4 cache; the checks
  of the patch path, the decode step against a prefill whose last row
  reads K and V quantised and dequantised as the cache does; the decode
  under `obs.torchhooks.profile_trace` (device busy share); and 4
  sequences at 32,768 positions decoded on bf16, int8 and int4 caches
  (exact pool bytes, step ms, peak memory);
* `serve.py --profile DIR --metrics-out PATH` on Whisper tiny at full
  size: the trace names the flash kernel, the metrics hold the card's
  memory gauges;
* the loadgen path: the golden scenarios `smoke_gqa`, `paged_mixed`
  (Llama 3.2 3B), `paged_mla` (DeepSeek) and `ssm_state` (Mamba 2) and
  `int8_cache` (Qwen 1.5 at 12 of 64 layers) at full width through the
  port's `loadgen.run_scenario`, written to `build/BENCH_serve.json`,
  which the port's `check()` and `scripts/diff_serve.py` read;
* the LM train path: the flash kernel at the train steps' bf16 shapes
  (Llama's 24/8 x 128 and DeepSeek's MLA (192, 128) on the bf16 route)
  and its backward (the plain version) against autograd through the
  plain forward; Llama 3.2 3B at full width, depth cut to 8 of 28 layers,
  through `launch.train.train` (bf16 compute over float32 master weights,
  AdamW, warm-up-cosine, clipping) for 8 steps of 2 x 1024 tokens: the
  first loss near ln V + σ²/2 of the random init, finite losses and
  gradient norms, a bf16 step against a float32 step from the same
  params and batch, 2 x layers flash launches a step (the forward and its
  checkpointed recompute), timed steps and tokens/s, 8 steps on one
  repeated batch at a constant lr that lower the loss, the peak device
  memory; DeepSeek-V2-Lite at full width, its dense first layer and one
  MoE layer (64 experts top-6, 2 shared), a bf16 and a float32 step; and
  `launch.train.main` on the smoke Llama;
* the distributed ULEEN trainer (`launch/uleen_cell.py` through
  `launch.train.train_uleen`) at ULN-L width: 16384 MNIST-shaped rows
  encoded on the card, a global batch of 8192 in 8 blocks, mesh (pod 2,
  data 2) in four rank processes sharing the card under gloo (with four
  cards, one rank a card under NCCL too): the exact run bit-equal at
  every step to the single-device blocked step the parent runs; the int8
  compressed run within the bound two Adam runs can part by, its
  gradient payloads int8 across `pod`, and the int8 mean of pod tensors
  at the trainer's leaf shapes within `quantization_bound`; a run
  preempted through `PreemptionGuard.request()` after step 2 resumed on
  (data 2), bit-equal; and the smoke Llama restarted from a mid-run
  checkpoint, bit-equal to the unbroken run;
* the dry run (`launch/dryrun.py`, in subprocesses): the six ULEEN cells
  traced with fake tensors as rank 0 of the 256- and 512-rank production
  meshes (the card's program: the kernels as `repro_torch::` operators,
  the collectives as `c10d` nodes) and linted (`repro_torch.analysis`),
  the executed cell's 8 ranks on the card; then rank 0's program of four
  cells run for real at its shard shapes (the fake group's collectives
  move nothing), its peak device memory held to the record's and its
  kernel launches to the trace's operator nodes; and the WNN and hash
  operators timed against their direct `ctypes` launches;
* the LM entry points on a mesh: Llama 3.2 3B at full width, depth cut
  to 2 of 28 layers, through `launch.train.train(mesh=)` for 3 float32
  steps of 4 x 1024 tokens in 2 microbatches on (data 2, model 2), four
  gloo ranks sharing the card with every shard on it (DTensor's
  all-gathers through the port's host-staged route): every rank's
  losses equal, the losses and final parameters held to the one-device
  `train()` of the same seed, the step-2 checkpoint resumed on (model 4)
  and in one process to the same; `serve(mesh=)` on (model 4), 2 x 512
  prompts for 16 tokens, against one-device `serve()`; the flash kernel
  at a rank's train shape against its plain version.

Each path resets the kernels' launch counts just before it and reads them
just after (the sharded, distributed-trainer and LM mesh paths in each
rank process too, summed over ranks). The tenant path's scoring is
tensor code, as the JAX package's is on every platform (no Pallas
tenant kernel); its line puts that time beside the WNN kernel's on the
same rows. Every phase prints one JSON line; any mismatch raises, so
the exit code is nonzero. The last line is `{"ok": true, "device": {...}}`;
the line before it is the card's name and power limit as `nvidia-smi`
reports them.

Times are CUDA-event medians after warm-up, per call (the host's work
included wherever the card waits for it); the WNN, front-end and flash
phases add each kernel's (and its PyTorch call's) device time from
CUDA-graph replays (`device_ms`, `library_device_ms`); the front end
also its achieved TB/s and share of its bound on that time. Each
kernel's bound is the
larger of its bytes (each input read once, each output written once) over
3.35 TB/s and its operations over the card's lane rate for their type;
both are computed from this run's shapes. NVIDIA's published non-tensor
float32 rate, 67 TFLOP/s, counts a fused multiply-add as two operations:
one operation per fp32 lane per clock is 33.5 T/s. A Hopper SM has half
as many int32 lanes as fp32 lanes, so integer work (the WNN kernels'
hash folds, shifts, masks, ANDs and votes; decompression's compares)
issues at most 16.75 T/s; the H3 hash's 2·n·k select-and-XOR operations
per tuple count there too. The WNN kernel's operations are those of the
class-sliced formulation it runs (`wnn_ensemble.wnn_ensemble_cost`: per row a gather
per input bit of every filter, the hash fold, k probes and k + 1 ANDs a
filter, a vote per class and 32-filter chunk); `bound_per_class_ms`
keeps the bound of the first, per-class formulation (k lookups and an
AND per class and filter) beside it. Each thermometer kernel's `library_ms` is one
broadcasting PyTorch compare (`torch.gt`, `torch.lt`) whose bool output
is viewed as int8; no single PyTorch call computes an H3-hashed Bloom
lookup or an XOR reduction, so the WNN and hash kernels' is null. The
flash kernel's operations are 2·(D + Dv) FLOP (two multiply-adds) per
visible (query, key) pair of each head, 4·D where v is as wide as q.
bf16 is bounded at 989 TFLOP/s on the tensor cores (its `wgmma_bf16` route). float32 is bounded at the rate of
the fastest route that keeps float32 accuracy, 3×TF32 on the tensor
cores (its `mma_3xtf32` route): three TF32 products per product, 495/3 =
165 TFLOP/s; `bound_cuda_core_ms` keeps the 67 TFLOP/s CUDA-core bound
beside it, the bound of the first (CUDA-core) version. Its `library_ms`
is one `torch.nn.functional.scaled_dot_product_attention` call on the
same tensors with the KV heads repeated (a yardstick only: the port
never calls it).
"""
from __future__ import annotations

import atexit
import collections
import dataclasses
import gc
import importlib
import json
import math
import os
import re
import shutil
import signal
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3
FP32_OPS_PER_S = 67e12 / 2       # one op per fp32 lane per clock
INT32_OPS_PER_S = 67e12 / 4      # half as many int32 lanes as fp32 lanes
FP32_FLOP_PER_S = 67e12          # FMA as two FLOP, CUDA cores
BF16_FLOP_PER_S = 989e12         # dense bf16 tensor cores
TF32X3_FLOP_PER_S = 495e12 / 3   # float32 as three TF32 tensor-core products

ULN_L = dict(num_classes=10, features=784, bits_per_input=7, num_hashes=2,
             submodels=((12, 6), (16, 7), (20, 7), (24, 8), (28, 8), (32, 9)))
ULN_XL_LARGEST = dict(n=32, log2_entries=15, num_classes=32,
                      total_bits=784 * 8)      # ULN-XL ensemble, E = 2^15
INFER_BATCH = 65536
PLAIN_CHUNK = 4096   # the plain WNN versions run in row chunks: their
#                      (M, B, N_f, k) gather intermediates at B = 65536
#                      would need tens of GB
SERVE_REQUESTS = 4096
SERVE_SLOTS = 256
TRAIN_ROWS = 16384       # multi-shot training rows (64 steps of 256 an epoch)
VAL_ROWS = 2048
ONE_SHOT_ROWS = 4096
# Accuracy floors of the train path on its synthetic data (10 classes,
# chance 0.1); the models land well above them.
ONE_SHOT_FLOOR = 0.5
MULTI_SHOT_FLOOR = 0.5

# The LM serve path (Llama 3.2 3B, `configs/llama3p2_3b.py`): serve() on
# one batch, then the Engine on a closed backlog of mixed requests.
LM_ARCH = "llama3p2_3b"
LM_BATCH, LM_PROMPT, LM_GEN = 4, 1024, 32
LM_SLOTS, LM_REQUESTS = 8, 32
LM_PROMPT_LENS, LM_GEN_LENS = (128, 256, 512, 1024), (16, 32, 64)
LM_DECODE_TIMED_STEPS = 8
# Tolerances of the flash kernel against its plain version: float32 (a
# running softmax rounds otherwise than one softmax), bf16 (one rounding
# of the output); the CPU tests hold the plain version to the JAX kernel
# at the same.
FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# Engine (batch-1) prefill logits against serve()'s batch-4 prefill on
# the same prompts: float32 products that cuBLAS may split otherwise for
# another batch, over 28 layers
LM_PREFILL_LOGITS_TOL = 1e-3

KERNEL_INFO = {
    "packed_wnn": ("src/repro_torch/kernels/csrc/wnn.cu",
                   "src/repro/kernels/packed_wnn.py:113"),
    "fused_wnn": ("src/repro_torch/kernels/csrc/wnn.cu",
                  "src/repro/kernels/fused_wnn.py:110"),
    "thermometer_encode": ("src/repro_torch/kernels/csrc/thermometer.cu",
                           "src/repro/kernels/thermometer.py:24"),
    "thermometer_decompress": ("src/repro_torch/kernels/csrc/thermometer.cu",
                               "src/repro/kernels/thermometer.py:59"),
    "h3_hash": ("src/repro_torch/kernels/csrc/h3_hash.cu",
                "src/repro/kernels/h3_hash.py:28"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:80"),
}


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median milliseconds of `fn()` over `reps` CUDA-event timed calls."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def graph_ms(fn, calls: int = 10, reps: int = 5) -> float:
    """Device milliseconds of one `fn()`: `calls` calls captured in a CUDA
    graph, the median replay over `reps` divided by `calls`. The host's
    work (Python, argument checks, the launch itself) is left out, which
    `cuda_ms` counts whenever the card waits for it."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / calls)
    del graph
    return float(np.median(times))


def chunked(fn, n_rows: int, *args):
    """fn over row chunks of the first argument, concatenated."""
    first, rest = args[0], args[1:]
    return torch.cat([fn(first[i:i + PLAIN_CHUNK], *rest)
                      for i in range(0, n_rows, PLAIN_CHUNK)])


def bound(bytes_moved: float, ops: float,
          ops_per_s: float) -> tuple[float, str]:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def assert_equal(what: str, got: torch.Tensor, want: torch.Tensor) -> int:
    """The max |got - want|; raises unless it is 0 (bit-equal)."""
    if got.shape != want.shape:
        raise AssertionError(f"{what}: shape {tuple(got.shape)} != "
                             f"{tuple(want.shape)}")
    diff = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
    if diff:
        raise AssertionError(f"{what}: not bit-equal (max |diff| {diff})")
    return diff


# ---------------------------------------------------------------------------
# Phase 3: every kernel against its plain version on the card
# ---------------------------------------------------------------------------

def wnn_case(gen, *, batch, n_f, n, log2_entries, m, k, mask_kind="random"):
    dev = "cuda"
    e = 2 ** log2_entries
    tuples = torch.randint(0, 2, (batch, n_f, n), generator=gen, device=dev,
                           dtype=torch.int8)
    params = torch.randint(0, e, (k, n), generator=gen, device=dev,
                           dtype=torch.int32)
    table = (torch.rand((m, n_f, e), generator=gen, device=dev) < 0.3
             ).to(torch.int8)
    if mask_kind == "zeros":
        mask = torch.zeros((m, n_f), dtype=torch.int8, device=dev)
    else:     # values in {0, 1, 2}: a filter survives iff its mask != 0
        mask = torch.randint(0, 3, (m, n_f), generator=gen, device=dev,
                             dtype=torch.int8)
    bias = torch.randint(-5, 6, (m,), generator=gen, device=dev,
                         dtype=torch.int32)
    return tuples, params, table, mask, bias


def wnn_per_class_ops(batch, n_f, n, m, k):
    """The first (per-class) formulation's integer operations: per
    (b, f) n·k hash select-and-XORs; per (b, m, f) k bit lookups (load,
    shift, mask) and the AND, plus the vote."""
    return batch * n_f * n * k * 2 + batch * m * n_f * (3 * k + 1)


def check_wnn_kernels(gen, packed_layout, ref, packed_wnn, fused_wnn):
    """The per-submodel tuple entries (`packed_wnn`, `fused_wnn` on
    (B, N_f, n) tuples: the same kernel with the identity permutation on
    class slices built in the call) against their plain versions,
    bit-equal, at every ULN-L geometry and the edge cases."""
    cases = []
    for n, log2e in ULN_L["submodels"]:
        total_bits = ULN_L["features"] * ULN_L["bits_per_input"]
        cases.append(dict(name=f"uln_l_n{n}_e{2 ** log2e}", timed=True,
                          batch=INFER_BATCH, n_f=math.ceil(total_bits / n),
                          n=n, log2_entries=log2e, m=ULN_L["num_classes"],
                          k=ULN_L["num_hashes"]))
    xl = ULN_XL_LARGEST
    cases += [
        dict(name="uln_xl_ensemble_n32_e32768", batch=INFER_BATCH,
             n_f=math.ceil(xl["total_bits"] / xl["n"]), n=xl["n"],
             log2_entries=xl["log2_entries"], m=xl["num_classes"], k=2),
        dict(name="e8_k1_odd_n", batch=4099, n_f=101, n=7, log2_entries=3,
             m=10, k=1),
        dict(name="e16_k4", batch=4097, n_f=77, n=12, log2_entries=4, m=10,
             k=4),
        dict(name="m40_k8_n64", batch=1031, n_f=45, n=64, log2_entries=10,
             m=40, k=8),
        dict(name="zero_mask", batch=2053, n_f=229, n=24, log2_entries=8,
             m=10, k=2, mask_kind="zeros"),
        # N_f·n = 32800 bits, past what the first ensemble kernel staged
        dict(name="wide_tuples_32800_bits", batch=1029, n_f=1025, n=32,
             log2_entries=6, m=10, k=2),
    ]
    rows = []
    for case in cases:
        name, timed = case.pop("name"), case.pop("timed", False)
        tuples, params, table, mask, bias = wnn_case(gen, **case)
        words = packed_layout.pack_words(table)
        b = case["batch"]
        got_p = packed_wnn(tuples, params, words, mask, bias)
        got_f = fused_wnn(tuples, params, table, mask, bias)
        want_p = chunked(ref.packed_wnn_ref, b, tuples, params, words, mask,
                         bias)
        want_f = chunked(ref.fused_wnn_ref, b, tuples, params, table, mask,
                         bias)
        torch.cuda.synchronize()
        assert_equal(f"packed_wnn[{name}]", got_p, want_p)
        assert_equal(f"fused_wnn[{name}]", got_f, want_f)
        assert_equal(f"packed_wnn vs fused_wnn[{name}]", got_p, got_f)
        row = {"case": name, "batch": b, "n_f": case["n_f"], "n": case["n"],
               "entries": 2 ** case["log2_entries"], "m": case["m"],
               "k": case["k"], "max_abs_err": 0}
        if timed:
            # per call, the class slices the wrapper builds included
            row["packed_wnn_ms"] = cuda_ms(
                lambda: packed_wnn(tuples, params, words, mask, bias), 10)
            row["fused_wnn_ms"] = cuda_ms(
                lambda: fused_wnn(tuples, params, table, mask, bias), 10)
        rows.append(row)
        del tuples, params, table, words, mask, bias
    emit("wnn_tuple_entries", cases=rows)


def seeded_artifact(export, seed, *, m, subs, total_bits,
                    bits_per_input=1, mask_kind="random"):
    """A seeded artifact: table fill ~0.3, mask ~0.8 (or all zero),
    random perm wrapped with repeated indices where N_f·n passes
    total_bits, H3 params in [0, E), integer bias. subs: (n, log2 E, k)."""
    rng = np.random.default_rng(seed)
    out = []
    for n, log2e, k in subs:
        e, n_f = 2 ** log2e, math.ceil(total_bits / n)
        perm = rng.permutation(total_bits)
        if n_f * n > total_bits:           # classic WiSARD wrap padding
            perm = np.concatenate(
                [perm, rng.integers(0, total_bits, n_f * n - total_bits)])
        packed = export.pack_table(rng.random((m, n_f, e)) < 0.3)
        mask = rng.random((m, n_f)) < 0.8
        if mask_kind == "zeros":
            mask[:] = False
        out.append(export.SubmodelArtifact(
            packed=packed,
            mask=mask, perm=perm[:n_f * n].reshape(n_f, n).astype(np.int32),
            h3=rng.integers(0, e, (k, n)).astype(np.uint32), entries=e,
            inputs_per_filter=n, num_hashes=k))
    return export.InferenceArtifact(
        submodels=out, bias=rng.integers(-5, 6, m).astype(np.int32),
        num_classes=m, total_bits=total_bits, bits_per_input=bits_per_input)


ULN_L_SUBS = tuple((n, log2e, ULN_L["num_hashes"])
                   for n, log2e in ULN_L["submodels"])
ULN_L_BITS = ULN_L["features"] * ULN_L["bits_per_input"]
# the whole-ensemble kernel: ULN-L (all six submodels, the served batch),
# the ULN-XL ensemble (`repro/launch/uleen_cell.py::ULN_XL_ENSEMBLE_SPEC`:
# M = 32, three submodels up to E = 2^15), and edge cases: M = 40 (two
# class planes) with n = 64 and k = 8, M = 33 with rows of an odd byte
# count (tiles start off 16-byte boundaries), M = 8 (uint8 slices), M = 1,
# an all-zero mask, B = 1, B off a multiple of the 8-row tile, rows of
# 40001 bits (several staged windows), M = 129 (two class groups of the
# grid), perms reading 65,537 input bits (int32 indices: the
# global-gather route) and 250,000 bits with M = 200
ENSEMBLE_CASES = [
    dict(name="uln_l_six_submodels", main=True, m=ULN_L["num_classes"],
         subs=ULN_L_SUBS, total_bits=ULN_L_BITS, batch=INFER_BATCH),
    dict(name="uln_xl_ensemble_m32", timed=True, m=32,
         subs=((16, 11, 2), (24, 13, 2), (32, 15, 2)), total_bits=784 * 8,
         batch=INFER_BATCH),
    dict(name="m40_n64_k8", m=40, subs=((64, 10, 8), (7, 3, 1)),
         total_bits=2880, batch=1031),
    dict(name="m33_k5_odd_row_bytes", m=33, subs=((13, 8, 5), (9, 4, 3)),
         total_bits=1001, batch=4099),
    dict(name="m8_uint8_k4", m=8, subs=((12, 6, 2), (20, 7, 4)),
         total_bits=784 * 2, batch=2053),
    dict(name="m1", m=1, subs=((7, 3, 1),), total_bits=97, batch=5),
    dict(name="zero_mask", m=10, subs=((24, 8, 2),), total_bits=ULN_L_BITS,
         batch=2053, mask_kind="zeros"),
    dict(name="b1", m=10, subs=ULN_L_SUBS, total_bits=ULN_L_BITS, batch=1),
    # rows in five staged windows, perm indices past 32767
    dict(name="wide_rows_40001", m=10, subs=((16, 7, 2), (12, 6, 2)),
         total_bits=40001, batch=4099),
    dict(name="m129_class_groups", timed=True, m=129, subs=ULN_L_SUBS,
         total_bits=ULN_L_BITS, batch=16384),
    dict(name="cols_65537_global_gather", timed=True, m=10,
         subs=((16, 7, 2), (24, 8, 2)), total_bits=65537, batch=16384),
    dict(name="cols_250000_m200", m=200, subs=((64, 6, 2),),
         total_bits=250000, batch=1031),
]


def check_wnn_ensemble(gen, export, ref, kernels, wnn_ensemble, *,
                       device="cuda"):
    """The whole-ensemble kernel on both table layouts (class slices from
    the packed words and from the int8 tables) against its plain version,
    bit-equal, at ENSEMBLE_CASES; the ULN-L batch and the ULN-XL ensemble
    timed per call and on the device beside the plain version and the
    bound. Returns the kernels line's rows for packed_wnn and fused_wnn
    (the ULN-L batch)."""
    dev = device
    rows, main = [], {}
    for i, case in enumerate(ENSEMBLE_CASES):
        case = dict(case)
        name, is_main = case.pop("name"), case.pop("main", False)
        timed = is_main or case.pop("timed", False)
        b = case.pop("batch")
        art = seeded_artifact(export, 20270 + i, **case)
        bits = torch.randint(0, 2, (b, case["total_bits"]), generator=gen,
                             device=dev, dtype=torch.int8)
        preps = {k: export.prepare_artifact(art, backend=b, device=dev)
                 for k, b in (("packed_wnn", "auto"), ("fused_wnn", "fused"))}
        entries = {"packed_wnn": kernels.packed_wnn_ensemble,
                   "fused_wnn": kernels.fused_wnn_ensemble}
        pt = preps["packed_wnn"]

        def plain(rows_, prep=pt):
            return ref.wnn_ensemble_ref(rows_, prep.perms, prep.h3s,
                                        prep.slices, prep.class_masks,
                                        prep.bias)
        want = chunked(plain, b, bits)
        args = pt.kernel_args
        groups = -(-args.planes // wnn_ensemble.GROUP_PLANES)
        want_route = wnn_ensemble.perm_route(case["total_bits"])
        if args.route != want_route or \
                preps["fused_wnn"].kernel_args.route != want_route:
            raise AssertionError(f"{name}: route {args.route}, expected "
                                 f"{want_route}")
        row = {"case": name, "batch": b, "m": case["m"],
               "total_bits": case["total_bits"], "route": args.route,
               "planes": args.planes, "class_groups": groups,
               "shared_bytes": wnn_ensemble.shared_bytes(
                   args.columns, case["m"], args.route),
               "submodels": [list(sm) for sm in case["subs"]],
               "slice_bytes": pt.slice_bytes(),
               "packed_table_bytes": pt.table_bytes()}
        geoms = [(p.shape[0], p.shape[1], h.shape[0])
                 for p, h in zip(pt.perms, pt.h3s)]
        for kname, entry in entries.items():
            before = getattr(kernels, kname).launches
            got = entry(bits, preps[kname])
            torch.cuda.synchronize()
            if getattr(kernels, kname).launches != before + 1:
                raise AssertionError(f"{kname}_ensemble[{name}]: not one "
                                     "launch")
            err = assert_equal(f"{kname}_ensemble[{name}]", got, want)
            if not timed:
                continue
            ms = cuda_ms(lambda: entry(bits, preps[kname]), 20)
            device_ms = graph_ms(lambda: entry(bits, preps[kname]))
            by_terms, op_terms = wnn_ensemble.wnn_ensemble_cost(
                b, case["total_bits"], geoms, case["m"],
                preps[kname].kernel_args.nbytes())
            bms, by = bound(sum(by_terms.values()), sum(op_terms.values()),
                            INT32_OPS_PER_S)
            per_class_ops = sum(wnn_per_class_ops(b, n_f, n, case["m"], k)
                                for n_f, n, k in geoms)
            row[kname] = {
                "ms": ms, "device_ms": device_ms, "bound_ms": bms,
                "bound_by": by,
                "bound_per_class_ms": bound(sum(by_terms.values()),
                                            per_class_ops,
                                            INT32_OPS_PER_S)[0],
                "bytes": sum(by_terms.values()), "bytes_terms": by_terms,
                "ops": sum(op_terms.values()), "ops_terms": op_terms,
                "max_abs_err": err}
        if timed:
            plain_ms = cuda_ms(lambda: chunked(plain, b, bits), 3, warmup=1)
            for kname in entries:
                row[kname]["plain_ms"] = plain_ms
        if is_main:
            main = {k: dict(row[k], library_ms=None) for k in entries}
        rows.append(row)
        del bits, want, preps, pt
    emit("wnn_ensemble", cases=rows)
    return main


def front_end_kernel_name(mangled: str) -> str:
    """thermometer.cu's template arguments (T, 0 for run-time T; the
    staged threshold ring; encode or decompress) read off a mangled name."""
    args = re.search(r"front_end_kernelILi(\d+)ELb([01])ELb([01])E", mangled)
    if not args:
        return mangled
    bits = args[1] if args[1] != "0" else "run-time"
    staged = ", staged" if args[2] == "1" else ""
    kind = "encode" if args[3] == "1" else "decompress"
    return f"front_end_kernel<T={bits}{staged}, {kind}>"


# the front-end kernels' edge shapes: a ragged last 16 bytes (B·F·T off a
# multiple of 16), T = 1, 2, 16 and run-time T = 17, 33, a single row,
# thresholds past the staged ring (F·T = 11200, and 15005 off every
# 4-float boundary)
FRONT_END_EDGES = [(3, 5, 1), (1, 784, 7), (1027, 33, 9), (3, 5, 17),
                   (37, 29, 16), (11, 13, 33), (129, 61, 2), (5, 1600, 7),
                   (2, 3001, 5)]


def check_front_end_kernels(gen, ref, thermometer_encode,
                            thermometer_decompress):
    """Both front-end kernels at 65536 ULN-L rows against their plain
    versions and one PyTorch call each, bit-equal, timed per call (`ms`)
    and on the device (`device_ms`, CUDA-graph replays) beside the bytes
    bound (achieved TB/s and share of the bound from `device_ms`); then
    bit-equal at FRONT_END_EDGES with NaN features, ±inf thresholds and
    counts past T."""
    dev = "cuda"
    b, f, t = INFER_BATCH, ULN_L["features"], ULN_L["bits_per_input"]
    x = torch.randn((b, f), generator=gen, device=dev)
    x[::97, ::13] = float("nan")                  # NaN encodes to zeros
    thr = torch.sort(torch.randn((f, t), generator=gen, device=dev),
                     dim=1).values
    counts = torch.randint(0, t + 1, (b, f), generator=gen, device=dev,
                           dtype=torch.uint8)
    iota = torch.arange(t, dtype=torch.uint8, device=dev)

    # one PyTorch call each: a broadcasting compare; its bool output has
    # the kernel's {0, 1} bytes, so viewing it as int8 costs nothing
    def encode_library(x, thr):
        return torch.gt(x[:, :, None], thr[None]).view(torch.int8)

    def decompress_library(counts, t):
        return torch.lt(iota, counts[..., None]).view(torch.int8)

    out = {}
    for name, kern, plain, library, args, bytes_moved, ops_per_s in (
            ("thermometer_encode", thermometer_encode, ref.thermometer_ref,
             encode_library, (x, thr), b * f * 4 + f * t * 4 + b * f * t,
             FP32_OPS_PER_S),
            ("thermometer_decompress", thermometer_decompress,
             ref.decompress_ref, decompress_library, (counts, t),
             b * f + b * f * t, INT32_OPS_PER_S)):
        got = kern(*args)
        err = assert_equal(name, got, plain(*args))
        assert_equal(f"{name} vs one PyTorch call", got, library(*args))
        del got
        ms = cuda_ms(lambda: kern(*args), 20)
        device_ms = graph_ms(lambda: kern(*args))
        plain_ms = cuda_ms(lambda: plain(*args), 20)
        library_ms = cuda_ms(lambda: library(*args), 20)
        library_device_ms = graph_ms(lambda: library(*args))
        # one compare per output bit
        bms, by = bound(bytes_moved, b * f * t, ops_per_s)
        out[name] = {"ms": ms, "device_ms": device_ms, "plain_ms": plain_ms,
                     "library_ms": library_ms,
                     "library_device_ms": library_device_ms,
                     "bound_ms": bms, "bound_by": by, "bytes": bytes_moved,
                     "tb_per_s": bytes_moved / device_ms / 1e9,
                     "bound_share": bms / device_ms,
                     "ops": b * f * t, "max_abs_err": err}
    del x, counts
    for shape_b, shape_f, tt in FRONT_END_EDGES:
        shape = (shape_b, shape_f)
        xs = torch.randn(shape, generator=gen, device=dev)
        xs[::2, ::3] = float("nan")
        xs[-1, 0] = float("inf")
        ts = torch.randn((shape_f, tt), generator=gen, device=dev)
        ts[0, -1] = float("inf")
        ts[-1, 0] = float("-inf")
        cs = torch.randint(0, tt + 3, shape, generator=gen, device=dev,
                           dtype=torch.uint8)
        cs[0, 0] = 255                             # past T: all ones
        assert_equal(f"thermometer_encode{shape + (tt,)}",
                     thermometer_encode(xs, ts), ref.thermometer_ref(xs, ts))
        assert_equal(f"thermometer_decompress{shape + (tt,)}",
                     thermometer_decompress(cs, tt),
                     ref.decompress_ref(cs, tt))
    emit("front_end_kernels", edges=FRONT_END_EDGES, **out)
    return out


def check_h3_kernel(gen, ref, h3_hash):
    """The hash kernel against its plain version, bit-equal: every ULN-L
    geometry at 65536 rows (one hash precompute of that many rows, timed),
    the ULN-XL largest submodel, k = 1, 4, 8 and 9, odd n/N_f/B, n = 1,
    and k·n words past the 48 KB of shared memory."""
    dev = "cuda"
    total_bits = ULN_L["features"] * ULN_L["bits_per_input"]
    cases = [dict(name=f"uln_l_n{n}_e{2 ** log2e}", main=True,
                  batch=INFER_BATCH, n_f=math.ceil(total_bits / n), n=n,
                  log2_entries=log2e, k=ULN_L["num_hashes"])
             for n, log2e in ULN_L["submodels"]]
    xl = ULN_XL_LARGEST
    cases += [
        dict(name="uln_xl_n32_e32768", batch=INFER_BATCH,
             n_f=math.ceil(xl["total_bits"] / xl["n"]), n=xl["n"],
             log2_entries=xl["log2_entries"], k=2),
        dict(name="k1_odd", batch=4099, n_f=101, n=7, log2_entries=3, k=1),
        dict(name="k4", batch=4097, n_f=77, n=12, log2_entries=4, k=4),
        dict(name="k8_n64", batch=1031, n_f=45, n=64, log2_entries=10, k=8),
        dict(name="k9_runtime_k", batch=2053, n_f=229, n=24, log2_entries=8,
             k=9),
        dict(name="n1", batch=3001, n_f=total_bits, n=1, log2_entries=6,
             k=2),
        dict(name="n100_k3_odd", batch=999, n_f=55, n=100, log2_entries=12,
             k=3),
        dict(name="k9_n1500_params_in_global", batch=33, n_f=3, n=1500,
             log2_entries=15, k=9),
    ]
    rows = []
    total = dict(ms=0.0, plain_ms=0.0, device_ms=0.0, bytes=0, ops=0,
                 max_abs_err=0)
    for case in cases:
        name, main = case.pop("name"), case.pop("main", False)
        b, n_f, n, k = case["batch"], case["n_f"], case["n"], case["k"]
        tuples = torch.randint(0, 2, (b, n_f, n), generator=gen, device=dev,
                               dtype=torch.int8)
        params = torch.randint(0, 2 ** case["log2_entries"], (k, n),
                               generator=gen, device=dev, dtype=torch.int32)
        got = h3_hash(tuples, params)
        want = chunked(ref.h3_hash_ref, b, tuples, params)
        torch.cuda.synchronize()
        err = assert_equal(f"h3_hash[{name}]", got, want)
        total["max_abs_err"] = max(total["max_abs_err"], err)
        bytes_moved = b * n_f * n + k * n * 4 + b * n_f * k * 4
        ops = 2 * n * k * b * n_f             # select and XOR per bit, hash
        ms = cuda_ms(lambda: h3_hash(tuples, params), 20)
        plain_ms = cuda_ms(lambda: chunked(ref.h3_hash_ref, b, tuples,
                                           params), 3, warmup=1)
        bms, by = bound(bytes_moved, ops, INT32_OPS_PER_S)
        rows.append({"case": name, "batch": b, "n_f": n_f, "n": n, "k": k,
                     "ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
                     "bound_by": by, "bytes": bytes_moved, "ops": ops})
        if main:
            rows[-1]["device_ms"] = device_ms = graph_ms(
                lambda: h3_hash(tuples, params))
            for key, v in (("ms", ms), ("plain_ms", plain_ms),
                           ("device_ms", device_ms),
                           ("bytes", bytes_moved), ("ops", ops)):
                total[key] += v
        del tuples, params, got, want
    total["bound_ms"], total["bound_by"] = bound(total["bytes"], total["ops"],
                                                 INT32_OPS_PER_S)
    total["library_ms"] = None
    emit("h3_kernel", cases=rows, uln_l_hash_precompute=total)
    return {"h3_hash": total}


def visible_pairs(sq: int, sk: int, causal: bool, window: int,
                  q_offset: int = 0) -> int:
    """(query, key) pairs the mask keeps in one head: the work the flash
    kernel's data needs (query row i at position i + q_offset)."""
    i = np.arange(sq) + q_offset
    hi = np.minimum(i, sk - 1) if causal else np.full(sq, sk - 1)
    lo = np.maximum(i - window + 1, 0) if window > 0 else np.zeros(sq, int)
    return int(np.maximum(hi - lo + 1, 0).sum())


# the wrapper's key of a launch in `flash_attention.shapes`
FLASH_SHAPE_KEYS = ("b", "h", "hkv", "sq", "sk", "d", "dv", "causal",
                    "window", "q_offset")


def flash_shape(case) -> tuple:
    """A FLASH_CASES case's (or its timed row's) key in the flash
    wrapper's launch counts by shape."""
    return (case["b"], case["h"], case["hkv"], case["sq"], case["sk"],
            case["d"], case.get("dv", case["d"]), case.get("causal", True),
            case.get("window", 0), case.get("q_offset", 0))


FLASH_CASES = [
    # the LM path's prefill shape, float32 (the kernels line's row)
    dict(name="llama3p2_3b_prefill_b4_s1024", main=True, b=4, h=24, hkv=8,
         sq=1024, sk=1024, d=128, dtype=torch.float32),
    dict(name="bf16_b4_s1024", b=4, h=24, hkv=8, sq=1024, sk=1024, d=128,
         dtype=torch.bfloat16),
    # the Engine's batch-1 prefill (smaller query tiles fill the card)
    dict(name="engine_prefill_b1_s256", b=1, h=24, hkv=8, sq=256, sk=256,
         d=128, dtype=torch.float32),
    dict(name="window256_s1024", b=2, h=24, hkv=8, sq=1024, sk=1024,
         d=128, window=256, dtype=torch.float32),
    dict(name="bf16_window256_s1024", b=2, h=24, hkv=8, sq=1024, sk=1024,
         d=128, window=256, dtype=torch.bfloat16),
    dict(name="ragged_s777", b=1, h=24, hkv=8, sq=777, sk=777, d=128,
         dtype=torch.float32),
    dict(name="d64_gqa32_8_s512", b=2, h=32, hkv=8, sq=512, sk=512, d=64,
         dtype=torch.float32),
    dict(name="d256_noncausal_sq200_sk333", b=1, h=4, hkv=2, sq=200,
         sk=333, d=256, causal=False, dtype=torch.bfloat16),
    # rows past a cached prefix: Sk = Sq + q_offset, bottom-right diagonal
    dict(name="q_offset724_sq300_sk1024", b=1, h=24, hkv=8, sq=300, sk=1024,
         d=128, q_offset=724, dtype=torch.float32),
    dict(name="bf16_q_offset724_sq300_sk1024", b=1, h=24, hkv=8, sq=300,
         sk=1024, d=128, q_offset=724, dtype=torch.bfloat16),
    # narrow heads: 32- and 64-byte rows (32/64-byte TMA swizzle)
    dict(name="bf16_d16_s512", b=2, h=8, hkv=2, sq=512, sk=512, d=16,
         dtype=torch.bfloat16),
    dict(name="bf16_d32_s512", b=2, h=8, hkv=2, sq=512, sk=512, d=32,
         dtype=torch.bfloat16),
    # GQA groups other than the prefill's 3: multi-head (1) and 8
    dict(name="bf16_d64_mha8_s512", b=2, h=8, hkv=8, sq=512, sk=512, d=64,
         dtype=torch.bfloat16),
    dict(name="bf16_d64_gqa32_4_s512", b=2, h=32, hkv=4, sq=512, sk=512,
         d=64, dtype=torch.bfloat16),
    # q, k and v as slices of one fused (B, S, (H + 2 Hkv) D) projection:
    # k is neither contiguous nor a plain transpose
    dict(name="bf16_fused_qkv_s512", b=2, h=24, hkv=8, sq=512, sk=512,
         d=128, fused=True, dtype=torch.bfloat16),
    # the encoder-decoder and patch paths' shapes, float32 as their
    # parameters are (each `path`'s launches go beside it in the kernels
    # line). 6d: Whisper's encoder, non-causal over 1500 frames (not a
    # multiple of the 64-key tile); 6e, 6e': its cross attention over the
    # encoder's keys and values as the model keeps them, contiguous
    # (B, Hkv, F, hd), at prefill (224 prompt rows) and at decode (one
    # row a sequence); 6f: InternVL2's prefill, 256 patch rows ahead of
    # 1024 prompt tokens, causal over all 1280
    dict(name="whisper_encoder_b8_s1500_d64", row="6d", path="encdec", b=8,
         h=6, hkv=6, sq=1500, sk=1500, d=64, causal=False,
         dtype=torch.float32),
    dict(name="whisper_cross_prefill_b8_sq224_sk1500", row="6e",
         path="encdec", b=8, h=6, hkv=6, sq=224, sk=1500, d=64,
         causal=False, kv_contiguous=True, dtype=torch.float32),
    dict(name="whisper_cross_decode_b8_sq1_sk1500", row="6e'",
         path="encdec", b=8, h=6, hkv=6, sq=1, sk=1500, d=64, causal=False,
         kv_contiguous=True, dtype=torch.float32),
    dict(name="internvl2_prefill_b4_s1280", row="6f", path="vlm", b=4,
         h=48, hkv=8, sq=1280, sk=1280, d=128, dtype=torch.float32),
    # 6g: Qwen 1.5's prefill, multi-head (40 KV heads for 40 query heads,
    # group 1) at 128, causal over 1024 tokens
    dict(name="qwen1p5_prefill_b4_s1024_mha", row="6g", path="qwen", b=4,
         h=40, hkv=40, sq=1024, sk=1024, d=128, dtype=torch.float32),
    # 6h: the bf16 route at DeepSeek MLA's (192, 128), its prefill shape
    dict(name="bf16_deepseek_mla_b4_s1024_d192_dv128", row="6h", b=4, h=16,
         hkv=16, sq=1024, sk=1024, d=192, dv=128, scale=192 ** -0.5,
         dtype=torch.bfloat16),
]


def flash_inputs(gen, case, dev="cuda"):
    """q (B, H, Sq, D), k (B, Hkv, Sk, D) and v (B, Hkv, Sk, Dv) as the
    model has them: (B, S, H, D) projections viewed as (B, H, S, D); or
    slices of one fused projection; or (`kv_contiguous`) k and v
    contiguous (B, Hkv, Sk, D), as Whisper's cross keys and values lie.
    Dv is the case's `dv` (D when absent)."""
    b, h, hkv, sq, sk, d, dt = (case[k] for k in
                                ("b", "h", "hkv", "sq", "sk", "d", "dtype"))
    dv = case.get("dv", d)
    if case.get("fused"):
        qkv = torch.randn((b, sq, (h + 2 * hkv) * d), generator=gen,
                          device=dev).to(dt)
        q = qkv[..., :h * d].view(b, sq, h, d)
        k = qkv[..., h * d:(h + hkv) * d].view(b, sk, hkv, d)
        v = qkv[..., (h + hkv) * d:].view(b, sk, hkv, d)
    else:
        q = torch.randn((b, sq, h, d), generator=gen, device=dev).to(dt)
        k = torch.randn((b, sk, hkv, d), generator=gen, device=dev).to(dt)
        v = torch.randn((b, sk, hkv, dv), generator=gen, device=dev).to(dt)
    if case.get("kv_contiguous"):
        return (q.transpose(1, 2), k.transpose(1, 2).contiguous(),
                v.transpose(1, 2).contiguous())
    return q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)


MAIN_FLASH_KEYS = ("ms", "plain_ms", "library_ms", "device_ms",
                   "library_device_ms", "bound_ms", "bound_by",
                   "bound_cuda_core_ms", "bytes", "ops", "max_abs_err",
                   "tolerance")


def flash_case_row(gen, ref, flash_attention, plan, case, dev="cuda"):
    """One FLASH_CASES-style case: the kernel against its plain version
    within FLASH_TOL, timed beside it and one SDPA call, naming the route
    its type takes. Operations are 2·(D + Dv) FLOP per visible (query,
    key) pair of each head (4·D where Dv = D)."""
    name = case["name"]
    b, h, hkv, sq, sk, d, dt = (case[k] for k in
                                ("b", "h", "hkv", "sq", "sk", "d", "dtype"))
    dv = case.get("dv", d)
    causal, window = case.get("causal", True), case.get("window", 0)
    q_offset = case.get("q_offset", 0)
    kw = dict(causal=causal, window=window, q_offset=q_offset,
              scale=case.get("scale"))
    q, k, v = flash_inputs(gen, case, dev)
    got = flash_attention(q, k, v, **kw)
    want = ref.attention_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    diff = (got.float() - want.float()).abs()
    tol = FLASH_TOL[dt]
    if not bool((diff <= tol + tol * want.float().abs()).all()):
        raise AssertionError(f"flash_attention[{name}]: max |diff| "
                             f"{float(diff.max())} past tolerance {tol}")
    err = float(diff.max())
    del got, want, diff

    # one PyTorch call computing the same function: SDPA with the KV
    # heads repeated beforehand (the repeat is not timed)
    kr = k.repeat_interleave(h // hkv, dim=1)
    vr = v.repeat_interleave(h // hkv, dim=1)
    mask = None
    if window > 0 or (causal and (sq != sk or q_offset)):
        iq = q_offset + torch.arange(sq, device=dev)[:, None]
        ik = torch.arange(sk, device=dev)[None, :]
        mask = (ik <= iq) if causal else torch.ones_like(ik <= iq)
        if window > 0:
            mask = mask & (ik > iq - window)

    def library():
        return F.scaled_dot_product_attention(
            q, kr, vr, attn_mask=mask,
            is_causal=causal and mask is None, scale=kw["scale"])
    want = ref.attention_ref(q, k, v, **kw)
    lib_err = float((library().float() - want.float()).abs().max())
    del want
    ms = cuda_ms(lambda: flash_attention(q, k, v, **kw), 20)
    plain_ms = cuda_ms(lambda: ref.attention_ref(q, k, v, **kw), 5)
    library_ms = cuda_ms(library, 20)
    device_ms = graph_ms(lambda: flash_attention(q, k, v, **kw))
    library_device_ms = graph_ms(library)
    esize = q.element_size()
    bytes_moved = esize * (b * h * sq * (d + dv)
                           + b * hkv * sk * (d + dv))
    ops = 2 * (d + dv) * b * h * visible_pairs(sq, sk, causal, window,
                                               q_offset)
    rate = TF32X3_FLOP_PER_S if dt == torch.float32 else BF16_FLOP_PER_S
    bms, by = bound(bytes_moved, ops, rate)
    p = plan(dt, d, batch=b, heads=h, sq=sq, dv=dv)
    row = {"case": name, "row": case.get("row"), "route": p.route, "b": b,
           "h": h, "hkv": hkv,
           "sq": sq, "sk": sk, "d": d, "dv": dv, "causal": causal,
           "window": window, "q_offset": q_offset,
           "dtype": str(dt).replace("torch.", ""),
           "block_q": p.block_q, "block_k": p.block_k,
           "blocks": p.blocks, "max_abs_err": err, "tolerance": tol,
           "library_max_abs_err": lib_err, "ms": ms,
           "plain_ms": plain_ms, "library_ms": library_ms,
           "device_ms": device_ms,
           "library_device_ms": library_device_ms,
           "bound_ms": bms, "bound_by": by, "bytes": bytes_moved,
           "ops": ops, "tflop_per_s": ops / device_ms / 1e9}
    if dt == torch.float32:
        row["bound_cuda_core_ms"] = bound(bytes_moved, ops,
                                          FP32_FLOP_PER_S)[0]
    del q, k, v, kr, vr, mask
    return row


def check_flash_kernel(gen, ref, flash_attention, plan, *, device="cuda"):
    """The flash kernel against its plain version within FLASH_TOL at the
    cases of FLASH_CASES, each timed beside its plain version and one
    SDPA call, and each naming the route its type takes. Returns the main
    row's numbers and, as (path, row) pairs, the rows of the cases that
    name a path."""
    rows, main, by_path = [], None, []
    for case in FLASH_CASES:
        row = flash_case_row(gen, ref, flash_attention, plan, case, device)
        rows.append(row)
        if case.get("main", False):
            main = {k: row[k] for k in MAIN_FLASH_KEYS}
        if "path" in case:
            by_path.append((case["path"], row))
    emit("lm_kernel", cases=rows)
    return {"flash_attention": main}, by_path


# The Engine's batch-1 prefills (128-1024 prompt tokens) and two
# non-causal shapes, where every key tile is full (the steady state)
FLASH_SCALING = ([dict(b=1, sq=n, causal=True) for n in (128, 256, 512, 1024)]
                 + [dict(b=4, sq=1024, causal=False),
                    dict(b=1, sq=4096, causal=False)])


def flash_scaling(gen, ref, flash_attention, plan):
    """Device time (CUDA graphs) of the flash kernel and of one SDPA call
    at the Llama heads (24/8 of 128) over FLASH_SCALING, both types; each
    output held to its plain version within FLASH_TOL."""
    rows = []
    for dt in (torch.float32, torch.bfloat16):
        for shape in FLASH_SCALING:
            b, sq, causal = shape["b"], shape["sq"], shape["causal"]
            case = dict(b=b, h=24, hkv=8, sq=sq, sk=sq, d=128, dtype=dt)
            q, k, v = flash_inputs(gen, case)
            got = flash_attention(q, k, v, causal=causal)
            want = ref.attention_ref(q, k, v, causal=causal)
            diff = (got.float() - want.float()).abs()
            tol = FLASH_TOL[dt]
            if not bool((diff <= tol + tol * want.float().abs()).all()):
                raise AssertionError(f"flash_attention[b{b} s{sq}]: max "
                                     f"|diff| {float(diff.max())}")
            kr = k.repeat_interleave(3, dim=1)
            vr = v.repeat_interleave(3, dim=1)
            ms = graph_ms(lambda: flash_attention(q, k, v, causal=causal))
            lib = graph_ms(lambda: F.scaled_dot_product_attention(
                q, kr, vr, is_causal=causal))
            ops = 4 * b * 24 * 128 * visible_pairs(sq, sq, causal, 0)
            p = plan(dt, 128, batch=b, heads=24, sq=sq)
            rows.append({"dtype": str(dt).replace("torch.", ""), "b": b,
                         "sq": sq, "causal": causal, "route": p.route,
                         "block_q": p.block_q, "blocks": p.blocks,
                         "max_abs_err": float(diff.max()), "device_ms": ms,
                         "library_device_ms": lib,
                         "tflop_per_s": ops / ms / 1e9,
                         "library_tflop_per_s": ops / lib / 1e9})
            del q, k, v, kr, vr, got, want, diff
    emit("lm_kernel_scaling", cases=rows)


# ---------------------------------------------------------------------------
# Phase 5: the main path at full width
# ---------------------------------------------------------------------------

def uln_l_artifact(export, seed: int):
    """A seeded ULN-L artifact: random weights at full width."""
    return seeded_artifact(export, seed, m=ULN_L["num_classes"],
                           subs=ULN_L_SUBS, total_bits=ULN_L_BITS,
                           bits_per_input=ULN_L["bits_per_input"])


# the kernels of the serve path; the train path adds h3_hash
SERVE_KERNELS = ("packed_wnn", "fused_wnn", "thermometer_encode",
                 "thermometer_decompress")


def serve(WnnBatcher, art, bits_host, want, backend):
    # one warm-up step on a throwaway batcher: the allocator's first
    # (slots, ...) buffers and the kernel lookup are set-up, not serving
    warm = WnnBatcher(art, slots=SERVE_SLOTS, backend=backend)
    warm.submit(bits_host[0])
    warm.drain()
    eng = WnnBatcher(art, slots=SERVE_SLOTS, backend=backend)
    t0 = time.perf_counter()
    for row in bits_host:
        eng.submit(row)
    results = eng.drain()
    wall = time.perf_counter() - t0
    got = np.stack([r.scores for r in results])
    if not np.array_equal(got, want):
        raise AssertionError(f"WnnBatcher[{backend}] scores != direct scores")
    if [r.pred for r in results] != list(np.argmax(want, -1)):
        raise AssertionError(f"WnnBatcher[{backend}] preds != argmax")
    st = eng.stats()
    if st["traces"] != 1:
        raise AssertionError(f"WnnBatcher[{backend}] launched "
                             f"{st['traces']} batch shapes, not 1")
    return {"backend": backend, "requests_per_s": len(results) / wall,
            "wall_s": wall, "warm_up_batches": warm.batches, **st}


def main_path(export, ops, fit_gaussian_thermometer, WnnBatcher, kernels):
    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(20260)
    art = uln_l_artifact(export, seed=20260)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        path = str(Path(tmp) / "uln_l_artifact.npz")
        export.save(art, path)
        loaded = export.load(path)
    for a, b in zip(art.submodels, loaded.submodels):
        for field in ("packed", "mask", "perm", "h3"):
            if not np.array_equal(getattr(a, field), getattr(b, field)):
                raise AssertionError(f"save/load changed {field}")
    art = loaded
    f, t = ULN_L["features"], ULN_L["bits_per_input"]
    # synthetic features: per-feature offsets and scales, fitted on a
    # separate training draw
    centre = torch.randn((f,), generator=gen, device=dev)
    scale = torch.rand((f,), generator=gen, device=dev) + 0.5
    x_train = centre + scale * torch.randn((8192, f), generator=gen,
                                           device=dev)
    x = centre + scale * torch.randn((INFER_BATCH, f), generator=gen,
                                     device=dev)
    enc = fit_gaussian_thermometer(x_train, t)

    kernels.reset_launch_counts()          # the main path's run starts here
    t0 = time.perf_counter()
    bits3 = ops.thermometer(x, enc.thresholds)                 # kernel #3
    bits4 = ops.decompress(enc.encode_counts(x), t)            # kernel #4
    bits = bits3.reshape(INFER_BATCH, f * t)
    torch.cuda.synchronize()
    base_bytes = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    s_auto = export.artifact_scores(art, bits, backend="auto")     # #1
    s_fused = export.artifact_scores(art, bits, backend="fused")   # #2
    torch.cuda.synchronize()
    direct_s = time.perf_counter() - t0
    # what the two scoring calls (and the one-time table preparation)
    # held on the card past the batch's bits: no (B, N_f, n) tuples
    scoring_peak_bytes = torch.cuda.max_memory_allocated() - base_bytes
    bits_host = bits[:SERVE_REQUESTS].cpu().numpy()
    want = s_auto[:SERVE_REQUESTS].cpu().numpy()
    served = [serve(WnnBatcher, art, bits_host, want, b)
              for b in ("auto", "fused")]
    launches = kernels.launch_counts()     # ... and ends here

    # the whole scoring call per backend (one kernel launch, the wrapper's
    # host work included wherever the card waits for it)
    scores_ms = {b: cuda_ms(lambda: export.artifact_scores(
        art, bits, backend=b), 5) for b in ("auto", "fused")}
    front_end_ms = cuda_ms(lambda: ops.thermometer(x, enc.thresholds), 5)

    assert_equal("decompress(encode_counts(x)) vs thermometer(x)", bits4,
                 bits3)
    assert_equal("thermometer kernel vs encoder.encode",
                 bits.bool(), enc.encode(x))
    s_gather = chunked(lambda rows: export.artifact_scores(
        art, rows, backend="gather"), INFER_BATCH, bits)
    assert_equal("artifact_scores auto vs gather", s_auto, s_gather)
    assert_equal("artifact_scores fused vs gather", s_fused, s_gather)
    if s_auto.shape != (INFER_BATCH, ULN_L["num_classes"]):
        raise AssertionError(f"scores shape {tuple(s_auto.shape)}")
    preds = torch.argmax(s_auto, -1)
    idle = [k for k in SERVE_KERNELS if launches[k] == 0]
    if idle:
        raise AssertionError(f"main path never launched {idle}")
    # one WNN launch a batch: the direct call and every batcher step
    for kname, backend in (("packed_wnn", "auto"), ("fused_wnn", "fused")):
        sv = next(v for v in served if v["backend"] == backend)
        batches = 1 + sv["warm_up_batches"] + sv["batches"]
        if launches[kname] != batches:
            raise AssertionError(f"{kname} launched {launches[kname]} times "
                                 f"for {batches} batches")
    # one submodel's tuples alone would be B·N_f·n >= B·total_bits bytes
    if scoring_peak_bytes >= INFER_BATCH * f * t:
        raise AssertionError(f"scoring held {scoring_peak_bytes} bytes past "
                             "the bits: a tuple tensor was materialised")
    prep_p = export.prepare_artifact(art, backend="auto")
    prep_f = export.prepare_artifact(art, backend="fused")
    emit("main_path", model="ULN-L", total_bits=f * t,
         submodels=len(art.submodels), batch=INFER_BATCH,
         direct_s=direct_s, bits_set_share=float(bits3.float().mean()),
         pred_histogram=torch.bincount(preds, minlength=10).tolist(),
         packed_table_kib=art.packed_size_kib,
         class_slice_bytes={"packed": prep_p.slice_bytes(),
                            "fused": sum(t_.numel() * t_.element_size()
                                         for t_ in prep_f.slices)},
         kernel_args_bytes={"packed": prep_p.kernel_args.nbytes(),
                            "fused": prep_f.kernel_args.nbytes()},
         scoring_peak_bytes=scoring_peak_bytes,
         artifact_scores_ms=scores_ms, thermometer_ms=front_end_ms,
         serve=served,
         launches=launches)
    return launches


# ---------------------------------------------------------------------------
# Phase 6: the train path at full width, serving what it exports
# ---------------------------------------------------------------------------

def uln_l_train_spec(model):
    """ULN-L with the JAX spec's training flags (`uleen_cell.py:29-34`)."""
    return model.UleenSpec(
        num_classes=ULN_L["num_classes"],
        total_bits=ULN_L["features"] * ULN_L["bits_per_input"],
        submodels=tuple(model.SubmodelSpec(n, log2e, ULN_L["num_hashes"])
                        for n, log2e in ULN_L["submodels"]),
        bits_per_input=ULN_L["bits_per_input"], dropout_shared_classes=True,
        bf16_tables=True)


def synchronized(fn):
    """fn() and the host seconds until the device has finished it."""
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def train_path(mods, kernels, *, device="cuda"):
    """ULN-L as the paper trains it (Fig. 7b): Gaussian thermometer ->
    one-shot -> multi-shot STE (Adam 1e-3, batch 256, dropout 0.5 shared
    across classes, bf16 tables) -> prune 30 % + fine-tune -> export ->
    save/load -> serve through the packed kernel. Returns the launches of
    the kernels on this path."""
    (encoding, model, one_shot, multi_shot, pruning, export, ops, opt,
     synth) = mods
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(20262)
    spec = uln_l_train_spec(model)
    # the JAX package's synthetic MNIST (`data/synth.py`) at MNIST's shape
    ds = synth.make_mnist_like(gen, TRAIN_ROWS, VAL_ROWS, hw=28, device=dev)
    x_tr, y_tr, x_val, y_val = ds.x_train, ds.y_train, ds.x_test, ds.y_test
    t = ULN_L["bits_per_input"]
    seconds = {}

    kernels.reset_launch_counts()          # the train path's run starts here
    t_path = time.perf_counter()

    def encode():
        enc = encoding.fit_gaussian_thermometer(x_tr, t, device=dev)
        return [ops.thermometer(a, enc.thresholds, device=dev).reshape(
            a.shape[0], -1) for a in (x_tr, x_val)]

    (bits_tr, bits_val), seconds["fit_and_encode"] = synchronized(encode)
    statics = model.init_static(gen, spec, device=dev)
    hashes, seconds["hash_precompute"] = synchronized(
        lambda: model.compute_hashes(spec, statics, bits_tr, device=dev))
    osm, seconds["one_shot"] = synchronized(lambda: one_shot.train_one_shot(
        spec, statics, bits_tr[:ONE_SHOT_ROWS], y_tr[:ONE_SHOT_ROWS],
        bits_val, y_val, device=dev))
    os_acc = one_shot.evaluate_one_shot(spec, statics, osm, bits_val, y_val,
                                        device=dev)
    # init_scale sets only the time scale of STE training (an entry flips
    # after ~|init|/lr steps of one-signed gradient): at the default lr of
    # 1e-3, 0.01 lets two epochs move entries as far as the JAX package's
    # small runs do with 0.1 at 1e-2
    params = model.init_params(gen, spec, init_scale=0.01, device=dev)
    ms, seconds["multi_shot"] = synchronized(
        lambda: multi_shot.train_multi_shot(
            spec, statics, params, bits_tr, y_tr, bits_val, y_val,
            multi_shot.MultiShotConfig(epochs=2), device=dev))
    pruned, seconds["prune_and_finetune"] = synchronized(
        lambda: pruning.prune_and_finetune(
            spec, statics, ms.params, bits_tr, y_tr, bits_val, y_val,
            ratio=0.3, finetune=multi_shot.MultiShotConfig(epochs=1),
            device=dev))

    def export_and_load():
        art = export.export_model(spec, statics, pruned.params)
        with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
            path = str(Path(tmp) / "uln_l_trained.npz")
            export.save(art, path)
            return art, export.load(path)

    (art, loaded), seconds["export_save_load"] = synchronized(export_and_load)
    served, seconds["serve"] = synchronized(
        lambda: export.artifact_scores(loaded, bits_val, backend="auto",
                                       device=dev))
    seconds["path"] = time.perf_counter() - t_path
    launches = kernels.launch_counts()     # ... and ends here

    # one train step at batch 256 from the trained params
    optimizer = opt.adam(1e-3)
    step = multi_shot.make_train_step(spec, optimizer)
    leaves = [*ms.params.tables, ms.params.bias]
    state = optimizer.init(leaves)
    hb = tuple(h[:256] for h in hashes)
    step_ms = cuda_ms(lambda: step(ms.params, state, hb, y_tr[:256], gen), 10)

    # what came out is right: the artifact the port exported, saved and
    # loaded serves exactly what forward_binary computes on the binarized
    # trained params
    tables_bin, masks, bias = model.binarize_params(pruned.params)
    h_val = model.compute_hashes(spec, statics, bits_val, device=dev)
    want = model.forward_binary(spec, tables_bin, masks, bias, h_val)
    assert_equal("served exported artifact vs forward_binary", served, want)
    assert_equal("served predictions vs forward_binary's",
                 torch.argmax(served, -1), torch.argmax(want, -1))
    for a, b in zip(art.submodels, loaded.submodels):
        for field in ("packed", "mask", "perm", "h3"):
            if not np.array_equal(getattr(a, field), getattr(b, field)):
                raise AssertionError(f"save/load changed {field}")
    losses = [h["loss"] for h in ms.history + pruned.history]
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"non-finite training loss: {losses}")
    if os_acc <= ONE_SHOT_FLOOR:
        raise AssertionError(f"one-shot accuracy {os_acc} <= {ONE_SHOT_FLOOR}")
    if ms.val_accuracy <= MULTI_SHOT_FLOOR:
        raise AssertionError(f"multi-shot accuracy {ms.val_accuracy} <= "
                             f"{MULTI_SHOT_FLOOR}")
    idle = [k for k in ("h3_hash", "thermometer_encode", "packed_wnn")
            if launches[k] == 0]
    if idle:
        raise AssertionError(f"train path never launched {idle}")
    served_acc = float((torch.argmax(served, -1) == y_val).float().mean())
    emit("train_path", model="ULN-L", total_bits=spec.total_bits,
         submodels=len(spec.submodels), train_rows=TRAIN_ROWS,
         val_rows=VAL_ROWS, one_shot_rows=ONE_SHOT_ROWS,
         bf16_tables=spec.bf16_tables,
         dropout_shared_classes=spec.dropout_shared_classes,
         seconds=seconds, train_step_ms_batch256=step_ms,
         one_shot_acc=os_acc, one_shot_bleach=int(osm.bleach),
         multi_shot_val_acc=ms.val_accuracy, multi_shot_history=ms.history,
         pruned_val_acc=pruned.val_accuracy, served_exported_acc=served_acc,
         floors={"one_shot": ONE_SHOT_FLOOR, "multi_shot": MULTI_SHOT_FLOOR},
         size_kib=art.size_kib, packed_kib=art.packed_size_kib,
         bias=art.bias.tolist(), launches=launches)
    return launches


# ---------------------------------------------------------------------------
# Phase 7: the LM serve path at full width and depth
# ---------------------------------------------------------------------------

def timed_prefill_and_decode(prefill, decode, params, prompts, steps_n,
                             inputs=None):
    """(last-position logits, CUDA-event ms of one prefill, ms of each of
    `steps_n` greedy decode steps after it): prefill and decode calls of
    the path's run. `inputs`: the prefill batch's frames or patches."""
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    first, state = prefill(params, {"tokens": prompts, **(inputs or {})})
    b.record()
    b.synchronize()
    prefill_ms = a.elapsed_time(b)
    tok = torch.argmax(first[:, -1:], dim=-1).to(torch.int32)
    decode_ms = []
    for _ in range(steps_n):
        a.record()
        logits, state = decode(params, tok, state)
        b.record()
        b.synchronize()
        decode_ms.append(a.elapsed_time(b))
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)
    del state
    return first, prefill_ms, decode_ms


def check_launches(what: str, launches: dict, n_layers: int, prefills: int):
    """Flash attention launched once a layer a prefill call, and no other
    kernel."""
    if launches["flash_attention"] != n_layers * prefills:
        raise AssertionError(
            f"{what}: flash_attention launched "
            f"{launches['flash_attention']} times, not {n_layers} x "
            f"{prefills} prefill calls")
    others = {k: v for k, v in launches.items()
              if k != "flash_attention" and v}
    if others:
        raise AssertionError(f"{what} launched other kernels: {others}")


def check_served(what, served, batch, gen, vocab):
    if tuple(served.shape) != (batch, gen):
        raise AssertionError(f"{what}: serve() returned "
                             f"{tuple(served.shape)}")
    if not bool(((served >= 0) & (served < vocab)).all()):
        raise AssertionError(f"{what}: serve() returned tokens outside "
                             "the vocabulary")


def check_results(what, results, reqs):
    if len(results) != len(reqs):
        raise AssertionError(f"{what}: {len(results)} results for "
                             f"{len(reqs)} requests")
    short = [r.rid for r, q in zip(results, reqs)
             if len(r.tokens) != q.max_new]
    if short:
        raise AssertionError(f"{what}: requests {short} did not return "
                             "max_new tokens")


def lm_serve_path(kernels, *, get_config, transformer, steps, scheduler,
                  serve_fn, device="cuda"):
    """Llama 3.2 3B at full width and depth, float32 parameters drawn on
    the card: serve() on LM_BATCH prompts of LM_PROMPT tokens for LM_GEN
    tokens, then the Engine draining LM_REQUESTS mixed requests, four of
    which carry serve()'s prompts. Returns the path's kernel launches,
    the parameters (the head path reuses them) and the config."""
    dev = torch.device(device)
    cfg = get_config(LM_ARCH)
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(20263)
    params = transformer.init_params(cfg, gen, dtype=torch.float32,
                                     device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = transformer.param_count(params)
    rng = np.random.default_rng(20263)
    prompts = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (LM_BATCH, LM_PROMPT), dtype=np.int32)).to(dev)
    # the widest request plus one, rounded up to whole KV blocks so the
    # paged path serves the same backlog at the same cache width
    max_len = -(-(max(LM_PROMPT + LM_GEN, max(LM_PROMPT_LENS)
                      + max(LM_GEN_LENS)) + 1) // PAGED_BLOCK) * PAGED_BLOCK
    reqs = scheduler.synth_request_stream(
        cfg, LM_REQUESTS, seed=20263, prompt_lens=LM_PROMPT_LENS,
        gen_lens=LM_GEN_LENS)
    for i in range(LM_BATCH):           # four requests carry serve()'s prompts
        reqs[i].tokens = prompts[i].cpu().numpy()
        reqs[i].max_new = LM_GEN
    prefill = steps.make_prefill_step(cfg, max_len=max_len)
    decode = steps.make_decode_step(cfg)
    # warm-up outside the counted run: cuBLAS handles and plans
    prefill(params, {"tokens": prompts[:1, :128]})
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    kernels.reset_launch_counts()          # the LM path's run starts here
    prefill_calls = 0
    t_path = time.perf_counter()
    # serve()'s batch prefill, timed alone, and its decode steps
    ref_logits, prefill_ms, decode_ms = timed_prefill_and_decode(
        prefill, decode, params, prompts, LM_DECODE_TIMED_STEPS)
    prefill_calls += 1
    t0 = time.perf_counter()
    served = serve_fn(cfg, params, prompts, max_len=max_len, gen=LM_GEN)
    served = served.cpu()
    serve_s = time.perf_counter() - t0
    prefill_calls += 1

    eng = scheduler.Engine(cfg, params, slots=LM_SLOTS, max_len=max_len,
                           device=dev)
    first_logits, margins = tap_engine(eng)
    t0 = time.perf_counter()
    results = eng.run(reqs)
    torch.cuda.synchronize()
    engine_s = time.perf_counter() - t0
    prefill_calls += len(results)
    seconds = time.perf_counter() - t_path
    launches = kernels.launch_counts()     # ... and ends here
    peak_bytes = torch.cuda.max_memory_allocated()

    # what came out is right
    n_layers = cfg.num_layers
    check_launches("the LM path", launches, n_layers, prefill_calls)
    check_served("Llama", served, LM_BATCH, LM_GEN, cfg.padded_vocab)
    check_results("Llama Engine", results, reqs)
    if not bool(torch.isfinite(ref_logits).all()):
        raise AssertionError("non-finite prefill logits")
    logit_err = []
    for i in range(LM_BATCH):
        want = ref_logits[i, -1].float()
        got = first_logits[i]
        err = (got - want).abs()
        if not bool((err <= LM_PREFILL_LOGITS_TOL * (1 + want.abs())).all()):
            raise AssertionError(
                f"Engine prefill logits of request {i} differ from "
                f"serve()'s by {float(err.max())}")
        logit_err.append(float(err.max()))
        if results[i].tokens[0] != int(served[i, 0]):
            raise AssertionError(f"request {i}: first token "
                                 f"{results[i].tokens[0]} != serve()'s "
                                 f"{int(served[i, 0])}")
    agreement = [float(np.mean(np.asarray(results[i].tokens)
                               == served[i].numpy()))
                 for i in range(LM_BATCH)]
    st = eng.stats()
    if st["requests"] != LM_REQUESTS or eng.trace_counts["decode"] != 1:
        raise AssertionError(f"engine stats {st}, shapes "
                             f"{dict(eng.trace_counts)}")
    profile = lm_profile(params, prefill, decode, prompts)
    if isinstance(profile["decode_b4"], dict):
        profile["decode_b4"]["device_busy_share_of_untraced_step"] = (
            profile["decode_b4"]["device_ms_per_call"]
            / float(np.median(decode_ms)))
        profile["prefill_b4_s1024"]["device_busy_share_of_untraced_call"] = (
            profile["prefill_b4_s1024"]["device_ms_per_call"] / prefill_ms)
    emit("lm_serve_path", model=cfg.name, layers=n_layers, d_model=cfg.d_model,
         heads=cfg.num_heads, kv_heads=cfg.num_kv_heads,
         head_dim=cfg.resolved_head_dim, d_ff=cfg.d_ff,
         vocab=cfg.vocab_size, params=n_params, param_dtype="float32",
         kv_cache_dtype=cfg.kv_cache_dtype, init_s=init_s,
         max_len=max_len,
         serve={"batch": LM_BATCH, "prompt": LM_PROMPT, "gen": LM_GEN,
                "prefill_ms": prefill_ms,
                "prefill_tok_per_s": LM_BATCH * LM_PROMPT / prefill_ms * 1e3,
                "decode_ms_per_step_median": float(np.median(decode_ms)),
                "decode_ms_per_step": decode_ms,
                "serve_s": serve_s,
                "serve_tok_per_s": LM_BATCH * LM_GEN / serve_s},
         engine={"slots": LM_SLOTS, "requests": LM_REQUESTS,
                 "prompt_lens": LM_PROMPT_LENS, "gen_lens": LM_GEN_LENS,
                 "wall_s": engine_s,
                 "prompt_tokens": int(sum(q.prompt_len for q in reqs)),
                 "shapes": dict(eng.trace_counts), **st},
         prefill_logits_max_abs_err=logit_err,
         prefill_logits_tolerance=LM_PREFILL_LOGITS_TOL,
         first_token_equal=True, token_agreement_vs_serve=agreement,
         prefill_calls=prefill_calls, path_s=seconds,
         max_memory_allocated_gib=peak_bytes / 2 ** 30, launches=launches,
         profile=profile)
    contiguous = {"reqs": reqs, "max_len": max_len,
                  "tokens": [r.tokens for r in results],
                  "first_logits": first_logits, "margins": margins,
                  "stats": st, "wall_s": engine_s}
    del eng
    return launches, params, cfg, contiguous


def tap_engine(eng):
    """Wrap an Engine's prefill and decode steps (contiguous or paged) to
    record, by rid, each request's first-token logits (float32, on the
    card) and the top-2 margin of the logits behind every token it is
    given. Returns (first_logits, margins), filled as the engine runs."""
    first_logits, margins = {}, collections.defaultdict(list)
    prefill, decode = eng._prefill, eng._decode

    def top2_margins(last):
        top = last.float().topk(2, dim=-1).values
        return (top[:, 0] - top[:, 1]).tolist()

    def tapped_prefill(*args):
        logits, state = prefill(*args)
        # contiguous: (params, batch, length, slot, state); paged:
        # (params, batch, lengths, slots, tables, state), dummy rows first
        # and aliasing the first real row's slot, which is written later
        slots = args[3].tolist() if eng.paged else [int(args[3])]
        m = top2_margins(logits[:, -1])
        for row, slot in enumerate(slots):
            rid = eng.slots[int(slot)].request.rid
            first_logits[rid] = logits[row, -1].float()
            margins[rid] = [m[row]]
        return logits, state

    def tapped_decode(params, token, state, active, *rest):
        logits, state = decode(params, token, state, active, *rest)
        m = top2_margins(logits[:, -1])
        for i, live in enumerate(active.tolist()):
            if live:
                margins[eng.slots[i].request.rid].append(m[i])
        return logits, state

    eng._prefill, eng._decode = tapped_prefill, tapped_decode
    return first_logits, margins


def token_differences(tokens, want, *margins):
    """Requests whose tokens differ from `want`'s: the first differing
    position and the smallest top-2 margin of the logits behind it (each
    of `margins` by rid, as `tap_engine` records them)."""
    out = []
    for rid, (got, ref_) in enumerate(zip(tokens, want, strict=True)):
        if got != ref_:
            t = next(i for i, (a, b) in enumerate(zip(got, ref_)) if a != b)
            out.append({"rid": rid, "first_differing_token": t,
                        "top2_margin": min(m[rid][t] for m in margins)})
    return out


def lm_profile(params, prefill, decode, prompts, top: int = 10) -> dict:
    """Where the device time of one batch-4 prefill and of decode steps
    goes: a torch.profiler trace (CPU and CUDA activities) of each, the
    device kernels' time summed by name, and the device time per call.
    Kernels run on one stream, so their times do not overlap. The trace's
    own host overhead stretches the wall time, so the busy share of a step
    is taken against the untraced CUDA-event step time by the caller.
    "not measured" where the trace holds no device time."""
    from torch.profiler import ProfilerActivity, profile

    out = {}
    for name, steps_n in (("prefill_b4_s1024", 0), ("decode_b4", 4)):
        if steps_n:
            _, state = prefill(params, {"tokens": prompts})
            tok = torch.zeros((prompts.shape[0], 1), dtype=torch.int32,
                              device=prompts.device)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            if steps_n:
                for _ in range(steps_n):
                    _, state = decode(params, tok, state)
            else:
                prefill(params, {"tokens": prompts})
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        if steps_n:
            del state
        out[name] = device_kernel_times(prof, max(steps_n, 1), wall_us, top)
    return out

# ---------------------------------------------------------------------------
# Phase 8: the UleenHead on the full-width Llama 3.2 3B backbone
# ---------------------------------------------------------------------------

# `examples/distill_uleen_head.py`'s task and head at the backbone's full
# width: 1536 sequences of 32 tokens, 4 classes by vocabulary quartile,
# mean-pooled embeddings (d 3072), 4 thermometer bits a feature (12,288
# input bits), submodels (8, 2^6) and (16, 2^6); 150 Adam steps at 1e-2
# with dropout 0.5 on 1408 rows; accuracy on the other 128. A class's
# tokens come from 128 ids of its quartile, the quartile of the example as
# it runs (smoke vocabulary 512): drawn from whole quartiles of 128,256
# tokens, 32 random embeddings average to almost no class signal (a
# nearest-centroid classifier reaches ~0.5, the head chance), so that task
# is trained and reported beside it, not gated.
HEAD_ROWS, HEAD_SEQ, HEAD_TEST_ROWS, HEAD_STEPS = 1536, 32, 128, 150
# ---------------------------------------------------------------------------
# The paged LM engine: the LM path's backlog under half its KV memory
# ---------------------------------------------------------------------------

PAGED_BLOCK = 16
# (prefill_batch, pool): the half pool binds; the worst-case pool (the
# Engine's default) never does, which leaves the block gather's cost alone
PAGED_RUNS = ((1, "half"), (4, "half"), (1, "worst_case"))
# first-token logits of a batched prefill against the batch-1 prefill's
# (float32 GEMMs that cuBLAS may split otherwise for another batch, over
# 28 layers), and the top-2 margin under which a token may differ
PAGED_LOGITS_TOL = 1e-3
PAGED_MARGIN = 1e-3


def paged_path(kernels, params, cfg, contiguous, *, scheduler,
               device="cuda"):
    """The LM path's closed backlog of LM_REQUESTS requests through the
    paged Engine (8 slots, blocks of PAGED_BLOCK tokens) with a pool of
    1 + 4 x max_len / PAGED_BLOCK blocks, half the contiguous worst case,
    at prefill_batch 1 and 4, and at prefill_batch 1 with the worst-case
    pool. Held against the contiguous Engine's run of
    the same backlog (`contiguous`, from lm_serve_path): batch-1 prefill
    token for token; batched prefill's first-token logits within
    PAGED_LOGITS_TOL and its tokens equal wherever the top-2 margin is at
    least PAGED_MARGIN. Returns the path's kernel launches (both runs)."""
    dev = torch.device(device)
    max_len = contiguous["max_len"]
    per_slot = max_len // PAGED_BLOCK
    half = 1 + 4 * per_slot
    reqs = contiguous["reqs"]
    runs, total = [], {}
    for pb, pool in PAGED_RUNS:
        num_blocks = half if pool == "half" else 1 + LM_SLOTS * per_slot
        eng = scheduler.Engine(cfg, params, slots=LM_SLOTS, max_len=max_len,
                               paged=True, block_size=PAGED_BLOCK,
                               num_blocks=num_blocks, prefill_batch=pb,
                               device=dev)
        first_logits, margins = tap_engine(eng)
        pool_bytes = sum(c.k.numel() * c.k.element_size() * 2
                         for seg in eng.state.caches for c in seg.values())
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

        kernels.reset_launch_counts()      # this run of the path starts here
        t0 = time.perf_counter()
        results = eng.run(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = kernels.launch_counts()  # ... and ends here
        peak_bytes = torch.cuda.max_memory_allocated()
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v

        st = eng.stats()
        eng.allocator.check()
        if st["requests"] != LM_REQUESTS or st["blocks_in_use"] != 0:
            raise AssertionError(f"paged engine (prefill_batch {pb}): {st}")
        if not 0 < st["peak_blocks"] <= num_blocks - 1:
            raise AssertionError(f"peak blocks {st['peak_blocks']} of "
                                 f"{num_blocks}")
        check_launches(f"the paged path (prefill_batch {pb})", launches,
                       cfg.num_layers, eng.prefill_launches)
        check_results(f"paged Engine (prefill_batch {pb})", results, reqs)
        tokens = [r.tokens for r in results]
        logit_err = max(
            float((first_logits[i] - contiguous["first_logits"][i]).abs()
                  .max()) for i in range(LM_REQUESTS))
        differ = token_differences(tokens, contiguous["tokens"], margins,
                                   contiguous["margins"])
        if pb == 1 and differ:
            raise AssertionError(f"batch-1 paged tokens differ from the "
                                 f"contiguous Engine's: {differ}")
        for i in range(LM_REQUESTS):
            want = contiguous["first_logits"][i]
            err = (first_logits[i] - want).abs()
            if not bool((err <= PAGED_LOGITS_TOL * (1 + want.abs())).all()):
                raise AssertionError(
                    f"prefill_batch {pb}: request {i}'s first-token logits "
                    f"differ from the batch-1 prefill's by {float(err.max())}")
        wide = [d for d in differ if d["top2_margin"] >= PAGED_MARGIN]
        if wide:
            raise AssertionError(f"prefill_batch {pb}: tokens differ where "
                                 f"the top-2 margin is {PAGED_MARGIN} or "
                                 f"more: {wide}")
        runs.append({
            "prefill_batch": pb, "pool": pool, "num_blocks": num_blocks,
            "wall_s": wall,
            "tok_per_s": st["tok_per_s"],
            "latency_p50_s": st["latency_p50_s"],
            "latency_p99_s": st["latency_p99_s"],
            "queue_wait_mean_s": st["queue_wait_mean_s"],
            "decode_steps": st["decode_steps"],
            "peak_active": st["peak_active"],
            "prefill_launches": eng.prefill_launches,
            "peak_blocks": st["peak_blocks"],
            "pool_bytes": pool_bytes,
            "peak_pool_bytes_in_use": pool_bytes * st["peak_blocks"]
            // num_blocks,
            "max_memory_allocated_gib": peak_bytes / 2 ** 30,
            "first_logits_max_abs_err": logit_err,
            "tokens_equal_contiguous": not differ,
            "differing_requests": differ, "shapes": dict(eng.trace_counts),
            "launches": launches})
        del eng
    hd = cfg.resolved_head_dim
    contiguous_bytes = (cfg.num_layers * 2 * LM_SLOTS * cfg.num_kv_heads
                        * max_len * hd * 2)
    cst = contiguous["stats"]
    emit("paged_path", model=cfg.name, slots=LM_SLOTS, requests=LM_REQUESTS,
         max_len=max_len, block_size=PAGED_BLOCK, half_pool_blocks=half,
         contiguous_worst_case_blocks=LM_SLOTS * per_slot,
         block_bytes=cfg.num_layers * 2 * cfg.num_kv_heads * PAGED_BLOCK
         * hd * 2,
         contiguous_cache_bytes=contiguous_bytes,
         contiguous_engine={"wall_s": contiguous["wall_s"],
                            "tok_per_s": cst["tok_per_s"],
                            "latency_p50_s": cst["latency_p50_s"],
                            "latency_p99_s": cst["latency_p99_s"],
                            "queue_wait_mean_s": cst["queue_wait_mean_s"],
                            "decode_steps": cst["decode_steps"]},
         logits_tolerance=PAGED_LOGITS_TOL, margin=PAGED_MARGIN, runs=runs,
         launches=total)
    return total


HEAD_POOL = 128
HEAD_FLOOR = 0.5          # the example's assert (4 classes, chance 0.25)
HEAD_BACKENDS = ("gather", "fused", "packed", "auto")
WNN_KERNELS = ("packed_wnn", "fused_wnn")


def profiled_device_ms(fn, name_part: str, calls: int = 5):
    """Device ms per call of the kernels whose name holds `name_part`, from
    a torch.profiler trace of `calls` calls of fn(); "not measured" where
    the trace holds no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us = sum(getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0))
             for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA and name_part in e.key)
    return us / calls / 1e3 if us > 0 else "not measured"


def nearest_centroid_acc(h_tr, y_tr, h_te, y_te, classes: int) -> float:
    """Test accuracy of the nearest class mean of the row-normalised
    training states: how much linear class signal the pooling leaves."""
    def norm(h):
        return (h - h.mean(-1, keepdim=True)) / h.std(-1, keepdim=True)

    h_tr, h_te = norm(h_tr), norm(h_te)
    cen = torch.stack([h_tr[y_tr == c].mean(0) for c in range(classes)])
    pred = torch.cdist(h_te, cen).argmin(-1)
    return float((pred == y_te).float().mean())


def head_path(kernels, params, cfg, *, distill, head, wnn_ensemble,
              device="cuda"):
    """The UleenHead trained on the pooled embeddings of the full-width
    backbone whose parameters the LM path drew, then deployed binarized
    through every WNN backend. Returns the path's kernel launches."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(20264)
    tokens, y = distill.make_task(cfg, gen, n=HEAD_ROWS, seq=HEAD_SEQ,
                                  pool=HEAD_POOL)
    with torch.no_grad():
        h = distill.pooled_states(params, tokens)
    h_tr, y_tr = h[:-HEAD_TEST_ROWS], y[:-HEAD_TEST_ROWS]
    h_te, y_te = h[-HEAD_TEST_ROWS:], y[-HEAD_TEST_ROWS:]
    hcfg = distill.head_config(cfg.d_model)
    spec = hcfg.spec()
    state = distill.init_scaled_head(gen, hcfg, device=dev)
    torch.cuda.synchronize()

    kernels.reset_launch_counts()          # the head path's run starts here
    t0 = time.perf_counter()
    trained, losses = distill.train_head(hcfg, state, h_tr, y_tr, gen,
                                         steps=HEAD_STEPS, log=None)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    state = state._replace(params=trained)
    with torch.no_grad():
        scores = head.apply_head(hcfg, state, h_te, device=dev)
        deployed = {b: head.apply_head(hcfg, state, h_te, backend=b,
                                       device=dev) for b in HEAD_BACKENDS}
    torch.cuda.synchronize()
    launches = kernels.launch_counts()     # ... and ends here

    # what came out is right: the kernel backends bit-equal to the plain
    # gather formulation, the trained head above the example's floor
    for b in HEAD_BACKENDS:
        if deployed[b].dtype != torch.int32 or tuple(deployed[b].shape) != (
                HEAD_TEST_ROWS, hcfg.num_classes):
            raise AssertionError(f"deployed head {b}: {deployed[b].dtype} "
                                 f"{tuple(deployed[b].shape)}")
        assert_equal(f"deployed head {b} vs gather", deployed[b],
                     deployed["gather"])
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"non-finite head loss: {losses}")
    acc = float((torch.argmax(scores, -1) == y_te).float().mean())
    if acc <= HEAD_FLOOR:
        raise AssertionError(f"head test accuracy {acc} <= {HEAD_FLOOR}")
    idle = [k for k in ("h3_hash", *WNN_KERNELS) if launches[k] == 0]
    if idle:
        raise AssertionError(f"head path never launched {idle}")

    # the example's task over whole quartiles: trained the same way and
    # reported beside the gated one
    f_tokens, f_y = distill.make_task(cfg, gen, n=HEAD_ROWS, seq=HEAD_SEQ)
    with torch.no_grad():
        f_h = distill.pooled_states(params, f_tokens)
    f_state = distill.init_scaled_head(gen, hcfg, device=dev)
    f_params, f_losses = distill.train_head(
        hcfg, f_state, f_h[:-HEAD_TEST_ROWS], f_y[:-HEAD_TEST_ROWS], gen,
        steps=HEAD_STEPS, log=None)
    with torch.no_grad():
        f_scores = head.apply_head(hcfg, f_state._replace(params=f_params),
                                   f_h[-HEAD_TEST_ROWS:], device=dev)
    whole_quartiles = {
        "test_acc": float((torch.argmax(f_scores, -1)
                           == f_y[-HEAD_TEST_ROWS:]).float().mean()),
        "loss_last": f_losses[-1],
        "nearest_centroid_acc": nearest_centroid_acc(
            f_h[:-HEAD_TEST_ROWS], f_y[:-HEAD_TEST_ROWS],
            f_h[-HEAD_TEST_ROWS:], f_y[-HEAD_TEST_ROWS:], hcfg.num_classes)}

    step, ost = distill.make_step(hcfg, state, h_tr, y_tr)
    step_ms = cuda_ms(lambda: step(state.params, ost, gen), 10)
    served = {}
    for b in HEAD_BACKENDS:
        def call(b=b):
            with torch.no_grad():
                return head.apply_head(hcfg, state, h_te, backend=b,
                                       device=dev)
        before = kernels.launch_counts()
        call()
        torch.cuda.synchronize()
        after = kernels.launch_counts()
        ms = cuda_ms(call, 10)
        kernel_ms = profiled_device_ms(call, "wnn_ensemble_kernel")
        served[b] = {
            "ms": ms,
            "wnn_launches_per_call": sum(after[k] - before[k]
                                         for k in WNN_KERNELS),
            "wnn_kernel_device_ms": kernel_ms,
            "share_outside_kernel": (1.0 - kernel_ms / ms
                                     if isinstance(kernel_ms, float)
                                     else "not measured"),
            "test_acc": float((torch.argmax(deployed[b], -1) == y_te)
                              .float().mean())}
    emit("head_path", backbone=cfg.name, d_model=cfg.d_model,
         vocab=cfg.vocab_size, backbone_params=sum(
             p.numel() for p in params.parameters()),
         rows=HEAD_ROWS, seq=HEAD_SEQ, token_pool_per_class=HEAD_POOL,
         train_rows=HEAD_ROWS - HEAD_TEST_ROWS,
         test_rows=HEAD_TEST_ROWS, classes=hcfg.num_classes,
         bits_per_feature=hcfg.bits_per_feature, input_bits=spec.total_bits,
         submodels=[(sm.inputs_per_filter, sm.entries, spec.num_filters(sm))
                    for sm in spec.submodels],
         perm_route=wnn_ensemble.perm_route(spec.total_bits),
         steps=HEAD_STEPS, lr=1e-2, dropout=hcfg.dropout, train_s=train_s,
         train_step_ms=step_ms, loss_first=losses[0], loss_last=losses[-1],
         test_acc=acc, floor=HEAD_FLOOR,
         nearest_centroid_acc=nearest_centroid_acc(
             h_tr, y_tr, h_te, y_te, hcfg.num_classes),
         whole_quartiles_task=whole_quartiles, deployed_bit_equal=True,
         deployed=served, launches=launches)
    return launches


# ---------------------------------------------------------------------------
# Phase 9: a full-size ULN-S tenant fleet
# ---------------------------------------------------------------------------

# ULN-S (`repro/launch/uleen_cell.py:80-84`): 784 x 2 bits, submodels
# (12, 2^6), (16, 2^6), (20, 2^6), k = 2, M = 10; 2048 tenants
# (`MULTITENANT_TENANTS`, uleen_cell.py:89), seeded weights.
ULN_S_SUBS = ((12, 6, 2), (16, 6, 2), (20, 6, 2))
ULN_S_BITS = 784 * 2
TENANTS = 2048
TENANT_ROWS = 65536
TENANT_CHECKED = 8          # tenants cross-checked against the WNN kernel
TENANT_REQUESTS = 16384
TENANT_CAPACITY, TENANT_SLOTS = 64, 256
TENANT_ZIPF = 1.1


def tenant_path(kernels, export, runtime, WnnTenantBatcher, *,
                device="cuda"):
    """prepare_tenants over 2048 ULN-S tenants, stacked_predict on 65536
    rows of uniform tenant ids, and WnnTenantBatcher(capacity 64, slots
    256) through 16384 Zipf-distributed requests. Returns the path's
    kernel launches."""
    dev = torch.device(device)
    t0 = time.perf_counter()
    arts = [seeded_artifact(export, 30000 + t, m=10, subs=ULN_S_SUBS,
                            total_bits=ULN_S_BITS, bits_per_input=2)
            for t in range(TENANTS)]
    make_s = time.perf_counter() - t0
    gen = torch.Generator(device=dev).manual_seed(20265)
    bits = torch.randint(0, 2, (TENANT_ROWS, ULN_S_BITS), generator=gen,
                         device=dev, dtype=torch.int8)
    tids = torch.randint(0, TENANTS, (TENANT_ROWS,), generator=gen,
                         device=dev)
    rng = np.random.default_rng(20265)
    p = 1.0 / np.arange(1, TENANTS + 1) ** TENANT_ZIPF
    req_tids = rng.choice(TENANTS, size=TENANT_REQUESTS, p=p / p.sum())
    req_rows = bits[:TENANT_REQUESTS].cpu().numpy()
    torch.cuda.synchronize()

    kernels.reset_launch_counts()          # the tenant path's run starts here
    t0 = time.perf_counter()
    st = export.prepare_tenants(arts, device=dev)
    torch.cuda.synchronize()
    prepare_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    if export.prepare_tenants(arts, device=dev) is not st:
        raise AssertionError("prepare_tenants did not memoize the fleet")
    memo_s = time.perf_counter() - t0
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    scores, preds = runtime.stacked_predict(st, bits, tids, device=dev)
    torch.cuda.synchronize()
    peak_bytes = torch.cuda.max_memory_allocated() - base
    checked = {}
    for t in range(TENANT_CHECKED):
        sel = (tids == t).nonzero().squeeze(1)
        checked[t] = (sel, export.artifact_scores(
            arts[t], bits[sel], backend="packed", device=dev))
    warm = WnnTenantBatcher(capacity=TENANT_CAPACITY, slots=TENANT_SLOTS,
                            device=dev)
    for a in arts:
        warm.add_tenant(a)
    warm.submit(0, req_rows[0])
    warm.drain()
    tb = WnnTenantBatcher(capacity=TENANT_CAPACITY, slots=TENANT_SLOTS,
                          device=dev)
    for a in arts:
        tb.add_tenant(a)
    t0 = time.perf_counter()
    for tid, row in zip(req_tids, req_rows):
        tb.submit(int(tid), row)
    results = tb.drain()
    batcher_s = time.perf_counter() - t0
    launches = kernels.launch_counts()     # ... and ends here

    # what came out is right
    if tuple(scores.shape) != (TENANT_ROWS, 10) or scores.dtype != torch.int32:
        raise AssertionError(f"stacked scores {tuple(scores.shape)} "
                             f"{scores.dtype}")
    for t, (sel, want) in checked.items():
        if sel.numel() == 0:
            raise AssertionError(f"tenant {t} drew no rows")
        assert_equal(f"stacked scores vs the WNN kernel, tenant {t}",
                     scores[sel], want)
    if not torch.equal(preds.long(), torch.argmax(scores, -1)):
        raise AssertionError("stacked_predict preds != argmax of its scores")
    want_s, want_p = runtime.stacked_predict(
        st, torch.from_numpy(req_rows).to(dev),
        torch.from_numpy(req_tids).to(dev), device=dev)
    got_s = np.stack([r.scores for r in results])
    if not np.array_equal(got_s, want_s.cpu().numpy()):
        raise AssertionError("WnnTenantBatcher scores != stacked_predict")
    if [r.pred for r in results] != want_p.cpu().tolist():
        raise AssertionError("WnnTenantBatcher preds != stacked_predict")
    if [r.tid for r in results] != req_tids.tolist():
        raise AssertionError("WnnTenantBatcher routed a request elsewhere")
    bst = tb.stats()
    if bst["traces"] != 1 or bst["install_traces"] != 1:
        raise AssertionError(f"tenant batcher launched {bst['traces']} "
                             f"scores and {bst['install_traces']} install "
                             "shapes, not 1 and 1")
    if bst["hits"] + bst["misses"] != TENANT_REQUESTS or bst["evictions"] < 1:
        raise AssertionError(f"tenant batcher counts {bst}")
    if launches["packed_wnn"] != TENANT_CHECKED:
        raise AssertionError(f"packed_wnn launched {launches['packed_wnn']} "
                             f"times for {TENANT_CHECKED} checked tenants")

    # the tenant formulation beside the WNN kernel on the same rows
    stacked_ms = cuda_ms(lambda: runtime.stacked_scores(st, bits, tids,
                                                        device=dev), 5)
    solo = export.prepare_artifact(arts[0], device=dev)
    kernel_ms = cuda_ms(lambda: export.scores_from_prep(solo, bits,
                                                        backend="packed"), 5)
    kernel_device_ms = graph_ms(lambda: export.scores_from_prep(
        solo, bits, backend="packed"))
    sel0 = checked[0][0]
    rows0 = bits[sel0]
    tids0 = tids[sel0]
    checked_ms = {
        "rows": int(sel0.numel()),
        "stacked_ms": cuda_ms(lambda: runtime.stacked_scores(
            st, rows0, tids0, device=dev), 10),
        "kernel_ms": cuda_ms(lambda: export.scores_from_prep(
            solo, rows0, backend="packed"), 10)}
    per_tenant = [v["requests"] for v in bst.pop("per_tenant").values()]
    emit("tenant_path", model="ULN-S", tenants=TENANTS,
         total_bits=ULN_S_BITS,
         submodels=[(n, 2 ** log2e, k) for n, log2e, k in ULN_S_SUBS],
         make_artifacts_s=make_s, prepare_tenants_s=prepare_s,
         prepare_tenants_memo_s=memo_s,
         packed_kib_per_tenant=arts[0].packed_size_kib,
         stacked_table_bytes=st.table_bytes(),
         stacked_device_bytes=st.nbytes(),
         stacked_predict={"rows": TENANT_ROWS, "ms": stacked_ms,
                          "peak_bytes": peak_bytes,
                          "checked_tenants": TENANT_CHECKED,
                          "checked_rows": [int(v[0].numel())
                                           for v in checked.values()],
                          "bit_equal_to_wnn_kernel": True},
         wnn_kernel_same_rows={"rows": TENANT_ROWS, "tenant": 0,
                               "ms": kernel_ms, "device_ms": kernel_device_ms,
                               "stacked_over_kernel": stacked_ms / kernel_ms},
         one_tenants_rows=checked_ms,
         batcher={"capacity": TENANT_CAPACITY, "slots": TENANT_SLOTS,
                  "requests": TENANT_REQUESTS, "zipf_s": TENANT_ZIPF,
                  "distinct_tenants": int(len(np.unique(req_tids))),
                  "wall_s": batcher_s,
                  "requests_per_s": TENANT_REQUESTS / batcher_s,
                  "busiest_tenant_requests": max(per_tenant),
                  "warm_up_batches": warm.batches, **bst},
         launches=launches)
    return launches


# ---------------------------------------------------------------------------
# Sharded ULEEN serving: ranks of a torch.distributed mesh on the card(s)
# ---------------------------------------------------------------------------

# the ULN-XL ensemble (`repro/launch/uleen_cell.py:68-72`): M = 32 over
# 784 x 8 bits, the JAX package's class-sharding target
ULN_XL_SUBS = ((16, 11, 2), (24, 13, 2), (32, 15, 2))
ULN_XL_BITS = 784 * 8
ULN_XL_M = 32
SHARDED_ROWS = 65536
SHARDED_SLOTS = 8192
SHARDED_SEED = 20266
# world size -> (class meshes, tenant meshes), ranks sharing one card
SHARDED_RUNS = {2: ([((2,), ("model",))], [((2,), ("model",))]),
                4: ([((4,), ("model",)), ((2, 2), ("data", "model"))],
                    [((4,), ("model",))])}
SHARDED_TIMEOUT_S = 300


def mesh_tag(shape, axes) -> str:
    return "x".join(f"{a}{n}" for a, n in zip(axes, shape))


def host_ms(fn, reps: int = 5) -> float:
    """Median host milliseconds of fn() followed by a synchronize."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def in_turn(rank: int, world: int, fn):
    """fn() on each rank in turn, the others waiting at a barrier: device
    times of ranks that share a card, measured one rank at a time."""
    import torch.distributed as dist
    out = None
    for r in range(world):
        dist.barrier()
        if r == rank:
            out = fn()
            torch.cuda.synchronize()
    dist.barrier()
    return out


def sharded_rank(rank, world, plan):
    """One rank of the sharded path (run by `launch.mesh.spawn_ranks`):
    every rank draws the same artifact, rows and fleet from the same
    seeds, serves them on its class or tenant shard, and checks its
    scores bit-equal to the unsharded reference the parent computed.
    Returns the rank's measurements and kernel launch counts."""
    import torch.distributed as dist
    from repro_torch import kernels
    from repro_torch.core import export
    from repro_torch.dist import collectives
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch.scheduler import WnnBatcher
    from repro_torch.packed import runtime
    dev = mesh_mod.rank_device(plan["device"])
    backend = dist.get_backend()
    launches = {k: 0 for k in KERNEL_INFO}
    out = {"rank": rank, "device": str(dev), "backend": backend,
           "class": {}, "tenant": {}}
    art = seeded_artifact(export, SHARDED_SEED, m=ULN_XL_M, subs=ULN_XL_SUBS,
                          total_bits=ULN_XL_BITS, bits_per_input=8)
    gen = torch.Generator(device=dev).manual_seed(SHARDED_SEED)
    bits = torch.randint(0, 2, (SHARDED_ROWS, ULN_XL_BITS), generator=gen,
                         device=dev, dtype=torch.int8)
    rows = bits.cpu().numpy().astype(np.uint8)
    want = plan["class_want"]
    for shape, axes in plan["class_meshes"]:
        mesh = mesh_mod.make_mesh(shape, axes)
        tag = mesh_tag(shape, axes)
        t0 = time.perf_counter()
        warm = WnnBatcher(art, slots=SHARDED_SLOTS, mesh=mesh, device=dev)
        torch.cuda.synchronize()
        prepare_s = time.perf_counter() - t0
        warm.submit(rows[0])
        warm.drain()
        eng = WnnBatcher(art, slots=SHARDED_SLOTS, mesh=mesh, device=dev)
        for row in rows:
            eng.submit(row)
        kernels.reset_launch_counts()      # this rank's run starts here
        step_ms = []
        while eng.queue:
            t0 = time.perf_counter()
            eng.step()                     # ends in a host copy: synced
            step_ms.append((time.perf_counter() - t0) * 1e3)
        got = kernels.launch_counts()      # ... and ends here
        for k, v in got.items():
            launches[k] += v
        scores = np.stack([r.scores for r in eng.drain()])
        err = int(np.abs(scores.astype(np.int64) - want).max())
        if err:
            raise AssertionError(f"rank {rank} {tag}: class-sharded scores "
                                 f"differ from the unsharded batcher's by "
                                 f"{err}")
        st = eng.stats()
        if got["packed_wnn"] != eng.batches or st["traces"] != 1:
            raise AssertionError(f"rank {rank} {tag}: {got['packed_wnn']} "
                                 f"WNN launches for {eng.batches} batches, "
                                 f"{st['traces']} batch shapes")
        sp = eng._prep
        b_axes = runtime.batch_axes(mesh, sp.rules, SHARDED_SLOTS,
                                    exclude=sp.class_axes)
        local_rows = bits[collectives.row_slice(SHARDED_SLOTS, mesh, b_axes)
                          if b_axes else slice(0, SHARDED_SLOTS)]
        kernel_device_ms = in_turn(rank, world, lambda: graph_ms(
            lambda: export.scores_from_prep(sp.local, local_rows)))
        part = export.scores_from_prep(sp.local, local_rows)
        gather_ms = host_ms(lambda: collectives.all_gather(
            part, mesh, sp.class_axes, dim=1), reps=10)
        out["class"][tag] = {
            "class_shards": st["class_shards"], "classes": [sp.lo, sp.lo
                                                            + ULN_XL_M
                                                            // sp.degree],
            "rows_a_batch": int(local_rows.shape[0]),
            "batches": eng.batches, "prepare_s": prepare_s,
            "ms_per_batch_median": float(np.median(step_ms)),
            "requests_per_s": SHARDED_ROWS / (sum(step_ms) / 1e3),
            "wnn_kernel_device_ms": kernel_device_ms,
            "gather_ms": gather_ms,
            "gather": ("host-staged all_gather_into_tensor (gloo)"
                       if collectives.host_staged(mesh.get_group(
                           sp.class_axes[0])) else "all_gather_into_tensor "
                       f"({backend})"),
            "table_bytes": sp.local.table_bytes(),
            "class_slice_bytes": sp.local.slice_bytes(),
            "kernel_args_bytes": sp.local.kernel_args.nbytes(),
            "launches": got, "max_abs_err": err}
        del eng, warm
    if plan["tenant_meshes"]:
        arts = tenant_fleet(export)
        tgen = torch.Generator(device=dev).manual_seed(20265)
        tbits = torch.randint(0, 2, (TENANT_ROWS, ULN_S_BITS),
                              generator=tgen, device=dev, dtype=torch.int8)
        tids = torch.randint(0, TENANTS, (TENANT_ROWS,), generator=tgen,
                             device=dev)
        for shape, axes in plan["tenant_meshes"]:
            mesh = mesh_mod.make_mesh(shape, axes)
            tag = mesh_tag(shape, axes)
            t0 = time.perf_counter()
            st = export.prepare_tenants(arts, mesh=mesh, device=dev)
            torch.cuda.synchronize()
            prepare_s = time.perf_counter() - t0
            predict = runtime.make_tenant_sharded_predict(
                st, mesh, None, TENANT_ROWS, device=dev)
            scores, preds = predict(st, tbits, tids)
            err = int((scores.cpu().to(torch.int64)
                       - torch.from_numpy(plan["tenant_want"])).abs().max())
            if err or not torch.equal(preds.cpu().long(),
                                      torch.argmax(scores.cpu(), -1)):
                raise AssertionError(f"rank {rank} {tag}: tenant-sharded "
                                     f"scores differ from stacked_predict's "
                                     f"by {err}")
            part = torch.zeros_like(scores)
            out["tenant"][tag] = {
                "tenants_per_rank": st.local.num_tenants,
                "tenant_shards": st.num_tenants // st.local.num_tenants,
                "tenant_range": [st.lo, st.lo + st.local.num_tenants],
                "stacked_table_bytes": st.local.table_bytes(),
                "stacked_device_bytes": st.local.nbytes(),
                "prepare_tenants_s": prepare_s,
                "ms_per_call": host_ms(lambda: predict(st, tbits, tids)),
                "all_reduce_ms": host_ms(lambda: collectives.all_reduce_sum(
                    part, mesh, st.tenant_axes), reps=10),
                "max_abs_err": err}
    out["launches"] = launches
    return out


def tenant_fleet(export):
    """The tenant path's 2048 seeded ULN-S artifacts."""
    return [seeded_artifact(export, 30000 + t, m=10, subs=ULN_S_SUBS,
                            total_bits=ULN_S_BITS, bits_per_input=2)
            for t in range(TENANTS)]


def sharded_path(kernels, export, runtime, WnnBatcher, mesh_mod, *,
                 device="cuda"):
    """Class-sharded serving of the ULN-XL ensemble (WnnBatcher(mesh=) on
    65536 rows, model = 2 and 4 and data = 2 x model = 2) and
    tenant-sharded serving of the 2048-tenant ULN-S fleet
    (make_tenant_sharded_predict, model = 2 and 4), every rank's scores
    bit-equal to the unsharded port's. The ranks share the one card under
    gloo (collectives on host copies); with two or more cards a run with
    one rank per card under NCCL follows. Returns the launches summed
    over every rank."""
    dev = torch.device(device)
    art = seeded_artifact(export, SHARDED_SEED, m=ULN_XL_M, subs=ULN_XL_SUBS,
                          total_bits=ULN_XL_BITS, bits_per_input=8)
    gen = torch.Generator(device=dev).manual_seed(SHARDED_SEED)
    bits = torch.randint(0, 2, (SHARDED_ROWS, ULN_XL_BITS), generator=gen,
                         device=dev, dtype=torch.int8)
    ref = WnnBatcher(art, slots=SHARDED_SLOTS, device=dev)
    ref_prepare_bytes = export.prepare_artifact(art, device=dev).table_bytes()
    for row in bits.cpu().numpy().astype(np.uint8):
        ref.submit(row)
    step_ms = []
    while ref.queue:
        t0 = time.perf_counter()
        ref.step()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    class_want = np.stack([r.scores for r in ref.drain()]).astype(np.int64)
    prep = export.prepare_artifact(art, device=dev)
    rows = bits[:SHARDED_SLOTS]
    unsharded = {"ms_per_batch_median": float(np.median(step_ms)),
                 "wnn_kernel_device_ms": graph_ms(
                     lambda: export.scores_from_prep(prep, rows)),
                 "table_bytes": ref_prepare_bytes,
                 "class_slice_bytes": prep.slice_bytes()}
    del ref, prep, rows, bits
    arts = tenant_fleet(export)
    st = export.prepare_tenants(arts, device=dev)
    tgen = torch.Generator(device=dev).manual_seed(20265)
    tbits = torch.randint(0, 2, (TENANT_ROWS, ULN_S_BITS), generator=tgen,
                          device=dev, dtype=torch.int8)
    tids = torch.randint(0, TENANTS, (TENANT_ROWS,), generator=tgen,
                         device=dev)
    tenant_want = runtime.stacked_predict(st, tbits, tids, device=dev)[
        0].cpu().to(torch.int64).numpy()
    stacked_bytes = st.table_bytes()
    del st, tbits, tids, arts
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    runs = []
    cards = torch.cuda.device_count()
    plans = [(w, "gloo", cm, tm) for w, (cm, tm) in SHARDED_RUNS.items()]
    if cards >= 2:
        w = min(cards, 4)
        plans.append((w, mesh_mod.collective_backend(dev, w),
                      [((w,), ("model",))], [((w,), ("model",))]))
        nccl = f"ran: {w} ranks, one a card"
    else:
        nccl = (f"not run: {cards} CUDA device; one rank per card under "
                "NCCL needs 2 or more")
    for world, backend, cmeshes, tmeshes in plans:
        plan = {"class_meshes": cmeshes, "tenant_meshes": tmeshes,
                "class_want": class_want, "tenant_want": tenant_want,
                "device": device}
        t0 = time.perf_counter()
        outs = mesh_mod.spawn_ranks(sharded_rank, world, plan,
                                    backend=backend,
                                    timeout_s=SHARDED_TIMEOUT_S)
        runs.append({"world": world, "backend": backend,
                     "seconds": time.perf_counter() - t0, "ranks": outs})
    launches = {k: sum(o["launches"][k] for r in runs for o in r["ranks"])
                for k in KERNEL_INFO}
    if launches["packed_wnn"] == 0:
        raise AssertionError("the sharded path never launched packed_wnn")
    for r in runs:
        for o in r["ranks"]:
            for tag, t in o["tenant"].items():
                if t["stacked_table_bytes"] * t["tenant_shards"] != \
                        stacked_bytes or t["tenant_shards"] != r["world"]:
                    raise AssertionError(
                        f"{tag}: {t['stacked_table_bytes']} stacked bytes "
                        f"a rank over {t['tenant_shards']} shards, not "
                        f"{stacked_bytes} / {r['world']}")
    emit("sharded_path", model="ULN-XL ensemble", classes=ULN_XL_M,
         total_bits=ULN_XL_BITS,
         submodels=[(n, 2 ** log2e, k) for n, log2e, k in ULN_XL_SUBS],
         rows=SHARDED_ROWS, slots=SHARDED_SLOTS, unsharded=unsharded,
         tenant_fleet={"model": "ULN-S", "tenants": TENANTS,
                       "rows": TENANT_ROWS,
                       "stacked_table_bytes": stacked_bytes},
         nccl_one_rank_per_card=nccl, runs=runs, launches=launches)
    return launches


# ---------------------------------------------------------------------------
# Phase 10: the examples at their own sizes
# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# Phase 11: the MoE family at full width (Mixtral 8x7B, DeepSeek-V2-Lite)
# ---------------------------------------------------------------------------

# Mixtral 8x7B (`configs/mixtral_8x7b.py`) at full width (d 4096, 32/8
# heads of 128, 8 experts top-2, d_ff 14336, window 4096, vocabulary
# 32000), depth cut to MOE_LAYERS of 32: serve() on MOE_BATCH prompts of
# MOE_PROMPT tokens (past the window: the banded prefill and the ring's
# wrap both run), then an Engine of MOE_SLOTS slots on MOE_REQUESTS
# requests. Prompt lengths are multiples of 512: a prefill's tokens must
# split into MoE groups of 512 (`models/moe.py`), as in the JAX package.
MOE_ARCH, MOE_LAYERS = "mixtral_8x7b", 4
MOE_BATCH, MOE_PROMPT, MOE_GEN = 2, 6144, 32
MOE_SLOTS, MOE_REQUESTS = 4, 8
MOE_PROMPT_LENS, MOE_GEN_LENS = (512, 1024, 2048, 4096, 6144), (16, 32)
# the sorted and einsum dispatches on the same input: float32 sums in
# another order
MOE_DISPATCH_TOL = 1e-4
# DeepSeek-V2-Lite (`configs/deepseek_v2_lite_16b.py`) at full width and
# depth: serve() on MLA_BATCH prompts of MLA_PROMPT tokens, then the LM
# path's backlog (LM_REQUESTS requests, LM_SLOTS slots) through the
# contiguous and the paged Engine (blocks of PAGED_BLOCK)
MLA_ARCH = "deepseek_v2_lite_16b"
MLA_BATCH, MLA_PROMPT, MLA_GEN = 4, 1024, 32
MLA_PREFILL_BATCH = 4
MOE_DECODE_TIMED_STEPS = 4
# the flash kernel at the shapes these paths give it, float32 as their
# parameters are: Mixtral's banded prefill and DeepSeek's MLA prefill
# (q and k 128 + 64 wide, v 128, scale 1/sqrt(192))
FLASH_MOE_CASES = {
    "moe": dict(name="mixtral_banded_b2_s6144_w4096", b=2, h=32, hkv=8,
                sq=6144, sk=6144, d=128, window=4096, dtype=torch.float32),
    "mla": dict(name="deepseek_mla_b4_s1024_d192_dv128", b=4, h=16,
                hkv=16, sq=1024, sk=1024, d=192, dv=128,
                scale=192 ** -0.5, dtype=torch.float32),
    # RecurrentGemma's local layers: MQA (10 query heads over one KV head)
    # at head dim 256, a window of 2048 over 4096 tokens
    "hybrid": dict(name="recurrentgemma_local_b2_s4096_w2048_d256", b=2,
                   h=10, hkv=1, sq=4096, sk=4096, d=256, window=2048,
                   dtype=torch.float32),
}


def token_mask_check(cfg, params, transformer, steps, reqs, max_len, dev):
    """A masked decode step over 4 slots, the last two live: the live
    rows' logits are bit-equal whether the two idle slots hold zeros (and
    token 0) or two other requests' prefilled leftovers (and their
    tokens). The same pair of steps without the mask is reported beside
    it: queue positions follow the token order, so the idle rows, ahead
    of the live ones, claim expert capacity first."""
    prefill = steps.make_slot_prefill_step(cfg, max_len=max_len)
    shortest = sorted(reqs, key=lambda r: r.prompt_len)[:4]

    def state_with(rows):
        st = steps.serve_state_zeros(cfg, params, 4, max_len)
        toks = [0, 0, 0, 0]
        for slot, r in rows:
            batch = {"tokens": torch.from_numpy(r.tokens[None]).to(dev)}
            logits, st = prefill(params, batch, r.prompt_len, slot, st)
            toks[slot] = int(torch.argmax(logits[0, -1]))
        return st, torch.tensor(toks, dtype=torch.int32, device=dev)[:, None]

    live = [(2, shortest[0]), (3, shortest[1])]
    active = torch.tensor([False, False, True, True], device=dev)
    out = {}
    for masked in (True, False):
        logits = []
        for rows in (live, live + [(0, shortest[2]), (1, shortest[3])]):
            st, tok = state_with(rows)
            with torch.inference_mode():
                lg, _ = transformer.forward_decode(
                    cfg, params, tok, st,
                    token_mask=active if masked else None)
            logits.append(lg[2:].float())
            del st
        out["masked" if masked else "unmasked"] = {
            "live_rows_bit_equal": bool(torch.equal(*logits)),
            "max_abs_diff": float((logits[0] - logits[1]).abs().max())}
    if not out["masked"]["live_rows_bit_equal"]:
        raise AssertionError(f"token mask: live rows' logits moved with the "
                             f"idle slots' contents: {out}")
    return out


def moe_path(kernels, *, get_config, transformer, steps, scheduler,
             serve_fn, moe, layers, ref, flash_attention, plan,
             device="cuda"):
    """Mixtral 8x7B at full width, MOE_LAYERS layers, float32 parameters
    drawn on the card: the flash kernel at the banded prefill shape
    against its plain version; serve() on MOE_BATCH x MOE_PROMPT; an
    Engine of MOE_SLOTS slots on MOE_REQUESTS requests; then, outside the
    counted run, the two dispatches on layer 0's input and the token
    mask. Returns (launches, the flash row with the launches the run
    made at its shape)."""
    import dataclasses
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(20264)
    flash = flash_case_row(gen, ref, flash_attention, plan,
                           FLASH_MOE_CASES["moe"], device)
    torch.cuda.empty_cache()
    full = get_config(MOE_ARCH)
    cfg = dataclasses.replace(full, num_layers=MOE_LAYERS)
    t0 = time.perf_counter()
    params = transformer.init_params(cfg, gen, dtype=torch.float32,
                                     device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(20264)
    prompts = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (MOE_BATCH, MOE_PROMPT), dtype=np.int32)).to(dev)
    max_len = MOE_PROMPT + MOE_GEN
    reqs = scheduler.synth_request_stream(
        cfg, MOE_REQUESTS, seed=20264, prompt_lens=MOE_PROMPT_LENS,
        gen_lens=MOE_GEN_LENS)
    prefill = steps.make_prefill_step(cfg, max_len=max_len)
    decode = steps.make_decode_step(cfg)
    prefill(params, {"tokens": prompts[:1, :512]})      # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    kernels.reset_launch_counts()          # the MoE path's run starts here
    t_path = time.perf_counter()
    _, prefill_ms, decode_ms = timed_prefill_and_decode(
        prefill, decode, params, prompts, MOE_DECODE_TIMED_STEPS)
    t0 = time.perf_counter()
    served = serve_fn(cfg, params, prompts, max_len=max_len,
                      gen=MOE_GEN).cpu()
    serve_s = time.perf_counter() - t0
    eng = scheduler.Engine(cfg, params, slots=MOE_SLOTS, max_len=max_len,
                           device=dev)
    t0 = time.perf_counter()
    results = eng.run(reqs)
    torch.cuda.synchronize()
    engine_s = time.perf_counter() - t0
    seconds = time.perf_counter() - t_path
    launches = kernels.launch_counts()     # ... and ends here
    flash["launches"] = kernels.flash_attention.shapes[flash_shape(flash)]
    peak_bytes = torch.cuda.max_memory_allocated()

    check_launches("the MoE path", launches, cfg.num_layers,
                   2 + eng.prefill_launches)
    check_served("Mixtral", served, MOE_BATCH, MOE_GEN, cfg.padded_vocab)
    check_results("Mixtral Engine", results, reqs)
    st = eng.stats()
    if st["requests"] != MOE_REQUESTS or eng.trace_counts["decode"] != 1:
        raise AssertionError(f"Mixtral engine stats {st}")
    del eng

    # the two dispatches on layer 0's MoE input (its ln2 of the prompts'
    # embeddings): one group of 512 tokens a row of 512
    lp = params.segments[0].l0[0]
    x = layers.apply_norm(cfg, lp.ln2, params.embed[prompts[:, :4096].long()])
    with torch.inference_mode():
        ys, aux_s = moe.moe_block(cfg, lp.ffn, x)
        ecfg = dataclasses.replace(cfg, moe_dispatch="einsum")
        ye, aux_e = moe.moe_block(ecfg, lp.ffn, x)
        sorted_ms = cuda_ms(lambda: moe.moe_block(cfg, lp.ffn, x), 3, 1)
        einsum_ms = cuda_ms(lambda: moe.moe_block(ecfg, lp.ffn, x), 3, 1)
    dispatch_err = float((ys - ye).abs().max())
    if not bool(((ys - ye).abs() <= MOE_DISPATCH_TOL
                 * (1 + ye.abs())).all()):
        raise AssertionError(f"sorted and einsum dispatches differ by "
                             f"{dispatch_err}")
    del x, ys, ye
    mask = token_mask_check(cfg, params, transformer, steps, reqs, max_len,
                            dev)
    emit("moe_path", model=full.name, layers=cfg.num_layers,
         layers_published=full.num_layers, d_model=cfg.d_model,
         heads=cfg.num_heads, kv_heads=cfg.num_kv_heads,
         head_dim=cfg.resolved_head_dim, experts=cfg.num_experts,
         top_k=cfg.top_k, d_ff=cfg.moe_d_ff, window=cfg.sliding_window,
         vocab=cfg.vocab_size, params=transformer.param_count(params),
         param_dtype="float32", init_s=init_s, max_len=max_len,
         ring=min(max_len, cfg.sliding_window),
         serve={"batch": MOE_BATCH, "prompt": MOE_PROMPT, "gen": MOE_GEN,
                "prefill_ms": prefill_ms,
                "prefill_tok_per_s": MOE_BATCH * MOE_PROMPT / prefill_ms
                * 1e3,
                "decode_ms_per_step": decode_ms, "serve_s": serve_s,
                "serve_tok_per_s": MOE_BATCH * MOE_GEN / serve_s},
         engine={"slots": MOE_SLOTS, "requests": MOE_REQUESTS,
                 "prompt_lens": MOE_PROMPT_LENS, "gen_lens": MOE_GEN_LENS,
                 "wall_s": engine_s, "prefill_launches": len(results),
                 "prompt_tokens": int(sum(q.prompt_len for q in reqs)),
                 **st},
         dispatch={"tokens": MOE_BATCH * 4096, "max_abs_diff": dispatch_err,
                   "tolerance": MOE_DISPATCH_TOL, "aux_sorted": float(aux_s),
                   "aux_einsum": float(aux_e), "sorted_ms": sorted_ms,
                   "einsum_ms": einsum_ms},
         token_mask=mask, path_s=seconds,
         max_memory_allocated_gib=peak_bytes / 2 ** 30, launches=launches,
         flash=flash)
    del params
    gc.collect()
    return launches, flash


def mla_path(kernels, *, get_config, transformer, steps, scheduler,
             serve_fn, ref, flash_attention, plan, device="cuda"):
    """DeepSeek-V2-Lite at full width and depth, float32 parameters drawn
    on the card: the flash kernel at the MLA prefill shape against its
    plain version; serve() on MLA_BATCH x MLA_PROMPT; the LM path's
    backlog through the contiguous Engine, the paged Engine with the
    worst-case pool (the same schedule: tokens and first-token logits
    equal), with half of it (the pool binds) and with half of it at
    prefill_batch MLA_PREFILL_BATCH. Returns (launches, the flash row
    with the launches the run made at its shape)."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(20265)
    flash = flash_case_row(gen, ref, flash_attention, plan,
                           FLASH_MOE_CASES["mla"], device)
    torch.cuda.empty_cache()
    cfg = get_config(MLA_ARCH)
    t0 = time.perf_counter()
    params = transformer.init_params(cfg, gen, dtype=torch.float32,
                                     device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(20265)
    prompts = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (MLA_BATCH, MLA_PROMPT), dtype=np.int32)).to(dev)
    max_len = -(-(max(MLA_PROMPT + MLA_GEN, max(LM_PROMPT_LENS)
                      + max(LM_GEN_LENS)) + 1) // PAGED_BLOCK) * PAGED_BLOCK
    per_slot = max_len // PAGED_BLOCK
    reqs = scheduler.synth_request_stream(
        cfg, LM_REQUESTS, seed=20265, prompt_lens=LM_PROMPT_LENS,
        gen_lens=LM_GEN_LENS)
    prefill = steps.make_prefill_step(cfg, max_len=max_len)
    decode = steps.make_decode_step(cfg)
    prefill(params, {"tokens": prompts[:1, :128]})      # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    kernels.reset_launch_counts()          # the MLA path's run starts here
    t_path = time.perf_counter()
    _, prefill_ms, decode_ms = timed_prefill_and_decode(
        prefill, decode, params, prompts, MOE_DECODE_TIMED_STEPS)
    t0 = time.perf_counter()
    served = serve_fn(cfg, params, prompts, max_len=max_len,
                      gen=MLA_GEN).cpu()
    serve_s = time.perf_counter() - t0
    runs, prefills, groups = [], 2, []
    half = 1 + LM_SLOTS * per_slot // 2
    for paged, pool, pb in ((False, None, 1), (True, "worst_case", 1),
                            (True, "half", 1),
                            (True, "half", MLA_PREFILL_BATCH)):
        kw = {}
        if paged:
            kw = dict(paged=True, block_size=PAGED_BLOCK, prefill_batch=pb,
                      num_blocks=(half if pool == "half"
                                  else 1 + LM_SLOTS * per_slot))
        eng = scheduler.Engine(cfg, params, slots=LM_SLOTS,
                               max_len=max_len, device=dev, **kw)
        first_logits, margins = tap_engine(eng)
        if pb > 1:                         # keep each group's inputs
            inner = eng._prefill

            def keep_group(params_, batch, lengths, *rest, inner=inner):
                logits, state = inner(params_, batch, lengths, *rest)
                groups.append((batch["tokens"], lengths,
                               logits[:, -1].float()))
                return logits, state
            eng._prefill = keep_group
        pool_bytes = sum(t.numel() * t.element_size()
                         for seg in eng.state.caches for c in seg.values()
                         for t in c if t is not None)
        t0 = time.perf_counter()
        results = eng.run(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        check_results(f"DeepSeek Engine ({pool or 'contiguous'}, "
                      f"prefill_batch {pb})", results, reqs)
        st = eng.stats()
        if paged:
            eng.allocator.check()
            if st["blocks_in_use"] != 0:
                raise AssertionError(f"paged engine kept blocks: {st}")
        prefills += eng.prefill_launches
        runs.append({"paged": paged, "pool": pool, "prefill_batch": pb,
                     "num_blocks": kw.get("num_blocks"), "wall_s": wall,
                     "cache_bytes": pool_bytes,
                     "prefill_launches": eng.prefill_launches,
                     "tokens": [r.tokens for r in results],
                     "first_logits": first_logits, "margins": margins,
                     **{k: st[k] for k in (
                         "tok_per_s", "latency_p50_s", "latency_p99_s",
                         "queue_wait_mean_s", "decode_steps", "peak_active",
                         "peak_blocks")}})
        del eng
    seconds = time.perf_counter() - t_path
    launches = kernels.launch_counts()     # ... and ends here
    flash["launches"] = kernels.flash_attention.shapes[flash_shape(flash)]
    peak_bytes = torch.cuda.max_memory_allocated()

    check_launches("the MLA path", launches, cfg.num_layers, prefills)
    check_served("DeepSeek", served, MLA_BATCH, MLA_GEN, cfg.padded_vocab)
    contiguous = runs[0]
    # the paged engine on the contiguous engine's schedule: equal tokens
    # and first-token logits (paging changes where the latents lie, not
    # the arithmetic)
    worst = runs[1]
    if worst["tokens"] != contiguous["tokens"]:
        raise AssertionError("paged (worst-case pool) tokens differ from "
                             "the contiguous Engine's")
    worst_err = max(float((worst["first_logits"][i]
                           - contiguous["first_logits"][i]).abs().max())
                    for i in range(LM_REQUESTS))
    if worst_err > LM_PREFILL_LOGITS_TOL:
        raise AssertionError(f"paged first-token logits differ by "
                             f"{worst_err}")
    # batched prefill: the group's first-token logits against the model's
    # own batched prefill of the same padded rows (padded rows claim MoE
    # capacity there too, as in the JAX package), and, reported beside
    # it, against the batch-1 prefill, whose capacity differs
    group_err = 0.0
    with torch.inference_mode():
        for toks, lengths, logits in groups[:3]:
            want, _ = transformer.forward_prefill(cfg, params, toks,
                                                  max_len=max_len,
                                                  length=lengths)
            want = want[:, -1].float()
            err = (logits - want).abs()
            if not bool((err <= LM_PREFILL_LOGITS_TOL
                         * (1 + want.abs())).all()):
                raise AssertionError(f"batched prefill logits differ from "
                                     f"forward_prefill by {float(err.max())}")
            group_err = max(group_err, float(err.max()))
    batched = runs[3]
    if batched["prefill_launches"] > LM_REQUESTS:
        raise AssertionError(f"{batched['prefill_launches']} prefill "
                             f"launches for {LM_REQUESTS} requests")
    vs_batch1 = [float((batched["first_logits"][i]
                        - contiguous["first_logits"][i]).abs().max())
                 for i in range(LM_REQUESTS)]
    want_tokens = contiguous["tokens"]
    for r in runs:
        r["tokens_equal_contiguous"] = r["tokens"] == want_tokens
        r["requests_with_other_tokens"] = sum(
            a != b for a, b in zip(r["tokens"], want_tokens))
        del r["tokens"], r["first_logits"], r["margins"]
    hd_bytes = (cfg.kv_lora_rank * 4 + cfg.qk_rope_dim * 2)
    emit("mla_path", model=cfg.name, layers=cfg.num_layers,
         d_model=cfg.d_model, heads=cfg.num_heads,
         kv_lora_rank=cfg.kv_lora_rank, qk_dims=(cfg.qk_nope_dim,
                                                 cfg.qk_rope_dim),
         v_head_dim=cfg.v_head_dim, experts=cfg.num_experts,
         shared_experts=cfg.num_shared_experts, top_k=cfg.top_k,
         moe_d_ff=cfg.moe_d_ff, dense_layers=cfg.first_dense_layers,
         moe_dispatch=cfg.moe_dispatch, vocab=cfg.vocab_size,
         params=transformer.param_count(params), param_dtype="float32",
         init_s=init_s, max_len=max_len, block_size=PAGED_BLOCK,
         half_pool_blocks=half, latent_bytes_per_token_layer=hd_bytes,
         serve={"batch": MLA_BATCH, "prompt": MLA_PROMPT, "gen": MLA_GEN,
                "prefill_ms": prefill_ms,
                "prefill_tok_per_s": MLA_BATCH * MLA_PROMPT / prefill_ms
                * 1e3,
                "decode_ms_per_step": decode_ms, "serve_s": serve_s,
                "serve_tok_per_s": MLA_BATCH * MLA_GEN / serve_s},
         engines=runs, worst_case_pool_first_logits_max_abs_err=worst_err,
         batched_prefill_vs_forward_prefill_max_abs_err=group_err,
         batched_prefill_vs_batch1_max_abs_err=max(vs_batch1),
         batched_prefill_requests_within_tol_of_batch1=sum(
             e <= LM_PREFILL_LOGITS_TOL for e in vs_batch1),
         logits_tolerance=LM_PREFILL_LOGITS_TOL, path_s=seconds,
         max_memory_allocated_gib=peak_bytes / 2 ** 30, launches=launches,
         flash=flash)
    del params
    gc.collect()
    return launches, flash


# ---------------------------------------------------------------------------
# Phase 12: the SSM and hybrid families at full width and depth
# ---------------------------------------------------------------------------

# Mamba 2 2.7B (`configs/mamba2_2p7b.py`): serve() on SSM_BATCH prompts of
# SSM_PROMPT tokens, then the LM path's backlog (LM_REQUESTS requests of
# LM_PROMPT_LENS / LM_GEN_LENS) through the contiguous and the paged Engine
# with SSM_SLOTS slots. RecurrentGemma 2B (`configs/recurrentgemma_2b.py`):
# serve() on HYBRID_BATCH prompts of HYBRID_PROMPT tokens (past the local
# window of 2048: the windowed flash kernel skips tiles and the ring
# wraps), then HYBRID_REQUESTS requests of 512-4096 tokens through both
# engines.
SSM_ARCH, HYBRID_ARCH = "mamba2_2p7b", "recurrentgemma_2b"
SSM_BATCH, SSM_PROMPT, SSM_GEN, SSM_SLOTS = 4, 1024, 32, 4
HYBRID_BATCH, HYBRID_PROMPT, HYBRID_GEN = 2, 4096, 32
HYBRID_SLOTS, HYBRID_REQUESTS = 4, 8
HYBRID_PROMPT_LENS, HYBRID_GEN_LENS = (512, 1024, 2048, 4096), (16, 32)
RECURRENT_DECODE_TIMED_STEPS = 8
# one layer's prefill against the same tokens stepped one at a time
# through its decode recurrence (the card's own oracle: it has no JAX):
# outputs and final states within STEP_CHECK_TOL x (1 + |prefill|), a
# chunked or log-depth sum against a sequential one in float32
STEP_CHECK_TOKENS = {"ssd": 1024, "rec": 4096}
STEP_CHECK_TOL = 1e-3
# the Engine's first-token logits for serve()'s prompts: against a batch-1
# prefill of the same prompt (the same products: within
# SAME_BATCH_LOGITS_TOL), and against serve()'s batched prefill (float32
# GEMMs that cuBLAS splits otherwise for another batch, over 64 Mamba
# layers: 1.1e-3 measured, past the 28-layer Llama path's 1e-3)
SAME_BATCH_LOGITS_TOL = 1e-5
CROSS_BATCH_LOGITS_TOL = 1e-2


def stepwise_check(cfg, params, module, dev):
    """The model's first layer (SSD or RG-LRU, of `module`): its prefill of
    STEP_CHECK_TOKENS tokens (the normed embeddings of seeded tokens) with
    the final state, against as many decode steps from a zero state.
    Raises past STEP_CHECK_TOL; returns the errors and the two times."""
    from repro_torch.models.layers import apply_norm
    mixer = "ssd" if cfg.family == "ssm" else "rec"
    n_tokens = STEP_CHECK_TOKENS[mixer]
    lp = params.segments[0].l0[0]
    rng = np.random.default_rng(20266)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, n_tokens),
                                         dtype=np.int32)).to(dev)
    if mixer == "ssd":
        block, step, zero = (module.mamba2_block, module.mamba2_decode,
                             module.init_ssm_state)
    else:
        block, step, zero = (module.recurrent_block,
                             module.recurrent_block_decode,
                             module.init_rg_state)
    with torch.inference_mode():
        h = apply_norm(cfg, lp.ln1, params.embed[toks.long()])
        t0 = time.perf_counter()
        out, want = block(cfg, lp.mixer, h, return_state=True)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        st = zero(cfg, 1, device=dev)
        ys = []
        t0 = time.perf_counter()
        for i in range(n_tokens):
            y, st = step(cfg, lp.mixer, h[:, i:i + 1], st)
            ys.append(y)
        torch.cuda.synchronize()
        steps_s = time.perf_counter() - t0
        pairs = [("outputs", torch.cat(ys, dim=1), out)]
        pairs += [(f"state_{name}", got, ref_)
                  for name, got, ref_ in zip(want._fields, st, want)]
    errs = {}
    for name, got, ref_ in pairs:
        diff = (got.float() - ref_.float()).abs()
        errs[name] = {"max_abs_err": float(diff.max()),
                      "max_abs": float(ref_.float().abs().max())}
        if not bool((diff <= STEP_CHECK_TOL * (1 + ref_.float().abs()))
                    .all()):
            raise AssertionError(f"{cfg.name} {mixer} layer: {name} of the "
                                 f"prefill and of {n_tokens} decode steps "
                                 f"differ by {float(diff.max())}")
    return {"mixer": mixer, "tokens": n_tokens, "tolerance": STEP_CHECK_TOL,
            "prefill_s": prefill_s, "steps_s": steps_s, **errs}


def recurrent_path(kernels, *, family, get_config, transformer, steps,
                   scheduler, serve_fn, module, ref, flash_attention, plan,
                   device="cuda"):
    """Mamba 2 (`family="ssm"`) or RecurrentGemma (`"hybrid"`) at full
    width and depth, float32 parameters drawn on the card: (hybrid) the
    flash kernel at the local layers' shape against its plain version;
    serve(); a backlog through the contiguous Engine and the paged one
    (the same schedule, no block pool: equal tokens); then, outside the
    counted run, one recurrent layer's prefill against its decode steps.
    Returns (launches, the flash row with the launches the run made at
    its shape, or None)."""
    ssm_family = family == "ssm"
    dev = torch.device(device)
    # the previous model's engines sit in reference cycles (`tap_engine`):
    # free its parameters before this model's are drawn
    gc.collect()
    torch.cuda.empty_cache()
    gen = torch.Generator(device=dev).manual_seed(20267 if ssm_family
                                                  else 20268)
    flash = None
    if not ssm_family:
        flash = flash_case_row(gen, ref, flash_attention, plan,
                               FLASH_MOE_CASES["hybrid"], device)
        torch.cuda.empty_cache()
    cfg = get_config(SSM_ARCH if ssm_family else HYBRID_ARCH)
    batch, prompt, gen_n = ((SSM_BATCH, SSM_PROMPT, SSM_GEN) if ssm_family
                            else (HYBRID_BATCH, HYBRID_PROMPT, HYBRID_GEN))
    slots, n_req, plens, glens = (
        (SSM_SLOTS, LM_REQUESTS, LM_PROMPT_LENS, LM_GEN_LENS) if ssm_family
        else (HYBRID_SLOTS, HYBRID_REQUESTS, HYBRID_PROMPT_LENS,
              HYBRID_GEN_LENS))
    t0 = time.perf_counter()
    params = transformer.init_params(cfg, gen, dtype=torch.float32,
                                     device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(20267)
    prompts = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (batch, prompt), dtype=np.int32)).to(dev)
    max_len = -(-(max(prompt + gen_n, max(plens) + max(glens)) + 1)
                // PAGED_BLOCK) * PAGED_BLOCK
    reqs = scheduler.synth_request_stream(cfg, n_req, seed=20267,
                                          prompt_lens=plens, gen_lens=glens)
    for i in range(batch):             # these requests carry serve()'s prompts
        reqs[i].tokens = prompts[i].cpu().numpy()
        reqs[i].max_new = gen_n
    attn_layers = sum(seg.repeat for seg in transformer.arch_segments(cfg)
                      for ls in seg.layers if ls.mixer in ("attn", "local"))
    prefill = steps.make_prefill_step(cfg, max_len=max_len)
    decode = steps.make_decode_step(cfg)
    prefill(params, {"tokens": prompts[:1, :128]})      # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    kernels.reset_launch_counts()          # the path's run starts here
    t_path = time.perf_counter()
    ref_logits, prefill_ms, decode_ms = timed_prefill_and_decode(
        prefill, decode, params, prompts, RECURRENT_DECODE_TIMED_STEPS)
    t0 = time.perf_counter()
    served = serve_fn(cfg, params, prompts, max_len=max_len, gen=gen_n).cpu()
    serve_s = time.perf_counter() - t0
    runs, prefills = [], 2
    for paged in (False, True):
        kw = dict(paged=True, block_size=PAGED_BLOCK) if paged else {}
        eng = scheduler.Engine(cfg, params, slots=slots, max_len=max_len,
                               device=dev, **kw)
        pooled = [type(c).__name__ for seg in eng.state.caches
                  for c in seg.values()
                  if "Paged" in type(c).__name__]
        if pooled:
            raise AssertionError(f"{cfg.name}: the paged engine allocated "
                                 f"block pools {pooled}")
        state_bytes = sum(t.numel() * t.element_size()
                          for seg in eng.state.caches for c in seg.values()
                          for t in c if t is not None)
        first_logits, margins = tap_engine(eng)
        t0 = time.perf_counter()
        results = eng.run(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        check_results(f"{cfg.name} Engine (paged={paged})", results, reqs)
        st = eng.stats()
        if st["requests"] != n_req or eng.trace_counts["decode"] != 1:
            raise AssertionError(f"{cfg.name} engine stats {st}")
        if paged:
            eng.allocator.check()
            if st["blocks_in_use"] != 0:
                raise AssertionError(f"paged engine kept blocks: {st}")
        prefills += eng.prefill_launches
        runs.append({"paged": paged, "wall_s": wall,
                     "state_bytes_per_slot": state_bytes // slots,
                     "prefill_launches": eng.prefill_launches,
                     "tokens": [r.tokens for r in results],
                     "first_logits": first_logits,
                     **{k: st[k] for k in (
                         "tok_per_s", "latency_p50_s", "latency_p99_s",
                         "queue_wait_mean_s", "decode_steps", "peak_active",
                         "peak_blocks")},
                     "generated_tokens": st["tokens"]})
        del eng
    seconds = time.perf_counter() - t_path
    launches = kernels.launch_counts()     # ... and ends here
    if flash is not None:
        flash["launches"] = kernels.flash_attention.shapes[
            flash_shape(flash)]
    peak_bytes = torch.cuda.max_memory_allocated()

    check_launches(f"the {family} path", launches, attn_layers, prefills)
    check_served(cfg.name, served, batch, gen_n, cfg.padded_vocab)
    if not bool(torch.isfinite(ref_logits).all()):
        raise AssertionError(f"{cfg.name}: non-finite prefill logits")
    contiguous, paged_run = runs
    if paged_run["tokens"] != contiguous["tokens"]:
        raise AssertionError(f"{cfg.name}: paged Engine tokens differ from "
                             "the contiguous Engine's")
    # the Engine's first-token logits for serve()'s prompts against a
    # batch-1 prefill of each prompt (and its first token that prefill's
    # argmax), and against serve()'s batched prefill
    logit_err = {"same_batch": [], "cross_batch": []}
    for i in range(batch):
        got = contiguous["first_logits"][i]
        with torch.inference_mode():
            one = prefill(params, {"tokens": prompts[i:i + 1]})[0][0, -1]
        for key, want, tol in (("same_batch", one.float(),
                                SAME_BATCH_LOGITS_TOL),
                               ("cross_batch", ref_logits[i, -1].float(),
                                CROSS_BATCH_LOGITS_TOL)):
            err = (got - want).abs()
            if not bool((err <= tol * (1 + want.abs())).all()):
                raise AssertionError(
                    f"{cfg.name}: Engine prefill logits of request {i} "
                    f"differ from the {key} prefill's by {float(err.max())}")
            logit_err[key].append(float(err.max()))
        if contiguous["tokens"][i][0] != int(torch.argmax(one)):
            raise AssertionError(f"{cfg.name} request {i}: first token "
                                 "differs from the batch-1 prefill's")
    agreement = [float(np.mean(np.asarray(contiguous["tokens"][i])
                               == served[i].numpy())) for i in range(batch)]
    want_tokens = contiguous["tokens"]
    for r in runs:
        r["tokens_equal_contiguous"] = r["tokens"] == want_tokens
        del r["tokens"], r["first_logits"]
    step_check = stepwise_check(cfg, params, module, dev)
    emit(f"{family}_path", model=cfg.name, layers=cfg.num_layers,
         d_model=cfg.d_model, vocab=cfg.vocab_size,
         **({"ssm_state": cfg.ssm_state, "ssm_head_dim": cfg.ssm_head_dim,
             "ssm_heads": cfg.ssm_expand * cfg.d_model // cfg.ssm_head_dim,
             "ssm_chunk": cfg.ssm_chunk} if ssm_family else
            {"block_pattern": cfg.block_pattern, "lru_width": cfg.lru_width,
             "heads": cfg.num_heads, "kv_heads": cfg.num_kv_heads,
             "head_dim": cfg.resolved_head_dim, "d_ff": cfg.d_ff,
             "local_window": cfg.local_window,
             "ring": min(max_len, cfg.local_window),
             "attention_layers": attn_layers}),
         params=transformer.param_count(params), param_dtype="float32",
         init_s=init_s, max_len=max_len,
         serve={"batch": batch, "prompt": prompt, "gen": gen_n,
                "prefill_ms": prefill_ms,
                "prefill_tok_per_s": batch * prompt / prefill_ms * 1e3,
                "decode_ms_per_step_median": float(np.median(decode_ms)),
                "decode_ms_per_step": decode_ms, "serve_s": serve_s,
                "serve_tok_per_s": batch * gen_n / serve_s},
         engine={"slots": slots, "requests": n_req, "prompt_lens": plens,
                 "gen_lens": glens,
                 "prompt_tokens": int(sum(q.prompt_len for q in reqs))},
         engines=runs, prefill_logits_max_abs_err=logit_err,
         prefill_logits_tolerance={"same_batch": SAME_BATCH_LOGITS_TOL,
                                   "cross_batch": CROSS_BATCH_LOGITS_TOL},
         token_agreement_vs_serve=agreement, step_check=step_check,
         prefill_calls=prefills, path_s=seconds,
         max_memory_allocated_gib=peak_bytes / 2 ** 30, launches=launches,
         flash=flash)
    del params
    gc.collect()
    return launches, flash


# ---------------------------------------------------------------------------
# Phase 13: the encoder-decoder and patch families, and Qwen 1.5's
# quantised KV cache
# ---------------------------------------------------------------------------

# Whisper tiny (`configs/whisper_tiny.py`) at full width and depth: serve()
# on ENCDEC_BATCH prompts over as many 1500-frame encoder inputs, then
# ENCDEC_REQUESTS requests, each with its own frames, through the
# contiguous Engine and the paged one (PAGED_RUNS). InternVL2 26B
# (`configs/internvl2_26b.py`) at full width, depth cut to VLM_LAYERS of
# 48 (all 48 in float32, 79.5 GB, do not fit one card beside their
# activations): serve() on VLM_BATCH x (256 patch rows + VLM_PROMPT
# tokens), then VLM_REQUESTS requests with their patches through both
# engines. Qwen 1.5 32B (`configs/qwen1p5_32b.py`: MHA 40/40 x 128, QKV
# bias, its int8 KV cache) at full width, depth cut to QWEN_LAYERS of 64
# (all 64 in float32, 141 GB, are not one card): serve() on QWEN_BATCH x
# QWEN_PROMPT, QWEN_REQUESTS requests through the contiguous Engine and
# the paged ones (PAGED_RUNS), then serve() and the contiguous Engine
# again on the int4 cache.
ENCDEC_ARCH, VLM_ARCH, QWEN_ARCH = "whisper_tiny", "internvl2_26b", \
    "qwen1p5_32b"
ENCDEC_BATCH, ENCDEC_PROMPT, ENCDEC_GEN = 8, 224, 64
ENCDEC_SLOTS, ENCDEC_REQUESTS = 8, 32
ENCDEC_PROMPT_LENS, ENCDEC_GEN_LENS = (16, 32, 64, 128, 224), (16, 32, 64)
VLM_LAYERS = 12
VLM_BATCH, VLM_PROMPT, VLM_GEN = 4, 1024, 32
VLM_SLOTS, VLM_REQUESTS = 4, 8
VLM_PROMPT_LENS, VLM_GEN_LENS = (128, 256, 512, 1024), (16, 32)
QWEN_LAYERS = 12
QWEN_BATCH, QWEN_PROMPT, QWEN_GEN = 4, 1024, 32
QWEN_SLOTS, QWEN_REQUESTS, QWEN_MAX_LEN = 8, 32, 2048
QWEN_PROMPT_LENS, QWEN_GEN_LENS = (128, 256, 512, 1024), (32,)
PREFIX_DECODE_TIMED_STEPS = 8
# (prefill_batch, pool) of each family's paged runs, after the contiguous
# one; a half pool holds half the slots' worst case
PREFIX_PAGED_RUNS = {"encdec": PAGED_RUNS,
                     "vlm": ((1, "worst_case"), (4, "half")),
                     "qwen": PAGED_RUNS}
# one decode step's logits against a prefill over the prompt and the
# token it was given whose last row attends as the decode step does (over
# keys and values rounded to the cache's bf16, or quantised and
# dequantised to bf16 as the int8 / int4 cache stores and reads them,
# with bf16 probabilities); the rows before it are the prompt's, which the
# decode step reads from its cache. Whisper's gap is ~1e-5 to 1e-4 (its
# float32 prefill's ~1e-3); InternVL2's 12 random 6144-wide layers turn
# the bf16 roundings that tiny float32 differences flip into gaps up to
# ~3e-3 (its float32 prefill's ~0.03); on Qwen's 12 layers the same
# differences flip int8 and int4 quantisation steps (a step is 1/127 or
# 1/7 of a token's largest value), ~2e-3 to 5e-3 (int8) and to 1.5e-2
# (int4). Each limit is held against a control: the same step over a
# cache whose row 3 of layer 0 holds row 4's keys and values (payloads
# and scales) must miss it (~0.02, ~0.3, ~0.3)
STEP_LOGITS_TOL = {"encdec": 1e-3, "vlm": 4e-3, "qwen_int8": 2e-2,
                   "qwen_int4": 2e-2}


def token_margin(cfg) -> float:
    """The top-2 margin at or above which two runs of a request must give
    the same token: PAGED_MARGIN over a bf16 cache (float32 products
    split otherwise move logits by ~1e-4); over a quantised cache the
    same differences flip quantisation steps of cached keys and values,
    which move a step's logits as far as the decode-step check allows
    (STEP_LOGITS_TOL)."""
    if cfg.kv_cache_dtype == "bf16":
        return PAGED_MARGIN
    return STEP_LOGITS_TOL[f"qwen_{cfg.kv_cache_dtype}"]
# Qwen's long context, the reason its config quantises the cache: 4
# slots at 32,768 positions over the QWEN_LAYERS layers, the caches
# filled with seeded normal keys and values by `cache_write` in chunks
# (no 32k prefill), then LONG_STEPS decode steps each for bf16, int8 and
# int4
LONG_SLOTS, LONG_LEN, LONG_CHUNK, LONG_STEPS = 4, 32768, 4096, 8
QWEN_PROFILE_STEPS = 4


def kv_bytes_per_token(cfg) -> int:
    """Cache bytes a token over all layers: K and V of every KV head, as
    bf16, int8 or packed int4 payloads plus a float32 scale each."""
    hkv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    per_head = {"bf16": 2 * hd, "int8": hd + 4,
                "int4": hd // 2 + 4}[cfg.kv_cache_dtype]
    return cfg.num_layers * 2 * hkv * per_head


def prefill_last_row_as_decode(transformer, prefill, params, batch,
                               quant=None):
    """`prefill(params, batch)` with the last query row of every causal
    attention layer through the model's `decode_attention` over that
    layer's keys and values as the cache returns them: rounded to bf16,
    or with `quant` ("int8" / "int4") quantised by the port's
    `kvcache._quantize` and dequantised to bf16 as `cache_read` does."""
    attend = transformer.chunked_attention

    def as_cached(t):
        if quant is None:
            return t.bfloat16()
        q, scale = transformer.kvcache._quantize(t, quant)
        return (q.float() * scale).bfloat16()

    def last_row_as_decode(q, k, v, *, causal, **kw):
        out = attend(q, k, v, causal=causal, **kw)
        if causal:
            b, s = k.shape[0], k.shape[2]
            out[:, :, -1:] = transformer.decode_attention(
                q[:, :, -1:], as_cached(k), as_cached(v),
                kv_len=torch.full((b,), s, device=q.device))
        return out
    transformer.chunked_attention = last_row_as_decode
    try:
        return prefill(params, batch)
    finally:
        transformer.chunked_attention = attend


def decode_step_check(cfg, tol_key, params, prefill, decode, transformer,
                      prompts, extra):
    """The first decode step after each prompt (1, S) against
    `prefill_last_row_as_decode` over the prompt and that token (in the
    cache's dtype), within STEP_LOGITS_TOL[tol_key], and the first
    prompt's step over a stale cache row (payload and scale) outside it.
    `extra`: the frames or patches of batch 1. Returns the errors, the
    control's and the plain float32 prefill's gaps."""
    tol = STEP_LOGITS_TOL[tol_key]
    quant = None if cfg.kv_cache_dtype == "bf16" else cfg.kv_cache_dtype
    errs, plain_errs, control = [], [], None
    for toks in prompts:
        one = {"tokens": toks, **extra}
        with torch.inference_mode():
            logits, state = prefill(params, one)
            tok = torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)
            stepped = decode(params, tok, state)[0][0, -1].float()
            longer = {**one, "tokens": torch.cat([one["tokens"], tok], 1)}
            want = prefill_last_row_as_decode(transformer, prefill, params,
                                              longer, quant)[0][0, -1].float()
            plain = prefill(params, longer)[0][0, -1].float()
            if control is None:
                stale = prefill(params, one)[1]
                # (L, B, Hkv, W, X): payloads, and scales where quantised
                for t in stale.caches[0]["l0"][:4]:
                    if t is not None:
                        t[0, :, :, 3] = t[0, :, :, 4]
                got = decode(params, tok, stale)[0][0, -1].float()
                control = float((got - want).abs().max())
        errs.append(float((stepped - want).abs().max()))
        plain_errs.append(float((stepped - plain).abs().max()))
    if max(errs) > tol:
        raise AssertionError(f"{cfg.name} ({cfg.kv_cache_dtype} cache): a "
                             f"decode step's logits differ from the prefill "
                             f"over prompt + token by {errs} (limit {tol})")
    if not control > tol:
        raise AssertionError(f"{cfg.name} ({cfg.kv_cache_dtype} cache): a "
                             f"decode step over a stale cache row passes the "
                             f"step check ({control} <= {tol})")
    return {"kv_cache_dtype": cfg.kv_cache_dtype,
            "prompt_lens": [t.shape[1] for t in prompts],
            "max_abs_err": errs, "tolerance": tol,
            "stale_row_control_max_abs_err": control,
            "float32_prefill_max_abs_err": plain_errs}


def prefix_family(family, get_config):
    """(cfg, published layers, batch, prompt, gen, slots, requests, prompt
    lengths, gen lengths, extra input's name or None, its rows) of a
    family of this phase."""
    if family == "encdec":
        cfg = get_config(ENCDEC_ARCH)
        return (cfg, cfg.num_layers, ENCDEC_BATCH, ENCDEC_PROMPT, ENCDEC_GEN,
                ENCDEC_SLOTS, ENCDEC_REQUESTS, ENCDEC_PROMPT_LENS,
                ENCDEC_GEN_LENS, "frames", cfg.encoder_frames)
    arch, layers = ((VLM_ARCH, VLM_LAYERS) if family == "vlm"
                    else (QWEN_ARCH, QWEN_LAYERS))
    full = get_config(arch)
    cfg = dataclasses.replace(full, num_layers=layers)
    if family == "vlm":
        return (cfg, full.num_layers, VLM_BATCH, VLM_PROMPT, VLM_GEN,
                VLM_SLOTS, VLM_REQUESTS, VLM_PROMPT_LENS, VLM_GEN_LENS,
                "patches", cfg.patch_tokens)
    return (cfg, full.num_layers, QWEN_BATCH, QWEN_PROMPT, QWEN_GEN,
            QWEN_SLOTS, QWEN_REQUESTS, QWEN_PROMPT_LENS, QWEN_GEN_LENS, None,
            0)


def run_engine_backlog(scheduler, cfg, params, reqs, *, slots, max_len, dev,
                       pool=None, prefill_batch=1):
    """The backlog through one Engine (contiguous for `pool` None, else
    paged on a "half" or "worst_case" pool of PAGED_BLOCK blocks), tapped
    (`tap_engine`), its results and stats checked; returns the run's
    record, its tokens, first-token logits and margins included."""
    kw = {}
    if pool is not None:
        per_slot = max_len // PAGED_BLOCK
        kw = dict(paged=True, block_size=PAGED_BLOCK,
                  prefill_batch=prefill_batch,
                  num_blocks=1 + (slots // 2 if pool == "half" else slots)
                  * per_slot)
    eng = scheduler.Engine(cfg, params, slots=slots, max_len=max_len,
                           device=dev, **kw)
    cross_bytes = sum(t.numel() * t.element_size()
                      for seg in eng.state.cross if seg
                      for c in seg.values() for t in c)
    cache_bytes = sum(t.numel() * t.element_size()
                      for seg in eng.state.caches for c in seg.values()
                      for t in c if isinstance(t, torch.Tensor))
    first_logits, margins = tap_engine(eng)
    t0 = time.perf_counter()
    results = eng.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    what = (f"{cfg.name} Engine ({pool or 'contiguous'}, prefill_batch "
            f"{prefill_batch}, {cfg.kv_cache_dtype} cache)")
    check_results(what, results, reqs)
    st = eng.stats()
    if st["requests"] != len(reqs) or eng.trace_counts["decode"] != 1:
        raise AssertionError(f"{what}: engine stats {st}")
    if pool is not None:
        eng.allocator.check()
        if st["blocks_in_use"] != 0:
            raise AssertionError(f"{what} kept blocks: {st}")
    run = {"pool": pool or "contiguous", "prefill_batch": prefill_batch,
           "kv_cache_dtype": cfg.kv_cache_dtype,
           "num_blocks": kw.get("num_blocks"), "wall_s": wall,
           "cache_bytes": cache_bytes,
           "cross_kv_bytes_per_slot": cross_bytes // slots,
           "prefill_launches": eng.prefill_launches,
           "tokens": [r.tokens for r in results],
           "first_logits": first_logits, "margins": margins,
           **{k: st[k] for k in (
               "tok_per_s", "latency_p50_s", "latency_p99_s",
               "queue_wait_mean_s", "decode_steps", "peak_active",
               "peak_blocks")},
           "generated_tokens": st["tokens"]}
    del eng
    return run


def prefix_path(kernels, *, family, get_config, transformer, steps,
                scheduler, serve_fn, device="cuda"):
    """Whisper (`family="encdec"`: frames into the encoder, cross
    attention at prefill and decode), InternVL2 (`"vlm"`: patch rows
    ahead of the prompt) or Qwen 1.5 (`"qwen"`: MHA on its int8 KV cache,
    then int4) with float32 parameters drawn on the card: serve(); a
    backlog through the contiguous Engine and the paged ones (Qwen: then
    serve() and the contiguous Engine on the int4 cache); flash launched
    once a layer a prefill (Whisper: encoder, self and cross layers) and,
    for Whisper, once a cross layer a decode step. Then, outside the
    counted run: the Engine's first-token logits against batch-1
    prefills, its tokens against a batch-1 serve() of each request and
    one decode step against a prefill over the prompt and its token
    (Qwen: for both cache dtypes; then `qwen_extras`). Returns the path's
    launches and, by its FLASH_CASES row, the flash launches the run made
    at exactly that row's shape (counted by the wrapper,
    `flash_attention.shapes`)."""
    encdec, qwen = family == "encdec", family == "qwen"
    dev = torch.device(device)
    # the previous model's engines sit in reference cycles (`tap_engine`)
    gc.collect()
    torch.cuda.empty_cache()
    seed = {"encdec": 20269, "vlm": 20270, "qwen": 20271}[family]
    (cfg, published_layers, batch, prompt, gen_n, slots, n_req, plens, glens,
     name, rows) = prefix_family(family, get_config)
    gen = torch.Generator(device=dev).manual_seed(seed)
    t0 = time.perf_counter()
    params = transformer.init_params(cfg, gen, dtype=torch.float32,
                                     device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(seed)
    prompts = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (batch, prompt), dtype=np.int32)).to(dev)
    inputs = {} if name is None else {
        name: torch.randn((batch, rows, cfg.d_model), generator=gen,
                          device=dev) * 0.02}
    # patch rows take cache rows ahead of the prompt
    max_len = QWEN_MAX_LEN if qwen else -(
        -(cfg.patch_tokens + max(prompt + gen_n, max(plens) + max(glens))
          + 1) // PAGED_BLOCK) * PAGED_BLOCK
    reqs = scheduler.synth_request_stream(cfg, n_req, seed=seed,
                                          prompt_lens=plens, gen_lens=glens)
    for i in range(batch):    # these requests carry serve()'s inputs
        reqs[i].tokens = prompts[i].cpu().numpy()
        reqs[i].max_new = gen_n
        for k, v in inputs.items():
            setattr(reqs[i], k, v[i].cpu().numpy())

    def inputs_of(r):
        return {k: torch.from_numpy(getattr(r, k)[None]).to(dev)
                for k in inputs}
    first = {k: v[:1] for k, v in inputs.items()}
    prefill = steps.make_prefill_step(cfg, max_len=max_len)
    decode = steps.make_decode_step(cfg)
    prefill(params, {"tokens": prompts[:1, :16], **first})
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    kernels.reset_launch_counts()          # the path's run starts here
    t_path = time.perf_counter()
    ref_logits, prefill_ms, decode_ms = timed_prefill_and_decode(
        prefill, decode, params, prompts, PREFIX_DECODE_TIMED_STEPS, inputs)
    prefills, decodes = 1, PREFIX_DECODE_TIMED_STEPS
    t0 = time.perf_counter()
    served = serve_fn(cfg, params, prompts, max_len=max_len, gen=gen_n,
                      **inputs).cpu()
    serve_s = time.perf_counter() - t0
    prefills, decodes = prefills + 1, decodes + gen_n
    runs = []
    for pb, pool in ((1, None), *PREFIX_PAGED_RUNS[family]):
        runs.append(run_engine_backlog(scheduler, cfg, params, reqs,
                                       slots=slots, max_len=max_len, dev=dev,
                                       pool=pool, prefill_batch=pb))
        prefills += runs[-1]["prefill_launches"]
        decodes += runs[-1]["decode_steps"]
    int4 = None
    if qwen:                  # serve() and the contiguous Engine on int4
        cfg4 = dataclasses.replace(cfg, kv_cache_dtype="int4")
        t0 = time.perf_counter()
        served4 = serve_fn(cfg4, params, prompts, max_len=max_len,
                           gen=gen_n).cpu()
        int4 = {"cfg": cfg4, "served": served4,
                "serve_s": time.perf_counter() - t0,
                "run": run_engine_backlog(scheduler, cfg4, params, reqs,
                                          slots=slots, max_len=max_len,
                                          dev=dev)}
        prefills += 1 + int4["run"]["prefill_launches"]
        decodes += gen_n + int4["run"]["decode_steps"]
    seconds = time.perf_counter() - t_path
    launches = kernels.launch_counts()     # ... and ends here
    shapes = dict(kernels.flash_attention.shapes)
    peak_bytes = torch.cuda.max_memory_allocated()

    # flash: once a layer a prefill (Whisper: its encoder's, self and
    # cross layers), and once a cross layer a decode step
    per_prefill = cfg.encoder_layers + cfg.num_layers * (2 if encdec else 1)
    per_decode = cfg.num_layers if encdec else 0
    want = per_prefill * prefills + per_decode * decodes
    if launches["flash_attention"] != want:
        raise AssertionError(
            f"the {family} path: flash_attention launched "
            f"{launches['flash_attention']} times, not {per_prefill} x "
            f"{prefills} prefills + {per_decode} x {decodes} decode steps")
    others = {k: v for k, v in launches.items()
              if k != "flash_attention" and v}
    if others:
        raise AssertionError(f"the {family} path launched {others}")
    at_row = {c["row"]: shapes.get(flash_shape(c), 0) for c in FLASH_CASES
              if c.get("path") == family}
    if not all(at_row.values()):
        raise AssertionError(f"the {family} path ran no flash launch at "
                             f"the shape of a FLASH_CASES row: {at_row}")
    check_served(cfg.name, served, batch, gen_n, cfg.padded_vocab)
    if not bool(torch.isfinite(ref_logits).all()):
        raise AssertionError(f"{cfg.name}: non-finite prefill logits")

    contiguous = runs[0]
    # the Engine's first-token logits against a batch-1 prefill of each
    # request (the same products), its first token that prefill's argmax
    logit_err = []
    for rid, r in enumerate(reqs):
        one = {"tokens": torch.from_numpy(r.tokens[None]).to(dev),
               **inputs_of(r)}
        with torch.inference_mode():
            want_l = prefill(params, one)[0][0, -1].float()
        err = (contiguous["first_logits"][rid] - want_l).abs()
        if not bool((err <= SAME_BATCH_LOGITS_TOL * (1 + want_l.abs()))
                    .all()):
            raise AssertionError(f"{cfg.name}: Engine prefill logits of "
                                 f"request {rid} differ from a batch-1 "
                                 f"prefill's by {float(err.max())}")
        logit_err.append(float(err.max()))
        if contiguous["tokens"][rid][0] != int(torch.argmax(want_l)):
            raise AssertionError(f"{cfg.name} request {rid}: first token "
                                 "differs from the batch-1 prefill's")
    # the paged runs against the contiguous one: batch-1 prefill token for
    # token, batched prefill wherever the top-2 margin is the cache's
    # `token_margin` or more
    margin = token_margin(cfg)
    for r in runs[1:]:
        differ = token_differences(r["tokens"], contiguous["tokens"],
                                   r["margins"])
        wide = [d for d in differ if r["prefill_batch"] == 1
                or d["top2_margin"] >= margin]
        if wide:
            raise AssertionError(f"{cfg.name} paged Engine ({r['pool']}, "
                                 f"prefill_batch {r['prefill_batch']}): "
                                 f"tokens differ from the contiguous "
                                 f"Engine's: {wide}")
        r["tokens_equal_contiguous"] = not differ
        r["differing_requests"] = differ
    # each request through a batch-1 serve(): its decode steps at batch 1
    # where the Engine's run at `slots` rows (float32 GEMMs that cuBLAS
    # may split otherwise), so tokens are equal wherever the top-2 margin
    # is the cache's `token_margin` or more
    t0 = time.perf_counter()
    alone = [serve_fn(cfg, params,
                      torch.from_numpy(r.tokens[None]).to(dev),
                      max_len=max_len, gen=r.max_new,
                      **inputs_of(r))[0].cpu().tolist() for r in reqs]
    alone_s = time.perf_counter() - t0
    vs_serve = token_differences(contiguous["tokens"], alone,
                                 contiguous["margins"])
    wide = [d for d in vs_serve if d["top2_margin"] >= margin]
    if wide:
        raise AssertionError(f"{cfg.name}: Engine tokens differ from a "
                             f"batch-1 serve() of each request: {wide}")
    # one decode step against a prefill over the prompt and that token,
    # for serve()'s first prompt cut to each of the backlog's lengths
    step_prompts = [prompts[:1, :n] for n in sorted(plens, reverse=True)]
    step_check = decode_step_check(
        cfg, f"qwen_{cfg.kv_cache_dtype}" if qwen else family, params,
        prefill, decode, transformer, step_prompts, first)
    agreement = [float(np.mean(np.asarray(contiguous["tokens"][i])
                               == served[i].numpy())) for i in range(batch)]
    extras = {}
    if qwen:
        extras = qwen_extras(cfg, int4, params, prompts, served, runs,
                             step_prompts, decode_ms, transformer=transformer,
                             steps=steps, dev=dev)
    for r in runs:
        del r["tokens"], r["first_logits"], r["margins"]
    hd, hkv = cfg.resolved_head_dim, cfg.num_kv_heads
    emit(f"{family}_path", model=cfg.name, layers=cfg.num_layers,
         published_layers=published_layers,
         encoder_layers=cfg.encoder_layers,
         d_model=cfg.d_model, heads=cfg.num_heads, kv_heads=hkv,
         head_dim=hd, d_ff=cfg.d_ff, vocab=cfg.vocab_size,
         params=transformer.param_count(params), param_dtype="float32",
         init_s=init_s, max_len=max_len, input=name, input_rows=rows,
         kv_cache_dtype=cfg.kv_cache_dtype,
         kv_cache_bytes_per_token=kv_bytes_per_token(cfg),
         serve={"batch": batch, "prompt": prompt, "gen": gen_n,
                "prefill_ms": prefill_ms,
                "prefill_tok_per_s": batch * prompt / prefill_ms * 1e3,
                "decode_ms_per_step_median": float(np.median(decode_ms)),
                "decode_ms_per_step": decode_ms, "serve_s": serve_s,
                "serve_tok_per_s": batch * gen_n / serve_s},
         engine={"slots": slots, "requests": n_req, "prompt_lens": plens,
                 "gen_lens": glens, "block_size": PAGED_BLOCK,
                 "prompt_tokens": int(sum(q.prompt_len for q in reqs))},
         engines=runs, prefill_logits_max_abs_err=logit_err,
         prefill_logits_tolerance=SAME_BATCH_LOGITS_TOL,
         engine_vs_batch1_serve={"differing_requests": vs_serve,
                                 "margin": margin, "seconds": alone_s},
         step_check=step_check,
         token_agreement_vs_serve=agreement, prefill_calls=prefills,
         decode_calls=decodes, path_s=seconds,
         max_memory_allocated_gib=peak_bytes / 2 ** 30, launches=launches,
         flash_launches_at_row=at_row, flash_launches_by_shape=[
             {**dict(zip(FLASH_SHAPE_KEYS, key)), "launches": n}
             for key, n in sorted(shapes.items())], **extras)
    del params
    gc.collect()
    return launches, at_row


def qwen_extras(cfg, int4, params, prompts, served, runs, step_prompts,
                decode_ms, *, transformer, steps, dev):
    """Qwen's checks and measurements past the shared ones: the int4
    serve() and Engine (the Engine's tokens for serve()'s prompts against
    serve()'s under the margin rule; its first-token logits equal the
    int8 Engine's, prefill being independent of the cache's dtype; one
    decode step against the prefill over prompt + token on int4), the
    profiled int8 decode (`profile_trace`) and the 32k decode steps on
    bf16, int8 and int4 caches."""
    cfg4, run4 = int4["cfg"], int4["run"]
    contiguous = runs[0]
    for rid, logits in run4["first_logits"].items():
        if not torch.equal(logits, contiguous["first_logits"][rid]):
            raise AssertionError(f"request {rid}: the int4 Engine's "
                                 "first-token logits differ from the int8 "
                                 "Engine's")
    vs_serve4 = token_differences(run4["tokens"][:QWEN_BATCH],
                                  int4["served"].tolist(),
                                  run4["margins"])
    wide = [d for d in vs_serve4 if d["top2_margin"] >= token_margin(cfg4)]
    if wide:
        raise AssertionError(f"{cfg4.name} (int4): Engine tokens differ from "
                             f"serve()'s: {wide}")
    prefill4 = steps.make_prefill_step(cfg4, max_len=QWEN_MAX_LEN)
    step_check4 = decode_step_check(
        cfg4, "qwen_int4", params, prefill4, steps.make_decode_step(cfg4),
        transformer, step_prompts, {})
    agreement = [float(np.mean(np.asarray(run4["tokens"][i])
                               == int4["served"][i].numpy()))
                 for i in range(QWEN_BATCH)]
    int8_vs_int4 = [float(np.mean(np.asarray(a) == np.asarray(b)))
                    for a, b in zip(contiguous["tokens"], run4["tokens"])]
    del run4["tokens"], run4["first_logits"], run4["margins"]
    profile = qwen_profile(cfg, params, prompts, decode_ms,
                           transformer=transformer, steps=steps)
    gc.collect()
    torch.cuda.empty_cache()
    long = [long_context_decode(cfg, params, quant, transformer=transformer,
                                steps=steps, dev=dev)
            for quant in ("bf16", "int8", "int4")]
    return {"int4": {"serve_s": int4["serve_s"],
                     "serve_tok_per_s": QWEN_BATCH * QWEN_GEN
                     / int4["serve_s"],
                     "engine": run4,
                     "engine_vs_serve": {"differing_requests": vs_serve4,
                                         "margin": token_margin(cfg4)},
                     "token_agreement_vs_serve": agreement,
                     "token_agreement_vs_int8_engine": int8_vs_int4,
                     "step_check": step_check4,
                     "kv_cache_bytes_per_token": kv_bytes_per_token(cfg4)},
            "int8_served_equals_int4_served_share": float(
                (served == int4["served"]).float().mean()),
            "profile": profile, "long_context": long}


def device_kernel_times(prof, calls: int, wall_us: float,
                        top: int = 10):
    """The device kernels of a `torch.profiler` trace summed by name: the
    device time per call, launches per call and the `top` kernels; "not
    measured" where the trace holds no device time. Kernels run on one
    stream, so their times do not overlap."""
    from torch.autograd import DeviceType

    def device_us(evt):
        return getattr(evt, "self_device_time_total",
                       getattr(evt, "self_cuda_time_total", 0.0))

    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and device_us(e) > 0]
    if not kernels:
        return "not measured"
    busy_us = sum(device_us(e) for e in kernels)
    kernels.sort(key=device_us, reverse=True)
    return {
        "calls": calls, "traced_wall_ms_per_call": wall_us / calls / 1e3,
        "device_ms_per_call": busy_us / calls / 1e3,
        "kernel_launches_per_call": sum(e.count for e in kernels) / calls,
        "top": [{"name": e.key[:90], "launches": e.count,
                 "device_ms": device_us(e) / 1e3,
                 "share": device_us(e) / busy_us}
                for e in kernels[:top]]}


def qwen_profile(cfg, params, prompts, decode_ms, *, transformer, steps):
    """QWEN_PROFILE_STEPS decode steps of serve()'s batch on the int8
    cache under `obs.torchhooks.profile_trace` (a Chrome trace under the
    git-ignored build/): the device time a step, its busy share of the
    untraced CUDA-event step time, and the trace file."""
    from repro_torch.obs import torchhooks
    prefill = steps.make_prefill_step(cfg, max_len=QWEN_MAX_LEN)
    decode = steps.make_decode_step(cfg)
    _, state = prefill(params, {"tokens": prompts})
    tok = torch.zeros((prompts.shape[0], 1), dtype=torch.int32,
                      device=prompts.device)
    log_dir = ROOT / "build" / "qwen_decode_trace"
    for old in log_dir.glob("trace_*.json"):
        old.unlink()
    torch.cuda.synchronize()
    with torchhooks.profile_trace(log_dir) as prof:
        t0 = time.perf_counter()
        for _ in range(QWEN_PROFILE_STEPS):
            _, state = decode(params, tok, state)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    del state
    out = device_kernel_times(prof, QWEN_PROFILE_STEPS, wall_us)
    traces = sorted(log_dir.glob("trace_*.json"))
    if len(traces) != 1:
        raise AssertionError(f"profile_trace wrote {traces}")
    if isinstance(out, dict):
        out["device_busy_share_of_untraced_step"] = (
            out["device_ms_per_call"] / float(np.median(decode_ms)))
    return {"decode_b4_int8": out,
            "trace": str(traces[0].relative_to(ROOT)),
            "trace_bytes": traces[0].stat().st_size}


def long_context_decode(cfg, params, quant, *, transformer, steps, dev):
    """LONG_SLOTS sequences at LONG_LEN positions on a `quant` cache: the
    caches filled by `kvcache.cache_write` with seeded normal keys and
    values, LONG_CHUNK positions at a time; then one warm-up and
    LONG_STEPS CUDA-event timed decode steps up to the last position.
    The cache's bytes must be exactly its shapes' (`kv_bytes_per_token`)."""
    kvcache = transformer.kvcache
    cfg_q = dataclasses.replace(cfg, kv_cache_dtype=quant)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    state = steps.serve_state_zeros(cfg_q, params, LONG_SLOTS, LONG_LEN)
    seg = state.caches[0]["l0"]
    gen = torch.Generator(device=dev).manual_seed(20272)
    hkv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    t0 = time.perf_counter()
    with torch.inference_mode():
        for li in range(cfg.num_layers):
            lay = seg.layer(li)
            for lo in range(0, LONG_LEN, LONG_CHUNK):
                k, v = (torch.randn((LONG_SLOTS, hkv, LONG_CHUNK, hd),
                                    generator=gen, device=dev)
                        for _ in range(2))
                kvcache.cache_write(lay, k, v, torch.arange(
                    lo, lo + LONG_CHUNK, device=dev))
    torch.cuda.synchronize()
    fill_s = time.perf_counter() - t0
    cache_bytes = sum(t.numel() * t.element_size() for t in seg[:4]
                      if t is not None)
    want = LONG_SLOTS * LONG_LEN * kv_bytes_per_token(cfg_q)
    if cache_bytes != want:
        raise AssertionError(f"{quant} cache of {cache_bytes} bytes, not "
                             f"{want}")
    decode = steps.make_decode_step(cfg_q)
    state = state._replace(pos=torch.full(
        (LONG_SLOTS,), LONG_LEN - LONG_STEPS - 1, dtype=torch.int32,
        device=dev))
    tok = torch.zeros((LONG_SLOTS, 1), dtype=torch.int32, device=dev)
    logits, state = decode(params, tok, state)          # warm-up
    ms = []
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    for _ in range(LONG_STEPS):
        a.record()
        logits, state = decode(params, tok, state)
        b.record()
        b.synchronize()
        ms.append(a.elapsed_time(b))
    if int(state.pos[0]) != LONG_LEN or not bool(
            torch.isfinite(logits).all()):
        raise AssertionError(f"{quant} long-context decode: pos "
                             f"{state.pos.tolist()}, finite "
                             f"{bool(torch.isfinite(logits).all())}")
    peak = torch.cuda.max_memory_allocated()
    weight_bytes = sum(p.numel() * p.element_size()
                       for p in params.parameters())
    del state, seg, logits
    return {"kv_cache_dtype": quant, "slots": LONG_SLOTS,
            "positions": LONG_LEN, "cache_bytes": cache_bytes,
            "fill_s": fill_s, "decode_ms_per_step": ms,
            "decode_ms_per_step_median": float(np.median(ms)),
            "bytes_bound_ms": (weight_bytes + cache_bytes)
            / HBM_BYTES_PER_S * 1e3,
            "max_memory_allocated_gib": peak / 2 ** 30}


def serve_profile_path(kernels, serve_mod, device="cuda"):
    """`serve.main` on Whisper tiny at full size with `--profile DIR` and
    `--metrics-out PATH` under the git-ignored build/: the trace names a
    kernel of the flash extension and the metrics hold the card's memory
    gauges (`obs.torchhooks.record_device_memory`). Returns the run's
    launches."""
    import contextlib
    import io
    out_dir = ROOT / "build" / "serve_profile"
    trace_dir, metrics = out_dir / "trace", out_dir / "METRICS.json"
    for old in trace_dir.glob("trace_*.json"):
        old.unlink()
    kernels.reset_launch_counts()          # the run starts here
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = serve_mod.main(["--arch", ENCDEC_ARCH, "--batch", "4",
                             "--prompt-len", "224", "--gen", "16",
                             "--device", device, "--profile", str(trace_dir),
                             "--metrics-out", str(metrics)])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = kernels.launch_counts()     # ... and ends here
    traces = sorted(trace_dir.glob("trace_*.json"))
    if rc or len(traces) != 1:
        raise AssertionError(f"serve.main --profile: rc {rc}, traces "
                             f"{traces}")
    events = json.loads(traces[0].read_text())["traceEvents"]
    flash = sorted({e["name"] for e in events
                    if e.get("cat") == "kernel" and "flash" in e["name"]})
    if not flash:
        raise AssertionError("the --profile trace names no flash kernel")
    gauges = json.loads(metrics.read_text())["gauges"]
    want = {f"torch.cuda0.{g}" for g in ("bytes_allocated", "bytes_reserved",
                                        "live_blocks")}
    if not want <= set(gauges) or not gauges["torch.cuda0.bytes_allocated"]:
        raise AssertionError(f"--metrics-out gauges {sorted(gauges)}")
    if not launches["flash_attention"]:
        raise AssertionError("serve.main --profile never launched flash")
    emit("serve_profile", argv_arch=ENCDEC_ARCH, seconds=seconds,
         trace=str(traces[0].relative_to(ROOT)),
         trace_bytes=traces[0].stat().st_size, trace_events=len(events),
         flash_kernels=flash,
         gauges={k: gauges[k] for k in sorted(want)},
         stdout=buf.getvalue().strip().splitlines(), launches=launches)
    return launches


# ---------------------------------------------------------------------------
# Phase 14: the load scenarios through the port's loadgen
# ---------------------------------------------------------------------------

# `tests/golden/scenarios/*.yaml` as dicts, and Qwen 1.5's `int8_cache`:
# the card has no pyyaml (`tests/test_torch_loadgen.py` holds them equal
# to the files' parse)
LOADGEN_SCENARIOS = {
    "smoke_gqa": {
        "schema": "scenario/v1", "name": "smoke_gqa", "arch": "llama3p2_3b",
        "engine": {"slots": 4, "max_len": 64, "paged": False},
        "workload": {"requests": 8, "seed": 1,
                     "arrival": {"process": "uniform", "rate": 64.0},
                     "prompt_lens": [8, 16, 24], "gen_lens": [4, 8]},
        "slo": {"p99_latency_s": 120.0}},
    "paged_mixed": {
        "schema": "scenario/v1", "name": "paged_mixed",
        "arch": "llama3p2_3b",
        "engine": {"slots": 4, "max_len": 64, "paged": True,
                   "block_size": 8, "prefill_batch": 2},
        "workload": {"requests": 10, "seed": 0,
                     "arrival": {"process": "poisson", "rate": 64.0},
                     "prompt_lens": [6, 12, 40], "gen_lens": [4, 8, 16]},
        "slo": {"p99_latency_s": 120.0, "min_tok_per_s": 0.5}},
    "paged_mla": {
        "schema": "scenario/v1", "name": "paged_mla",
        "arch": "deepseek_v2_lite_16b",
        "engine": {"slots": 2, "max_len": 48, "paged": True,
                   "block_size": 8},
        "workload": {"requests": 5, "seed": 2,
                     "arrival": {"process": "poisson", "rate": 32.0},
                     "prompt_lens": [6, 12, 24], "gen_lens": [4, 8]},
        "slo": {"p99_latency_s": 120.0}},
    "ssm_state": {
        "schema": "scenario/v1", "name": "ssm_state", "arch": "mamba2_2p7b",
        "engine": {"slots": 2, "max_len": 32, "paged": False},
        "workload": {"requests": 5, "seed": 3,
                     "arrival": {"process": "uniform", "rate": 32.0},
                     "prompt_lens": [8, 16], "gen_lens": [4, 8]},
        "slo": {"p99_latency_s": 120.0}},
    # Qwen 1.5 on its int8 cache, paged with batched prefill (no golden
    # file: the JAX suite globs that directory)
    "int8_cache": {
        "schema": "scenario/v1", "name": "int8_cache", "arch": "qwen1p5_32b",
        "engine": {"slots": 4, "max_len": 64, "paged": True,
                   "block_size": 8, "prefill_batch": 2},
        "workload": {"requests": 8, "seed": 4,
                     "arrival": {"process": "poisson", "rate": 64.0},
                     "prompt_lens": [8, 16, 32], "gen_lens": [4, 8, 16]},
        "slo": {"p99_latency_s": 120.0}},
}
# scenarios whose model's published depth one card cannot hold, with the
# depth they run at (their width kept): Qwen 1.5 32B as in `qwen_path`
LOADGEN_LAYERS = {"int8_cache": 12}


def loadgen_path(kernels, loadgen, device="cuda"):
    """LOADGEN_SCENARIOS through the port's `run_scenario` at full width
    (`smoke=False`; the depth of LOADGEN_LAYERS), on the card; the rows
    as a bench_serve/v1 file under the git-ignored build/, which the
    port's `check()` accepts and `scripts/diff_serve.py` reads (the file
    against itself). Returns the path's launches."""
    kernels.reset_launch_counts()          # the loadgen run starts here
    rows, seconds = [], {}
    for name, spec in LOADGEN_SCENARIOS.items():
        defects = loadgen.validate_scenario(spec)
        if defects:
            raise AssertionError(f"scenario {name}: {defects}")
        t0 = time.perf_counter()
        rows.append(loadgen.run_scenario(spec, smoke=False, verbose=False,
                                         device=device,
                                         layers=LOADGEN_LAYERS.get(name)))
        torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - t0
        gc.collect()
        torch.cuda.empty_cache()
    launches = kernels.launch_counts()     # ... and ends here
    if not launches["flash_attention"]:
        raise AssertionError("the loadgen run never launched flash "
                             "attention")
    others = {k: v for k, v in launches.items()
              if k != "flash_attention" and v}
    if others:
        raise AssertionError(f"the loadgen run launched {others}")
    for row, spec in zip(rows, LOADGEN_SCENARIOS.values()):
        if row["requests"] != spec["workload"]["requests"] \
                or row["platform"] != "gpu":
            raise AssertionError(f"loadgen row {row}")
        if row["paged"] and not row["peak_cache_rows"] \
                < row["reserved_rows_contiguous"]:
            raise AssertionError(f"paged row reserved the worst case: {row}")
    path = ROOT / "build" / "BENCH_serve.json"
    path.parent.mkdir(exist_ok=True)
    path.write_text(json.dumps({"schema": loadgen.BENCH_SCHEMA,
                                "rows": rows}, indent=1, sort_keys=True))
    rc = loadgen.check(str(path))
    if rc:
        raise AssertionError(f"loadgen.check({path}) returned {rc}")
    diff = subprocess.run(
        [sys.executable, str(ROOT / "scripts" / "diff_serve.py"), str(path),
         str(path)], capture_output=True, text=True, timeout=120)
    if diff.returncode:
        raise AssertionError(f"diff_serve.py exited {diff.returncode}: "
                             f"{diff.stdout[-2000:]}{diff.stderr[-2000:]}")
    emit("loadgen_path", rows=rows, seconds=seconds,
         bench=str(path.relative_to(ROOT)), check_rc=rc,
         diff_serve_rc=diff.returncode,
         diff_serve=diff.stdout.strip().splitlines()[-1:],
         layers=LOADGEN_LAYERS,
         launches=launches)
    return launches


def examples_path(kernels, examples):
    """The port's three examples on the card, each at its own size (the
    JAX examples'), their printed lines kept and their asserts live.
    quickstart runs last. Returns the launches of all three."""
    import contextlib
    import io
    kernels.reset_launch_counts()          # the examples' run starts here
    out = []
    for name, kwargs in (("uleen_edge_pipeline", {"backend": "fused"}),
                         ("distill_uleen_head", {"backend": "packed"}),
                         ("quickstart", {})):
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            examples[name].main(device="cuda", **kwargs)
        torch.cuda.synchronize()
        out.append({"example": name, **kwargs,
                    "seconds": time.perf_counter() - t0,
                    "lines": buf.getvalue().strip().splitlines()})
    launches = kernels.launch_counts()     # ... and ends here
    idle = [k for k in ("thermometer_encode", "h3_hash", *WNN_KERNELS)
            if launches[k] == 0]
    if idle:
        raise AssertionError(f"the examples never launched {idle}")
    emit("examples", runs=out, launches=launches)
    return launches


# ---------------------------------------------------------------------------
# Phase 15: LM training at full width
# ---------------------------------------------------------------------------

# Llama 3.2 3B (`configs/llama3p2_3b.py`) at full width, depth cut to
# TRAIN_LAYERS of 28 (all 28: 51 GB of float32 weights, moments and
# gradients before the update's new trees), through `launch.train.train`
# (bf16 compute over float32 master weights, AdamW under the warm-up-cosine
# schedule, clipping at 1.0) for TRAIN_STEPS steps of TRAIN_BATCH x
# TRAIN_SEQ tokens; DeepSeek-V2-Lite (`configs/deepseek_v2_lite_16b.py`) at
# full width, its dense first layer and one MoE layer, one bf16 step at the
# same batch (the flash kernel's bf16 (192, 128) route)
TRAIN_ARCH, TRAIN_LAYERS = "llama3p2_3b", 8
TRAIN_MLA_LAYERS = 2
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 2, 1024, 8
TRAIN_TIMED_STEPS = 3
TRAIN_REPEAT_STEPS, TRAIN_REPEAT_LR = 8, 1e-3
# the first loss against ln V + σ²/2: random-init logits are normal with
# σ² = 0.02² · d_model (unit-RMS final activations through the 0.02-std
# LM head), and E[logsumexp] over V of them is ln V + σ²/2
TRAIN_FIRST_LOSS_TOL = 0.5
# a bf16-compute step against a float32 one from the same params and batch
TRAIN_BF16_LOSS_RTOL = 2e-2
# the backward (the plain version, autograd through `attention_ref` in
# query blocks) against autograd through `attention_ref` in one piece
TRAIN_GRAD_TOL = {torch.float32: (1e-5, 1e-5),
                  torch.bfloat16: (1e-2, 2 ** -7)}      # (atol, rtol)
TRAIN_FLASH_CASES = [
    # the train steps' shapes, bf16 as their compute copies are
    dict(name="llama3p2_3b_train_b2_s1024_bf16", row="6i", b=2, h=24,
         hkv=8, sq=1024, sk=1024, d=128, dtype=torch.bfloat16),
    dict(name="deepseek_mla_train_b2_s1024_d192_dv128_bf16", row="6j", b=2,
         h=16, hkv=16, sq=1024, sk=1024, d=192, dv=128, scale=192 ** -0.5,
         dtype=torch.bfloat16),
]
TRAIN_BACKWARD_CASES = [
    dict(b=2, h=24, hkv=8, s=1024, d=128, dv=128, dtype=torch.float32),
    dict(b=2, h=24, hkv=8, s=1024, d=128, dv=128, dtype=torch.bfloat16),
    dict(b=2, h=16, hkv=16, s=1024, d=192, dv=128, dtype=torch.bfloat16),
]


def check_flash_backward(gen, ops, ref, device="cuda"):
    """`ops.flash_attention` under autograd (the kernel forward, the plain
    backward) against autograd through `ref.attention_ref` in one piece,
    at the train shapes: dq, dk and dv within TRAIN_GRAD_TOL, with the
    forward's output within FLASH_TOL."""
    rows = []
    for case in TRAIN_BACKWARD_CASES:
        b, h, hkv, s, d, dv, dt = (case[k] for k in
                                   ("b", "h", "hkv", "s", "d", "dv", "dtype"))
        q = torch.randn((b, s, h, d), generator=gen, device=device).to(dt)
        q = q.transpose(1, 2).requires_grad_()
        k = torch.randn((b, hkv, s, d), generator=gen,
                        device=device).to(dt).requires_grad_()
        v = torch.randn((b, hkv, s, dv), generator=gen,
                        device=device).to(dt).requires_grad_()
        dout = torch.randn((b, h, s, dv), generator=gen,
                           device=device).to(dt)
        kw = dict(causal=True, scale=d ** -0.5)
        out = ops.flash_attention(q, k, v, **kw)
        got = torch.autograd.grad(out, (q, k, v), dout)
        want_out = ref.attention_ref(q, k, v, **kw)
        want = torch.autograd.grad(want_out, (q, k, v), dout)
        torch.cuda.synchronize()
        out, want_out = out.detach(), want_out.detach()
        out_err = float((out.float() - want_out.float()).abs().max())
        if out_err > FLASH_TOL[dt] * (1 + float(want_out.float().abs().max())):
            raise AssertionError(f"flash forward under autograd: max |diff| "
                                 f"{out_err}")
        atol, rtol = TRAIN_GRAD_TOL[dt]
        errs = {}
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            diff = (g.float() - w.float()).abs()
            if not bool((diff <= atol + rtol * w.float().abs()).all()):
                raise AssertionError(f"flash backward {name} ({dt}, D {d}, "
                                     f"Dv {dv}): max |diff| "
                                     f"{float(diff.max())}")
            errs[name] = float(diff.max())
        rows.append({"b": b, "h": h, "hkv": hkv, "s": s, "d": d, "dv": dv,
                     "dtype": str(dt).replace("torch.", ""), "causal": True,
                     "forward_max_abs_err": out_err,
                     "max_abs_err": errs, "atol": atol, "rtol": rtol})
        del q, k, v, dout, out, got, want, want_out
    return rows


def expected_first_loss(cfg) -> float:
    return math.log(cfg.vocab_size) + 0.5 * 0.02 ** 2 * cfg.d_model


def check_finite(what, history):
    bad = [h for h in history
           if not (math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"]))]
    if bad:
        raise AssertionError(f"{what}: non-finite metrics {bad[:3]}")


def bf16_against_f32_step(cfg, params, opt_state, batch, *, steps, optimizer):
    """The loss of one bf16-compute step and of one float32 step taken from
    the same params, state and batch, and their relative gap; raises past
    TRAIN_BF16_LOSS_RTOL."""
    out = {}
    for name, dt in (("bf16", torch.bfloat16), ("float32", None)):
        step = steps.make_train_step(cfg, optimizer, compute_dtype=dt)
        new, _, m = step(params, opt_state, batch)
        out[name] = {k: float(v) for k, v in m.items()}
        del new
    gap = abs(out["bf16"]["loss"] - out["float32"]["loss"]) / abs(
        out["float32"]["loss"])
    if not gap <= TRAIN_BF16_LOSS_RTOL:
        raise AssertionError(f"{cfg.name}: bf16 step loss "
                             f"{out['bf16']['loss']} vs float32 "
                             f"{out['float32']['loss']} (rel {gap})")
    check_finite(cfg.name, list(out.values()))
    return {**out, "loss_rel_gap": gap, "tolerance": TRAIN_BF16_LOSS_RTOL}


def lm_train_path(kernels, *, get_config, transformer, steps, train_mod,
                  optimizer, ops, ref, flash_attention, plan,
                  device="cuda"):
    """LM training on the card. Kernel checks first (not counted): the
    flash kernel at the train steps' bf16 shapes (rows 6i, 6j) and its
    backward at those shapes. Then, counted: `launch.train.train` on
    Llama 3.2 3B at full width and TRAIN_LAYERS layers; one bf16 and one
    float32 step from its final params on one batch; TRAIN_TIMED_STEPS
    timed bf16 steps; TRAIN_REPEAT_STEPS steps on one repeated batch at a
    constant lr, whose loss must fall; one bf16 and one float32 step of
    DeepSeek-V2-Lite at full width and TRAIN_MLA_LAYERS layers; and
    `launch.train.main` on the smoke Llama. Returns (launches, the
    flash rows with the launches the run made at their shapes)."""
    import contextlib
    import io
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(20267)
    flash_rows = [flash_case_row(gen, ref, flash_attention, plan, case,
                                 device) for case in TRAIN_FLASH_CASES]
    backward = check_flash_backward(gen, ops, ref, device)
    torch.cuda.empty_cache()
    cfg = dataclasses.replace(get_config(TRAIN_ARCH),
                              num_layers=TRAIN_LAYERS)
    tokens_a_step = TRAIN_BATCH * TRAIN_SEQ
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    kernels.reset_launch_counts()          # the train path's run starts here
    t_path = time.perf_counter()
    t0 = time.perf_counter()
    out = train_mod.train(cfg, steps_total=TRAIN_STEPS, batch=TRAIN_BATCH,
                          seq=TRAIN_SEQ, seed=20267, verbose=False,
                          device=dev)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    history = out["history"]
    check_finite("Llama train", history)
    first_want = expected_first_loss(cfg)
    if abs(history[0]["loss"] - first_want) > TRAIN_FIRST_LOSS_TOL:
        raise AssertionError(f"Llama first loss {history[0]['loss']} is not "
                             f"within {TRAIN_FIRST_LOSS_TOL} of {first_want}")
    params, opt_state = out["params"], out["opt_state"]
    del out
    _, batch = next(train_mod.data_iterator(cfg, TRAIN_BATCH, TRAIN_SEQ,
                                            seed=20268, device=dev))
    adamw = optimizer.chain_clip(optimizer.adamw(
        optimizer.warmup_cosine_schedule(3e-4, train_mod.WARMUP_STEPS,
                                         TRAIN_STEPS)), 1.0)
    versus = bf16_against_f32_step(cfg, params, opt_state, batch,
                                   steps=steps, optimizer=adamw)

    # one bf16 step's launches at the train shape, then timed steps
    step = steps.make_train_step(cfg, adamw)
    shape = flash_shape(TRAIN_FLASH_CASES[0])
    before = kernels.flash_attention.shapes[shape]
    new, _, _ = step(params, opt_state, batch)
    torch.cuda.synchronize()
    per_step = kernels.flash_attention.shapes[shape] - before
    if per_step != 2 * cfg.num_layers:
        raise AssertionError(f"a train step launched flash {per_step} times "
                             f"at {shape}, not 2 x {cfg.num_layers} (the "
                             "forward and its recompute)")
    del new
    step_ms = cuda_ms(lambda: step(params, opt_state, batch),
                      TRAIN_TIMED_STEPS, warmup=0)
    # one step under torch.profiler: device time by kernel, busy share
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(params, opt_state, batch)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    step_profile = device_kernel_times(prof, 1, wall_us, top=12)
    if isinstance(step_profile, dict):
        step_profile["device_busy_share_of_untraced_step"] = (
            step_profile["device_ms_per_call"] / step_ms)
    del prof

    # a repeated batch at a constant lr: the loss falls
    fixed = optimizer.chain_clip(optimizer.adamw(TRAIN_REPEAT_LR), 1.0)
    step_fixed = steps.make_train_step(cfg, fixed)
    p, s = params, fixed.init(steps.tree_leaves(params))
    del opt_state
    repeat = []
    for _ in range(TRAIN_REPEAT_STEPS):
        p, s, m = step_fixed(p, s, batch)
        repeat.append({k: float(v) for k, v in m.items()})
    check_finite("Llama repeated batch", repeat)
    if not repeat[-1]["loss"] < repeat[0]["loss"]:
        raise AssertionError(f"the loss did not fall on a repeated batch: "
                             f"{[r['loss'] for r in repeat]}")
    llama_peak = torch.cuda.max_memory_allocated()
    n_params = transformer.param_count(params)
    del p, s, params, step, step_fixed, batch
    gc.collect()
    torch.cuda.empty_cache()

    # DeepSeek-V2-Lite, the dense first layer and one MoE layer
    mla_cfg = dataclasses.replace(get_config(MLA_ARCH),
                                  num_layers=TRAIN_MLA_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    mla_params = transformer.init_params(
        mla_cfg, torch.Generator(device=dev).manual_seed(20269),
        dtype=torch.float32, device=dev)
    mla_opt = optimizer.chain_clip(optimizer.adamw(
        optimizer.warmup_cosine_schedule(3e-4, 1, 2)), 1.0)
    mla_state = mla_opt.init(steps.tree_leaves(mla_params))
    _, mla_batch = next(train_mod.data_iterator(
        mla_cfg, TRAIN_BATCH, TRAIN_SEQ, seed=20269, device=dev))
    t0 = time.perf_counter()
    mla_versus = bf16_against_f32_step(mla_cfg, mla_params, mla_state,
                                       mla_batch, steps=steps,
                                       optimizer=mla_opt)
    torch.cuda.synchronize()
    mla_pair_s = time.perf_counter() - t0
    mla_first_want = expected_first_loss(mla_cfg)
    if abs(mla_versus["bf16"]["loss"] - mla_first_want) \
            > TRAIN_FIRST_LOSS_TOL:
        raise AssertionError(f"DeepSeek first loss "
                             f"{mla_versus['bf16']['loss']} is not within "
                             f"{TRAIN_FIRST_LOSS_TOL} of {mla_first_want}")
    # one bf16 step's launches at the train shape (the bf16 (192, 128)
    # route), then timed steps
    mla_step = steps.make_train_step(mla_cfg, mla_opt)
    mla_shape = flash_shape(TRAIN_FLASH_CASES[1])
    before = kernels.flash_attention.shapes[mla_shape]
    new, _, _ = mla_step(mla_params, mla_state, mla_batch)
    torch.cuda.synchronize()
    mla_launches = kernels.flash_attention.shapes[mla_shape] - before
    if mla_launches != 2 * mla_cfg.num_layers:
        raise AssertionError(f"DeepSeek's bf16 step launched flash "
                             f"{mla_launches} times at {mla_shape}, not 2 x "
                             f"{mla_cfg.num_layers}")
    del new
    mla_step_ms = cuda_ms(lambda: mla_step(mla_params, mla_state, mla_batch),
                          TRAIN_TIMED_STEPS, warmup=0)
    mla_peak = torch.cuda.max_memory_allocated()
    mla_n_params = transformer.param_count(mla_params)
    del mla_params, mla_state, mla_batch, mla_step
    gc.collect()
    torch.cuda.empty_cache()

    # the CLI on the smoke Llama, on the card
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = train_mod.main(["--arch", TRAIN_ARCH, "--smoke", "--steps",
                             "6", "--batch", "2", "--seq", "32"])
    if rc != 0 or "done: first loss" not in buf.getvalue():
        raise AssertionError(f"launch.train.main: rc {rc}, "
                             f"{buf.getvalue()[-500:]}")
    seconds = time.perf_counter() - t_path
    launches = kernels.launch_counts()     # ... and ends here
    if launches["flash_attention"] == 0:
        raise AssertionError("the train path never launched flash")
    others = {k: v for k, v in launches.items()
              if k != "flash_attention" and v}
    if others:
        raise AssertionError(f"the train path launched other kernels: "
                             f"{others}")
    for row in flash_rows:
        row["launches"] = kernels.flash_attention.shapes[flash_shape(row)]
    emit("lm_train_path", model=cfg.name, layers=cfg.num_layers,
         of_layers=get_config(TRAIN_ARCH).num_layers, d_model=cfg.d_model,
         heads=(cfg.num_heads, cfg.num_kv_heads), d_ff=cfg.d_ff,
         vocab=cfg.vocab_size, params=n_params, master_dtype="float32",
         compute_dtype="bfloat16", batch=TRAIN_BATCH, seq=TRAIN_SEQ,
         steps=TRAIN_STEPS, train_s=train_s,
         history=history, first_loss_expected=first_want,
         first_loss_ln_vocab=math.log(cfg.vocab_size),
         first_loss_tolerance=TRAIN_FIRST_LOSS_TOL,
         bf16_vs_float32_step=versus, flash_launches_a_step=per_step,
         step_ms=step_ms, tok_per_s=tokens_a_step / step_ms * 1e3,
         step_profile=step_profile,
         repeated_batch={"lr": TRAIN_REPEAT_LR,
                         "losses": [r["loss"] for r in repeat],
                         "grad_norms": [r["grad_norm"] for r in repeat]},
         max_memory_allocated_gib=llama_peak / 2 ** 30,
         mla={"model": mla_cfg.name, "layers": mla_cfg.num_layers,
              "params": mla_n_params, "experts": mla_cfg.num_experts,
              "top_k": mla_cfg.top_k, "dense_layers":
              mla_cfg.first_dense_layers,
              "first_loss_expected": mla_first_want,
              "bf16_vs_float32_step": mla_versus,
              "bf16_and_float32_steps_s": mla_pair_s,
              "flash_launches_a_step": mla_launches,
              "step_ms": mla_step_ms,
              "tok_per_s": tokens_a_step / mla_step_ms * 1e3,
              "max_memory_allocated_gib": mla_peak / 2 ** 30},
         cli=buf.getvalue().strip().splitlines(), backward=backward,
         flash=flash_rows, path_s=seconds, launches=launches)
    return launches, flash_rows


# ---------------------------------------------------------------------------
# Phase 16: the distributed ULEEN trainer at ULN-L width
# ---------------------------------------------------------------------------

# ULN-L (`launch/uleen_cell.ULN_L_SPEC`: 784 x 7 bits, six submodels,
# dropout shared across classes, bf16 tables) on DIST_ROWS MNIST-shaped
# synthetic rows encoded on the card, a global batch of DIST_BATCH in
# DIST_BLOCKS blocks (1024 rows a block), through `launch.train.
# train_uleen` on DIST_MESH: four rank processes sharing the card under
# gloo (and, with four cards or more, one rank a card under NCCL)
DIST_ROWS, DIST_BATCH, DIST_BLOCKS = 16384, 8192, 8
DIST_STEPS, DIST_LR, DIST_SEED = 5, 1e-3, 20270
DIST_MESH = ((2, 2), ("pod", "data"))
DIST_RESUME_MESH = ((2,), ("data",))
DIST_PREEMPT_AT = 2              # a guard fires after this step
DIST_TIMEOUT_S = 400
# the JAX battery's envelope for the compressed run's distance from the
# exact one after step t, lr·(t+1)·1.25, measured on its 2-submodel smoke
# spec; reported here (ULN-L exceeds it), while the check holds the run
# bit for bit to its one-device emulation
DIST_JAX_ENVELOPE = 1.25
# the smoke Llama's checkpoint drill: DIST_LM_STEPS steps unbroken, and
# a run restarted from the checkpoint of step DIST_LM_STEPS / 2
DIST_LM_STEPS, DIST_LM_BATCH, DIST_LM_SEQ = 6, 2, 32


def wire_check(compression, collectives, mesh, shapes, dev) -> list:
    """`compression.compressed_psum` across `pod` at the trainer's leaf
    shapes: pod k's tensors are drawn from a generator seeded
    DIST_SEED + k (so every rank can draw every pod's), and the int8 mean
    is held to the exact mean of all pods within `quantization_bound`.
    Returns (max |error|, bound) a leaf."""
    npods = dict(zip(mesh.mesh_dim_names, mesh.shape))["pod"]

    def draw(k):
        gen = torch.Generator(device=dev).manual_seed(DIST_SEED + k)
        return [torch.randn(s, generator=gen, device=dev) * 1e-3
                for s in shapes]
    pods = [draw(k) for k in range(npods)]
    mean, _ = compression.compressed_psum(
        pods[collectives.axis_index(mesh, ("pod",))], mesh, "pod")
    out = []
    for i, m in enumerate(mean):
        stack = torch.stack([p[i] for p in pods]).double()
        err = float((m.double() - stack.mean(0)).abs().max())
        out.append((err, compression.quantization_bound([stack])))
    return out


def bytes_sent(mesh_sizes, axes, payload: float) -> float:
    """Bytes one rank sends in an all-gather of `payload` bytes over
    `axes`, innermost axis first (`dist.collectives.all_gather`): at each
    stage it sends what it holds to the axis's other ranks, then holds
    the stage's concatenation."""
    sent = 0.0
    for ax in reversed(axes):
        n = mesh_sizes[ax]
        sent += payload * (n - 1)
        payload *= n
    return sent


def uleen_dist_rank(rank, world, plan):
    """One rank of the distributed trainer's phase (run by
    `launch.mesh.spawn_ranks`): rebuilds the ULN-L problem on its card
    (the thermometer and hash kernels), runs `plan["runs"]` through
    `launch.train.train_uleen` on `plan["mesh"]` and measures each step's
    distance from the one-device reference `plan["ref"][o["ref"]]` (the
    exact blocked step, or the compressed step's emulation; the parent
    requires 0, `dist_failures`) and, for the compressed run, from the
    exact one. A run with "threads" set runs on that many CPU threads.
    Records the dtype and size of every
    gradient payload that crosses the `pod` group, and runs `wire_check`
    on a mesh with a `pod` axis. Returns its measurements and kernel
    launches."""
    import torch.distributed as dist
    from repro_torch import kernels
    from repro_torch.dist import collectives
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch import train as train_mod
    from repro_torch.launch import uleen_cell
    from repro_torch.train import checkpoint, compression, fault
    dev = mesh_mod.rank_device(plan["device"])
    kernels.reset_launch_counts()          # this rank's run starts here
    t0 = time.perf_counter()
    spec, statics, bits, labels = train_mod.uleen_problem(
        uleen_cell.ULN_L_SPEC, DIST_SEED, DIST_ROWS, hw=28, device=dev)
    refs = {name: [[torch.from_numpy(a).to(dev) for a in leaves]
                   for leaves in snaps]
            for name, snaps in plan["ref"].items()}
    problem_s = time.perf_counter() - t0
    mesh = mesh_mod.make_mesh(*plan["mesh"])
    pod_ranks = (dist.get_process_group_ranks(mesh.get_group("pod"))
                 if "pod" in plan["mesh"][1] else None)
    wire = []
    real_gather = dist.all_gather_into_tensor

    def recording_gather(out, x, group=None, *a, **k):
        # a gradient leaf has at least num_classes entries (the bias); the
        # loss and accuracy scalars cross too, in float32
        if (pod_ranks is not None and group is not None
                and x.numel() >= spec.num_classes
                and dist.get_process_group_ranks(group) == pod_ranks):
            wire.append((str(x.dtype).replace("torch.", ""), x.numel()))
        return real_gather(out, x, group, *a, **k)

    dist.all_gather_into_tensor = recording_gather
    out = {"rank": rank, "device": str(dev), "backend": dist.get_backend(),
           "problem_s": problem_s, "runs": {}}
    try:
        for name, o in plan["runs"]:
            guard = fault.PreemptionGuard()
            stamps, diffs, from_exact = [], [], []
            ref = refs[o.get("ref", "exact")]

            def diff(params, leaves):
                return max(float((a - b).abs().max()) for a, b in zip(
                    (*params.tables, params.bias), leaves))

            def hook(step, params, o=o, guard=guard, stamps=stamps,
                     diffs=diffs, from_exact=from_exact, ref=ref):
                torch.cuda.synchronize(dev)
                stamps.append(time.perf_counter())
                diffs.append(diff(params, ref[step]))
                from_exact.append(diff(params, refs["exact"][step]))
                if step == o.get("preempt_at") and rank == o.get(
                        "preempt_rank", 0):
                    guard.request()
            wire.clear()
            threads = torch.get_num_threads()
            torch.set_num_threads(o.get("threads", threads))
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            res = train_mod.train_uleen(
                spec, statics, bits, labels, steps_total=o["steps"],
                global_batch=DIST_BATCH, lr=DIST_LR,
                grad_blocks=DIST_BLOCKS, compress=o.get("compress", False),
                seed=DIST_SEED, mesh=mesh, ckpt_dir=o.get("ckpt"),
                ckpt_every=100, guard=guard, on_step=hook,
                time_collectives=o.get("time", False), verbose=False,
                device=dev)
            torch.set_num_threads(threads)
            steps_run = len(res["history"])
            run_s = stamps[-1] - t0 if stamps else 0.0
            out["runs"][name] = {
                "steps": steps_run, "first_step": res["resumed_from"],
                "latest_checkpoint": (checkpoint.latest_step(o["ckpt"])
                                      if o.get("ckpt") else None),
                "seconds": run_s,
                "step_ms": [(b - a) * 1e3 for a, b in zip(stamps,
                                                           stamps[1:])],
                "first_step_ms": (stamps[0] - t0) * 1e3 if stamps else None,
                "collective_s": [h["collective_s"] for h in res["history"]],
                "losses": [h["loss"] for h in res["history"]],
                "max_abs_diff": diffs, "max_abs_diff_from_exact": from_exact,
                "threads": o.get("threads", threads),
                "preempted": res["preempted"],
                "pod_payloads": sorted(set(wire))}
        if pod_ranks is not None:
            out["wire_check"] = wire_check(
                compression, collectives, mesh,
                [t.shape for t in refs["exact"][0]], dev)
    finally:
        dist.all_gather_into_tensor = real_gather
    out["launches"] = kernels.launch_counts()     # ... and ends here
    return out


def dist_failures(runs) -> list:
    """Every rank's run held to its check: every run bit-equal at every
    step to its one-device reference (the exact runs to the blocked step,
    the compressed run to its emulation); the compressed run apart from
    the exact one, its gradient payloads across `pod` int8, and
    `wire_check` within `quantization_bound`; the preempted run stopped
    after DIST_PREEMPT_AT with that checkpoint; the resumed run from it,
    bit-equal at the end."""
    bad = []
    for r in runs:
        for o in r["ranks"]:
            for i, (err, lim) in enumerate(o.get("wire_check", [])):
                if not err <= lim:
                    bad.append(f"{r['mesh']} rank {o['rank']}: int8 mean of "
                               f"leaf {i} off by {err} > {lim}")
            for name, run in o["runs"].items():
                what = f"{r['mesh']} {r['backend']} rank {o['rank']} {name}"
                diffs = run["max_abs_diff"]
                if any(d != 0.0 for d in diffs):
                    bad.append(f"{what}: |Δparam| from its one-device "
                               f"reference {diffs}")
                if name == "compressed":
                    if not any(d > 0 for d in run["max_abs_diff_from_exact"]):
                        bad.append(f"{what}: equal to the exact run")
                    if not run["pod_payloads"] or any(
                            dt != "int8" for dt, _ in run["pod_payloads"]):
                        bad.append(f"{what}: payloads across pod "
                                   f"{run['pod_payloads']}")
                if name == "preempted" and not (
                        run["preempted"] and run["steps"] == DIST_PREEMPT_AT
                        + 1 and run["latest_checkpoint"]
                        == DIST_PREEMPT_AT + 1):
                    bad.append(f"{what}: {run['steps']} steps, preempted "
                               f"{run['preempted']}, checkpoint "
                               f"{run['latest_checkpoint']}")
                if name == "elastic_resume" and (
                        run["first_step"] != DIST_PREEMPT_AT + 1
                        or run["preempted"] or run["steps"]
                        != DIST_STEPS - DIST_PREEMPT_AT - 1):
                    bad.append(f"{what}: resumed from {run['first_step']} "
                               f"for {run['steps']} steps")
    return bad


def lm_checkpoint_resume(train_mod, get_config, dev):
    """The smoke Llama through `launch.train.train` on the card: an
    unbroken DIST_LM_STEPS-step run (checkpoints every half of it) and a
    run restarted from its mid-run checkpoint alone end on bit-equal
    parameters and optimizer state."""
    import shutil
    from repro_torch.train import checkpoint
    cfg = get_config(TRAIN_ARCH, smoke=True)
    half = DIST_LM_STEPS // 2
    kw = dict(steps_total=DIST_LM_STEPS, batch=DIST_LM_BATCH,
              seq=DIST_LM_SEQ, seed=20271, ckpt_every=half, verbose=False,
              device=dev)
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        a, b = str(Path(tmp) / "unbroken"), str(Path(tmp) / "restarted")
        full = train_mod.train(cfg, ckpt_dir=a, **kw)
        os.makedirs(b)
        mid = f"step_{half:010d}"
        shutil.copytree(os.path.join(a, mid), os.path.join(b, mid))
        resumed = train_mod.train(cfg, ckpt_dir=b, **kw)
        steps_after = checkpoint.all_steps(b)
    leaves = checkpoint.flatten((full["params"], full["opt_state"]))
    again = checkpoint.flatten((resumed["params"], resumed["opt_state"]))
    diff = max(float((x.float() - y.float()).abs().max())
               for x, y in zip(leaves, again))
    if resumed["resumed_from"] != half or diff != 0.0 or \
            steps_after != [half, DIST_LM_STEPS]:
        raise AssertionError(f"LM restart: resumed from "
                             f"{resumed['resumed_from']}, checkpoints "
                             f"{steps_after}, max |Δ| {diff}")
    return {"model": cfg.name, "steps": DIST_LM_STEPS, "restart_at": half,
            "batch": DIST_LM_BATCH, "seq": DIST_LM_SEQ, "leaves": len(leaves),
            "max_abs_diff": diff,
            "losses_unbroken": [h["loss"] for h in full["history"]],
            "losses_restarted": [h["loss"] for h in resumed["history"]]}


def uleen_dist_train_path(kernels, *, train_mod, uleen_cell, compression,
                          mesh_mod, get_config, device="cuda"):
    """The distributed ULEEN trainer at ULN-L width. The parent builds the
    problem (thermometer kernel) and runs two one-device references for
    DIST_STEPS steps (`launch.train.uleen_reference_params`, the hash
    kernel on every block): the blocked step, and the compressed step's
    emulation on DIST_MESH. Then, in DIST_MESH ranks sharing the card
    under gloo: the exact run (bit-equal to the blocked step every step),
    the same on one CPU thread a rank (the thread count's cost), the
    compressed run (bit-equal to its emulation every step, apart from the
    exact run, int8 across `pod`; its ratio to the JAX battery's
    lr·(t+1)·1.25 is reported), a run preempted through
    `PreemptionGuard.request()` after step DIST_PREEMPT_AT that
    checkpoints, and `wire_check`; then on DIST_RESUME_MESH the elastic
    resume to DIST_STEPS (bit-equal). Last, the smoke Llama's checkpoint
    restart (`lm_checkpoint_resume`). Returns the launches, the parent's
    and every rank's summed."""
    import shutil
    dev = torch.device(device)
    spec = uleen_cell.ULN_L_SPEC
    kernels.reset_launch_counts()          # the path's run starts here
    t_path = time.perf_counter()
    t0 = time.perf_counter()
    spec, statics, bits, labels = train_mod.uleen_problem(
        spec, DIST_SEED, DIST_ROWS, hw=28, device=dev)
    torch.cuda.synchronize()
    problem_s = time.perf_counter() - t0
    stamps = [time.perf_counter()]

    def stamp(step, params):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
    ref = train_mod.uleen_reference_params(
        spec, statics, bits, labels, steps=DIST_STEPS,
        global_batch=DIST_BATCH, lr=DIST_LR, grad_blocks=DIST_BLOCKS,
        seed=DIST_SEED, on_step=stamp, device=dev)
    ref_ms = [(b - a) * 1e3 for a, b in zip(stamps, stamps[1:])]
    emulated = train_mod.uleen_reference_params(
        spec, statics, bits, labels, steps=DIST_STEPS,
        global_batch=DIST_BATCH, lr=DIST_LR, grad_blocks=DIST_BLOCKS,
        seed=DIST_SEED, compress_mesh=DIST_MESH, device=dev)
    ref_np = {name: [[t.cpu().numpy() for t in (*p.tables, p.bias)]
                     for p in snaps]
              for name, snaps in (("exact", ref), ("compressed", emulated))}
    trainable = [*ref[-1].tables, ref[-1].bias]
    elements = sum(t.numel() for t in trainable)
    del ref, emulated
    parent = kernels.launch_counts()

    (ROOT / "build").mkdir(exist_ok=True)
    runs = []
    cards = torch.cuda.device_count()
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        ckpt = str(Path(tmp) / "uleen")
        plans = [
            ("gloo", DIST_MESH, [
                ("exact", {"steps": DIST_STEPS, "time": True}),
                ("exact_threads_1", {"steps": DIST_STEPS, "time": True,
                                     "threads": 1}),
                ("compressed", {"steps": DIST_STEPS, "compress": True,
                                "time": True, "ref": "compressed"}),
                ("preempted", {"steps": DIST_STEPS, "ckpt": ckpt,
                               "preempt_at": DIST_PREEMPT_AT,
                               "preempt_rank": 1})]),
            ("gloo", DIST_RESUME_MESH, [
                ("elastic_resume", {"steps": DIST_STEPS, "ckpt": ckpt,
                                    "resume_from": DIST_PREEMPT_AT + 1})])]
        world4 = math.prod(DIST_MESH[0])
        if cards >= world4:
            plans.append((mesh_mod.collective_backend(dev, world4),
                          DIST_MESH, [("exact_one_rank_a_card",
                                       {"steps": DIST_STEPS,
                                        "time": True})]))
            nccl = f"ran: {world4} ranks, one a card"
        else:
            nccl = (f"not run: {cards} CUDA device; one rank per card under "
                    f"NCCL needs {world4} or more")
        for backend, mesh, rank_runs in plans:
            world = math.prod(mesh[0])
            t0 = time.perf_counter()
            outs = mesh_mod.spawn_ranks(
                uleen_dist_rank, world, {"mesh": mesh, "runs": rank_runs,
                                         "ref": ref_np, "device": device},
                backend=backend, timeout_s=DIST_TIMEOUT_S)
            runs.append({"world": world, "backend": backend,
                         "mesh": mesh_tag(*mesh),
                         "seconds": time.perf_counter() - t0,
                         "ranks": outs})
        shutil.rmtree(ckpt, ignore_errors=True)
    lm = lm_checkpoint_resume(train_mod, get_config, dev)
    failures = dist_failures(runs)
    seconds = time.perf_counter() - t_path
    parent_all = kernels.launch_counts()   # ... and ends here
    launches = {k: parent_all[k] + sum(o["launches"][k] for r in runs
                                       for o in r["ranks"])
                for k in KERNEL_INFO}
    idle = [k for k in ("h3_hash", "thermometer_encode") if not launches[k]]
    if idle:
        raise AssertionError(f"the distributed trainer's path never "
                             f"launched {idle}")

    sizes = dict(zip(DIST_MESH[1], DIST_MESH[0]))
    bpd = DIST_BLOCKS // math.prod(DIST_MESH[0])
    grad_bytes = 4 * elements
    summary = {}
    for name in ("exact", "exact_threads_1", "compressed"):
        r0 = runs[0]["ranks"][0]["runs"][name]
        # steps after the first (its host and device warm-up), each ending
        # in a synchronized hook: the share of their wall time spent in
        # collectives (synchronized around each)
        summary[name] = {
            "ms_a_step_median_after_first": float(np.median(r0["step_ms"])),
            "step_ms": r0["step_ms"], "first_step_ms": r0["first_step_ms"],
            "collective_share_after_first": sum(r0["collective_s"][1:])
            / (sum(r0["step_ms"]) / 1e3),
            "collective_s": r0["collective_s"],
            "threads": r0["threads"], "losses": r0["losses"],
            "max_abs_diff": r0["max_abs_diff"],
            "pod_payloads": r0["pod_payloads"]}
    summary["exact"]["bytes_sent_a_step_per_rank"] = bytes_sent(
        sizes, DIST_MESH[1], bpd * grad_bytes)
    summary["compressed"]["bytes_sent_a_step_per_rank"] = (
        bytes_sent(sizes, ("data",), grad_bytes)
        + bytes_sent(sizes, ("pod",), elements))
    summary["exact"]["cross_pod_bytes"] = compression.cross_pod_bytes(
        trainable, compressed=False)
    summary["compressed"]["cross_pod_bytes"] = compression.cross_pod_bytes(
        trainable, compressed=True)
    diffs = runs[0]["ranks"][0]["runs"]["compressed"][
        "max_abs_diff_from_exact"]
    summary["compressed"]["max_abs_diff_from_exact"] = diffs
    summary["compressed"]["diff_over_lr_t_plus_1"] = [
        d / (DIST_LR * (t + 1)) for t, d in enumerate(diffs)]
    summary["compressed"]["jax_envelope_1_25_holds"] = all(
        d <= DIST_LR * (t + 1) * DIST_JAX_ENVELOPE
        for t, d in enumerate(diffs))
    summary["compressed"]["wire_check"] = runs[0]["ranks"][0]["wire_check"]
    emit("uleen_dist_train_path", model="ULN-L", total_bits=spec.total_bits,
         submodels=len(spec.submodels), table_entries=elements - 10,
         trainable_bytes_float32=grad_bytes, bf16_tables=spec.bf16_tables,
         dropout_shared_classes=spec.dropout_shared_classes,
         train_rows=DIST_ROWS, global_batch=DIST_BATCH,
         grad_blocks=DIST_BLOCKS, rows_a_block=DIST_BATCH // DIST_BLOCKS,
         steps=DIST_STEPS, lr=DIST_LR, mesh=mesh_tag(*DIST_MESH),
         problem_s=problem_s,
         single_device_reference={
             "steps": DIST_STEPS, "step_ms": ref_ms,
             "ms_a_step_median_after_first": float(np.median(ref_ms[1:])),
             "launches": parent},
         exact=summary["exact"], exact_threads_1=summary["exact_threads_1"],
         compressed=summary["compressed"],
         elastic={"preempted_after_step": DIST_PREEMPT_AT,
                  "resumed_on": mesh_tag(*DIST_RESUME_MESH),
                  "final_max_abs_diff": runs[1]["ranks"][0]["runs"][
                      "elastic_resume"]["max_abs_diff"][-1]},
         lm_checkpoint_resume=lm, nccl_one_rank_per_card=nccl,
         runs=runs, path_s=seconds, launches=launches, failures=failures)
    if failures:
        raise AssertionError(f"uleen_dist_train_path: {failures}")
    return launches


# ---------------------------------------------------------------------------
# The dry run: the ULEEN cells traced on the production meshes, then rank
# 0's program of four cells run for real on the card against its record
# ---------------------------------------------------------------------------

DRYRUN_OUT = ROOT / "build" / "dryrun"
DRYRUN_TIMEOUT_S = 600
# the record's peak a rank against the card's max_memory_allocated of the
# same program at the same shapes: within this fraction of the record.
# The trace sees every operator's output but not a CUDA kernel's own
# workspace (the training step's index backward sorts its indices: +10 %
# at ULN-L on an H100)
DRYRUN_PEAK_TOL = 0.15
# cells the dry run is allowed to fail on: none (the class-sharded
# cell's rank fits JAX's bound since its slices take 2 bits an entry)
DRYRUN_KNOWN_FAULTS: tuple = ()
OP_TIMED_CALLS = 100


def host_us_pair(op, direct, calls: int = OP_TIMED_CALLS,
                 rounds: int = 7) -> tuple[float, float]:
    """Host microseconds a call of `op` and of `direct`: `calls` calls
    issued back to back (no synchronize between them: each only queues
    its launch), in rounds that alternate which goes first; the medians
    over rounds."""
    def per_call(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        return (t1 - t0) / calls * 1e6
    op(), direct()
    times = {"op": [], "direct": []}
    for r in range(rounds):
        order = (("op", op), ("direct", direct))
        for name, fn in (order if r % 2 == 0 else order[::-1]):
            times[name].append(per_call(fn))
    return float(np.median(times["op"])), float(np.median(times["direct"]))


def op_against_direct(export, wnn_ensemble, h3_mod, gen) -> dict:
    """Rows 1, 2 and 5 through their operators against the direct ctypes
    launch on the same inputs (ULN-L, 65536 rows; the output allocated,
    then launched, as the wrappers did before the operators): per-call
    ms (CUDA events) and host µs of issuing the call (`host_us_pair`)."""
    art = uln_l_artifact(export, 20290)
    bits = torch.randint(0, 2, (INFER_BATCH, ULN_L_BITS), generator=gen,
                         device="cuda", dtype=torch.int8)
    out = {}
    for kname, backend in (("packed_wnn", "auto"), ("fused_wnn", "fused")):
        prep = export.prepare_artifact(art, backend=backend, device="cuda")
        a = prep.kernel_args
        tensors = (bits, a.perms, a.params, a.slices, a.masks, a.desc,
                   prep.bias)
        extra = wnn_ensemble.op_arguments(a)
        def op():
            return torch.ops.repro_torch.wnn_ensemble.default(
                *tensors, *extra, kname)

        def direct():     # the launch as the wrapper made it before
            res = torch.empty((INFER_BATCH, a.num_classes),
                              dtype=torch.int32, device="cuda")
            wnn_ensemble.launch_direct(*tensors, res, a.columns, a.chunks,
                                       a.planes, a.max_hashes)
            return res
        want = op()
        res = direct()
        torch.cuda.synchronize()
        assert_equal(f"{kname} op vs direct", want, res)
        op_us, direct_us = host_us_pair(op, direct)
        out[kname] = {"op_ms": cuda_ms(op, 20), "direct_ms": cuda_ms(direct, 20),
                      "op_host_us": op_us, "direct_host_us": direct_us}
        del prep, want
    n_f, n = math.ceil(ULN_L_BITS / 12), 12
    tuples = torch.randint(0, 2, (INFER_BATCH, n_f, n), generator=gen,
                           device="cuda", dtype=torch.int8)
    params = torch.randint(0, 64, (2, n), generator=gen, device="cuda",
                           dtype=torch.int32)
    def op():
        return torch.ops.repro_torch.h3_hash.default(tuples, params)

    def direct():         # the launch as the wrapper made it before
        res = torch.empty((INFER_BATCH, n_f, 2), dtype=torch.int32,
                          device="cuda")
        h3_mod.launch_direct(tuples, params, res)
        return res
    want = op()
    res = direct()
    torch.cuda.synchronize()
    assert_equal("h3_hash op vs direct", want, res)
    op_us, direct_us = host_us_pair(op, direct)
    out["h3_hash"] = {"op_ms": cuda_ms(op, 20), "direct_ms": cuda_ms(direct, 20),
                      "op_host_us": op_us, "direct_host_us": direct_us}
    out.update(front_end_and_flash_ops(gen))
    for row in out.values():
        row["added_host_us"] = row["op_host_us"] - row["direct_host_us"]
    return out


def front_end_and_flash_ops(gen) -> dict:
    """Rows 3, 4 and 6 through their operators (`repro_torch::
    thermometer_encode`, `::thermometer_decompress`, `::flash_attention`)
    against the direct ctypes launch on the same inputs: the front end at
    the ULN-L serve batch (65536 x 784 features, 7 bits), flash at Llama
    3.2 3B's prefill (B 4, 24/8 x 128, 1024, float32). Per-call ms (CUDA
    events) and host µs a call."""
    th = importlib.import_module("repro_torch.kernels.thermometer")
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    x = torch.rand((INFER_BATCH, 784), generator=gen, device="cuda")
    thr = torch.sort(torch.rand((784, 7), generator=gen, device="cuda"),
                     dim=1).values
    counts = torch.randint(0, 8, (INFER_BATCH, 784), generator=gen,
                           device="cuda", dtype=torch.uint8)
    q = torch.randn((4, 24, 1024, 128), generator=gen, device="cuda")
    k = torch.randn((4, 8, 1024, 128), generator=gen, device="cuda")
    v = torch.randn((4, 8, 1024, 128), generator=gen, device="cuda")
    scale = 128 ** -0.5

    def enc_direct():
        res = torch.empty((INFER_BATCH, 784, 7), dtype=torch.int8,
                          device="cuda")
        th.encode_direct(x, thr, res)
        return res

    def dec_direct():
        res = torch.empty((INFER_BATCH, 784, 7), dtype=torch.int8,
                          device="cuda")
        th.decompress_direct(counts, res)
        return res

    def flash_direct():
        res = torch.empty((4, 1024, 24, 128), device="cuda")
        fa.launch_direct(q, k, v, res, True, 0, scale, 0)
        return res
    cases = {
        "thermometer_encode": (
            lambda: torch.ops.repro_torch.thermometer_encode.default(x, thr),
            enc_direct),
        "thermometer_decompress": (
            lambda: torch.ops.repro_torch.thermometer_decompress.default(
                counts, 7), dec_direct),
        "flash_attention": (
            lambda: torch.ops.repro_torch.flash_attention.default(
                q, k, v, True, 0, scale, 0), flash_direct)}
    out = {}
    for name, (op, direct) in cases.items():
        want, res = op(), direct()
        torch.cuda.synchronize()
        if not torch.equal(want, res):
            raise AssertionError(f"{name} op vs direct: not bit-equal")
        op_us, direct_us = host_us_pair(op, direct)
        out[name] = {"op_ms": cuda_ms(op, 20),
                     "direct_ms": cuda_ms(direct, 20),
                     "op_host_us": op_us, "direct_host_us": direct_us}
    return out


def _json_lines(text: str) -> list:
    return [json.loads(ln) for ln in text.splitlines()
            if ln.startswith("{")]


def dryrun_path(kernels, *, export, wnn_ensemble, h3_mod):
    """`launch.dryrun --arch uleen --mesh both --analyze` in a subprocess
    (it plays a fake world of 256 and 512 ranks; this process's later
    phases start real groups), one line a cell; then `--rank-run` in a
    subprocess: rank 0's program of infer_mnist_scale,
    infer_packed_scale, infer_sharded_scale and train_mnist_scale run for
    real on the card at its single-pod shard shapes, its
    max_memory_allocated held to the record's peak within
    DRYRUN_PEAK_TOL and its kernel launches to the trace's operator
    nodes; then the operators against their direct launches (rows 1, 2,
    5): per-call ms (CUDA events) and host µs a call. Returns (the op
    timings by kernel, the rank runs' launches by kernel)."""
    t0 = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
           "uleen", "--mesh", "both", "--analyze", "--out", str(DRYRUN_OUT)]
    run = subprocess.run(cmd, capture_output=True, text=True, env=env,
                         cwd=ROOT, timeout=DRYRUN_TIMEOUT_S)
    dry_s = time.perf_counter() - t0
    records = {}
    for path in sorted(DRYRUN_OUT.glob("*.json")):
        rec = json.loads(path.read_text())
        if isinstance(rec, dict) and "ok" in rec:
            records[path.stem] = rec
    if len(records) != 12 or not (DRYRUN_OUT / "ANALYSIS.json").exists() \
            or not (DRYRUN_OUT / "METRICS.json").exists():
        raise AssertionError(f"dryrun: {len(records)} records (want 12), "
                             f"rc {run.returncode}:\n{run.stdout[-3000:]}"
                             f"\n{run.stderr[-3000:]}")
    bad = sorted(t for t, r in records.items() if not r["ok"]
                 and r["shape"] not in DRYRUN_KNOWN_FAULTS)
    if bad or run.returncode != (1 if any(
            not r["ok"] for r in records.values()) else 0):
        raise AssertionError(f"dryrun: cells failed {bad}, rc "
                             f"{run.returncode}:\n{run.stderr[-3000:]}")
    cells = []
    for tag, r in sorted(records.items()):
        roof = r.get("roofline", {})
        cells.append({"cell": tag, "ok": r["ok"],
                      "peak_gib": r.get("memory", {}).get("peak_gib"),
                      "compute_s": roof.get("compute_s"),
                      "memory_s": roof.get("memory_s"),
                      "collective_s": roof.get("collective_s"),
                      "dominant": roof.get("dominant"),
                      "traced_device": r.get("traced_device"),
                      "op_nodes": r.get("op_nodes"),
                      **({"error": r["error"]} if not r["ok"] else {})})
        print(f"[dryrun] {tag}: peak {cells[-1]['peak_gib']} GiB a rank, "
              f"terms {roof.get('compute_s')}/{roof.get('memory_s')}/"
              f"{roof.get('collective_s')}, {roof.get('dominant')}, "
              f"ok={r['ok']}", flush=True)
    t1 = time.perf_counter()
    rank = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                           "--rank-run"], capture_output=True, text=True,
                          env=env, cwd=ROOT, timeout=DRYRUN_TIMEOUT_S)
    if rank.returncode:
        raise AssertionError(f"dryrun --rank-run rc {rank.returncode}:\n"
                             f"{rank.stderr[-3000:]}")
    checks = []
    op_kernels = {"repro_torch::wnn_ensemble": ("packed_wnn", "fused_wnn"),
                  "repro_torch::h3_hash": ("h3_hash",)}
    for run_ in _json_lines(rank.stdout):
        shape = run_["shape"]
        tag = next(t for t in records if f".{shape}.pod1" in t)
        rec = records[tag]
        want_peak = rec["memory"]["peak_gib"] * 2 ** 30
        ratio = run_["peak_bytes"] / want_peak
        nodes = rec["op_nodes"]
        launched = {op: sum(run_["launches"].get(k, 0) for k in ks)
                    for op, ks in op_kernels.items()}
        traced = {op: nodes.get(op, 0) for op in op_kernels}
        checks.append({"cell": tag, "peak_bytes": run_["peak_bytes"],
                       "record_peak_bytes": want_peak, "ratio": ratio,
                       "args_bytes": run_["args_bytes"],
                       "record_args_bytes": rec["memory"]["args_gib"]
                       * 2 ** 30, "launches": run_["launches"],
                       "op_nodes": traced,
                       "traced_device": rec.get("traced_device")})
        if abs(ratio - 1.0) > DRYRUN_PEAK_TOL:
            raise AssertionError(f"{tag}: the card's peak {run_['peak_bytes']}"
                                 f" B is {ratio:.3f} x the record's")
        if launched != traced:
            raise AssertionError(f"{tag}: launches {launched} != the "
                                 f"trace's operator nodes {traced}")
    if len(checks) != 4:
        raise AssertionError(f"dryrun --rank-run: {len(checks)} cells ran")
    rank_s = time.perf_counter() - t1
    gen = torch.Generator(device="cuda").manual_seed(25)
    ops = op_against_direct(export, wnn_ensemble, h3_mod, gen)
    total = time.perf_counter() - t0
    emit("dryrun_path", seconds=total, dryrun_s=dry_s, rank_run_s=rank_s,
         cells=cells, rank_checks=checks, op_vs_direct=ops,
         peak_tolerance=DRYRUN_PEAK_TOL,
         card_total_memory=torch.cuda.get_device_properties(0).total_memory,
         analysis=json.loads((DRYRUN_OUT / "ANALYSIS.json").read_text())[
             "errors"])
    launches = {k: sum(c["launches"].get(k, 0) for c in checks)
                for k in KERNEL_INFO}
    return ops, launches


# ---------------------------------------------------------------------------
# The LM dry run: the cells of Llama 3.2 3B (dense), Mixtral 8x7B
# (tensor-parallel experts, banded window), DeepSeek-V2-Lite
# (expert-parallel experts, MLA), Mamba 2 2.7B (the SSD mixer by heads),
# RecurrentGemma 2B (the RG-LRU by channels, the local MQA by query
# rows), Whisper tiny (the encoder whole over `model`, the decoder's
# attention by query rows, cross keys and values gathered) and InternVL2
# 26B (patch rows ahead of the prompt, the prefill's cache write
# wrapping) traced on the production meshes (the card's program), then
# rank 0's program of each one's single-pod cells run for real against
# the records
# ---------------------------------------------------------------------------

LM_DRYRUN_OUT = ROOT / "build" / "lm_dryrun"
LM_DRYRUN_ARCHS = ("llama3p2_3b", "mixtral_8x7b", "deepseek_v2_lite_16b",
                   "mamba2_2p7b", "recurrentgemma_2b", "whisper_tiny",
                   "internvl2_26b")
# layers of each arch the phase traces and runs (full width; DeepSeek's
# dense layer and one MoE layer; RecurrentGemma's `--layers 2` rounds up
# to its one whole (rec, rec, local) pattern, so that its local layer's
# flash kernel runs; Whisper's 2 decoder layers beside its 4 encoder
# layers): a train cell's trace runs its 16 microbatches through every
# layer for the graph (its memory pass two of them), tens of seconds a
# layer on the host; the full-depth sweep runs by hand (`python -m
# repro_torch.launch.sweep`, PERF.md)
LM_DRYRUN_LAYERS = 2
# the sweep is host work only (fake tensors: nothing on the card), so it
# starts in the background right after the build, LM_DRYRUN_JOBS cells
# at a time, leaving the other cores to the card's phases, and
# `lm_dryrun_path` waits for it at most LM_DRYRUN_TIMEOUT_S from its start
LM_DRYRUN_JOBS = 4
LM_DRYRUN_TIMEOUT_S = 900
# the flash kernel at rank shards of the placed prefill_32k (2 rows a
# rank). 6k: RecurrentGemma's local MQA: bf16, D 256, 10 query heads over
# one KV head, a window of 2048; the heads cannot take `model`, so the
# last rank's 2048 query rows start at 30,720, past the window, against
# all 32,768 keys. 6l: Whisper's decoder self-attention: bf16, D 64, 6
# heads (which cannot take `model` either), causal, the last rank's 2048
# rows at 30,720. 6m: its cross attention: the bf16 queries promoted to
# float32 over the float32 keys and values of the 1500 frames,
# non-causal, a rank's 2048 rows (rank 0's, the rank runs' shape)
LM_DRYRUN_FLASH_CASES = (
    dict(name="recurrentgemma_local_rank_b2_sq2048_off30720_sk32768_w2048"
              "_bf16",
         row="6k", b=2, h=10, hkv=1, sq=2048, sk=32768, d=256, window=2048,
         q_offset=30720, dtype=torch.bfloat16),
    dict(name="whisper_decoder_rank_b2_sq2048_off30720_sk32768_bf16",
         row="6l", b=2, h=6, hkv=6, sq=2048, sk=32768, d=64,
         q_offset=30720, dtype=torch.bfloat16),
    dict(name="whisper_cross_rank_b2_sq2048_sk1500_f32", row="6m", b=2,
         h=6, hkv=6, sq=2048, sk=1500, d=64, causal=False,
         dtype=torch.float32))
# the most a rank run may find allocated past what its arguments took
# when the measured step starts (its warm-up's leftovers, or an earlier
# cell's in the same process): the cuBLAS workspaces PyTorch keeps (2 x
# 32 MiB on an H100, the forward's thread and the autograd engine's) and
# 1 MiB besides. Past it, a buffer the
# record does not count would be taken off the peak unseen. The
# allocator's slack at the arguments (rounding, and a large block's tail
# below 1 MiB, which it does not split off: 1440 KiB at RecurrentGemma's
# embedding and its two moments) stays in the peak.
LM_OUTSIDE_LIMIT = 65 * 2 ** 20


def start_lm_dryrun_sweep():
    """`launch.sweep --archs LM_DRYRUN_ARCHS --layers LM_DRYRUN_LAYERS`
    started in the background, in a session of its own (so that
    `stop_process_group` ends its cells' processes with it), its output
    to files beside LM_DRYRUN_OUT. Returns (process, start time on the
    wall clock, log paths)."""
    shutil.rmtree(LM_DRYRUN_OUT, ignore_errors=True)
    LM_DRYRUN_OUT.mkdir(parents=True)
    logs = tuple(LM_DRYRUN_OUT.with_suffix(x) for x in (".out", ".err"))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    with open(logs[0], "w") as out, open(logs[1], "w") as err:
        proc = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.sweep", "--archs",
             *LM_DRYRUN_ARCHS, "--layers", str(LM_DRYRUN_LAYERS), "--jobs",
             str(LM_DRYRUN_JOBS), "--out", str(LM_DRYRUN_OUT)],
            stdout=out, stderr=err, env=env, cwd=ROOT,
            start_new_session=True)
    atexit.register(stop_process_group, proc)
    return proc, time.time(), logs


def stop_process_group(proc) -> None:
    """Kill `proc`'s session (it and every process it started) unless it
    has ended, and reap it."""
    if proc.poll() is None:
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
    proc.wait()


def lm_dryrun_path(kernels, sweep):
    """First the flash kernel at LM_DRYRUN_FLASH_CASES (6k, 6l, 6m)
    against its plain version, timed beside it and one SDPA call. Then
    the end of `sweep` (`start_lm_dryrun_sweep`: 48 cells, train_4k,
    prefill_32k and decode_32k of each arch, and long_500k of Mixtral,
    Mamba 2 and RecurrentGemma, on both meshes; one process each), every
    record ok
    with no wnnlint error; then `launch.dryrun --rank-run` of each arch's
    cells on one pod (one process an arch, all at once): rank 0's real
    program on the card at its shard shapes, its max_memory_allocated
    less what outlives a step outside the program (`args_bytes` past
    `args_alloc_bytes`, what its arguments took: the BLAS workspaces, at
    most LM_OUTSIDE_LIMIT) held to the record's peak within
    DRYRUN_PEAK_TOL and its flash launches to the trace's
    `repro_torch::flash_attention` nodes. Returns the rank runs' launches
    by kernel and the three flash rows, each with the path's launches at
    its shape and, as `rank_run_launches`, the rank runs' launches at
    exactly its shape (rank 0's query block starts at offset 0: 6m's
    shape, not 6k's or 6l's)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import plan
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    flash_rows = []
    for case in LM_DRYRUN_FLASH_CASES:
        flash_rows.append(flash_case_row(gen, ref, kernels.flash_attention,
                                         plan, case))
        torch.cuda.empty_cache()
    torch.cuda.empty_cache()
    kernels.reset_launch_counts()     # the path's run starts here
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc, started, logs = sweep
    t_wait = time.time()
    try:
        rc = proc.wait(timeout=max(
            1.0, LM_DRYRUN_TIMEOUT_S - (t_wait - started)))
    except subprocess.TimeoutExpired:
        rc = "timeout"
    finally:
        stop_process_group(proc)
    # the sweep's own time (its start to its last record's write), from
    # its start to this read, and what this phase waited for it
    read_s, wait_s = time.time() - started, time.time() - t_wait
    records, sweep_s = {}, 0.0
    for arch in LM_DRYRUN_ARCHS:
        for path in sorted(LM_DRYRUN_OUT.glob(f"{arch}.*.json")):
            records[path.stem] = json.loads(path.read_text())
            sweep_s = max(sweep_s, path.stat().st_mtime - started)
    bad = sorted(t for t, r in records.items() if not r.get("ok")
                 or r.get("analysis", {}).get("errors", 1))
    from repro_torch.configs import get_config, shapes_for
    shapes = {a: len(shapes_for(get_config(a))) for a in LM_DRYRUN_ARCHS}
    want_cells = 2 * sum(shapes.values())
    if rc or len(records) != want_cells or bad:
        raise AssertionError(f"lm_dryrun: {len(records)} records, failed "
                             f"{bad}, rc {rc}:\n"
                             f"{logs[0].read_text()[-3000:]}\n"
                             f"{logs[1].read_text()[-3000:]}")
    cells = []
    for tag, r in records.items():
        roof, mem = r["roofline"], r["memory"]
        cells.append({"cell": tag, "layers": r["layers"],
                      "trace_s": r["trace_s"],
                      "traced_device": r["traced_device"],
                      "peak_gib": mem["peak_gib"], "args_gib": mem["args_gib"],
                      "temp_gib": mem["temp_gib"],
                      "args_bytes_by_kind": r["args_bytes_by_kind"],
                      "compute_s": roof["compute_s"],
                      "memory_s": roof["memory_s"],
                      "collective_s": roof["collective_s"],
                      "collectives": {k: int(d["count"]) for k, d in
                                      roof["collectives_by_kind"].items()},
                      "op_nodes": r["op_nodes"]})
        print(f"[lm_dryrun] {tag}: peak {mem['peak_gib']:.4f} GiB a rank, "
              f"terms {roof['compute_s']:.3e}/{roof['memory_s']:.3e}/"
              f"{roof['collective_s']:.3e}, traced on {r['traced_device']}",
              flush=True)
    t1 = time.perf_counter()
    procs = {arch: subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
         "--layers", str(LM_DRYRUN_LAYERS), "--rank-run"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=ROOT)
        for arch in LM_DRYRUN_ARCHS}
    outs = {}
    try:
        for arch, proc in procs.items():
            out, err = proc.communicate(timeout=LM_DRYRUN_TIMEOUT_S)
            if proc.returncode:
                raise AssertionError(f"lm dryrun --rank-run --arch {arch} rc "
                                     f"{proc.returncode}:\n{err[-3000:]}")
            outs[arch] = out
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    checks = []
    for arch in LM_DRYRUN_ARCHS:
        for run_ in _json_lines(outs[arch]):
            tag = f"{arch}.{run_['shape']}.pod1"
            rec = records[tag]
            want_peak = rec["memory"]["peak_gib"] * 2 ** 30
            # what outlives a step outside the program (the BLAS
            # libraries' workspaces: no traced operator allocates them)
            outside = run_["args_bytes"] - run_["args_alloc_bytes"]
            ratio = (run_["peak_bytes"] - outside) / want_peak
            launched = run_["launches"].get("flash_attention", 0)
            traced = rec["op_nodes"].get("repro_torch::flash_attention", 0)
            checks.append({"cell": tag, "peak_bytes": run_["peak_bytes"],
                           "record_peak_bytes": want_peak, "ratio": ratio,
                           "raw_ratio": run_["peak_bytes"] / want_peak,
                           "outside_bytes": outside,
                           "args_slack_bytes": run_["args_alloc_bytes"]
                           - run_["arg_tensor_bytes"],
                           "args_bytes": run_["args_bytes"],
                           "record_args_bytes": rec["memory"]["args_gib"]
                           * 2 ** 30, "launches": run_["launches"],
                           "flash_shapes": run_["flash_shapes"],
                           "flash_nodes": traced,
                           "traced_device": rec["traced_device"]})
            print(f"[lm_dryrun] {tag} on the card: peak {run_['peak_bytes']}"
                  f" B less {outside} B outside the program = {ratio:.4f} x "
                  f"the record, flash launches {launched} against {traced} "
                  f"nodes", flush=True)
            if not 0 <= outside <= LM_OUTSIDE_LIMIT:
                raise AssertionError(f"{tag}: {outside} B allocated past "
                                     f"the step's arguments, not within "
                                     f"[0, {LM_OUTSIDE_LIMIT}] B")
            if abs(ratio - 1.0) > DRYRUN_PEAK_TOL:
                raise AssertionError(f"{tag}: the card's peak "
                                     f"{run_['peak_bytes']} B is "
                                     f"{ratio:.3f} x the record's")
            if launched != traced or \
                    set(run_["launches"]) - {"flash_attention"}:
                raise AssertionError(f"{tag}: launches {run_['launches']} "
                                     f"!= the trace's flash nodes {traced}")
    if len(checks) != sum(shapes.values()):
        raise AssertionError(f"lm dryrun --rank-run: {len(checks)} cells ran")
    # each row's launches at its shape: this process's (none: the rank
    # runs run in processes of their own) and the rank runs'
    for row in flash_rows:
        key = list(flash_shape(row))
        row["launches"] = kernels.flash_attention.shapes[flash_shape(row)]
        row["rank_run_launches"] = sum(
            n for c in checks for *shape, n in c["flash_shapes"]
            if shape == key)
    emit("lm_dryrun_path", seconds=time.perf_counter() - t0, sweep_s=sweep_s,
         sweep_read_s=read_s, sweep_wait_s=wait_s, sweep_jobs=LM_DRYRUN_JOBS,
         rank_run_s=time.perf_counter() - t1, archs=list(LM_DRYRUN_ARCHS),
         layers=LM_DRYRUN_LAYERS, cells=cells, rank_checks=checks,
         peak_tolerance=DRYRUN_PEAK_TOL, outside_limit=LM_OUTSIDE_LIMIT,
         flash=flash_rows)
    return {k: sum(c["launches"].get(k, 0) for c in checks)
            for k in KERNEL_INFO}, flash_rows


# ---------------------------------------------------------------------------
# The LM entry points on a mesh: `launch.train.train(mesh=)` and
# `launch.serve.serve(mesh=)` in rank processes that share the card
# ---------------------------------------------------------------------------

# Llama 3.2 3B at full width and MESH_LAYERS of its 28 layers, trained
# for MESH_STEPS float32-compute steps of MESH_BATCH x MESH_SEQ tokens in
# MESH_MICROBATCHES microbatches on MESH_MAIN, a checkpoint after step
# MESH_CKPT_AT resumed on MESH_RESUME and in one process; then served on
# MESH_RESUME. Four gloo ranks share the card, their shards on it ("cuda"
# DeviceMeshes, DTensor's all-gathers through `dist.collectives`' route)
MESH_LAYERS = 2
MESH_BATCH, MESH_SEQ, MESH_STEPS, MESH_MICROBATCHES = 4, 1024, 3, 2
MESH_CKPT_AT = 2
MESH_SEED, MESH_SERVE_SEED = 20272, 20273
MESH_MAIN = ((2, 2), ("data", "model"))
# serving runs on MESH_RESUME too: with no `data` axis the `fsdp`
# weights are whole on every rank, where on MESH_MAIN each decode step
# gathered ~1.2 GB a rank through gloo: 56 s for the 16 tokens on an H100
MESH_RESUME = ((4,), ("model",))
MESH_SERVE_BATCH, MESH_SERVE_PROMPT, MESH_SERVE_GEN = 2, 512, 16
MESH_TIMEOUT_S = 600
# Tolerances against the one-device run of the same seed. The losses
# within 1e-5 relative: a rank's matmuls reduce over its own slice of
# `model` and an all-reduce adds the slices, and cuBLAS splits a
# reduction by its shape, so each float32 activation rounds otherwise
# (~1e-7 relative), over two layers and a mean of 4096 tokens. Each
# parameter within 2·Σ lr_t over the steps run: AdamW moves an element
# by about lr_t a step whatever its gradient's size (m / √v), so a
# gradient near 0 that rounds to the other sign moves it by up to 2·lr_t
# the other way. And the whole difference's L2 norm within 1e-3 of the
# L2 norm of the run's own update (final less initial parameters): a
# placement fault misplaces whole rows or columns, an error of the
# update's own size
MESH_LOSS_RTOL = 1e-5
MESH_UPDATE_RTOL = 1e-3
# a served token that differs from one device's must follow logits whose
# top two are closer than this (float32 logits, ~1e-5 apart)
MESH_MARGIN = 1e-3
# 6n: the flash kernel at a rank's train shape on MESH_MAIN
# (`mesh_flash_case`): a microbatch's one row of the rank's two, Llama's
# 24/8 heads of 128 over `model` 2
MESH_FLASH_CASE = dict(name="llama3p2_3b_train_rank_b1_h12_kv4_s1024_f32",
                       row="6n", dtype=torch.float32)
COLLECTIVE_NAMES = ("c10d", "all_gather", "all_reduce", "reduce_scatter",
                    "all_to_all", "wait_tensor", "barrier", "broadcast")


def mesh_flash_case(cfg) -> dict:
    """MESH_FLASH_CASE at `cfg`'s shape on a rank of MESH_MAIN."""
    (data, model), _ = MESH_MAIN
    return dict(MESH_FLASH_CASE, b=MESH_BATCH // data // MESH_MICROBATCHES,
                h=cfg.num_heads // model, hkv=cfg.num_kv_heads // model,
                sq=MESH_SEQ, sk=MESH_SEQ, d=cfg.head_dim)


def mesh_train_kw(dev) -> dict:
    return dict(steps_total=MESH_STEPS, batch=MESH_BATCH, seq=MESH_SEQ,
                microbatches=MESH_MICROBATCHES, compute_dtype=None,
                seed=MESH_SEED, ckpt_every=MESH_CKPT_AT, verbose=False,
                device=dev)


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def link_checkpoint(src: str, dst: str, step: int) -> None:
    """The checkpoint of `step` in `src` as one in `dst` (hard links: the
    files are written once)."""
    name = f"step_{step:010d}"
    os.makedirs(dst, exist_ok=True)
    shutil.copytree(os.path.join(src, name), os.path.join(dst, name),
                    copy_function=os.link)


def collective_seconds(prof, skip=()) -> float:
    """Seconds during which some collective call (a name in
    COLLECTIVE_NAMES: gloo's, DTensor's and the route's) was in progress
    on any thread of the profile `prof`, outside the windows `skip`
    ((start, end) seconds from the profile's start): the union of those
    calls' intervals, so that a call nested in another, or a caller's
    wait beside gloo's own thread, counts once."""
    spans = sorted((ev.time_range.start / 1e6, ev.time_range.end / 1e6)
                   for ev in prof.events()
                   if any(k in ev.name for k in COLLECTIVE_NAMES))
    total, end = 0.0, -math.inf
    for a, b in spans:
        if any(lo <= a and b <= hi for lo, hi in skip) or b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


def lm_mesh_rank(rank, world, plan):
    """One rank of `lm_mesh_path` (run by `launch.mesh.spawn_ranks`):
    `train(mesh=)` on MESH_MAIN into plan["ckpt"] (rank 0 under
    `torch.profiler` on the host, for the collectives' share); the step
    MESH_CKPT_AT checkpoint resumed on MESH_RESUME from plan["resume"];
    `serve(mesh=)` on MESH_RESUME. Asserts every local shard of the
    parameters and the AdamW state lies on the rank's card. Returns the
    histories, the served tokens, step and checkpoint seconds, peaks and
    kernel launches (by flash shape too)."""
    import contextlib
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import kernels
    from repro_torch.dist import placed
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch import serve as serve_mod
    from repro_torch.launch import train as train_mod
    from repro_torch.models import transformer
    from repro_torch.obs import registry
    from repro_torch.train import checkpoint
    del world
    dev = mesh_mod.rank_device(plan["device"])
    cfg = plan["cfg"]
    meshes = {"main": mesh_mod.make_mesh(*MESH_MAIN, device_type=dev.type),
              "resume": mesh_mod.make_mesh(*MESH_RESUME,
                                           device_type=dev.type)}
    kernels.reset_launch_counts()          # this rank's run starts here
    out = {"rank": rank, "device": str(dev), "runs": {}}
    for name, ckpt in (("main", plan["ckpt"]), ("resume", plan["resume"])):
        if name == "resume":
            if rank == 0:
                link_checkpoint(plan["ckpt"], ckpt, MESH_CKPT_AT)
            dist.barrier()
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        prof = (profile(activities=[ProfilerActivity.CPU])
                if rank == 0 and name == "main" else contextlib.nullcontext())
        with registry.recording() as rec, prof:
            t0 = time.perf_counter()
            res = train_mod.train(cfg, mesh=meshes[name], ckpt_dir=ckpt,
                                  **mesh_train_kw(dev))
            sync(dev)
            wall = time.perf_counter() - t0
        saves = [(sp.t0 - t0, sp.t1 - t0) for sp in rec.spans
                 if sp.name == "ckpt.save"]
        locals_ = [t.to_local() for t in checkpoint.flatten(
            (res["params"], res["opt_state"])) if placed.is_placed(t)]
        off = sorted({str(t.device) for t in locals_} - {str(dev)})
        if off or not locals_:
            raise AssertionError(f"rank {rank}: {len(locals_)} placed "
                                 f"leaves, shards off {dev}: {off}")
        run = {"history": res["history"],
               "resumed_from": res["resumed_from"],
               "placed_leaves": len(locals_), "wall_s": wall,
               "steps": {k: getattr(rec.histograms["train.step_s"], k)
                         for k in ("count", "sum", "min", "max")},
               "ckpt_spans_s": [(sp.name, sp.t1 - sp.t0)
                                for sp in rec.spans],
               "checkpoints": checkpoint.all_steps(ckpt),
               "peak_bytes": (torch.cuda.max_memory_allocated(dev)
                              if dev.type == "cuda" else None)}
        if not isinstance(prof, contextlib.nullcontext):
            # the steps' collectives: the saves' gathers left out
            run["collective_s"] = collective_seconds(prof, skip=saves)
        out["runs"][name] = run
        del res, locals_, prof
        gc.collect()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    params = transformer.init_params(
        cfg, torch.Generator(device=dev).manual_seed(MESH_SERVE_SEED),
        dtype=torch.float32, device=dev)
    prompts = torch.from_numpy(plan["prompts"]).to(dev)
    sync(dev)
    t0 = time.perf_counter()
    tokens = serve_mod.serve(cfg, params, prompts, mesh=meshes["resume"],
                             max_len=MESH_SERVE_PROMPT + MESH_SERVE_GEN,
                             gen=MESH_SERVE_GEN)
    sync(dev)
    out["serve"] = {"tokens": tokens.cpu().numpy(),
                    "seconds": time.perf_counter() - t0,
                    "peak_bytes": (torch.cuda.max_memory_allocated(dev)
                                   if dev.type == "cuda" else None)}
    out["launches"] = kernels.launch_counts()     # ... and ends here
    out["flash_shapes"] = [(*k, n) for k, n in
                           kernels.flash_attention.shapes.items()]
    return out


def greedy_with_margins(cfg, params, prompts, steps, *, max_len, gen):
    """`serve()`'s greedy loop on one device (a prefill, then a decode
    step a token), with the top-2 margin of the logits behind each token:
    (tokens (B, gen) numpy, margins[rid][t])."""
    prefill = steps.make_prefill_step(cfg, max_len=max_len)
    decode = steps.make_decode_step(cfg)
    toks, margins = [], []
    with torch.inference_mode():
        logits, state = prefill(params, {"tokens": prompts})
        for _ in range(gen):
            last = logits[:, -1].float()
            top = torch.topk(last, 2, dim=-1).values
            margins.append(top[:, 0] - top[:, 1])
            toks.append(torch.argmax(last, dim=-1)[:, None].to(torch.int32))
            logits, state = decode(params, toks[-1], state)
    return (torch.cat(toks, 1).cpu().numpy(),
            torch.stack(margins, 1).cpu().tolist())


def param_gap(got, want, init, dev) -> dict:
    """Parameter leaves `got` (tensors or numpy arrays) against the
    one-device run's `want`, whose initial leaves are `init` (both on the
    host): the max |difference|, the elements past 1e-6, and the
    difference's L2 norm over that of the run's update (want - init)."""
    worst, past, d2, u2 = 0.0, 0, 0.0, 0.0
    for g, w, i in zip(got, want, init, strict=True):
        w = w.to(dev)
        d = (torch.as_tensor(g).to(dev) - w).double()
        worst = max(worst, float(d.abs().max()))
        past += int((d.abs() > 1e-6).sum())
        d2 += float(d.pow(2).sum())
        u2 += float((w - i.to(dev)).double().pow(2).sum())
        del d, w
    return {"max_abs_diff": worst, "elements_past_1e-6": past,
            "update_rel_l2": math.sqrt(d2 / u2) if u2 else math.inf}


def lm_mesh_path(kernels, *, get_config, transformer, steps, train_mod,
                 serve_mod, mesh_mod, optimizer, checkpoint, ref,
                 flash_attention, plan, device="cuda"):
    """The LM entry points on a mesh. First (not counted) the flash kernel
    at a rank's train shape (6n) against its plain version, timed beside
    it and one SDPA call. Then, counted: the one-device references in
    this process (`train()` of the same seed and `serve()` with its
    top-2 margins), freed before the ranks start; four gloo ranks sharing
    the card (`lm_mesh_rank`): `train(mesh=)` on MESH_MAIN with its step
    MESH_CKPT_AT checkpoint resumed on MESH_RESUME, and `serve(mesh=)`;
    last, that checkpoint resumed in this process. Every rank's losses
    must be equal; each run's losses within MESH_LOSS_RTOL of one
    device's and its final parameters within 2·Σ lr_t and MESH_UPDATE_RTOL
    (the checkpoints' stored parameters for the ranks' runs); the served
    tokens equal one device's but where the top-2 margin is under
    MESH_MARGIN. Returns (launches, the 6n row with the ranks' launches
    at its shape)."""
    from repro_torch.obs import registry as obs_registry
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(MESH_SEED)
    cfg = dataclasses.replace(get_config(LM_ARCH), num_layers=MESH_LAYERS)
    case = mesh_flash_case(cfg)
    flash_row = flash_case_row(gen, ref, flash_attention, plan, case, device)
    gc.collect()
    torch.cuda.empty_cache()

    kernels.reset_launch_counts()          # the path's run starts here
    t_path = time.perf_counter()
    kw = mesh_train_kw(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    one = train_mod.train(cfg, **kw)
    sync(dev)
    one_s = time.perf_counter() - t0
    one_peak = (torch.cuda.max_memory_allocated() if dev.type == "cuda"
                else None)
    want = [t.cpu() for t in checkpoint.flatten(one["params"])]
    history = one["history"]
    check_finite("mesh reference", history)
    del one
    init = [t.cpu() for t in checkpoint.flatten(transformer.init_params(
        cfg, torch.Generator(device=dev).manual_seed(MESH_SEED),
        dtype=torch.float32, device=dev))]
    rng = np.random.default_rng(MESH_SERVE_SEED)
    prompts = rng.integers(0, cfg.vocab_size, (MESH_SERVE_BATCH,
                                               MESH_SERVE_PROMPT)).astype(
                                                   np.int32)
    serve_params = transformer.init_params(
        cfg, torch.Generator(device=dev).manual_seed(MESH_SERVE_SEED),
        dtype=torch.float32, device=dev)
    max_len = MESH_SERVE_PROMPT + MESH_SERVE_GEN
    served = serve_mod.serve(cfg, serve_params, prompts, max_len=max_len,
                             gen=MESH_SERVE_GEN).cpu().numpy()
    looped, margins = greedy_with_margins(
        cfg, serve_params, torch.from_numpy(prompts).to(dev), steps,
        max_len=max_len, gen=MESH_SERVE_GEN)
    if not np.array_equal(served, looped):
        raise AssertionError("serve() and its greedy loop disagree")
    del serve_params
    gc.collect()
    torch.cuda.empty_cache()
    parent = kernels.launch_counts()

    (ROOT / "build").mkdir(exist_ok=True)
    free_gib = shutil.disk_usage(ROOT / "build").free / 2 ** 30
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        dirs = {k: str(Path(tmp) / k) for k in ("main", "resume", "one")}
        t0 = time.perf_counter()
        ranks = mesh_mod.spawn_ranks(
            lm_mesh_rank, math.prod(MESH_MAIN[0]),
            {"device": device, "cfg": cfg, "ckpt": dirs["main"],
             "resume": dirs["resume"], "prompts": prompts},
            backend="gloo", timeout_s=MESH_TIMEOUT_S)
        ranks_s = time.perf_counter() - t0
        n = len(want)
        t0 = time.perf_counter()
        gaps = {}
        for name in ("main", "resume"):      # the parameters' leaves
            stored = checkpoint.stored_arrays(dirs[name], MESH_STEPS)
            gaps[name] = param_gap([stored[f"a{i}"] for i in range(n)],
                                   want, init, dev)
        read_s = time.perf_counter() - t0
        shutil.rmtree(dirs["resume"])
        link_checkpoint(dirs["main"], dirs["one"], MESH_CKPT_AT)
        shutil.rmtree(dirs["main"])
        t0 = time.perf_counter()
        with obs_registry.recording() as rec:
            here = train_mod.train(cfg, ckpt_dir=dirs["one"], **kw)
            sync(dev)
        here_s = time.perf_counter() - t0
        here_spans = [(sp.name, sp.t1 - sp.t0) for sp in rec.spans]
        gaps["one_process"] = param_gap(checkpoint.flatten(here["params"]),
                                        want, init, dev)
        runs = {"main": ranks[0]["runs"]["main"]["history"],
                "resume": ranks[0]["runs"]["resume"]["history"],
                "one_process": here["history"]}
        resumed = {"main": ranks[0]["runs"]["main"]["resumed_from"],
                   "resume": ranks[0]["runs"]["resume"]["resumed_from"],
                   "one_process": here["resumed_from"]}
        del here
    gc.collect()
    torch.cuda.empty_cache()
    seconds = time.perf_counter() - t_path
    parent_all = kernels.launch_counts()   # ... and ends here

    schedule = optimizer.warmup_cosine_schedule(3e-4, train_mod.WARMUP_STEPS,
                                                MESH_STEPS)
    param_tol = 2 * sum(float(schedule(torch.tensor(t)))
                        for t in range(MESH_STEPS))
    failures = []
    for r in ranks[1:]:
        for name in ("main", "resume"):
            if r["runs"][name]["history"] != ranks[0]["runs"][name][
                    "history"]:
                failures.append(f"rank {r['rank']} {name}: history differs "
                                f"from rank 0's")
        if not np.array_equal(r["serve"]["tokens"],
                              ranks[0]["serve"]["tokens"]):
            failures.append(f"rank {r['rank']}: served tokens differ")
    by_step = {h["step"]: h["loss"] for h in history}
    loss_gaps = {}
    for name, hist in runs.items():
        start = MESH_CKPT_AT if name != "main" else 0
        if resumed[name] != start or [h["step"] for h in hist] != list(
                range(start, MESH_STEPS)):
            failures.append(f"{name}: resumed from {resumed[name]}, steps "
                            f"{[h['step'] for h in hist]}")
        loss_gaps[name] = [abs(h["loss"] - by_step[h["step"]])
                           / abs(by_step[h["step"]]) for h in hist]
        if not all(g <= MESH_LOSS_RTOL for g in loss_gaps[name]):
            failures.append(f"{name}: losses {loss_gaps[name]} relative "
                            f"from one device's")
        gap = gaps[name]
        if not (gap["max_abs_diff"] <= param_tol
                and gap["update_rel_l2"] <= MESH_UPDATE_RTOL):
            failures.append(f"{name}: parameters {gap} (tolerances "
                            f"{param_tol}, {MESH_UPDATE_RTOL})")
    tokens = ranks[0]["serve"]["tokens"]
    differ = token_differences(tokens.tolist(), served.tolist(), margins)
    if any(d["top2_margin"] >= MESH_MARGIN for d in differ):
        failures.append(f"served tokens differ past the margin: {differ}")
    launches = {k: parent_all[k] + sum(r["launches"][k] for r in ranks)
                for k in KERNEL_INFO}
    key = list(flash_shape(case))
    flash_row["launches"] = sum(n for r in ranks
                                for *shape, n in r["flash_shapes"]
                                if shape == key)
    want_launches = (4 * MESH_STEPS * MESH_MICROBATCHES * 2
                     * cfg.num_layers)
    if flash_row["launches"] != want_launches:
        failures.append(f"the ranks' main runs launched flash "
                        f"{flash_row['launches']} times at {key}, not "
                        f"{want_launches}")
    if not launches["flash_attention"] or any(
            launches[k] for k in KERNEL_INFO if k != "flash_attention"):
        failures.append(f"launches {launches}")

    main0 = ranks[0]["runs"]["main"]
    steps_s = main0["steps"]
    # the steps' mean but the slowest (the first warms up)
    later_ms = ((steps_s["sum"] - steps_s["max"])
                / max(1, steps_s["count"] - 1) * 1e3)
    emit("lm_mesh_path", model=cfg.name, layers=cfg.num_layers,
         of_layers=get_config(LM_ARCH).num_layers, d_model=cfg.d_model,
         heads=(cfg.num_heads, cfg.num_kv_heads), d_ff=cfg.d_ff,
         vocab=cfg.vocab_size, params=sum(t.numel() for t in want),
         batch=MESH_BATCH, seq=MESH_SEQ, steps=MESH_STEPS,
         microbatches=MESH_MICROBATCHES, compute_dtype="float32",
         mesh=mesh_tag(*MESH_MAIN), resume_mesh=mesh_tag(*MESH_RESUME),
         serve_mesh=mesh_tag(*MESH_RESUME),
         backend="gloo", ranks_on=sorted({r["device"] for r in ranks}),
         one_device={"history": history, "seconds": one_s,
                     "peak_gib": one_peak / 2 ** 30 if one_peak else None,
                     "launches": parent},
         losses={k: [h["loss"] for h in v] for k, v in runs.items()},
         loss_rel_gaps=loss_gaps, loss_rtol=MESH_LOSS_RTOL,
         param_gaps=gaps, param_atol=param_tol,
         update_rtol=MESH_UPDATE_RTOL,
         ms_a_step_but_slowest=later_ms, step_s=steps_s,
         collective_s=main0.get("collective_s"),
         collective_share_of_steps=main0["collective_s"] / steps_s["sum"],
         train_wall_s=main0["wall_s"],
         ckpt_spans_s=main0["ckpt_spans_s"],
         resume_ckpt_spans_s=ranks[0]["runs"]["resume"]["ckpt_spans_s"],
         peak_gib_a_rank={r["rank"]: {
             k: (v["peak_bytes"] / 2 ** 30 if v["peak_bytes"] else None)
             for k, v in (*r["runs"].items(), ("serve", r["serve"]))}
             for r in ranks},
         serve={"batch": MESH_SERVE_BATCH, "prompt": MESH_SERVE_PROMPT,
                "gen": MESH_SERVE_GEN, "tokens_equal": not differ,
                "token_differences": differ, "margin": MESH_MARGIN,
                "seconds": ranks[0]["serve"]["seconds"]},
         ranks_s=ranks_s, read_s=read_s, one_process_resume_s=here_s,
         one_process_ckpt_spans_s=here_spans,
         disk_free_gib=free_gib, path_s=seconds, launches=launches,
         flash=flash_row, failures=failures)
    if failures:
        raise AssertionError(f"lm_mesh_path: {failures}")
    return launches, flash_row


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "drives the port on an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import kernels
    from repro_torch.core import (encoding, export, head, model, multi_shot,
                                  one_shot, pruning)
    from repro_torch.examples import (distill_uleen_head, quickstart,
                                      uleen_edge_pipeline)
    from repro_torch.core.encoding import fit_gaussian_thermometer
    from repro_torch.configs import get_config
    from repro_torch.data import synth
    from repro_torch.kernels import build, ops, ref, wnn_ensemble
    from repro_torch.kernels.flash_attention import plan as flash_plan
    from repro_torch.launch import loadgen
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch import scheduler, steps
    from repro_torch.launch import serve as serve_mod
    from repro_torch.launch import train as train_mod
    from repro_torch.launch import uleen_cell
    from repro_torch.launch.scheduler import WnnBatcher, WnnTenantBatcher
    from repro_torch.launch.serve import serve as lm_serve
    from repro_torch.models import layers, moe, rglru, ssm, transformer
    from repro_torch.packed import layout as packed_layout
    from repro_torch.packed import runtime
    from repro_torch.train import checkpoint, compression, optimizer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi_line()
    emit("device", name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda)

    t0 = time.perf_counter()
    build.build_all()
    ptxas = [ln.strip() for src in build.SOURCES
             if src not in ("wnn.cu", "thermometer.cu")
             for ln in build.build_log(src).splitlines()
             if "registers" in ln or "spill" in ln
             or "Performance Loss" in ln or "setmaxnreg" in ln]
    emit("build", seconds=time.perf_counter() - t0, ptxas=ptxas,
         wnn_ptxas=build.ptxas_report(build.build_log("wnn.cu"),
                                      wnn_ensemble.instantiation_name),
         thermometer_ptxas=build.ptxas_report(build.build_log("thermometer.cu"),
                                        front_end_kernel_name),
         wnn_shared_bytes_uln_l=wnn_ensemble.shared_bytes(
             ULN_L_BITS, ULN_L["num_classes"]))
    # host work only: it runs beside the card's phases until
    # `lm_dryrun_path` reads it
    lm_dryrun_sweep = start_lm_dryrun_sweep()

    gen = torch.Generator(device="cuda").manual_seed(0)
    wnn = check_wnn_ensemble(gen, export, ref, kernels, wnn_ensemble)
    check_wnn_kernels(gen, packed_layout, ref, kernels.packed_wnn,
                      kernels.fused_wnn)
    front = check_front_end_kernels(gen, ref, kernels.thermometer_encode,
                                    kernels.thermometer_decompress)
    h3 = check_h3_kernel(gen, ref, kernels.h3_hash)
    flash, flash_path_rows = check_flash_kernel(
        gen, ref, kernels.flash_attention, flash_plan)
    flash_scaling(gen, ref, kernels.flash_attention, flash_plan)
    torch.cuda.empty_cache()

    golden = export.load(str(ROOT / "tests/golden/uln_s_artifact.npz"))
    with np.load(ROOT / "tests/golden/uln_s_golden.npz") as z:
        gbits, gscores = z["bits"], z["scores"]
    for backend in ("gather", "fused", "packed", "auto"):
        got = export.artifact_scores(golden, gbits, backend=backend)
        if not np.array_equal(got.cpu().numpy(), gscores):
            raise AssertionError(f"golden scores differ for {backend}")
    emit("golden", artifact="uln_s", rows=int(gbits.shape[0]),
         backends=["gather", "fused", "packed", "auto"], exact=True)

    launches = main_path(export, ops, fit_gaussian_thermometer, WnnBatcher,
                         kernels)
    torch.cuda.empty_cache()
    train_launches = train_path(
        (encoding, model, one_shot, multi_shot, pruning, export, ops,
         optimizer, synth), kernels)
    torch.cuda.empty_cache()
    lm_launches, lm_params, lm_cfg, contiguous = lm_serve_path(
        kernels, get_config=get_config, transformer=transformer, steps=steps,
        scheduler=scheduler, serve_fn=lm_serve)
    torch.cuda.empty_cache()
    paged_launches = paged_path(kernels, lm_params, lm_cfg, contiguous,
                                scheduler=scheduler)
    del contiguous
    torch.cuda.empty_cache()
    head_launches = head_path(kernels, lm_params, lm_cfg,
                              distill=distill_uleen_head, head=head,
                              wnn_ensemble=wnn_ensemble)
    del lm_params
    torch.cuda.empty_cache()
    tenant_launches = tenant_path(kernels, export, runtime, WnnTenantBatcher)
    torch.cuda.empty_cache()
    sharded_launches = sharded_path(kernels, export, runtime, WnnBatcher,
                                    mesh_mod)
    torch.cuda.empty_cache()
    example_launches = examples_path(kernels, {
        "quickstart": quickstart, "uleen_edge_pipeline": uleen_edge_pipeline,
        "distill_uleen_head": distill_uleen_head})
    gc.collect()
    torch.cuda.empty_cache()
    moe_kw = dict(get_config=get_config, transformer=transformer,
                  steps=steps, scheduler=scheduler, serve_fn=lm_serve,
                  ref=ref, flash_attention=kernels.flash_attention,
                  plan=flash_plan)
    moe_launches, moe_flash = moe_path(kernels, moe=moe, layers=layers,
                                       **moe_kw)
    torch.cuda.empty_cache()
    mla_launches, mla_flash = mla_path(kernels, **moe_kw)
    torch.cuda.empty_cache()
    ssm_launches, _ = recurrent_path(kernels, family="ssm", module=ssm,
                                     **moe_kw)
    torch.cuda.empty_cache()
    hybrid_launches, hybrid_flash = recurrent_path(
        kernels, family="hybrid", module=rglru, **moe_kw)
    torch.cuda.empty_cache()
    prefix_kw = {k: moe_kw[k] for k in ("get_config", "transformer", "steps",
                                        "scheduler", "serve_fn")}
    encdec_launches, at_row = prefix_path(kernels, family="encdec",
                                          **prefix_kw)
    torch.cuda.empty_cache()
    vlm_launches, vlm_at_row = prefix_path(kernels, family="vlm",
                                           **prefix_kw)
    torch.cuda.empty_cache()
    qwen_launches, qwen_at_row = prefix_path(kernels, family="qwen",
                                             **prefix_kw)
    for _, row in flash_path_rows:
        row["launches"] = {**at_row, **vlm_at_row,
                           **qwen_at_row}[row["row"]]
    torch.cuda.empty_cache()
    profile_launches = serve_profile_path(kernels, serve_mod)
    gc.collect()
    torch.cuda.empty_cache()
    loadgen_launches = loadgen_path(kernels, loadgen)
    gc.collect()
    torch.cuda.empty_cache()
    train_lm_launches, train_flash = lm_train_path(
        kernels, get_config=get_config, transformer=transformer, steps=steps,
        train_mod=train_mod, optimizer=optimizer, ops=ops, ref=ref,
        flash_attention=kernels.flash_attention, plan=flash_plan)
    gc.collect()
    torch.cuda.empty_cache()
    dist_launches = uleen_dist_train_path(
        kernels, train_mod=train_mod, uleen_cell=uleen_cell,
        compression=compression, mesh_mod=mesh_mod, get_config=get_config)
    torch.cuda.empty_cache()
    h3_mod = importlib.import_module("repro_torch.kernels.h3_hash")
    op_rows, dryrun_launches = dryrun_path(
        kernels, export=export, wnn_ensemble=wnn_ensemble, h3_mod=h3_mod)
    torch.cuda.empty_cache()
    lm_dryrun_launches, lm_dryrun_flash = lm_dryrun_path(kernels,
                                                         lm_dryrun_sweep)
    torch.cuda.empty_cache()
    lm_mesh_launches, lm_mesh_flash = lm_mesh_path(
        kernels, get_config=get_config, transformer=transformer, steps=steps,
        train_mod=train_mod, serve_mod=serve_mod, mesh_mod=mesh_mod,
        optimizer=optimizer, checkpoint=checkpoint, ref=ref,
        flash_attention=kernels.flash_attention, plan=flash_plan)
    torch.cuda.empty_cache()
    by_path = {"uleen_serve": launches, "uleen_train": train_launches,
               "lm_serve": lm_launches, "head": head_launches,
               "tenant": tenant_launches, "examples": example_launches,
               "sharded": sharded_launches, "paged": paged_launches,
               "moe": moe_launches, "mla": mla_launches,
               "ssm": ssm_launches, "hybrid": hybrid_launches,
               "encdec": encdec_launches, "vlm": vlm_launches,
               "qwen": qwen_launches, "serve_profile": profile_launches,
               "loadgen": loadgen_launches, "lm_train": train_lm_launches,
               "uleen_dist_train": dist_launches, "dryrun": dryrun_launches,
               "lm_dryrun": lm_dryrun_launches, "lm_mesh": lm_mesh_launches}
    # the flash kernel's rows at the MoE, hybrid, encoder-decoder, patch
    # and Qwen paths' shapes, each with the launches its path's run made at
    # exactly that shape and all of its path's flash launches
    flash_shapes = [
        {"path": path, "case": row["case"], "row": row["row"],
         "b": row["b"], "h": row["h"], "hkv": row["hkv"],
         "d": row["d"], "dv": row["dv"], "sq": row["sq"], "sk": row["sk"],
         "causal": row["causal"], "window": row["window"],
         "q_offset": row.get("q_offset", 0), "launches": row["launches"],
         "path_launches": by_path[path]["flash_attention"],
         **({"rank_run_launches": row["rank_run_launches"]}
            if "rank_run_launches" in row else {}),
         **{k: row[k] for k in MAIN_FLASH_KEYS if k in row}}
        for path, row in (("moe", moe_flash), ("mla", mla_flash),
                          ("hybrid", hybrid_flash), *flash_path_rows,
                          *(("lm_train", row) for row in train_flash),
                          *(("lm_dryrun", row) for row in lm_dryrun_flash),
                          ("lm_mesh", lm_mesh_flash))]
    # each kernel's launches on the path that carries it: the ULEEN serve
    # path for the WNN and front-end kernels, the train path for the hash,
    # the LM serve path for flash attention; `launches_by_path` has every
    # path's count
    launches = {**launches, "h3_hash": train_launches["h3_hash"],
                "flash_attention": lm_launches["flash_attention"]}

    rows = []
    for name, timing in {**wnn, **front, **h3, **flash}.items():
        source, replaces = KERNEL_INFO[name]
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": launches[name],
                     "max_abs_err": timing["max_abs_err"], "ms": timing["ms"],
                     "plain_ms": timing["plain_ms"],
                     "bound_ms": timing["bound_ms"],
                     "bound_by": timing["bound_by"],
                     "bytes": timing["bytes"], "ops": timing["ops"],
                     "library_ms": timing["library_ms"],
                     "launches_by_path": {p: v[name]
                                          for p, v in by_path.items()},
                     **({"shapes": flash_shapes}
                        if name == "flash_attention" else {}),
                     **({"op_vs_direct": op_rows[name]}
                        if name in op_rows else {}),
                     **{k: timing[k] for k in ("tolerance",
                                               "bound_cuda_core_ms",
                                               "bound_per_class_ms",
                                               "device_ms",
                                               "library_device_ms",
                                               "tb_per_s", "bound_share")
                        if k in timing}})
    print(json.dumps({"kernels": rows}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
