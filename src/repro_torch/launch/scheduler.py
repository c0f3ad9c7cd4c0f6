"""Serve engines (port of `repro/launch/scheduler.py`): the
continuous-batching LM `Engine` and the WNN micro-batcher `WnnBatcher`.

`Engine` keeps every KV-cache slot busy every decode step: requests enter
a FIFO queue (`submit`), each cache row is a *slot* with lifecycle
FREE -> PREFILL -> DECODE -> DRAIN -> FREE, and whenever a slot frees the
queue head is prefilled into that row (`steps.make_slot_prefill_step`) and
joins the running masked decode batch mid-flight. With `paged=True` the
KV caches are shared block pools: a request reserves ceil(need /
block_size) blocks at admission instead of a worst-case row, frees them
when it drains, and waits in the queue while the pool is short
(backpressure, never a drop); up to `prefill_batch` same-bucket requests
are prefilled in one launch. The LM engine takes no `mesh=`: it serves on
one card.

`WnnBatcher` queues WNN classification requests on the host; each
`step()` serves up to `slots` of them through ONE fixed-shape scores
launch over the artifact's prepared tables on the device; with `mesh=`
the tables are partitioned by class over the ranks of a
`torch.distributed` mesh. `WnnTenantBatcher` grows it a tenant axis: a
fleet of same-geometry artifacts, at most `capacity` of them resident in
one stacked device cache under LRU admission; with `mesh=` its batch rows
split over the mesh's batch axes.

Eager PyTorch compiles nothing, so where the JAX engines count retraces,
`trace_counts` here counts the distinct input shapes each step function
receives (`obs.torchhooks.counted`): a warm engine keeps one decode
shape, and one prefill shape per prompt-length bucket.
"""
from __future__ import annotations

import collections
import dataclasses
import enum
import time
from typing import Any, Callable, Iterable, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.dist import sharding as sh
from repro_torch.launch import steps
from repro_torch.models import kvcache, transformer
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import registry as obs_registry
from repro_torch.obs import torchhooks

class SlotState(enum.Enum):
    FREE = "free"          # no request; row contents are dead
    PREFILL = "prefill"    # request admitted this step, cache being built
    DECODE = "decode"      # live: emits one token per engine step
    DRAIN = "drain"        # finished; result final, row reclaimed at the
    #                        next admission scan


@dataclasses.dataclass
class Request:
    """One generation request. `tokens` is the unpadded prompt (plen,)."""
    tokens: np.ndarray
    max_new: int
    rid: int = -1                      # assigned by Engine.submit
    arrival: float = 0.0               # stream offset (s) for run(realtime=)
    frames: Optional[np.ndarray] = None    # (F, D) Whisper encoder frames
    patches: Optional[np.ndarray] = None   # (P, D) patch embeddings

    @property
    def prompt_len(self) -> int:
        return int(np.asarray(self.tokens).shape[0])


@dataclasses.dataclass
class RequestResult:
    rid: int
    prompt_len: int
    tokens: List[int]                  # generated ids, len == max_new
    t_submit: float
    t_admit: float = 0.0
    t_first: float = 0.0               # first token (end of prefill)
    # None = still in flight: with an injected clock a request can finish
    # at time 0.0, and stats() filters on `is not None`
    t_done: Optional[float] = None

    @property
    def latency(self) -> float:
        return self.t_done - self.t_submit

    @property
    def queue_wait(self) -> float:
        return self.t_admit - self.t_submit


@dataclasses.dataclass
class _Slot:
    state: SlotState = SlotState.FREE
    request: Optional[Request] = None
    result: Optional[RequestResult] = None
    generator: Any = None              # per-request generator (sampling)


def _bucket_pow2(n: int, lo: int = 8) -> int:
    b = lo
    while b < n:
        b *= 2
    return b


def _request_seed(seed: int, rid: int) -> int:
    """The seed of request `rid`'s sampling generator: a function of the
    engine seed and the rid only, so a request's sampled tokens do not
    depend on the slot or step it lands in."""
    return int(np.random.SeedSequence([seed, rid]).generate_state(1)[0])


class Engine:
    """Step-driven continuous-batching engine over one ServeState.

    slots: batch width of the decode step == concurrent requests.
    max_len: cache width; every request needs prompt_len + max_new <=
        max_len, plus `cfg.patch_tokens` for a patch model (its patch
        rows take cache rows ahead of the prompt).
    bucket: None -> each prompt is prefilled at its exact length; "pow2"
        -> prompts are right-padded to the next power-of-two bucket (at
        least 8) and the length-aware prefill reads the last real
        position. Padded prefill is only sound for full-width attention
        caches, so "pow2" refuses a model with any other state (a sliding
        or local window, an SSM or RG-LRU layer, patch tokens): those
        prefill at exact prompt length.
    greedy/seed/temperature: token selection, mirroring `serve()`. Greedy
        takes `torch.argmax` (the first maximum, as `jnp.argmax`). Sampled
        decode draws from one `torch.Generator` per request, seeded from
        (seed, rid): a request's tokens do not depend on its slot, though
        they are not JAX's.
    paged: block-granular KV: full-width attention caches become shared
        block pools (`kvcache.PagedAttnCache`); a request reserves
        ceil((prompt_len + max_new) / block_size) blocks at admission and
        frees them when it drains. When the pool is short the queue head
        waits (backpressure, never a drop). Windowed caches stay
        contiguous.
    block_size/num_blocks: [paged] block granularity (max_len must be a
        multiple) and pool size; num_blocks defaults to the contiguous
        worst case plus the null block, and must hold at least one
        worst-case request.
    prefill_batch: [paged] up to this many same-bucket queue heads are
        prefilled in ONE launch (FIFO: another bucket ends the group);
        partial groups pad with dummy rows.
    device: where params live and the engine runs; "cuda" by default, and
        with no CUDA device it raises unless asked for the CPU.

        eng = Engine(cfg, params, slots=4, max_len=64, device="cuda")
        eng.submit(prompt_tokens, max_new=16)
        results = eng.drain()          # -> [RequestResult]
    """

    def __init__(self, cfg: ArchConfig, params, *, slots: int = 4,
                 max_len: int = 128, greedy: bool = True, seed: int = 0,
                 temperature: float = 1.0, bucket: Optional[str] = None,
                 clock: Callable = None, paged: bool = False,
                 block_size: int = 16, num_blocks: Optional[int] = None,
                 prefill_batch: int = 1, device=DEFAULT_DEVICE):
        self.device = resolve_device(device)
        if bucket not in (None, "pow2"):
            raise ValueError(f"unknown bucket policy {bucket!r}")
        if prefill_batch < 1:
            raise ValueError(f"need prefill_batch >= 1, got {prefill_batch}")
        if prefill_batch > 1 and not paged:
            raise ValueError(
                "prefill_batch > 1 (batched multi-slot admission) requires "
                "paged=True: the contiguous engine admits one slot per "
                "launch")
        transformer.check_supported(cfg)
        if bucket == "pow2" and not self._bucket_eligible(cfg):
            raise ValueError(
                "bucketed (padded) prefill needs full-width attention "
                "caches: a sliding-window ring buffer or an SSM or "
                f"recurrent state folds padding in sequentially ({cfg.name})")
        if params.embed.device != self.device:
            raise ValueError(f"params lie on {params.embed.device}, the "
                             f"engine runs on {self.device}")
        self.cfg = cfg
        self.params = params
        self.num_slots = slots
        self.max_len = max_len
        self.greedy = greedy
        self.seed = seed
        self.temperature = temperature
        self.bucket = bucket
        self.clock = clock or time.perf_counter

        self.paged = bool(paged)
        self.prefill_batch = min(int(prefill_batch), slots)
        if self.paged:
            if block_size < 1:
                raise ValueError(f"need block_size >= 1, got {block_size}")
            if max_len % block_size:
                raise ValueError(
                    f"max_len {max_len} must be a multiple of block_size "
                    f"{block_size} so a slot's logical view tiles exactly")
            self.block_size: Optional[int] = int(block_size)
            self.blocks_per_slot = max_len // block_size
            if num_blocks is None:
                num_blocks = slots * self.blocks_per_slot + 1
            if num_blocks < self.blocks_per_slot + 1:
                raise ValueError(
                    f"num_blocks {num_blocks} cannot hold one worst-case "
                    f"request ({self.blocks_per_slot} blocks + the null "
                    "block): an empty engine would deadlock")
            self.num_blocks: Optional[int] = int(num_blocks)
            self.allocator = kvcache.BlockAllocator(self.num_blocks)
            self.block_tables = np.zeros((slots, self.blocks_per_slot),
                                         np.int32)
            self._slot_blocks: list = [[] for _ in range(slots)]
        else:
            self.block_size = self.num_blocks = None
            self.allocator = None

        # distinct input shapes of each step function (one decode shape;
        # one prefill shape per bucket), mirrored into the global recorder
        self.trace_counts: collections.Counter = collections.Counter()
        self.lat_hist = obs_metrics.Histogram()
        self.queue_hist = obs_metrics.Histogram()
        if self.paged:
            prefill = steps.make_paged_prefill_step(
                cfg, max_len=max_len, admit=self.prefill_batch)
            decode = steps.make_paged_decode_step(cfg)
        else:
            prefill = steps.make_slot_prefill_step(cfg, max_len=max_len)
            decode = steps.make_masked_decode_step(cfg)
        self._prefill = torchhooks.counted(
            prefill, self.trace_counts,
            lambda params, batch, *a: f"prefill_{batch['tokens'].shape[1]}",
            agg_key="prefill")
        self._decode = torchhooks.counted(decode, self.trace_counts, "decode")

        if self.paged:
            self.state = steps.paged_serve_state_zeros(
                cfg, params, slots, max_len, block_size=self.block_size,
                num_blocks=self.num_blocks)
        else:
            self.state = steps.serve_state_zeros(cfg, params, slots,
                                                 max_len)
        self.slots = [_Slot() for _ in range(slots)]
        self.queue: collections.deque = collections.deque()
        self._next_tok = np.zeros((slots,), np.int32)
        self.results: dict = {}
        self._next_rid = 0
        self.step_count = 0
        self.peak_active = 0
        self.prefill_launches = 0

    # -- scheduling ---------------------------------------------------------

    @staticmethod
    def _bucket_eligible(cfg: ArchConfig) -> bool:
        """Padded prefill is exact only when every layer keeps a full-width
        attention or MLA cache (the JAX `Engine._bucket_eligible`)."""
        mixers = {ls.mixer for seg in transformer.arch_segments(cfg)
                  for ls in seg.layers}
        return (mixers <= {"attn", "mla"} and not cfg.sliding_window
                and not cfg.block_pattern and not cfg.patch_tokens)

    def submit(self, tokens, max_new: int, *, frames=None, patches=None,
               arrival: float = 0.0) -> int:
        """Queue one request; returns its rid. Never drops: a full engine
        only deepens the queue. frames (F, D) and patches (P, D): the
        request's encoder input (Whisper) or patch rows (InternVL2), which
        a model that reads them needs at exactly that shape; a request
        without them is refused here, before it holds a slot."""
        tokens = np.asarray(tokens, np.int32).reshape(-1)
        req = Request(tokens=tokens, max_new=int(max_new), arrival=arrival,
                      frames=None if frames is None else np.asarray(frames),
                      patches=None if patches is None else
                      np.asarray(patches))
        if req.prompt_len < 1 or req.max_new < 1:
            raise ValueError("need prompt_len >= 1 and max_new >= 1")
        self._check_inputs(req)
        # patch rows come ahead of the prompt and take cache rows. The
        # decode budget is the REAL prompt length (a bucket's padded tail
        # sits above the kv_len mask and is overwritten by decode
        # writes); the padded prefill itself must still fit the cache
        patch = self.cfg.patch_tokens
        need = patch + req.prompt_len + req.max_new
        if need > self.max_len:
            raise ValueError(
                f"request needs {need} cache rows (patches + prompt + "
                f"max_new), engine max_len is {self.max_len}")
        padded = patch + self._padded_len(req.prompt_len)
        if padded > self.max_len:
            raise ValueError(
                f"prompt pads to the {self._padded_len(req.prompt_len)} "
                f"bucket ({padded} cache rows with patches), which exceeds "
                f"engine max_len {self.max_len} even though the request "
                f"itself fits ({need} rows) — raise max_len or drop "
                "bucketing")
        req.rid = self._next_rid
        self._next_rid += 1
        self.results[req.rid] = RequestResult(
            rid=req.rid, prompt_len=req.prompt_len, tokens=[],
            t_submit=self.clock())
        self.queue.append(req)
        return req.rid

    def _check_inputs(self, req: Request):
        cfg = self.cfg
        for name, rows, read in (
                ("frames", cfg.encoder_frames, cfg.encoder_layers),
                ("patches", cfg.patch_tokens, cfg.patch_tokens)):
            if not read:
                continue
            arr, want = getattr(req, name), (rows, cfg.d_model)
            if arr is None:
                raise ValueError(f"{cfg.name}: a request needs {name} "
                                 f"{want}; none given")
            if arr.shape != want:
                raise ValueError(f"{cfg.name}: a request's {name} must be "
                                 f"{want}, got {arr.shape}")

    def _padded_len(self, plen: int) -> int:
        return _bucket_pow2(plen) if self.bucket == "pow2" else plen

    def _select(self, logits_last: torch.Tensor, slot: _Slot) -> int:
        """Next token from (V,) logits: greedy argmax (as `serve()`) or a
        sample from the request's own generator."""
        if self.greedy:
            return int(torch.argmax(logits_last))
        probs = torch.softmax(logits_last.float() / self.temperature, -1)
        return int(torch.multinomial(probs, 1, generator=slot.generator))

    def _admit(self):
        """Reclaim DRAIN slots (freeing their blocks when paged), then
        prefill queue heads into FREE rows; the prefill's logits give each
        request's first token."""
        for i, sl in enumerate(self.slots):
            if sl.state is SlotState.DRAIN:
                sl.state = SlotState.FREE
                sl.request = sl.result = sl.generator = None
                if self.paged and self._slot_blocks[i]:
                    self.allocator.free(self._slot_blocks[i])
                    self._slot_blocks[i] = []
                    # all-null row: the slot's masked decode writes sink
                    # into block 0 until the next admission re-tables it
                    self.block_tables[i, :] = 0
        if self.paged:
            self._admit_paged()
        else:
            self._admit_contiguous()

    def _start(self, i: int, req: Request) -> _Slot:
        """Slot i takes `req`: PREFILL, its generator, its queue wait."""
        sl = self.slots[i]
        res = self.results[req.rid]
        sl.state = SlotState.PREFILL
        sl.request = req
        sl.result = res
        if not self.greedy:
            sl.generator = torch.Generator(device=self.device)
            sl.generator.manual_seed(_request_seed(self.seed, req.rid))
        res.t_admit = self.clock()
        self.queue_hist.observe(res.queue_wait)
        obs_registry.get_recorder().histogram(
            "serve.engine.queue_wait_s").observe(res.queue_wait)
        return sl

    def _first_token(self, i: int, sl: _Slot, logits_last: torch.Tensor):
        tok = self._select(logits_last, sl)
        sl.result.tokens.append(tok)
        sl.result.t_first = self.clock()
        self._next_tok[i] = tok
        self._finish_if_done(sl)
        if sl.state is SlotState.PREFILL:
            sl.state = SlotState.DECODE

    def _admit_contiguous(self):
        """One batch-1 prefill into its slot per admitted request."""
        rec = obs_registry.get_recorder()
        for i, sl in enumerate(self.slots):
            if not self.queue or sl.state is not SlotState.FREE:
                continue
            req = self.queue.popleft()
            self._start(i, req)
            plen = self._padded_len(req.prompt_len)
            toks = np.zeros((1, plen), np.int32)
            toks[0, :req.prompt_len] = req.tokens
            batch = {"tokens": torch.from_numpy(toks).to(self.device)}
            for name in ("frames", "patches"):
                if getattr(req, name) is not None:
                    batch[name] = torch.from_numpy(
                        getattr(req, name)[None]).to(self.device)
            with rec.span("engine.prefill", rid=req.rid, slot=i, plen=plen):
                logits, self.state = self._prefill(
                    self.params, batch, req.prompt_len, i, self.state)
                self.prefill_launches += 1
                self._first_token(i, sl, logits[0, -1])

    def _blocks_needed(self, req: Request) -> int:
        need = self.cfg.patch_tokens + req.prompt_len + req.max_new
        return -(-need // self.block_size)

    def _admit_paged(self):
        """Group up to `prefill_batch` same-bucket queue heads (FIFO: a
        head of another bucket ends the group), allocate each request's
        blocks, and prefill the group in one launch. A head whose blocks
        the pool cannot give waits until a drain frees some; construction
        made sure an empty engine holds one worst-case request, so
        `drain()` ends."""
        rec = obs_registry.get_recorder()
        while self.queue:
            free_slots = [i for i, sl in enumerate(self.slots)
                          if sl.state is SlotState.FREE]
            if not free_slots:
                break
            bucket = self._padded_len(self.queue[0].prompt_len)
            group = []                       # (req, slot, blocks)
            while (self.queue and free_slots
                   and len(group) < self.prefill_batch):
                req = self.queue[0]
                if self._padded_len(req.prompt_len) != bucket:
                    break
                blocks = self.allocator.alloc(self._blocks_needed(req))
                if blocks is None:
                    break                    # backpressure: the head waits
                self.queue.popleft()
                group.append((req, free_slots.pop(0), blocks))
            if not group:
                break
            self._launch_paged_prefill(group, bucket)
            rec.gauge("serve.engine.blocks_in_use").set(self.allocator.used)

    def _launch_paged_prefill(self, group, bucket: int):
        """One batched prefill launch over `prefill_batch` rows. Dummy pad
        rows come FIRST and alias the first real request's slot with an
        all-null table row: their pos write is overwritten by the real
        row's, written after it, and their cache rows sink into the null
        block, and their frames and patches are zero."""
        rec = obs_registry.get_recorder()
        cfg = self.cfg
        a = self.prefill_batch
        pad = a - len(group)
        toks = np.zeros((a, bucket), np.int32)
        lengths = np.ones((a,), np.int32)
        slots_arr = np.full((a,), group[0][1], np.int64)
        tables = np.zeros((a, self.blocks_per_slot), np.int32)
        extra = {}
        if cfg.encoder_layers:
            extra["frames"] = np.zeros((a, cfg.encoder_frames, cfg.d_model),
                                       np.float32)
        if cfg.patch_tokens:
            extra["patches"] = np.zeros((a, cfg.patch_tokens, cfg.d_model),
                                        np.float32)
        for j, (req, slot_i, blocks) in enumerate(group):
            r = pad + j
            self._start(slot_i, req)
            toks[r, :req.prompt_len] = req.tokens
            lengths[r] = req.prompt_len
            slots_arr[r] = slot_i
            self._slot_blocks[slot_i] = blocks
            self.block_tables[slot_i, :] = 0
            self.block_tables[slot_i, :len(blocks)] = blocks
            tables[r] = self.block_tables[slot_i]
            for name, rows in extra.items():
                rows[r] = getattr(req, name)
        dev = self.device
        batch = {"tokens": torch.from_numpy(toks).to(dev),
                 **{k: torch.from_numpy(v).to(dev) for k, v in extra.items()}}
        with rec.span("engine.prefill", rids=[r.rid for r, _, _ in group],
                      slots=[s for _, s, _ in group], plen=bucket,
                      admitted=len(group)):
            logits, self.state = self._prefill(
                self.params, batch,
                torch.from_numpy(lengths).to(dev),
                torch.from_numpy(slots_arr),
                torch.from_numpy(tables).to(dev), self.state)
            self.prefill_launches += 1
            for j, (_req, slot_i, _) in enumerate(group):
                self._first_token(slot_i, self.slots[slot_i],
                                  logits[pad + j, -1])

    def _finish_if_done(self, sl: _Slot):
        if len(sl.result.tokens) >= sl.request.max_new:
            sl.result.t_done = self.clock()
            sl.state = SlotState.DRAIN
            self.lat_hist.observe(sl.result.latency)
            obs_registry.get_recorder().histogram(
                "serve.engine.latency_s").observe(sl.result.latency)

    def step(self) -> int:
        """One engine step: admissions, then one masked decode over every
        slot. Returns the number of live slots that emitted a token."""
        self._admit()
        active = np.array([sl.state is SlotState.DECODE
                           for sl in self.slots])
        self.peak_active = max(self.peak_active, int(active.sum()))
        if not active.any():
            return 0
        rec = obs_registry.get_recorder()
        with rec.span("engine.decode", active=int(active.sum())):
            args = (self.params,
                    torch.from_numpy(self._next_tok[:, None]).to(self.device),
                    self.state, torch.from_numpy(active).to(self.device))
            if self.paged:
                # the tables ride along every step, one fixed shape, so
                # table churn never changes the decode's shapes
                args += (torch.from_numpy(self.block_tables).to(
                    self.device),)
            logits, self.state = self._decode(*args)
            last = logits[:, -1]
            if self.greedy:   # one batched argmax and one transfer a step
                sel = torch.argmax(last, dim=-1).cpu().numpy()
        self.step_count += 1
        emitted = 0
        for i, sl in enumerate(self.slots):
            if not active[i]:
                continue
            tok = int(sel[i]) if self.greedy else self._select(last[i], sl)
            sl.result.tokens.append(tok)
            self._next_tok[i] = tok
            emitted += 1
            self._finish_if_done(sl)
        return emitted

    # -- drivers ------------------------------------------------------------

    def busy(self) -> bool:
        return bool(self.queue) or any(
            sl.state in (SlotState.PREFILL, SlotState.DECODE, SlotState.DRAIN)
            for sl in self.slots)

    def drain(self) -> List[RequestResult]:
        """Run until queue and slots are empty; results in rid order."""
        while self.busy():
            self.step()
        return [self.results[rid] for rid in sorted(self.results)]

    def run(self, requests: Iterable[Request], *,
            realtime: bool = False) -> List[RequestResult]:
        """Drain a request stream. With realtime=True each request is held
        back until the clock passes its `arrival` offset; otherwise all
        are submitted in arrival order and slot pressure alone governs
        admission."""
        pending = sorted(requests, key=lambda r: r.arrival)
        t0 = self.clock()
        while pending or self.busy():
            now = self.clock() - t0
            while pending and (not realtime or pending[0].arrival <= now):
                r = pending.pop(0)
                self.submit(r.tokens, r.max_new, frames=r.frames,
                            patches=r.patches, arrival=r.arrival)
            if self.busy():
                self.step()
            elif pending:
                time.sleep(min(0.001, pending[0].arrival - now))
        return [self.results[rid] for rid in sorted(self.results)]

    def stats(self) -> dict:
        """Aggregate serving stats. The key set is the JAX engine's and is
        STABLE: every key is present on an empty engine too (latencies as
        None, counters as 0), and the paged keys are False/None on a
        contiguous engine.
        p50/p99 come from the fixed-bucket latency histogram (bucket
        upper edges clamped into the exact [min, max]); mean and max are
        exact. `queue_wait_mean_s` averages over admitted requests."""
        done = [r for r in self.results.values() if r.t_done is not None]
        h = self.lat_hist
        paged_keys = {
            "paged": self.paged,
            "block_size": self.block_size,
            "num_blocks": self.num_blocks,
            "blocks_in_use": self.allocator.used if self.paged else None,
            "peak_blocks": self.allocator.peak if self.paged else None,
        }
        if not done:
            return {
                "requests": 0, "tokens": 0, "tok_per_s": 0.0,
                "latency_mean_s": None, "latency_p50_s": None,
                "latency_p99_s": None, "latency_max_s": None,
                "queue_wait_mean_s": None,
                "decode_steps": self.step_count,
                "peak_active": self.peak_active,
                **paged_keys,
            }
        toks = sum(len(r.tokens) for r in done)
        span = max(r.t_done for r in done) - min(r.t_submit for r in done)
        return {
            "requests": len(done),
            "tokens": toks,
            "tok_per_s": toks / span if span > 0 else float("inf"),
            "latency_mean_s": h.mean,
            "latency_p50_s": h.quantile(0.5),
            "latency_p99_s": h.quantile(0.99),
            "latency_max_s": h.max,
            "queue_wait_mean_s": self.queue_hist.mean,
            "decode_steps": self.step_count,
            "peak_active": self.peak_active,
            **paged_keys,
        }


def synth_request_stream(cfg: ArchConfig, n: int, *, rate: float = 32.0,
                         seed: int = 0, prompt_lens=(8, 16, 24),
                         gen_lens=(4, 8, 16)) -> List[Request]:
    """n synthetic requests with Poisson arrivals (exponential gaps at
    `rate` req/s) and mixed prompt and generation lengths, drawn from
    numpy exactly as the JAX package draws them: the same seed gives the
    same stream in both packages. An encoder model's requests carry
    (F, D) frames and a patch model's (P, D) patches, normal x 0.02,
    drawn after each request's tokens."""
    rng = np.random.default_rng(seed)
    t = 0.0
    out = []
    for _ in range(n):
        t += float(rng.exponential(1.0 / rate))
        plen = int(rng.choice(prompt_lens))
        req = Request(
            tokens=rng.integers(0, cfg.vocab_size, size=(plen,),
                                dtype=np.int32),
            max_new=int(rng.choice(gen_lens)), arrival=t)
        if cfg.encoder_layers:
            req.frames = (rng.standard_normal(
                (cfg.encoder_frames, cfg.d_model)) * 0.02).astype(np.float32)
        if cfg.patch_tokens:
            req.patches = (rng.standard_normal(
                (cfg.patch_tokens, cfg.d_model)) * 0.02).astype(np.float32)
        out.append(req)
    return out


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

    With `mesh` the batcher serves class-sharded, SPMD: every rank of the
    mesh builds it alike, submits the same requests and steps in
    lockstep. Each rank holds only its class slice of the tables
    (`prepare_artifact(mesh=)`; replication when M does not divide the
    `classes` axes), scores its columns with one kernel launch a batch,
    and one all-gather makes the (B, M) matrix whole on every rank (rows
    split over a `data` axis first, when the mesh has one). The scores are
    bit-equal to the unsharded batcher's; `stats()["class_shards"]` is
    the resolved degree.

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
                 mesh=None, device=DEFAULT_DEVICE, clock: Callable = None):
        from repro_torch.core import export as export_mod
        if slots < 1:
            raise ValueError("need slots >= 1")
        self.device = resolve_device(device)
        self.artifact = artifact
        self.slots = slots
        self.backend = backend
        self.mesh = mesh
        self.rules = sh.SERVE_RULES
        self.total_bits = int(artifact.total_bits)
        self.clock = clock or time.perf_counter
        self._prep = export_mod.prepare_artifact(
            artifact, backend=backend, mesh=mesh, rules=self.rules,
            device=self.device)
        self.class_shards = 1 if mesh is None else sh.class_partition(
            mesh, int(artifact.num_classes), self.rules)[1]
        self.trace_counts: collections.Counter = collections.Counter()
        self.lat_hist = obs_metrics.Histogram()

        def _batch_scores(prep, bits):
            # THE serve loop, shared with artifact_scores — semantics
            # cannot drift between the one-shot and batch paths; sharded,
            # its tail gathers the class columns (a no-op unsharded)
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
        exact mean/max. `class_shards` is the resolved class degree (1
        unsharded)."""
        done = [r for r in self.results.values() if r.t_done is not None]
        occupancy = self.served / max(1, self.batches * self.slots)
        h = self.lat_hist
        return {"requests": len(done), "batches": self.batches,
                "submitted": self._next_rid, "served": self.served,
                "queued": len(self.queue),
                "class_shards": self.class_shards,
                "occupancy": occupancy,
                "traces": int(self.trace_counts["batch_scores"]),
                "latency_mean_s": h.mean,
                "latency_p50_s": h.quantile(0.5),
                "latency_p99_s": h.quantile(0.99),
                "latency_max_s": h.max}


@dataclasses.dataclass
class WnnTenantResult:
    """One served multi-tenant classification request."""
    rid: int
    tid: int                           # tenant the request was routed to
    scores: np.ndarray                 # (M,) int32 ensemble scores
    pred: int
    t_submit: float
    t_done: Optional[float] = None     # None = queued; see WnnResult

    @property
    def latency(self) -> float:
        return self.t_done - self.t_submit


class WnnTenantBatcher:
    """Tenant-routed micro-batching over a fleet of same-geometry WNN
    artifacts: `WnnBatcher` grown a tenant axis.

    Artifacts register with `add_tenant`; at most `capacity` of them are
    resident at once in one device-side `StackedPackedTables` cache
    (`packed.stacked_zeros` slots). Requests carry a tenant id; each
    `step()` routes up to `slots` of them through ONE fixed-shape
    `stacked_predict` call whose rows index their tenant's tables by slot,
    so neither the queue depth nor which tenants are in the batch changes
    the shapes launched (`trace_counts["batch_scores"]` stays 1; slot
    installs are one more fixed shape, `trace_counts["install"]`).

    Admission is LRU: a request for a tenant that is not resident copies
    its prepared tables (`core.export.prepare_artifact`, cached, so a
    tenant admitted again after eviction is never prepared again) into a
    free slot, else into the least-recently-used slot whose tenant the
    forming batch does not use. When every slot is pinned by the batch,
    the request defers to the queue head for the next step: a batch never
    needs more distinct tenants than `capacity`, and `drain()` always
    ends (a step's first request always admits).

    With `mesh` (SPMD: every rank builds, submits and steps alike) the
    batch rows split over the mesh's batch axes and one all-gather makes
    the scores whole, while the resident stack is replicated: per-tenant
    tables are KB-scale, which is the point; a static fleet partitioned
    by tenant is `prepare_tenants(mesh=)` with
    `runtime.make_tenant_sharded_predict`.

        batcher = WnnTenantBatcher(capacity=64, slots=32)
        tid = batcher.add_tenant(artifact)
        rid = batcher.submit(tid, encoded_bits_row)
        results = batcher.drain()      # -> [WnnTenantResult]
    """

    def __init__(self, *, capacity: int = 64, slots: int = 64,
                 backend: str = "auto", mesh=None, device=DEFAULT_DEVICE,
                 clock: Callable = None):
        if capacity < 1:
            raise ValueError("need capacity >= 1")
        if slots < 1:
            raise ValueError("need slots >= 1")
        if backend not in ("packed", "auto"):
            raise ValueError(
                f"the tenant batcher serves the packed domain only "
                f"(backend='packed'|'auto', got {backend!r})")
        self.device = resolve_device(device)
        self.mesh = mesh
        self.rules = sh.SERVE_RULES
        self.capacity = capacity
        self.slots = slots
        self.backend = backend
        self.clock = clock or time.perf_counter
        self.trace_counts: collections.Counter = collections.Counter()
        self.lat_hist = obs_metrics.Histogram()

        self.total_bits: Optional[int] = None
        self._tenants: list = []           # tid -> prepared PackedTables
        self._artifacts: list = []         # keep prep cache owners alive
        self._stack = None                 # device StackedPackedTables
        self._resident: dict = {}          # tid -> slot
        self._slot_tid: list = [None] * capacity
        self._lru: collections.OrderedDict = collections.OrderedDict()
        self._scores = None
        self._install = None

        self.queue: collections.deque = collections.deque()
        self.results: dict = {}
        self._next_rid = 0
        self.batches = 0
        self.served = 0
        self.admissions = 0
        self.evictions = 0
        self.hits = 0
        self.misses = 0
        self.per_tenant: dict = {}

    # -- fleet registry -----------------------------------------------------

    def add_tenant(self, artifact) -> int:
        """Register one artifact; returns its tenant id. The first tenant
        fixes the fleet's geometry, which later artifacts must match
        exactly (entries, classes, per-submodel shapes), as
        `packed.stack_tenants` requires."""
        from repro_torch.core import export as export_mod
        prep = export_mod.prepare_artifact(artifact, backend=self.backend,
                                           device=self.device)
        if self._stack is None:
            self.total_bits = int(artifact.total_bits)
            self._build(prep)
        else:
            tmpl = self._tenants[0]
            if (prep.entries != tmpl.entries
                    or prep.num_classes != tmpl.num_classes
                    or int(artifact.total_bits) != self.total_bits
                    or any(a.shape != b.shape for a, b in
                           zip(prep.words, tmpl.words))
                    or any(a.shape != b.shape for a, b in
                           zip(prep.perms, tmpl.perms))):
                raise ValueError(
                    f"tenant {len(self._tenants)} geometry does not match "
                    f"the fleet's (entries {prep.entries} vs {tmpl.entries}, "
                    f"M {prep.num_classes} vs {tmpl.num_classes}) — stacked "
                    "tenants must share geometry")
        tid = len(self._tenants)
        self._tenants.append(prep)
        self._artifacts.append(artifact)
        # per-tenant latency is a fixed-bucket histogram, not a list that
        # grows with the traffic
        self.per_tenant[tid] = {"requests": 0, "batches": 0,
                                "hist": obs_metrics.Histogram()}
        return tid

    def _build(self, template):
        """The device cache and the two fixed-shape calls, from the first
        tenant's geometry."""
        from repro_torch.dist import collectives
        from repro_torch.packed import layout, runtime
        backend, dev, mesh = self.backend, self.device, self.mesh
        self._stack = layout.stacked_zeros(template, self.capacity)
        b_axes = () if mesh is None else runtime.batch_axes(
            mesh, self.rules, self.slots)

        def _batch_scores(st, bits, sids):
            # slot-indexed fleet scoring: THE serve loop of the stacked
            # path; under a mesh each rank scores its rows, gathered after
            if b_axes:
                rows = collectives.row_slice(self.slots, mesh, b_axes)
                bits, sids = bits[rows], sids[rows]
            scores, _ = runtime.stacked_predict(st, bits, sids,
                                                backend=backend, device=dev)
            if b_axes:
                scores = collectives.all_gather(scores, mesh, b_axes, dim=0)
            return scores

        def _install(st, pt, slot: int):
            # in place: the resident stack keeps its shapes and storage
            for dst, src in zip((*st.words, *st.masks, *st.perms, *st.h3s,
                                 st.bias),
                                (*pt.words, *pt.masks, *pt.perms, *pt.h3s,
                                 pt.bias)):
                dst[slot].copy_(src)
            return st

        self._scores = torchhooks.counted(_batch_scores, self.trace_counts,
                                          "batch_scores")
        self._install = torchhooks.counted(_install, self.trace_counts,
                                           "install")

    # -- serving ------------------------------------------------------------

    def submit(self, tid: int, bits) -> int:
        """Queue one encoded input for tenant `tid`; returns its rid."""
        if not 0 <= tid < len(self._tenants):
            raise ValueError(
                f"unknown tenant {tid}; registered: {len(self._tenants)}")
        bits = np.asarray(bits).reshape(-1)
        if bits.shape[0] != self.total_bits:
            raise ValueError(f"request has {bits.shape[0]} bits, the fleet "
                             f"encodes {self.total_bits}")
        rid = self._next_rid
        self._next_rid += 1
        self.results[rid] = WnnTenantResult(rid=rid, tid=tid, scores=None,
                                            pred=-1, t_submit=self.clock())
        self.queue.append((rid, tid, bits.astype(np.uint8)))
        return rid

    def _admit(self, tid: int, batch_tenants: set) -> Optional[int]:
        """Install tenant `tid` into a slot: a free one, else the LRU
        resident the forming batch does not use. None when every slot is
        pinned (the caller defers the request)."""
        rec = obs_registry.get_recorder()
        free = [s for s, t in enumerate(self._slot_tid) if t is None]
        if free:
            slot = free[0]
        else:
            victim = next((t for t in self._lru if t not in batch_tenants),
                          None)
            if victim is None:
                return None
            slot = self._resident.pop(victim)
            del self._lru[victim]
            self.evictions += 1
            rec.counter("serve.tenant.eviction").inc()
        with rec.span("tenant.install", tid=tid, slot=slot):
            self._stack = self._install(self._stack, self._tenants[tid],
                                        slot)
        self._slot_tid[slot] = tid
        self._resident[tid] = slot
        self.admissions += 1
        rec.counter("serve.tenant.admission").inc()
        return slot

    def step(self) -> int:
        """Serve up to `slots` queued requests in one fixed-shape call,
        admitting and evicting tenants as needed; returns the number
        served. Requests whose tenant cannot be made resident beside this
        batch's tenants defer, in order, to the queue head."""
        if not self.queue:
            return 0
        rec = obs_registry.get_recorder()
        take: list = []
        deferred: list = []
        batch_tenants: set = set()
        while self.queue and len(take) < self.slots:
            rid, tid, bits = self.queue.popleft()
            slot = self._resident.get(tid)
            if slot is not None:
                self.hits += 1
                rec.counter("serve.tenant.cache_hit").inc()
            else:
                slot = self._admit(tid, batch_tenants)
                if slot is None:
                    # deferred, not a miss: the retry decides again, so
                    # hits + misses always equals requests served
                    deferred.append((rid, tid, bits))
                    continue
                self.misses += 1
                rec.counter("serve.tenant.cache_miss").inc()
            batch_tenants.add(tid)
            take.append((rid, tid, bits, slot))
        for item in reversed(deferred):
            self.queue.appendleft(item)

        batch = np.zeros((self.slots, self.total_bits), np.uint8)
        sids = np.zeros((self.slots,), np.int64)
        for i, (_rid, _tid, bits, slot) in enumerate(take):
            batch[i] = bits
            sids[i] = slot
        with rec.span("wnn.tenant_batch", take=len(take),
                      tenants=len(batch_tenants)):
            # .cpu() waits for the device: the span covers the whole call
            scores = self._scores(
                self._stack, torch.from_numpy(batch).to(self.device),
                torch.from_numpy(sids).to(self.device)).cpu().numpy()
        t = self.clock()
        lat_hist_global = rec.histogram("serve.tenant.latency_s")
        for i, (rid, tid, _bits, _slot) in enumerate(take):
            res = self.results[rid]
            res.scores = scores[i]
            res.pred = int(np.argmax(scores[i]))   # ties: first class
            res.t_done = t
            self.lat_hist.observe(res.latency)
            lat_hist_global.observe(res.latency)
            pt = self.per_tenant[tid]
            pt["requests"] += 1
            pt["hist"].observe(res.latency)
        for tid in batch_tenants:
            self.per_tenant[tid]["batches"] += 1
            self._lru[tid] = None
            self._lru.move_to_end(tid)    # most recently used -> tail
        self.batches += 1
        self.served += len(take)
        return len(take)

    def drain(self) -> List[WnnTenantResult]:
        """Serve until the queue is empty; results in rid order."""
        while self.queue:
            self.step()
        return [self.results[rid] for rid in sorted(self.results)]

    def stats(self) -> dict:
        """Fleet-serving stats: the JAX batcher's stable key set
        (latencies None before any request finishes) and a per-tenant
        breakdown (requests, batches the tenant rode in, its share of the
        launched capacity, latency mean/p50/p99)."""
        done = [r for r in self.results.values() if r.t_done is not None]
        h = self.lat_hist
        out = {"requests": len(done), "batches": self.batches,
               "submitted": self._next_rid, "served": self.served,
               "queued": len(self.queue),
               "tenants": len(self._tenants),
               "capacity": self.capacity,
               "resident": len(self._resident),
               "admissions": self.admissions,
               "evictions": self.evictions,
               "hits": self.hits, "misses": self.misses,
               "occupancy": self.served / max(1, self.batches * self.slots),
               "traces": int(self.trace_counts["batch_scores"]),
               "install_traces": int(self.trace_counts["install"]),
               "latency_mean_s": h.mean,
               "latency_p50_s": h.quantile(0.5),
               "latency_p99_s": h.quantile(0.99),
               "latency_max_s": h.max,
               "per_tenant": {}}
        cap = max(1, self.batches * self.slots)
        for tid, pt in self.per_tenant.items():
            th = pt["hist"]
            out["per_tenant"][tid] = {
                "requests": pt["requests"],
                "batches": pt["batches"],
                "occupancy": pt["requests"] / cap,
                "latency_mean_s": th.mean,
                "latency_p50_s": th.quantile(0.5),
                "latency_p99_s": th.quantile(0.99),
            }
        return out
