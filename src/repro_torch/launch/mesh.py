"""Meshes over `torch.distributed` ranks, and a launcher that runs one
function in several rank processes (port of `repro/launch/mesh.py`).

A mesh is a `torch.distributed.device_mesh.DeviceMesh` built over the
ranks of an initialised default process group, row-major over named axes
(`pod` -> `data` -> `model`, outermost first). `make_host_mesh` is the
one-process stand-in: every axis has size 1, so every sharding rule
resolves to replication and no collective ever runs.

The collective backend follows the mesh's device type, by rule
(`collective_backend`): NCCL for one rank per card, gloo for the CPU and
for several ranks sharing one card (its collectives then run on host
copies, `dist.collectives`). `spawn_ranks` starts the processes, with a
`file://` rendezvous in a temporary directory (never a fixed TCP port,
so parallel test workers cannot collide), a timeout on every collective
and, but for a launcher's job, a deadline on the whole run.

    outs = spawn_ranks(fn, 4, arg, backend=collective_backend("cpu", 4))
    # fn(rank, world, arg) ran in 4 processes; outs[r] is rank r's return

The production meshes (`make_production_mesh`: 16 x 16 (data, model) on
one pod, 2 x 16 x 16 (pod, data, model) on two) serve the dry run, where
one process plays rank `rank` of a fake world of 256 or 512 ranks
(`fake_world`), whose collectives record what they would send and move
nothing, so the per-rank program is traced with no cluster and no card;
and `launch/train.py --production-mesh`, whose 256 ranks a launcher
(torchrun) starts, one card a rank under NCCL.
"""
from __future__ import annotations

import contextlib
import datetime
import math
import multiprocessing
import os
import pickle
import queue as queue_mod
import signal
import tempfile
import threading
import time
import traceback
from typing import NamedTuple

import torch
import torch.distributed as dist

from repro_torch.device import DEFAULT_DEVICE, resolve_device

class HostMesh(NamedTuple):
    """The one-process mesh: named axes of size 1, no process group."""
    mesh_dim_names: tuple
    shape: tuple


def make_host_mesh(axes: tuple = ("data", "model")) -> HostMesh:
    """A one-process mesh for CPU callers: every rule resolves to no-op."""
    return HostMesh(tuple(axes), (1,) * len(axes))


def collective_backend(device=DEFAULT_DEVICE, world: int = 1) -> str:
    """The backend for `world` ranks computing on `device`: "nccl" when
    each rank has a card of its own, "gloo" on the CPU and when ranks
    share a card."""
    dev = torch.device(device)
    if dev.type == "cuda" and world <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def rank_device(device=DEFAULT_DEVICE) -> torch.device:
    """This rank's compute device: the CPU, or card `rank % cards` (under
    gloo several ranks land on one card; under NCCL each has its own)."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return dev
    rank = dist.get_rank() if dist.is_initialized() else 0
    idx = rank % torch.cuda.device_count()
    torch.cuda.set_device(idx)
    return torch.device("cuda", idx)


def make_mesh(shape: tuple, axes: tuple, device_type: str | None = None):
    """A DeviceMesh of `shape` named `axes` over the ranks of the
    initialised default process group (world == prod(shape)). Under NCCL
    its device type is "cuda"; under gloo "cpu", where its collectives
    run, unless `device_type` is "cuda": the mesh of a placed LM program
    whose ranks share a card, its DTensors' shards on the card. gloo then
    runs DTensor's collectives on the card's tensors itself, but for the
    all-gather, which takes the host-staged route of
    `dist.collectives.stage_cuda_gathers_on_host`."""
    shape, axes = tuple(shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} names {len(axes)} axes {axes}")
    if not dist.is_initialized():
        raise RuntimeError(
            f"mesh {dict(zip(axes, shape))} needs an initialised process "
            "group (spawn_ranks, or init_process_group); one process "
            "serves unsharded with make_host_mesh()")
    n = math.prod(shape)
    if dist.get_world_size() != n:
        raise RuntimeError(f"mesh {dict(zip(axes, shape))} needs {n} ranks, "
                           f"the process group has {dist.get_world_size()}")
    from torch.distributed.device_mesh import init_device_mesh
    if dist.get_backend() == "nccl":
        device_type = "cuda"
    elif device_type == "cuda":
        from repro_torch.dist.collectives import stage_cuda_gathers_on_host
        stage_cuda_gathers_on_host()
    else:
        device_type = "cpu"
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


PRODUCTION_MESHES = {False: ((16, 16), ("data", "model")),
                     True: ((2, 16, 16), ("pod", "data", "model"))}


@contextlib.contextmanager
def fake_world(world: int, rank: int = 0):
    """This process as rank `rank` of a fake process group of `world`
    ranks (torch's `fake` backend over a `FakeStore`): no process is
    started and no collective moves data, so a trace under it records the
    collectives rank `rank` would make. The group is destroyed on exit,
    whatever happens inside."""
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialised; a fake "
                           "world needs the process to itself")
    if not 0 <= rank < world:
        raise ValueError(f"rank {rank} outside a world of {world}")
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def make_production_mesh(multi_pod: bool = False, rank: int = 0, *,
                         device_type: str = "cuda"):
    """The production DeviceMesh (the JAX package's `make_production_mesh`
    shapes) as rank `rank` sees it. Needs an initialised group of the
    mesh's size in which this process is `rank`: `fake_world(256 or 512,
    rank)`, or a launcher's world."""
    shape, axes = PRODUCTION_MESHES[bool(multi_pod)]
    n = math.prod(shape)
    if not dist.is_initialized():
        raise RuntimeError(f"the production mesh needs a world of {n} ranks:"
                           f" run inside launch.mesh.fake_world({n}, rank)")
    if dist.get_world_size() != n or dist.get_rank() != rank:
        raise RuntimeError(f"the production mesh {dict(zip(axes, shape))} "
                           f"as rank {rank} needs a world of {n} with this "
                           f"process as rank {rank}; the group has "
                           f"{dist.get_world_size()} ranks, this is rank "
                           f"{dist.get_rank()}")
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def pods_in(mesh) -> int:
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape))).get("pod", 1)


# ---------------------------------------------------------------------------
# Rank processes
# ---------------------------------------------------------------------------

def _rank_main(fn, rank, world, args_file, backend, init_file, timeout_s,
               out):
    try:
        with open(args_file, "rb") as f:
            args = pickle.load(f)
        dist.init_process_group(
            backend, init_method=f"file://{init_file}", rank=rank,
            world_size=world, timeout=datetime.timedelta(seconds=timeout_s))
        try:
            result = fn(rank, world, *args)
        finally:
            dist.destroy_process_group()
        out.put((rank, True, result))
    except BaseException:    # reported to the parent, which raises
        out.put((rank, False, traceback.format_exc()))
        raise


def _failures(out, failed: dict, grace_s: float = 3.0) -> str:
    """Every rank's failure report that arrives within `grace_s` of the
    first, in rank order: the rank that failed first is named beside the
    peers its failure stranded in a collective."""
    deadline = time.monotonic() + grace_s
    while time.monotonic() < deadline:
        try:
            rank, ok, value = out.get(timeout=max(0.0, deadline
                                                  - time.monotonic()))
        except queue_mod.Empty:
            break
        if not ok:
            failed[rank] = value
    return "\n".join(f"rank {r} failed:\n{tb}"
                     for r, tb in sorted(failed.items()))


def _forward(signals, procs):
    """From now on, each of `signals` that reaches this process is sent on
    to every live process of `procs`; returns the function that restores
    the previous handlers. Only the main thread may install handlers:
    elsewhere nothing is forwarded."""
    if threading.current_thread() is not threading.main_thread():
        signals = ()

    def forward(signum, frame):
        for p in procs:
            if p.pid is not None and p.is_alive():
                os.kill(p.pid, signum)

    prev = {sig: signal.signal(sig, forward) for sig in signals}

    def restore():
        for sig, handler in prev.items():
            signal.signal(sig, handler)
    return restore


def spawn_ranks(fn, world: int, *args, backend: str = "gloo",
                timeout_s: float = 120.0, whole_run_deadline: bool = True,
                forward_signals: tuple = ()) -> list:
    """Run `fn(rank, world, *args)` in `world` fresh processes joined in
    one default process group; returns each rank's return value, in rank
    order.

    `fn` must be importable by name from a module that the children can
    import (they start from a fresh interpreter: the `spawn` method), and
    its arguments and return value picklable. Every collective times out
    after `timeout_s`, and with `whole_run_deadline` the whole run has
    the same deadline (without it, a launcher's ranks run as long as
    their job does): a rank that fails, dies or times out makes the call
    raise with the failing rank's traceback, and every child is stopped
    before it returns.
    `forward_signals` (such as `(signal.SIGTERM,)`) are passed on to
    every rank while they run: a preempted launcher preempts its ranks."""
    ctx = multiprocessing.get_context("spawn")
    out = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="repro_torch_rdv_") as tmp:
        init_file = os.path.join(tmp, "rendezvous")
        # the arguments go through a file: handed to Process, each child's
        # start would wait until that child had read them from its pipe
        args_file = os.path.join(tmp, "args.pkl")
        with open(args_file, "wb") as f:
            pickle.dump(args, f, protocol=pickle.HIGHEST_PROTOCOL)
        procs = [ctx.Process(target=_rank_main,
                             args=(fn, r, world, args_file, backend,
                                   init_file, timeout_s, out), daemon=True)
                 for r in range(world)]
        for p in procs:
            p.start()
        restore_signals = _forward(forward_signals, procs)
        results: dict = {}
        failure = None
        deadline = (time.monotonic() + timeout_s if whole_run_deadline
                    else math.inf)
        try:
            # drain the queue before joining: a child blocks on exit until
            # its result has been read
            while len(results) < world and failure is None:
                left = deadline - time.monotonic()
                if left <= 0:
                    failure = (f"ranks {sorted(set(range(world)) - set(results))}"
                               f" did not finish within {timeout_s} s")
                    break
                try:
                    rank, ok, value = out.get(timeout=min(left, 1.0))
                except queue_mod.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if r not in results and p.exitcode is not None]
                    if dead:
                        # give a dying rank's report a moment to arrive
                        try:
                            rank, ok, value = out.get(timeout=5.0)
                        except queue_mod.Empty:
                            failure = (f"rank {dead[0]} exited with code "
                                       f"{procs[dead[0]].exitcode} and no "
                                       "report")
                            break
                    else:
                        continue
                if ok:
                    results[rank] = value
                else:
                    failure = _failures(out, {rank: value})
            for p in procs:
                p.join(timeout=min(max(0.0, deadline - time.monotonic()),
                                   timeout_s) + 5.0)
        finally:
            restore_signals()
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join(timeout=10.0)
            out.close()
        if failure is not None:
            raise RuntimeError(f"spawn_ranks({getattr(fn, '__name__', fn)}, "
                               f"world={world}, backend={backend}): "
                               f"{failure}")
    return [results[r] for r in range(world)]
