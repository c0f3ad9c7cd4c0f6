"""Rank functions of `tests/test_torch_tp.py`, run by
`repro_torch.launch.mesh.spawn_ranks` in gloo processes on the CPU.

It holds no tests itself: a spawned rank imports its function by module
name, so this module imports only torch, numpy, pytest and the port.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.dist import sharding as sh  # noqa: E402
from repro_torch.launch import mesh as mesh_mod  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.train import optimizer as opt_lib  # noqa: E402

MAX_LEN_PAD = 4          # cache positions past the prompt: two decodes
# the dry run's train cell's AdamW rate (JAX's `lower_cell`): a first
# Adam step moves an entry by lr·g/(|g| + eps), so where |g| is near eps
# a rounding of g moves the update by up to a few thousandths of lr
LR = 1e-4


def config(heads):
    """llama3p2_3b's smoke config, or with `heads` = (H, Hkv, hd)."""
    cfg = get_config("llama3p2_3b", smoke=True)
    if heads:
        h, hkv, hd = heads
        cfg = dataclasses.replace(cfg, num_heads=h, num_kv_heads=hkv,
                                  head_dim=hd)
    return cfg


def run(cfg, plan, *, place=None, state_after_prefill=None,
        decode_states=None) -> dict:
    """The prefill, two decode steps and one float32 AdamW(LR) train step of
    `plan` (numpy tokens and labels), on one device or, with `place` (a
    DeviceMesh), placed on that mesh. Everything comes back whole, as
    numpy, the state after the prefill too (`state`, in
    `graph_cost.flatten` order, with its leaves' dtypes `state_dtypes`). `state_after_prefill` (such leaves)
    replaces the prefill's state before the decode steps: the bf16 cache
    rounds float32 values that differ in their last bits between two
    programs to different bf16 neighbours, so the decode steps are held
    to each other on one state. The state before and after each decode
    step comes back too (`states`, `after`), and `decode_states` (lists
    of `states`' leaves) replaces the state before each step."""
    from repro_torch.launch import graph_cost
    params = transformer.init_params(
        cfg, torch.Generator().manual_seed(plan["seed"]), device="cpu")
    tokens = torch.from_numpy(plan["tokens"])
    labels = torch.from_numpy(plan["labels"])
    nxt = torch.from_numpy(plan["next"])
    # Whisper's frames, InternVL2's patches (float32, by batch rows)
    extra = {k: torch.from_numpy(v)
             for k, v in (plan.get("inputs") or {}).items()}
    s = tokens.shape[1]

    def whole(t):
        t = t.full_tensor() if hasattr(t, "full_tensor") else t
        if t.dtype == torch.bfloat16:       # numpy has no bf16: exact
            t = t.float()
        return t.detach().numpy()

    def placed(kind):
        if place is None:
            import contextlib
            return contextlib.nullcontext(), (lambda t, lg: t), \
                (lambda p: p)
        mesh = place
        rules = sh.TRAIN_RULES if kind == "train" else sh.SERVE_RULES
        return (sh.use_placement(mesh, rules),
                lambda t, lg: sh.distribute_tensor(t, lg, mesh, rules),
                lambda p: steps.place_params(cfg, p, mesh, rules))

    out = {}
    ctx, put, put_params = placed("serve")
    with ctx:
        p = put_params(params)
        logits, state = steps.make_prefill_step(cfg, max_len=s + MAX_LEN_PAD)(
            p, {"tokens": put(tokens, ("batch", "seq")),
                **{k: put(v, ("batch", None, None))
                   for k, v in extra.items()}})
        out["prefill"] = whole(logits)
        out["state"] = [whole(t) for _, t in graph_cost.flatten(state)]
        out["state_dtypes"] = [t.dtype for _, t in graph_cost.flatten(state)]
        out["state_kinds"] = [[type(c).__name__ for c in seg.values()]
                              for seg in state.caches]
        if state_after_prefill is not None:
            state = graph_cost.rebuild(state, iter(
                torch.from_numpy(a).to(t.dtype) for a, (_, t) in zip(
                    state_after_prefill, graph_cost.flatten(state),
                    strict=True)))
        decode = steps.make_decode_step(cfg)
        out["states"] = []
        for i in range(nxt.shape[1]):
            if decode_states is not None:
                state = graph_cost.rebuild(state, iter(
                    torch.from_numpy(a).to(t.dtype) for a, (_, t) in zip(
                        decode_states[i], graph_cost.flatten(state),
                        strict=True)))
            out["states"].append([whole(t) for _, t in
                                  graph_cost.flatten(state)])
            logits, state = decode(p, put(nxt[:, i:i + 1].contiguous(),
                                          ("batch", None)), state)
            out[f"decode{i}"] = whole(logits)
            out.setdefault("after", []).append(
                [whole(t) for _, t in graph_cost.flatten(state)])
    ctx, put, put_params = placed("train")
    with ctx:
        p = put_params(params)
        optimizer = opt_lib.adamw(LR)
        state = optimizer.init(steps.tree_leaves(p))
        step = steps.make_train_step(cfg, optimizer,
                                     compute_dtype=torch.float32)
        new, _, metrics = step(p, state, {
            "tokens": put(tokens, ("batch", "seq")),
            "labels": put(labels, ("batch", "seq")),
            **{k: put(v, ("batch", None, None)) for k, v in extra.items()}})
        out["loss"] = float(whole(metrics["loss"]))
        out["params"] = [whole(t) for t in steps.tree_leaves(new)]
    return out


def placed_rank(rank, world, plans) -> list:
    """One gloo rank of the placed runs: each plan on its plan["mesh"] =
    (shape, axes), a mesh over the same world of ranks. Rank 0 returns
    every result, the others their losses."""
    torch.set_num_threads(1)
    outs = []
    for plan in plans:
        mesh = mesh_mod.make_mesh(*plan["mesh"])
        out = run(config(plan["heads"]), plan, place=mesh)
        outs.append(out if rank == 0 else {"loss": out["loss"]})
    return outs


def plan_for(heads, mesh, seed=0) -> dict:
    """Numpy tokens, labels and the decode tokens of a (4, 16) batch."""
    rng = np.random.default_rng(seed)
    cfg = config(heads)
    return {"heads": heads, "mesh": mesh, "seed": seed,
            "tokens": rng.integers(0, cfg.vocab_size, (4, 16)).astype(
                np.int32),
            "labels": rng.integers(0, cfg.vocab_size, (4, 16)).astype(
                np.int32),
            "next": rng.integers(0, cfg.vocab_size, (4, 2)).astype(
                np.int32)}


def moe_plan(arch, mesh, *, batch=8, seq=24, seed=0, change=None) -> dict:
    """Numpy tokens, labels and two decode tokens of a (batch, seq) batch
    of `arch`'s smoke config (with the fields `change` gives replaced),
    to run on `mesh` = (shape, axes); for a model that takes them, its
    frames (batch, F, D) or patches (batch, P, D), normal x 0.02
    (`inputs`)."""
    rng = np.random.default_rng(seed)
    plan = {"arch": arch, "mesh": mesh, "seed": seed, "change": change}
    cfg = plan_config(plan)
    v = cfg.vocab_size
    plan.update(
        tokens=rng.integers(0, v, (batch, seq)).astype(np.int32),
        labels=rng.integers(0, v, (batch, seq)).astype(np.int32),
        next=rng.integers(0, v, (batch, 2)).astype(np.int32))
    rows = {"frames": cfg.encoder_frames, "patches": cfg.patch_tokens}
    inputs = {k: (rng.standard_normal((batch, n, cfg.d_model)) * 0.02
                  ).astype(np.float32) for k, n in rows.items() if n}
    if inputs:
        plan["inputs"] = inputs
    return plan


def plan_config(plan):
    """The plan's smoke config, with the fields its `change` gives."""
    cfg = get_config(plan["arch"], smoke=True)
    return dataclasses.replace(cfg, **(plan.get("change") or {}))


def run_tapped(plan, *, place=None, decode_states=None) -> dict:
    """`run` of the plan's smoke MoE arch, with every MoE routing's group
    capacity, expert choices and kept choices recorded in call order
    (`taps`: the prefill's layers, each decode step's, then the train
    step's): a placed block records the groups it routes, which on a
    rank whose rows do not make whole groups are the groups its rows
    belong to, routed from their gathered choices."""
    from repro_torch.models import moe
    taps = []
    queue = moe._queue

    def tapped(cfg, onehot, mask=None):
        out = queue(cfg, onehot, mask)
        taps.append({"cap": out[3], "idx": onehot.argmax(-1).numpy(),
                     "keep": out[2].numpy().copy()})
        return out
    moe._queue = tapped
    try:
        out = run(plan_config(plan), plan, place=place,
                  decode_states=decode_states)
    finally:
        moe._queue = queue
    out["taps"] = taps
    return out


def moe_rank(rank, world, plans) -> list:
    """One gloo rank of the placed MoE runs: each plan on its
    plan["mesh"]. Every rank returns its results (its taps are its own
    groups'; its arrays are whole)."""
    del rank, world
    torch.set_num_threads(1)
    return [run_tapped(plan, place=mesh_mod.make_mesh(*plan["mesh"]))
            for plan in plans]
