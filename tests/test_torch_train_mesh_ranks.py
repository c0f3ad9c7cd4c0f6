"""Rank functions of `tests/test_torch_train_mesh.py`, run by
`repro_torch.launch.mesh.spawn_ranks` in gloo processes on the CPU.

It holds no tests itself: a spawned rank imports its function by module
name, so this module imports only torch, numpy, pytest and the port.
"""
import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.dist import placed  # noqa: E402
from repro_torch.launch import mesh as mesh_mod  # noqa: E402
from repro_torch.launch import serve as serve_mod  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.launch import train as train_mod  # noqa: E402
from repro_torch.models import transformer  # noqa: E402

MESHES = {"data2-model2": ((2, 2), ("data", "model")),
          "model4": ((4,), ("model",))}
# float32 compute, as `tests/test_torch_tp.py` holds the placed step
TRAIN = dict(steps_total=3, batch=4, seq=16, microbatches=2,
             compute_dtype=None, seed=3, verbose=False, device="cpu")
WHISPER_TRAIN = dict(TRAIN, steps_total=2)
CKPT_AT = 2                    # the mid-run checkpoint the resumes start at
SERVE = dict(batch=4, prompt_len=12, gen=6, seed=5)
SAMPLE_SEED = 11
COLD = 1e-6                    # a temperature that leaves the argmax alone


def whole_numpy(t) -> np.ndarray:
    """A tensor or DTensor gathered whole, as numpy (bf16 as float32)."""
    t = placed.whole(t).detach()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def run_summary(run, rank) -> dict:
    """A `train()` result as numpy: its history, its start and, from rank
    0, the final parameters and the placements of the parameters and
    the AdamW state (whole leaves are gathered by every rank)."""
    params = [whole_numpy(t) for t in steps.tree_leaves(run["params"])]
    out = {"history": run["history"], "resumed_from": run["resumed_from"]}
    if rank == 0:
        st = run["opt_state"]
        out["params"] = params
        out["placements"] = {
            "params": [placements(t) for t in steps.tree_leaves(
                run["params"])],
            "mu": [placements(t) for t in st.mu],
            "nu": [placements(t) for t in st.nu],
            "step": placements(st.step)}
    return out


def placements(t) -> list:
    return [repr(p) for p in t.placements] if placed.is_placed(t) else None


def copy_checkpoint(src_dir, dst_dir, step) -> None:
    name = f"step_{step:010d}"
    os.makedirs(dst_dir, exist_ok=True)
    shutil.copytree(os.path.join(src_dir, name), os.path.join(dst_dir, name))


def serve_inputs(cfg):
    """The smoke model's serve parameters (seeded, on the CPU) and numpy
    prompts."""
    rng = np.random.default_rng(SERVE["seed"])
    prompts = rng.integers(0, cfg.vocab_size,
                           (SERVE["batch"], SERVE["prompt_len"])).astype(
                               np.int32)
    params = transformer.init_params(
        cfg, torch.Generator().manual_seed(SERVE["seed"]), device="cpu")
    return params, prompts


def serve_runs(cfg, mesh=None) -> dict:
    """Greedy tokens, the same generator seed sampled twice at
    temperature 1, and sampled at COLD, on `mesh` (None: one process)."""
    params, prompts = serve_inputs(cfg)
    kw = dict(max_len=SERVE["prompt_len"] + SERVE["gen"] + 1,
              gen=SERVE["gen"], mesh=mesh)

    def sampled(temperature):
        return serve_mod.serve(
            cfg, params, prompts, greedy=False, temperature=temperature,
            rng=torch.Generator().manual_seed(SAMPLE_SEED), **kw).numpy()
    return {"greedy": serve_mod.serve(cfg, params, prompts, **kw).numpy(),
            "sampled": [sampled(1.0), sampled(1.0)], "cold": sampled(COLD)}


def mesh_rank(rank, world, plan) -> dict:
    """One gloo rank of every placed case: the smoke Llama through
    `train(mesh=)` on each of MESHES (on (data 2, model 2) with a
    checkpoint every CKPT_AT steps into plan["ckpt"]); that run's step
    CKPT_AT checkpoint resumed on (model 4) from plan["resume"]; the
    smoke Whisper through `train(mesh=)` on (data 2, model 2); and
    `serve(mesh=)` on (data 2, model 2)."""
    del world
    torch.set_num_threads(1)
    meshes = {k: mesh_mod.make_mesh(*v) for k, v in MESHES.items()}
    llama = get_config("llama3p2_3b", smoke=True)
    out = {}
    for name, mesh in meshes.items():
        ckpt = plan["ckpt"] if name == "data2-model2" else None
        out[f"llama/{name}"] = run_summary(train_mod.train(
            llama, mesh=mesh, ckpt_dir=ckpt, ckpt_every=CKPT_AT, **TRAIN),
            rank)
    if rank == 0:
        copy_checkpoint(plan["ckpt"], plan["resume"], CKPT_AT)
    dist.barrier()
    out["llama/resume-model4"] = run_summary(train_mod.train(
        llama, mesh=meshes["model4"], ckpt_dir=plan["resume"], **TRAIN),
        rank)
    out["whisper/data2-model2"] = run_summary(train_mod.train(
        get_config("whisper_tiny", smoke=True), mesh=meshes["data2-model2"],
        **WHISPER_TRAIN), rank)
    out["serve"] = serve_runs(llama, meshes["data2-model2"])
    return out
