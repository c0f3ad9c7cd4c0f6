"""The LM half of the port's dry run (`launch.dryrun.run_lm_cell`,
`launch/specs.py`, the DTensor placement of the dense family) against the
JAX package's specs and rules.

Llama 3.2 3B at full width and 2 of its 28 layers (`dataclasses.replace`
on both packages' configs), traced as rank 0 of the production meshes:
train_4k, prefill_32k and decode_32k on one pod, decode_32k on two. Each
record is ok with no wnnlint error; each part of the rank's arguments
(`args_bytes_by_kind`: parameters, AdamW moments, inputs, the decode
state) equals the bytes of the shards JAX's rules give the same leaves,
exactly; the collectives show the placement (the `fsdp` weights gathered
over `data` in training, the tensor-parallel sums over `model`). The
card's program is traced where this torch can (serving cells); the
training cell traces the CPU program here, as the record says.
"""
import dataclasses
import math
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import SHAPES as JSHAPES  # noqa: E402
from repro.configs.base import get_config as jget_config  # noqa: E402
from repro.dist import sharding as jsh  # noqa: E402
from repro.launch import specs as jspecs  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402

LAYERS = 2
CELLS = [("train_4k", False), ("prefill_32k", False), ("decode_32k", False),
         ("decode_32k", True)]
JMESH = {False: ((16, 16), ("data", "model")),
         True: ((2, 16, 16), ("pod", "data", "model"))}


def jmesh(multi_pod):
    shape, axes = JMESH[multi_pod]
    return types.SimpleNamespace(axis_names=axes,
                                 devices=np.empty(shape, dtype=object))


def shard_bytes(shape, spec, jm, itemsize) -> int:
    sizes = dict(zip(jm.axis_names, jm.devices.shape))
    n = 1
    for dim, entry in zip(shape, tuple(spec) + (None,) * len(shape)):
        axes = () if entry is None else (
            entry if isinstance(entry, tuple) else (entry,))
        n *= dim // math.prod(sizes[a] for a in axes)
    return n * itemsize


def jax_parts(shape_name, multi_pod, *, arch="llama3p2_3b",
              layers=LAYERS) -> dict:
    """{part: bytes a rank} of `arch`'s JAX cell at `layers` layers under
    JAX's rules on the stand-in mesh: parameters and AdamW state by
    `param_logical`, inputs by the data arguments' logical axes (at
    decode the token, the one input `lower_cell` lowers), the decode
    state by `cache_shardings`' classification."""
    jcfg = dataclasses.replace(jget_config(arch), num_layers=layers)
    shape = JSHAPES[shape_name]
    jm = jmesh(multi_pod)
    train = shape.kind == "train"
    rules = jsh.TRAIN_RULES if train else jsh.SERVE_RULES
    dtype = jnp.float32 if train else jnp.bfloat16
    pshapes = jtransformer.param_shapes(jcfg, dtype=dtype)
    plog = jtransformer.param_logical(jcfg)

    def tree_bytes(shapes, logs):
        total = 0
        for s, lg in zip(jax.tree.leaves(shapes),
                         jax.tree.leaves(logs, is_leaf=lambda x:
                                         isinstance(x, tuple))):
            total += shard_bytes(s.shape, rules.resolve(lg, jm, shape=s.shape),
                                 jm, np.dtype(s.dtype).itemsize)
        return total
    out = {"params": tree_bytes(pshapes, plog)}
    log = {"tokens": ("batch", "seq"), "labels": ("batch", "seq"),
           "token": ("batch", None), "frames": ("batch", None, None),
           "patches": ("batch", None, None)}
    # `lower_cell` lowers a decode on the token alone, whatever else
    # `input_specs` lists (Whisper's frames)
    out["inputs"] = sum(
        shard_bytes(v.shape, rules.resolve(log[k], jm, shape=v.shape), jm,
                    np.dtype(v.dtype).itemsize)
        for k, v in jspecs.input_specs(jcfg, shape).items()
        if shape.kind != "decode" or k == "token")
    if train:
        ostate = jspecs.opt_specs(jopt.adamw(1e-4), pshapes)
        out["opt"] = (np.dtype(ostate.step.dtype).itemsize
                      + tree_bytes(ostate.mu, plog)
                      + tree_bytes(ostate.nu, plog))
    if shape.kind == "decode":
        state = jsteps.serve_state_spec(jcfg, shape.global_batch,
                                        shape.seq_len, pshapes)
        saved = jsh.named_sharding
        try:
            jsh.named_sharding = lambda mesh, rules_, lg, shape=None: \
                types.SimpleNamespace(spec=rules_.resolve(lg, mesh,
                                                          shape=shape))
            ent = jspecs.cache_shardings(jcfg, state, jm, rules)
        finally:
            jsh.named_sharding = saved
        leaves = jax.tree.leaves(state)
        specs_ = jax.tree.leaves(ent, is_leaf=lambda x: hasattr(x, "spec"))
        out["state"] = sum(shard_bytes(s.shape, e.spec, jm,
                                       np.dtype(s.dtype).itemsize)
                           for s, e in zip(leaves, specs_, strict=True))
    return out


@pytest.fixture(scope="module")
def records():
    cfg = dataclasses.replace(get_config("llama3p2_3b"), num_layers=LAYERS)
    out = {}
    for shape, multi in CELLS:
        out[(shape, multi)] = dryrun.run_lm_cell(
            "llama3p2_3b", shape, multi, None, analyze=True, device="cuda",
            cfg=cfg)
    return out


@pytest.mark.parametrize("shape,multi", CELLS)
def test_lm_cell_is_ok_with_no_lint_error(records, shape, multi):
    rec = records[(shape, multi)]
    assert rec["ok"], rec.get("error")
    assert rec["analysis"]["errors"] == 0
    assert rec["layers"] == LAYERS
    assert rec["mesh"] == ("2x16x16" if multi else "16x16")
    assert rec["chips"] == (512 if multi else 256)
    assert {"arch", "shape", "kind", "mesh", "chips", "ok", "memory",
            "roofline", "trace_s", "traced_device"} <= set(rec)
    if shape != "train_4k":          # the card's program, fake CUDA
        assert rec["traced_device"] == "cuda:0"
    nodes = rec["op_nodes"].get("repro_torch::flash_attention", 0)
    assert nodes == (0 if shape == "decode_32k" else LAYERS
                     if shape == "prefill_32k" else nodes)


@pytest.mark.parametrize("shape,multi", CELLS)
def test_args_bytes_by_kind_equal_jax_shards(records, shape, multi):
    assert records[(shape, multi)]["args_bytes_by_kind"] == \
        jax_parts(shape, multi)


def test_collectives_show_the_placement(records):
    train = records[("train_4k", False)]["roofline"]["collectives_by_kind"]
    assert train["all-gather"]["axes"].get("data", 0) > 0     # fsdp
    assert train["all-reduce"]["axes"].get("model", 0) > 0    # tp sums
    decode = records[("decode_32k", False)]["roofline"]["collectives_by_kind"]
    # the log-sum-exp combine over the cache's sequence shards
    assert decode["all-reduce"]["axes"].get("model", 0) >= 3 * LAYERS
    prefill = records[("prefill_32k", False)]["roofline"]
    assert prefill["collective_s"] > 0 and prefill["model_flops"] > 0


def test_memory_pass_of_two_microbatches_equals_the_whole_step(
        monkeypatch):
    """A training cell's memory pass runs the step on its first
    MEMORY_MICROBATCHES microbatches (`lm_cell_args`' `memory_step`):
    the memory and host reads it records equal those of the whole step,
    here the smoke Llama at one layer with 3 microbatches a rank of the
    production mesh (the graph pass, which runs every microbatch either
    way, is stopped: `make_fx` raises, and the trace keeps the memory
    pass's results)."""
    from torch.fx.experimental import proxy_tensor
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import mesh as mesh_mod

    def no_graph(*a, **k):
        raise RuntimeError("graph pass skipped")
    monkeypatch.setattr(proxy_tensor, "make_fx", no_graph)
    cfg = dataclasses.replace(get_config("llama3p2_3b", smoke=True),
                              num_layers=1)
    shape = ShapeSpec("train_small", 16, 48, "train")
    out = {}
    for n in (dryrun.MEMORY_MICROBATCHES, 3):
        monkeypatch.setattr(dryrun, "MEMORY_MICROBATCHES", n)
        with mesh_mod.fake_world(256, 0):
            mesh = mesh_mod.make_production_mesh(False, 0, device_type="cpu")
            traced, _, _ = dryrun.trace_lm_cell(cfg, shape, mesh,
                                                device="cpu")
        assert traced.error == "RuntimeError: graph pass skipped"
        out[n] = (traced.memory, traced.host_reads)
    short, whole = out.values()
    assert short == whole
    assert short[0]["peak"] > short[0]["args"] > 0
