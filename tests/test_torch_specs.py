"""`repro_torch.launch.specs` and `transformer.param_shapes`/`param_logical`
against the JAX package's `launch/specs.py` for all ten archs.

Nothing is compiled: the JAX side is `ShapeDtypeStruct` trees and
`jax.eval_shape`, the port's meta and fake tensors. The JAX package
stacks a segment's layers on a leading axis where the port keeps a list,
so the JAX trees are unstacked here the way `repro_torch.convert` reads
them: a stacked leaf's shape is (L, *port shape) and its logical tuple
(None, *port logical). Resolved entries are held to JAX's `resolve` on
stand-in production meshes (16 x 16 and 2 x 16 x 16), as
`tests/test_torch_sharding.py` builds them.
"""
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
from repro_torch.configs import ARCH_IDS, SHAPES, get_config  # noqa: E402
from repro_torch.dist import sharding as sh  # noqa: E402
from repro_torch.launch import mesh as mesh_mod  # noqa: E402
from repro_torch.launch import specs, steps  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.train import optimizer as opt_lib  # noqa: E402

PRODUCTION = {"pod1": ((16, 16), ("data", "model")),
              "pod2": ((2, 16, 16), ("pod", "data", "model"))}


def meshes(pod):
    shape, axes = PRODUCTION[pod]
    jm = types.SimpleNamespace(axis_names=axes,
                               devices=np.empty(shape, dtype=object))
    return jm, mesh_mod.HostMesh(axes, shape)


def unstack(cfg, jtree, leaf):
    """The JAX parameter tree in the port's layout: `leaf(x, stacked)`
    maps each JAX leaf (stacked: it carries the layer axis) to a port
    leaf; a stacked segment becomes a list of its layers."""
    def node(n, li, stacked):
        if isinstance(n, dict):
            return {k: node(v, li, stacked) for k, v in n.items()}
        return leaf(n, li if stacked else None)

    def segs(trees, repeats):
        return [{name: [node(t[name], li, r > 1) for li in range(r)]
                 for name in t} for r, t in zip(repeats, trees, strict=True)]

    def plain(n):
        if isinstance(n, dict):
            return {k: plain(v) for k, v in n.items()}
        return leaf(n, None)

    out = {k: plain(v) for k, v in jtree.items()
           if k not in ("segments", "encoder")}
    out["segments"] = segs(jtree["segments"], [
        s.repeat for s in transformer.arch_segments(cfg)])
    if "encoder" in jtree:
        out["encoder"] = {
            "segments": segs(jtree["encoder"]["segments"],
                             [cfg.encoder_layers]),
            "final_norm": plain(jtree["encoder"]["final_norm"])}
    return out


def dtype_name(dt) -> str:
    return str(dt).replace("torch.", "") if isinstance(dt, torch.dtype) \
        else str(np.dtype(dt))


@pytest.fixture(scope="module", params=ARCH_IDS)
def arch(request):
    """(arch, port config, JAX config)."""
    return request.param, get_config(request.param), jget_config(
        request.param)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_param_specs_and_logical_equal_jax_leaf_for_leaf(arch, dtype):
    name, cfg, jcfg = arch
    jshapes = jtransformer.param_shapes(jcfg, dtype=getattr(jnp, dtype))
    want = unstack(cfg, jshapes, lambda s, li: (
        tuple(s.shape[1:] if li is not None else s.shape),
        dtype_name(s.dtype)))
    got = specs.map_tree(lambda t: (tuple(t.shape), dtype_name(t.dtype)),
                         specs.param_specs(cfg, getattr(torch, dtype)))
    assert got == want
    jlog = unstack(cfg, jtransformer.param_logical(jcfg),
                   lambda lg, li: tuple(lg[1:]) if li is not None
                   else tuple(lg))
    assert transformer.param_logical(cfg) == jlog
    assert all(t.device.type == "meta" for t in
               specs.tree_leaves(specs.param_specs(cfg)))


@pytest.mark.parametrize("pod", ["pod1", "pod2"])
def test_param_and_opt_entries_equal_jax_resolve(arch, pod):
    """Every parameter's resolved entry on the production mesh equals
    JAX's resolve of its (stacked) logical tuple on its (stacked) shape,
    the stacked layer axis taking none; the AdamW moments mirror them."""
    name, cfg, jcfg = arch
    jm, pm = meshes(pod)
    for rules, jrules in ((sh.TRAIN_RULES, jsh.TRAIN_RULES),
                          (sh.SERVE_RULES, jsh.SERVE_RULES)):
        jshapes = jtransformer.param_shapes(jcfg)
        jlog = jtransformer.param_logical(jcfg)
        resolved = jax.tree.map(
            lambda lg, s: tuple(jrules.resolve(lg, jm, shape=s.shape)),
            jlog, jshapes, is_leaf=lambda x: isinstance(x, tuple))
        want = unstack(cfg, resolved,
                       lambda e, li: e[1:] if li is not None else e)
        got = specs.param_shardings(cfg, pm, rules)
        assert got == want
    opt = specs.opt_shardings(cfg, opt_lib.adamw(1e-4), pm, sh.TRAIN_RULES)
    leaves = specs.tree_leaves(specs.param_shardings(cfg, pm,
                                                     sh.TRAIN_RULES))
    assert opt.step == () and list(opt.mu) == leaves == list(opt.nu)


def test_opt_specs_equal_jax_eval_shape(arch):
    """AdamW's state over the stand-ins: the step a 0-d int32, mu and nu
    leaf for leaf the parameters' shapes in float32, as JAX's
    `jax.eval_shape(optimizer.init)` gives them."""
    name, cfg, jcfg = arch
    jstate = jspecs.opt_specs(jopt.adamw(1e-4),
                              jspecs.param_specs(jcfg, jnp.bfloat16))
    state = specs.opt_specs(opt_lib.adamw(1e-4),
                            specs.param_specs(cfg, torch.bfloat16))
    assert tuple(state.step.shape) == tuple(jstate.step.shape) == ()
    assert dtype_name(state.step.dtype) == dtype_name(jstate.step.dtype)
    for jtree, leaves in ((jstate.mu, state.mu), (jstate.nu, state.nu)):
        want = unstack(cfg, jtree, lambda s, li: (
            tuple(s.shape[1:] if li is not None else s.shape),
            dtype_name(s.dtype)))
        # JAX rebuilds dicts with sorted keys: read them in the port's
        ordered = specs.map_tree(lambda _, w: w, specs.param_specs(cfg),
                                 want)
        assert [(tuple(t.shape), dtype_name(t.dtype)) for t in leaves] \
            == specs.tree_leaves(ordered)


@pytest.mark.parametrize("shape_name", list(SHAPES))
def test_input_specs_and_dp_degree_equal_jax(arch, shape_name):
    name, cfg, jcfg = arch
    shape, jshape = SHAPES[shape_name], JSHAPES[shape_name]
    want = {k: (tuple(v.shape), dtype_name(v.dtype))
            for k, v in jspecs.input_specs(jcfg, jshape).items()}
    got = {k: (tuple(v.shape), dtype_name(v.dtype))
           for k, v in specs.input_specs(cfg, shape).items()}
    assert got == want
    for pod in PRODUCTION:
        jm, pm = meshes(pod)
        assert specs.dp_degree(pm) == jspecs.dp_degree(jm)
        assert specs.microbatches_for(cfg, shape, pm) \
            == jspecs.microbatches_for(jcfg, jshape, jm)
        rules, jrules = ((sh.TRAIN_RULES, jsh.TRAIN_RULES)
                         if shape.kind == "train"
                         else (sh.SERVE_RULES, jsh.SERVE_RULES))
        jlog = {"tokens": ("batch", "seq"), "labels": ("batch", "seq"),
                "token": ("batch", None), "frames": ("batch", None, None),
                "patches": ("batch", None, None)}
        got = specs.input_shardings(cfg, shape, pm, rules)
        assert got == {k: tuple(jrules.resolve(jlog[k], jm,
                                               shape=want[k][0]))
                       for k in want}


@pytest.mark.parametrize("paged", [False, True])
def test_engine_input_specs_equal_jax(arch, paged):
    name, cfg, jcfg = arch
    kw = dict(paged=True, block_size=8, prefill_batch=3,
              max_len=100) if paged else {}
    want = {k: (tuple(v.shape), dtype_name(v.dtype)) for k, v in
            jspecs.engine_input_specs(jcfg, 64, 5, **kw).items()}
    got = {k: (tuple(v.shape), dtype_name(v.dtype)) for k, v in
           specs.engine_input_specs(cfg, 64, 5, **kw).items()}
    assert got == want
    assert specs.ENGINE_INPUT_LOGICAL == jspecs.ENGINE_INPUT_LOGICAL
    jm, pm = meshes("pod2")
    assert specs.engine_input_shardings(cfg, 64, 32, pm, sh.SERVE_RULES,
                                        **kw) == {
        k: tuple(jsh.SERVE_RULES.resolve(
            jspecs.ENGINE_INPUT_LOGICAL[k], jm, shape=v.shape))
        for k, v in jspecs.engine_input_specs(jcfg, 64, 32, **kw).items()}


class _Entry:
    """A resolved entry as an opaque pytree leaf."""

    def __init__(self, entry):
        self.entry = tuple(entry)


def test_serve_state_spec_and_cache_entries_equal_jax(arch, monkeypatch):
    """The state after a prefill of 64 positions at batch 32: every leaf
    of JAX's `serve_state_spec` in the port's (same shape, the port's
    one-layer segments stacked on an axis of 1), and each leaf's entries
    on both production meshes equal JAX's `cache_shardings`
    classification resolved there (its `named_sharding` reduced to the
    resolved entries, since a stand-in mesh places nothing)."""
    import jax.tree_util as jtu
    _, cfg, jcfg = arch
    jstate = jsteps.serve_state_spec(
        jcfg, 32, 64, jspecs.param_specs(jcfg, jnp.bfloat16))
    state = steps.serve_state_spec(cfg, 32, 64,
                                   specs.param_specs(cfg, torch.bfloat16))
    jleaves = jtu.tree_flatten_with_path(jstate)[0]
    got = specs.state_leaves(state)
    assert len(got) == len(jleaves)
    monkeypatch.setattr(jsh, "named_sharding",
                        lambda mesh, rules, log, shape=None: _Entry(
                            rules.resolve(log, mesh, shape=shape)))
    entries = {}
    for pod in PRODUCTION:
        jm, pm = meshes(pod)
        jent = [e.entry for e in jax.tree.leaves(jspecs.cache_shardings(
            jcfg, jstate, jm, jsh.SERVE_RULES))]
        ent = [e for _, e in specs.state_leaves(specs.cache_entries(
            cfg, state, pm, sh.SERVE_RULES))]
        assert len(jent) == len(ent) == len(got)
        entries[pod] = (jent, ent)
    for i, ((jpath, jl), (path, t)) in enumerate(zip(jleaves, got)):
        jshape = tuple(jl.shape)
        shape = tuple(t.shape)
        assert shape == jshape or shape == (1, *jshape), (path, jpath)
        assert dtype_name(t.dtype) == dtype_name(jl.dtype), \
            (path, t.dtype, jl.dtype)
        for pod, (jent, ent) in entries.items():
            assert ent[i] == jent[i] or ent[i] == (None, *jent[i]), \
                (pod, path, ent[i], jent[i])
