"""The port's step-atomic checkpoints (`train/checkpoint.py`) and the
ULEEN training state carried over from the JAX package
(`convert.uleen_train_state_from_numpy`), on the CPU.

The layout tests mirror the JAX package's battery
(`tests/test_fault_checkpoint.py`): keep-N pruning, empty and missing
directories, malformed entries ignored, None leaves, atomic under a
failed write. Round trips are exact (every leaf bit-equal, dtypes kept).
A checkpoint that the JAX package's `train_uleen` wrote restores into
the port, whose next step equals JAX's next step within
`test_torch_train`'s tolerances (loss rtol 1e-6 / atol 1e-6, accuracy
exact, tables and bias atol 1e-7, Adam's first moments atol 1e-8).
"""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import multi_shot as jms  # noqa: E402
from repro.core.model import compute_hashes as jcompute_hashes  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.launch.mesh import make_mesh as jmake_mesh  # noqa: E402
from repro.train import checkpoint as jcheckpoint  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import model, multi_shot  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.launch import uleen_cell  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.train import checkpoint  # noqa: E402
from repro_torch.train import optimizer as opt  # noqa: E402


def _tree(x=0.0):
    return {"w": torch.arange(6.0).reshape(2, 3) + x,
            "opt": (torch.zeros((4,), dtype=torch.int32), None)}


def _leaves_equal(a, b):
    la, lb = checkpoint.flatten(a), checkpoint.flatten(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        if x is None:
            assert y is None
            continue
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x, y)


def test_keep_pruning(tmp_path):
    d = str(tmp_path)
    for s in range(1, 6):
        checkpoint.save(d, s, _tree(s), keep=3)
    assert checkpoint.all_steps(d) == [3, 4, 5]
    assert checkpoint.latest_step(d) == 5
    assert not os.path.exists(os.path.join(d, "step_0000000001"))


def test_latest_step_empty_and_missing_dirs(tmp_path):
    assert checkpoint.latest_step(str(tmp_path)) is None
    assert checkpoint.latest_step(str(tmp_path / "never_made")) is None
    assert checkpoint.restore_latest(str(tmp_path), _tree()) == (None, None)


def test_corrupt_and_malformed_entries_are_ignored(tmp_path):
    d = str(tmp_path)
    checkpoint.save(d, 7, _tree())
    os.makedirs(os.path.join(d, "step_0000000009"))   # no DONE: torn write
    os.makedirs(os.path.join(d, "step_backup"))       # not a step at all
    os.makedirs(os.path.join(d, "step_12xy"))         # malformed digits
    (tmp_path / "step_note.txt").write_text("x")      # a stray file
    assert checkpoint.all_steps(d) == [7]
    assert checkpoint.latest_step(d) == 7


def test_none_leaves_round_trip(tmp_path):
    d = str(tmp_path)
    checkpoint.save(d, 1, _tree())
    out = checkpoint.restore(d, 1, _tree(5.0))
    assert out["opt"][1] is None
    assert torch.equal(out["w"], _tree()["w"])
    assert out["opt"][0].dtype == torch.int32
    with open(os.path.join(d, "step_0000000001", "tree.json")) as f:
        meta = json.load(f)
    # dicts flatten by sorted key: opt's two leaves, then w
    assert meta["num_leaves"] == 3 and meta["none_leaves"] == [1]
    assert meta["step"] == 1


def test_save_is_atomic_under_failure(tmp_path, monkeypatch):
    """A write that dies before the rename leaves no visible checkpoint
    and no stray temp dir poisoning `all_steps`."""
    d = str(tmp_path)
    checkpoint.save(d, 1, _tree())

    def boom(*a, **k):
        raise RuntimeError("disk full")
    monkeypatch.setattr(checkpoint.np.lib.format, "write_array", boom)
    with pytest.raises(RuntimeError):
        checkpoint.save(d, 2, _tree())
    monkeypatch.undo()
    assert checkpoint.all_steps(d) == [1]
    assert checkpoint.restore_latest(d, _tree())[1] == 1
    assert not [n for n in os.listdir(d) if n.startswith(".tmp_ckpt_")]


def test_leaf_count_mismatch_raises(tmp_path):
    checkpoint.save(str(tmp_path), 1, _tree())
    with pytest.raises(ValueError, match="leaves"):
        checkpoint.restore(str(tmp_path), 1, {"w": torch.zeros(2, 3)})


def test_uleen_state_round_trip(tmp_path):
    """(UleenParams, AdamState) with bf16 and float32 leaves: every leaf
    bit-equal, each on the dtype of `like`."""
    spec = uleen_cell.ULEEN_EXEC_SPEC
    gen = torch.Generator().manual_seed(3)
    params = model.init_params(gen, spec, init_scale=0.1, device="cpu")
    adam = opt.adam(1e-3)
    state = adam.init([*params.tables, params.bias])
    state = state._replace(step=state.step + 7, mu=tuple(
        torch.randn(m.shape, generator=gen) for m in state.mu))
    extra = torch.randn(5, generator=gen).to(torch.bfloat16)
    tree = (params, state, extra)
    checkpoint.save(str(tmp_path), 7, tree)
    like = (model.init_params(torch.Generator().manual_seed(4), spec,
                              device="cpu"),
            adam.init([*params.tables, params.bias]),
            torch.zeros(5, dtype=torch.bfloat16))
    out, at = checkpoint.restore_latest(str(tmp_path), like)
    assert at == 7
    assert isinstance(out[0], model.UleenParams)
    assert isinstance(out[1], opt.AdamState)
    _leaves_equal(out, tree)


def test_lm_param_tree_and_adamw_state_round_trip(tmp_path):
    cfg = get_config("llama3p2_3b", smoke=True)
    params = transformer.init_params(cfg, torch.Generator().manual_seed(0),
                                     device="cpu")
    adamw = opt.chain_clip(opt.adamw(1e-3), 1.0)
    step = steps.make_train_step(cfg, adamw, compute_dtype=None)
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 9)).astype(
        np.int32))
    new, state, _ = step(params, adamw.init(steps.tree_leaves(params)),
                         {"tokens": toks[:, :-1], "labels": toks[:, 1:]})
    checkpoint.save(str(tmp_path), 1, (new, state))
    like = (params, adamw.init(steps.tree_leaves(params)))
    (p, s), _ = checkpoint.restore_latest(str(tmp_path), like)
    assert isinstance(p, transformer.ParamTree)
    assert [n for n, _ in p.named_parameters()] == \
        [n for n, _ in new.named_parameters()]
    assert not any(x.requires_grad for x in p.parameters())
    _leaves_equal((p, s), (new, state))


def test_jax_uleen_checkpoint_continues_in_the_port(tmp_path):
    """JAX's `train_uleen` writes step 2; its arrays.npz crosses through
    `uleen_train_state_from_numpy`; one port step from it equals JAX's
    step from its own restore (the blocked step, grad_blocks 8, with
    JAX's per-block dropout masks through `keep=`)."""
    jspec, jstatics, jbits, jlabels = jtrain.uleen_smoke_problem(
        0, n_train=512)
    d = str(tmp_path / "jax")
    out = jtrain.train_uleen(jspec, jstatics, jbits, jlabels, steps_total=2,
                             global_batch=256, mesh=jmake_mesh(
                                 (1,), ("data",)), ckpt_dir=d, verbose=False)
    assert checkpoint.latest_step(d) == jcheckpoint.latest_step(d) == 2
    with np.load(os.path.join(d, "step_0000000002", "arrays.npz")) as z:
        leaves = [z[f"a{i}"] for i in range(len(z.files))]
    params, state = convert.uleen_train_state_from_numpy(leaves,
                                                         device="cpu")
    assert int(state.step) == 2
    jp, js = jcheckpoint.restore(d, 2, (out["params"], out["opt_state"]))

    blocks, batch = 8, 256
    idx = jtrain.uleen_batch_indices(0, 2, 512, batch)
    bits = np.asarray(jbits)[idx]
    labels = np.asarray(jlabels)[idx]
    rng = jax.random.fold_in(jax.random.PRNGKey(0), 2)
    keep = [[] for _ in jspec.submodels]
    for blk in range(blocks):
        r = jms.block_rng(rng, blk)
        for i, sm in enumerate(jspec.submodels):
            r, sub = jax.random.split(r)
            keep[i].append(np.asarray(jax.random.bernoulli(
                sub, 1.0 - jspec.dropout,
                (batch // blocks, jspec.num_classes,
                 jspec.num_filters(sm)))))
    jo = jopt.adam(1e-3)
    jstep = jax.jit(jms.make_train_step(jspec, jo, grad_blocks=blocks))
    jp2, js2, jloss, jacc = jstep(jp, js, jcompute_hashes(
        jspec, jstatics, jnp.asarray(bits)), jnp.asarray(labels), rng)

    spec = uleen_cell.ULEEN_EXEC_SPEC
    statics = convert.statics_from_numpy(
        [(np.asarray(s.perm), np.asarray(s.h3)) for s in jstatics],
        device="cpu")
    pstep = multi_shot.make_train_step(spec, opt.adam(1e-3),
                                       grad_blocks=blocks)
    p2, s2, loss, acc = pstep(
        params, state, model.compute_hashes(spec, statics, bits,
                                            device="cpu"),
        torch.from_numpy(labels.astype(np.int64)),
        keep=[torch.from_numpy(np.concatenate(k)) for k in keep])
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-6,
                               atol=1e-6)
    assert float(acc) == float(jacc)
    for a, b in zip((*p2.tables, p2.bias), (*jp2.tables, jp2.bias)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-7)
    for a, b in zip(s2.mu, (*js2.mu.tables, js2.mu.bias)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-8)
    assert int(s2.step) == int(js2.step) == 3


def test_uleen_state_from_numpy_checks_its_input():
    with pytest.raises(ValueError, match="6"):
        convert.uleen_train_state_from_numpy([np.zeros(3)] * 9,
                                             device="cpu")
    spec = uleen_cell.ULEEN_EXEC_SPEC
    p = model.init_params(torch.Generator().manual_seed(0), spec,
                          device="cpu")
    tables = [t.numpy() for t in p.tables]
    masks = [m.numpy() for m in p.masks]
    bias = p.bias.numpy()

    def moments(mask_value):
        return [*(np.zeros_like(t) for t in tables), np.zeros_like(bias),
                *(np.full_like(m, mask_value) for m in masks)]
    good = [*tables, bias, *masks, np.int32(4), *moments(0.0),
            *moments(0.0)]
    params, state = convert.uleen_train_state_from_numpy(good, device="cpu")
    assert int(state.step) == 4 and len(state.mu) == len(tables) + 1
    assert all(torch.equal(a, torch.from_numpy(b))
               for a, b in zip(params.tables, tables))
    bad = [*tables, bias, *masks, np.int32(4), *moments(1.0),
           *moments(0.0)]
    with pytest.raises(ValueError, match="masks"):
        convert.uleen_train_state_from_numpy(bad, device="cpu")
