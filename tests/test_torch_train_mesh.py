"""The LM entry points on a mesh: `launch.train.train(mesh=)` with its
placed AdamW state and logical checkpoints, and `launch.serve.serve(
mesh=, greedy=, rng=, temperature=)`, held to the one-process runs.

One spawn of 4 gloo ranks on the CPU runs every placed case (rank
functions in `tests/test_torch_train_mesh_ranks.py`): the smoke Llama
trained for 3 float32-compute steps of 2 microbatches on (data 2, model
2), with a checkpoint after step 2, and on (model 4); that checkpoint
resumed on (model 4); the smoke Whisper for 2 steps on (data 2, model 2)
(its frames placed by rows); and `serve(mesh=)` on (data 2, model 2),
greedy and sampled. The one-process runs are in this process, and the
step-2 checkpoint is resumed here too. Tolerances are those of
`tests/test_torch_tp.py`: each loss within 1e-6 relative of the
one-process loss (the float32 all-reduces' rounding), each parameter
within 2e-6.
"""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs.base import get_config as jget_config  # noqa: E402
from repro.dist import sharding as jsh  # noqa: E402
from repro.launch import specs as jspecs  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.dist import sharding as sh  # noqa: E402
from repro_torch.launch import mesh as mesh_mod  # noqa: E402
from repro_torch.launch import specs  # noqa: E402
from repro_torch.launch import train as train_mod  # noqa: E402

import test_torch_train_mesh_ranks as ranks  # noqa: E402
from test_torch_specs import unstack  # noqa: E402

LOSS_RTOL, PARAM_ATOL = 1e-6, 2e-6


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("train_mesh")
    return {k: str(root / k) for k in ("ckpt", "resume", "one", "here")}


@pytest.fixture(scope="module")
def placed_runs(dirs):
    """Every rank's results of every placed case, in one spawn."""
    return mesh_mod.spawn_ranks(ranks.mesh_rank, 4, dirs, backend="gloo",
                                timeout_s=300)


@pytest.fixture(scope="module")
def one_process(dirs):
    """The one-process runs: the smoke Llama (its step-2 checkpoint in
    dirs["one"]), the smoke Whisper and the serve runs."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)            # as the ranks run
    try:
        llama = train_mod.train(get_config("llama3p2_3b", smoke=True),
                                ckpt_dir=dirs["one"],
                                ckpt_every=ranks.CKPT_AT, **ranks.TRAIN)
        whisper = train_mod.train(get_config("whisper_tiny", smoke=True),
                                  **ranks.WHISPER_TRAIN)
        return {"llama": ranks.run_summary(llama, 0),
                "whisper": ranks.run_summary(whisper, 0),
                "serve": ranks.serve_runs(get_config("llama3p2_3b",
                                                     smoke=True))}
    finally:
        torch.set_num_threads(prev)


def assert_run_matches(got, want, *, steps=None):
    """`got`'s losses (of the steps it ran) and final parameters against
    the one-process run `want`."""
    by_step = {h["step"]: h for h in want["history"]}
    assert [h["step"] for h in got["history"]] == (
        steps or list(by_step))
    for h in got["history"]:
        w = by_step[h["step"]]["loss"]
        assert abs(h["loss"] - w) <= LOSS_RTOL * abs(w), h
    assert len(got["params"]) == len(want["params"])
    for i, (g, w) in enumerate(zip(got["params"], want["params"])):
        np.testing.assert_allclose(g, w, atol=PARAM_ATOL, rtol=0,
                                   err_msg=f"leaf {i}")


@pytest.mark.parametrize("case", ["llama/data2-model2", "llama/model4",
                                  "whisper/data2-model2"])
def test_placed_train_equals_one_process(placed_runs, one_process, case):
    """Every rank logs the same history (the metrics read whole), and the
    losses and final parameters are the one-process run's."""
    histories = [out[case]["history"] for out in placed_runs]
    assert all(h == histories[0] for h in histories)
    assert_run_matches(placed_runs[0][case],
                       one_process[case.split("/")[0]])


def test_checkpoint_resumes_on_another_mesh_and_in_one_process(
        placed_runs, one_process, dirs):
    """The (data 2, model 2) run's checkpoint after step 2 resumes on
    (model 4) and in this process, each to the unbroken run's last loss
    and parameters."""
    resumed = placed_runs[0]["llama/resume-model4"]
    assert resumed["resumed_from"] == ranks.CKPT_AT
    assert_run_matches(resumed, one_process["llama"], steps=[ranks.CKPT_AT])
    ranks.copy_checkpoint(dirs["ckpt"], dirs["here"], ranks.CKPT_AT)
    here = train_mod.train(get_config("llama3p2_3b", smoke=True),
                           ckpt_dir=dirs["here"], **ranks.TRAIN)
    assert here["resumed_from"] == ranks.CKPT_AT
    assert_run_matches(ranks.run_summary(here, 0), one_process["llama"],
                       steps=[ranks.CKPT_AT])


def test_placed_checkpoint_is_the_one_process_layout(placed_runs,
                                                     one_process, dirs):
    """The checkpoint the ranks wrote holds the leaves, shapes and dtypes
    (and tree metadata) of the one written in one process, with values
    within the tolerances."""
    del placed_runs, one_process
    name = f"step_{ranks.CKPT_AT:010d}"
    paths = [os.path.join(dirs[k], name) for k in ("ckpt", "one")]
    metas = []
    for p in paths:
        with open(os.path.join(p, "tree.json")) as f:
            metas.append({k: v for k, v in json.load(f).items()
                          if k != "time"})
    assert metas[0] == metas[1]
    with np.load(os.path.join(paths[0], "arrays.npz")) as got, \
            np.load(os.path.join(paths[1], "arrays.npz")) as want:
        assert sorted(got.files) == sorted(want.files)
        for k in want.files:
            assert got[k].shape == want[k].shape
            assert got[k].dtype == want[k].dtype
            np.testing.assert_allclose(got[k], want[k], atol=PARAM_ATOL,
                                       rtol=0, err_msg=k)


def jax_opt_placements(cfg, jcfg, shape, axes):
    """DTensor placements of JAX's `specs.opt_shardings` entries for AdamW
    on a (shape, axes) mesh under TRAIN_RULES: (step, mu leaves, nu
    leaves), the mu and nu trees unstacked into the port's leaf order."""
    jmesh = jax.sharding.Mesh(
        np.array(jax.devices()[:1] * int(np.prod(shape)),
                 dtype=object).reshape(shape), axes)
    state = jspecs.opt_shardings(jcfg, jopt.adamw(1e-4), jmesh,
                                 jsh.TRAIN_RULES)
    host = mesh_mod.HostMesh(axes, shape)

    def leaves(tree):
        port = unstack(cfg, tree, lambda s, li: tuple(
            s.spec[1:] if li is not None else s.spec))
        ordered = specs.map_tree(lambda _, w: w, specs.param_specs(cfg),
                                 port)
        return [[repr(p) for p in sh.placements(
            tuple(e) + (None,) * (len(t.shape) - len(e)), host)]
            for e, t in zip(specs.tree_leaves(ordered),
                            specs.tree_leaves(specs.param_specs(cfg)))]
    step = [repr(p) for p in sh.placements((), host)]
    return step, leaves(state.mu), leaves(state.nu)


@pytest.mark.parametrize("case", ["llama/data2-model2", "llama/model4"])
def test_adamw_moments_placed_as_jax_opt_shardings(placed_runs, case):
    """After the run (three updates), each moment is placed as its
    parameter and as JAX's `opt_shardings` entry places it; the step
    count is replicated."""
    got = placed_runs[0][case]["placements"]
    shape, axes = ranks.MESHES[case.split("/")[1]]
    step, mu, nu = jax_opt_placements(
        get_config("llama3p2_3b", smoke=True),
        jget_config("llama3p2_3b", smoke=True), shape, axes)
    assert got["mu"] == got["params"] == got["nu"]
    assert got["mu"] == mu and got["nu"] == nu
    assert got["step"] == step


def test_placed_serve_greedy_equals_one_process(placed_runs, one_process):
    want = one_process["serve"]["greedy"]
    for out in placed_runs:
        np.testing.assert_array_equal(out["serve"]["greedy"], want)


def test_sampled_serve_is_rank_equal_reproducible_and_cold_is_greedy(
        placed_runs, one_process):
    """`greedy=False`: the same generator seed gives the same tokens on
    every rank and on a rerun; at temperature 1e-6 they are the greedy
    tokens, placed and in one process."""
    first = placed_runs[0]["serve"]["sampled"][0]
    assert not np.array_equal(first, one_process["serve"]["greedy"])
    for out in placed_runs:
        for again in out["serve"]["sampled"]:
            np.testing.assert_array_equal(again, first)
        np.testing.assert_array_equal(out["serve"]["cold"],
                                      one_process["serve"]["greedy"])
    np.testing.assert_array_equal(one_process["serve"]["sampled"][0],
                                  one_process["serve"]["sampled"][1])
    np.testing.assert_array_equal(one_process["serve"]["cold"],
                                  one_process["serve"]["greedy"])


@pytest.mark.parametrize("env, found", [
    ({}, "no launcher (RANK, WORLD_SIZE, MASTER_ADDR unset)"),
    ({"RANK": "0", "WORLD_SIZE": "4", "MASTER_ADDR": "localhost"},
     "a world of 4 ranks"),
    ({"RANK": "3", "WORLD_SIZE": "256", "MASTER_ADDR": "localhost"}, None)])
def test_production_mesh_names_the_world_it_needs(env, found):
    """`--production-mesh` runs only as one of a launcher's 256 ranks;
    otherwise its message names the ranks it needs and those it found."""
    missing = train_mod.production_world_missing(env)
    if found is None:
        assert missing is None
    else:
        assert "needs 256 ranks" in missing and found in missing
