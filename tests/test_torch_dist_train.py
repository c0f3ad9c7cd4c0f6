"""The port's distributed ULEEN trainer (`launch/uleen_cell.py`,
`launch/train.py --arch uleen`) and the LM step's cross-pod reduction,
on the CPU, in gloo rank processes (`launch.mesh.spawn_ranks`, one spawn
per world size: every check of a world runs in one process group,
`test_torch_dist_ranks.py`).

The problem is the JAX package's `uleen_smoke_problem` (ULEEN_EXEC_SPEC,
1024 rows) carried across as numpy. Tolerances, with their reasons:

* exact — the distributed trainer on meshes (pod 2, data 4), (data 4)
  and one process against the port's single-device blocked step
  (`multi_shot.make_train_step(grad_blocks=8)` with the same
  `block_generator`s), every step's parameters and losses: the blocks
  are computed whole and folded in one fixed order, so nothing may
  differ; likewise every preempted, elastic and SIGTERM-killed run
  against the uninterrupted one;
* the port's blocked step against JAX's (`multi_shot.make_train_step(
  grad_blocks=8)`, JAX's `block_rng` masks passed through `keep=`), one
  step from JAX's state at each of 10 steps: `test_torch_train`'s
  tolerances (loss rtol 1e-6 / atol 1e-6, accuracy exact, tables and
  bias atol 1e-7, Adam's first moments atol 1e-8);
* int8 cross-pod compression: every step's parameters bit-equal to the
  compressed step's one-device emulation (`uleen_reference_params(
  compress_mesh=)`: every operation is deterministic), on (pod 2,
  data 4) and (pod 2, data 2); and max |Δparam| from the exact run <=
  lr·(t+1)·1.25 after step t (Adam's update is capped near lr; the 1.25
  covers the quantisation steering a few updates' signs), and nonzero;
* `collectives.all_reduce_sum` of float32 tensors on 4 ranks: the same
  bits on every rank, within 3 float32 eps of the sum of magnitudes of
  the float64 sum (three adds).
"""
import os
import shutil
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import model as jmodel  # noqa: E402
from repro.core import multi_shot as jms  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import model, multi_shot  # noqa: E402
from repro_torch.launch import mesh as mesh_mod  # noqa: E402
from repro_torch.launch import train as train_mod  # noqa: E402
from repro_torch.launch import uleen_cell  # noqa: E402
from repro_torch.train import checkpoint  # noqa: E402
from repro_torch.train import optimizer as opt  # noqa: E402

import test_torch_dist_ranks as ranks  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LR, BATCH, BLOCKS, STEPS = 1e-3, 256, 8, 10
LM_ARCH, LM_LR, LM_STEPS = "llama3p2_3b", 1e-3, 3
SPAWN_TIMEOUT_S = 240


@pytest.fixture(autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def jax_problem():
    return jtrain.uleen_smoke_problem(0, n_train=1024)


@pytest.fixture(scope="module")
def arrays(jax_problem):
    _, statics, bits, labels = jax_problem
    return {"statics": [(np.asarray(s.perm), np.asarray(s.h3))
                        for s in statics],
            "bits": np.asarray(bits).astype(np.int8),
            "labels": np.asarray(labels).astype(np.int64)}


@pytest.fixture(scope="module")
def problem(arrays):
    return ranks._problem(arrays)


def _reference(problem, steps):
    """The single-device blocked step's (params, loss) after each step."""
    spec, statics, bits, labels = problem
    optimizer = opt.adam(LR)
    params = model.init_params(torch.Generator().manual_seed(0), spec,
                               init_scale=0.1, device="cpu")
    state = optimizer.init([*params.tables, params.bias])
    step_fn = multi_shot.make_train_step(spec, optimizer,
                                         grad_blocks=BLOCKS)
    out = []
    for s in range(steps):
        idx = torch.from_numpy(train_mod.uleen_batch_indices(
            0, s, bits.shape[0], BATCH))
        h = model.compute_hashes(spec, statics, bits[idx], device="cpu")
        params, state, loss, _ = step_fn(
            params, state, h, labels[idx], block_generators=[
                multi_shot.block_generator(0, s, j, "cpu")
                for j in range(BLOCKS)])
        out.append((ranks.np_params(params), float(loss)))
    return out


@pytest.fixture(scope="module")
def reference(problem):
    return _reference(problem, STEPS)


def _lm_batch():
    rng = np.random.default_rng(3)
    from repro_torch.configs import get_config
    vocab = get_config(LM_ARCH, smoke=True).vocab_size
    toks = rng.integers(0, vocab, (4, 17)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _spawn(world, plan):
    return mesh_mod.spawn_ranks(ranks.dist_train_checks, world, plan,
                                backend="gloo", timeout_s=SPAWN_TIMEOUT_S)


@pytest.fixture(scope="module")
def ckpt_dirs(tmp_path_factory):
    base = tmp_path_factory.mktemp("dist_ckpt")
    return {"pre": str(base / "pre"), "elastic": str(base / "elastic")}


@pytest.fixture(scope="module")
def world8(arrays, ckpt_dirs):
    """8 ranks, mesh (pod 2, data 4): the exact and compressed runs, the
    preemption drill (rank 5's guard fires after step 2), and the first
    4 steps of the elastic drill."""
    m = ((2, 4), ("pod", "data"))
    runs = [("exact", *m, {"steps": STEPS}),
            ("compressed", *m, {"steps": STEPS, "compress": True}),
            ("preempted", *m, {"steps": 6, "ckpt": ckpt_dirs["pre"],
                               "preempt_at": 2, "preempt_rank": 5}),
            ("resumed", *m, {"steps": 6, "ckpt": ckpt_dirs["pre"]}),
            ("elastic", *m, {"steps": 4, "ckpt": ckpt_dirs["elastic"]})]
    return _spawn(8, {"uleen": {"problem": arrays, "runs": runs}})


@pytest.fixture(scope="module")
def world4(arrays, ckpt_dirs, world8):
    """4 ranks: mesh (data 4) exact, steps 4-7 of the elastic drill
    (after `world8`'s 0-3), the parity probe, the compressed run on
    (pod 2, data 2), the LM step on (pod 2, data 2), and float sums."""
    m = ((4,), ("data",))
    runs = [("exact", *m, {"steps": STEPS}),
            ("elastic", *m, {"steps": 8, "ckpt": ckpt_dirs["elastic"]}),
            ("probe", *m, {"probe": True}),
            ("compressed", (2, 2), ("pod", "data"),
             {"steps": STEPS, "compress": True})]
    lm = {"arch": LM_ARCH, "lr": LM_LR, "steps": LM_STEPS,
          "batch": _lm_batch(), "meshes": [((2, 2), ("pod", "data"))]}
    sums = {"meshes": [((4,), ("data",)), ((2, 2), ("pod", "data"))],
            "shapes": [(1000,), (37, 29), ()]}
    return _spawn(4, {"uleen": {"problem": arrays, "runs": runs},
                      "lm": lm, "sums": sums})


@pytest.fixture(scope="module")
def world2():
    """2 ranks: the LM step on (pod 2)."""
    lm = {"arch": LM_ARCH, "lr": LM_LR, "steps": LM_STEPS,
          "batch": _lm_batch(), "meshes": [((2,), ("pod",))]}
    return _spawn(2, {"lm": lm})


def _max_diff(a, b) -> float:
    return max(float(np.max(np.abs(x - y))) for x, y in zip(a, b))


def _assert_equal_every_step(snaps, losses, reference, what):
    assert len(snaps) == len(reference), what
    for s, (p, loss, (rp, rl)) in enumerate(zip(snaps, losses, reference)):
        assert _max_diff(p, rp) == 0.0, f"{what}: step {s} params differ"
        assert loss == rl, f"{what}: step {s} loss {loss} != {rl}"


# ---------------------------------------------------------------------------
# exact: every mesh equals the single-device blocked step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("world", [8, 4], ids=["pod2xdata4", "data4"])
def test_mesh_is_bit_equal_to_the_blocked_step_every_step(
        world, world8, world4, reference):
    outs = {8: world8, 4: world4}[world]
    run = outs[0]["uleen"]["exact"]
    _assert_equal_every_step(run["snaps"], run["losses"], reference,
                             f"{world} ranks")
    for r, o in enumerate(outs):
        assert _max_diff(o["uleen"]["exact"]["final"],
                         reference[-1][0]) == 0.0, f"rank {r}"
        assert o["uleen"]["exact"]["losses"] == run["losses"]


def test_one_process_is_bit_equal_to_the_blocked_step_every_step(
        problem, reference):
    out = ranks._run(problem, None, STEPS)
    _assert_equal_every_step(out["snaps"],
                             [h["loss"] for h in out["history"]],
                             reference, "one process")


def test_blocked_step_matches_jax_on_every_step(jax_problem, problem):
    """One port step from JAX's state at each of 10 steps of JAX's own
    blocked trajectory, with JAX's per-block dropout masks."""
    jspec, jstatics, jbits, jlabels = jax_problem
    spec, statics, _, _ = problem
    jo = jopt.adam(LR)
    jstep = jax.jit(jms.make_train_step(jspec, jo, grad_blocks=BLOCKS))
    jp = jmodel.init_params(jax.random.PRNGKey(0), jspec, init_scale=0.1)
    js = jo.init(jp)
    pstep = multi_shot.make_train_step(spec, opt.adam(LR),
                                       grad_blocks=BLOCKS)
    base = jax.random.PRNGKey(0)
    rows = BATCH // BLOCKS
    for s in range(STEPS):
        idx = train_mod.uleen_batch_indices(0, s, jbits.shape[0], BATCH)
        bits = np.asarray(jbits)[idx]
        jh = jmodel.compute_hashes(jspec, jstatics, jnp.asarray(bits))
        rng = jax.random.fold_in(base, s)
        keep = [[] for _ in jspec.submodels]
        for blk in range(BLOCKS):
            r = jms.block_rng(rng, blk)
            for i, sm in enumerate(jspec.submodels):
                r, sub = jax.random.split(r)
                keep[i].append(np.asarray(jax.random.bernoulli(
                    sub, 1.0 - jspec.dropout,
                    (rows, jspec.num_classes, jspec.num_filters(sm)))))
        params, state = convert.uleen_train_state_from_numpy(
            [np.asarray(x) for x in jax.tree.leaves((jp, js))],
            device="cpu")
        h = model.compute_hashes(spec, statics, bits, device="cpu")
        p, state, loss, acc = pstep(
            params, state, h, torch.from_numpy(np.asarray(jlabels)[idx]),
            keep=[torch.from_numpy(np.concatenate(k)) for k in keep])
        jp, js, jloss, jacc = jstep(jp, js, jh,
                                    jnp.asarray(np.asarray(jlabels)[idx]),
                                    rng)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-6,
                                   atol=1e-6, err_msg=f"step {s}")
        assert float(acc) == float(jacc), s
        for a, b in zip((*p.tables, p.bias), (*jp.tables, jp.bias)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                       atol=1e-7, err_msg=f"step {s}")
        for a, b in zip(state.mu, (*js.mu.tables, js.mu.bias)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                       atol=1e-8, err_msg=f"step {s}")


# ---------------------------------------------------------------------------
# compression, preemption, elasticity
# ---------------------------------------------------------------------------

def test_compressed_run_stays_within_the_adam_bound(world8, reference):
    run = world8[0]["uleen"]["compressed"]
    diverged = False
    for t, (p, (rp, _)) in enumerate(zip(run["snaps"], reference)):
        d = _max_diff(p, rp)
        bound = LR * (t + 1) * 1.25
        assert d <= bound, f"step {t}: divergence {d} > bound {bound}"
        diverged = diverged or d > 0.0
    assert diverged, "compression produced zero divergence"
    assert all(np.isfinite(run["losses"]))
    for o in world8:
        assert _max_diff(o["uleen"]["compressed"]["final"],
                         run["snaps"][-1]) == 0.0


@pytest.mark.parametrize("world", [8, 4], ids=["pod2xdata4", "pod2xdata2"])
def test_compressed_run_is_bit_equal_to_its_emulation(world, world8, world4,
                                                      problem):
    """The compressed run against `uleen_reference_params(compress_mesh=)`
    on one device (the ranks' block sums added in data order x npods/S,
    one shared int8 scale, an int32 sum, x scale/npods): every step's
    parameters bit-equal, on every rank at the end."""
    outs = {8: world8, 4: world4}[world]
    shape = {8: (2, 4), 4: (2, 2)}[world]
    spec, statics, bits, labels = problem
    ref = train_mod.uleen_reference_params(
        spec, statics, bits, labels, steps=STEPS, global_batch=BATCH,
        lr=LR, grad_blocks=BLOCKS, compress_mesh=(shape, ("pod", "data")),
        device="cpu")
    run = outs[0]["uleen"]["compressed"]
    assert len(run["snaps"]) == STEPS
    for t, (p, r) in enumerate(zip(run["snaps"], ref)):
        assert _max_diff(p, ranks.np_params(r)) == 0.0, f"step {t}"
    for o in outs:
        assert _max_diff(o["uleen"]["compressed"]["final"],
                         ranks.np_params(ref[-1])) == 0.0


def test_float_all_reduce_gives_every_rank_the_same_bits(world4):
    """`collectives.all_reduce_sum` of each rank's float32 draws (values
    spread over 12 decades, so the order of the adds shows in the bits),
    over (data 4) and over both axes of (pod 2, data 2)."""
    for tag, got in world4[0]["sums"].items():
        for i, x in enumerate(got["sum"]):
            parts = np.stack(got["inputs"][i]).astype(np.float64)
            # three float32 adds: at most 3 eps of the sum of magnitudes
            bound = 3 * np.finfo(np.float32).eps * np.sum(np.abs(parts), 0)
            assert np.all(np.abs(x - parts.sum(0)) <= bound), f"{tag} {i}"
            for o in world4[1:]:
                assert o["sums"][tag]["sum"][i].tobytes() == x.tobytes(), \
                    f"{tag} leaf {i}"


def test_preempted_run_resumes_identically(world8, reference):
    """Rank 5's guard fires after step 2: every rank stops after step 2,
    rank 0 checkpoints step 3, and the restart reaches the uninterrupted
    run's parameters after step 5."""
    for o in world8:
        pre, res = o["uleen"]["preempted"], o["uleen"]["resumed"]
        assert pre["preempted"] and len(pre["losses"]) == 3
        assert pre["ckpt_latest"] == 3
        assert res["resumed_from"] == 3 and not res["preempted"]
        assert _max_diff(res["final"], reference[5][0]) == 0.0


def test_elastic_restore_8_to_4_to_1(world8, world4, problem, ckpt_dirs,
                                     reference):
    assert world8[0]["uleen"]["elastic"]["ckpt_latest"] == 4
    mid = world4[0]["uleen"]["elastic"]
    assert mid["resumed_from"] == 4 and mid["ckpt_latest"] == 8
    fin = ranks._run(problem, None, STEPS, ckpt_dir=ckpt_dirs["elastic"])
    assert fin["resumed_from"] == 8
    assert _max_diff(ranks.np_params(fin["params"]),
                     reference[-1][0]) == 0.0


def test_parity_probe_is_zero(world4):
    assert all(o["uleen"]["probe"] == 0.0 for o in world4)
    assert train_mod.uleen_parity_probe(device="cpu") == 0.0


def test_value_errors():
    stand_in = mesh_mod.HostMesh(("pod", "data"), (2, 4))
    with pytest.raises(ValueError, match="grad_blocks"):
        uleen_cell.make_uleen_dist_train_step(
            uleen_cell.ULEEN_EXEC_SPEC, opt.adam(LR), stand_in,
            grad_blocks=3)
    with pytest.raises(ValueError, match="pod"):
        uleen_cell.make_uleen_dist_train_step(
            uleen_cell.ULEEN_EXEC_SPEC, opt.adam(LR),
            mesh_mod.make_host_mesh(("data",)), grad_blocks=8,
            compress=True)
    with pytest.raises(ValueError, match="pod"):
        train_mod.compressed_grads([[torch.zeros(2)]] * 2, (2,), ("data",))


def test_block_generator_is_a_function_of_seed_step_and_block():
    def draw(*args):
        return torch.rand(8, generator=multi_shot.block_generator(
            *args, device="cpu"))
    assert torch.equal(draw(0, 3, 5), draw(0, 3, 5))
    others = [draw(1, 3, 5), draw(0, 4, 5), draw(0, 3, 6)]
    assert not any(torch.equal(draw(0, 3, 5), o) for o in others)


def test_uleen_train_step_lowers_the_loss(problem):
    spec, statics, bits, labels = problem
    optimizer = opt.adam(1e-2)
    step = uleen_cell.make_uleen_train_step(spec, optimizer)
    params = model.init_params(torch.Generator().manual_seed(0), spec,
                               init_scale=0.1, device="cpu")
    state = optimizer.init([*params.tables, params.bias])
    gen = torch.Generator().manual_seed(0)
    losses = []
    for _ in range(8):
        params, state, loss = step(params, state, statics, bits[:256],
                                   labels[:256], gen)
        losses.append(float(loss))
    assert losses[-1] < losses[0]


def test_sigterm_subprocess_drill(tmp_path):
    """`--arch uleen --mesh pod=1,data=2` killed with SIGTERM mid-run:
    the launcher forwards it, both ranks stop after the same step, rank 0
    checkpoints, the launcher exits 0; the relaunch resumes and its final
    checkpoint equals an uninterrupted in-process run's parameters."""
    d = str(tmp_path / "ckpt")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(REPO, "src"), env.get("PYTHONPATH", "")])
    env["OMP_NUM_THREADS"] = "1"
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
           "uleen", "--mesh", "pod=1,data=2", "--steps", "8", "--batch",
           str(BATCH), "--ckpt-dir", d, "--ckpt-every", "100", "--seed",
           "0", "--device", "cpu"]
    proc = subprocess.Popen(cmd + ["--step-delay", "0.5"],
                            stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, env=env)
    try:
        deadline = time.time() + 200
        saw_step = False
        for line in proc.stdout:
            if "[train] step 0" in line:
                saw_step = True
                break
            if time.time() > deadline:
                break
        assert saw_step, "the trainer never reached step 0"
        proc.send_signal(signal.SIGTERM)
        rest = proc.stdout.read()
        assert proc.wait(timeout=200) == 0, f"dirty exit:\n{rest}"
    finally:
        if proc.poll() is None:
            proc.kill()
    assert "preempted" in rest
    killed_at = checkpoint.latest_step(d)
    assert killed_at is not None and 0 < killed_at < 8

    resumed = subprocess.run(cmd, capture_output=True, text=True, env=env,
                             timeout=200)
    assert resumed.returncode == 0, resumed.stdout + resumed.stderr
    assert f"restored step {killed_at}" in resumed.stdout
    assert checkpoint.latest_step(d) == 8

    spec, statics, bits, labels = train_mod.uleen_smoke_problem(
        0, device="cpu")
    full = train_mod.train_uleen(spec, statics, bits, labels, steps_total=8,
                                 global_batch=BATCH, verbose=False,
                                 device="cpu")
    like = (full["params"], full["opt_state"])
    ck_params, _ = checkpoint.restore(d, 8, like)
    assert train_mod.max_param_diff(full["params"], ck_params) == 0.0


# ---------------------------------------------------------------------------
# LM: restart through --ckpt-dir, the cross-pod step
# ---------------------------------------------------------------------------

def test_lm_restart_through_ckpt_dir_is_bit_equal(tmp_path):
    """An unbroken 4-step run (checkpoints at 2 and 4) against a run
    restarted from its step-2 checkpoint alone: the step-4 checkpoints
    hold the same bits."""
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    argv = ["--arch", LM_ARCH, "--smoke", "--steps", "4", "--batch", "2",
            "--seq", "16", "--device", "cpu", "--ckpt-every", "2"]
    assert train_mod.main(argv + ["--ckpt-dir", a]) == 0
    assert checkpoint.all_steps(a) == [2, 4]
    os.makedirs(b)
    shutil.copytree(os.path.join(a, "step_0000000002"),
                    os.path.join(b, "step_0000000002"))
    assert train_mod.main(argv + ["--ckpt-dir", b]) == 0
    assert checkpoint.all_steps(b) == [2, 4]
    with np.load(os.path.join(a, "step_0000000004", "arrays.npz")) as za, \
            np.load(os.path.join(b, "step_0000000004", "arrays.npz")) as zb:
        assert za.files == zb.files
        for k in za.files:
            np.testing.assert_array_equal(za[k], zb[k], err_msg=k)


def _lm_steps(rows, optimizer, steps_n, **kw):
    """The single-process step on `rows` of the batch: params after each
    of `steps_n` steps and the losses."""
    from repro_torch.configs import get_config
    from repro_torch.launch import steps
    from repro_torch.models import transformer
    cfg = get_config(LM_ARCH, smoke=True)
    params = transformer.init_params(cfg, torch.Generator().manual_seed(0),
                                     device="cpu")
    step = steps.make_train_step(cfg, optimizer, compute_dtype=None, **kw)
    state = optimizer.init(steps.tree_leaves(params))
    batch = {k: torch.from_numpy(v[rows]) for k, v in _lm_batch().items()}
    p0 = [p.numpy().copy() for p in steps.tree_leaves(params)]
    out = []
    for _ in range(steps_n):
        params, state, m = step(params, state, batch)
        out.append(([p.numpy().copy() for p in steps.tree_leaves(params)],
                    float(m["loss"])))
    return p0, out


@pytest.mark.parametrize("world", [2, 4], ids=["pod2", "pod2xdata2"])
def test_lm_cross_pod_step_within_the_adam_bound(world, world2, world4):
    """`make_train_step(cross_pod_mesh=)` on every rank's rows against the
    single-process step on the whole batch.

    Its reduced gradient (minus one SGD(1.0) step's update) is the mean
    of the pods' gradients within `quantization_bound` of each leaf's
    pod gradients (+1e-7 for reading a gradient off a float32 update).
    AdamW: within 2·1.01·lr·(t+1) after step t — each run's update of an
    entry is at most lr·|m̂|/√v̂ <= 1.01·lr at these first steps (Cauchy-
    Schwarz over the moments' weights), and a quantised gradient may
    flip an entry's sign. The first loss (same weights on both sides)
    within rel 1e-5; every rank's weights equal."""
    from repro_torch.train import compression
    outs = {2: world2, 4: world4}[world]
    (tag, got), = outs[0]["lm"].items()
    npods, rows = 2, 4
    per_pod = []
    for k in range(npods):
        sl = slice(k * rows // npods, (k + 1) * rows // npods)
        p0, ((p1, _),) = _lm_steps(sl, opt.sgd(1.0), 1, clip_norm=0.0)
        per_pod.append([b - a for a, b in zip(p0, p1)])
    for i, upd in enumerate(got["sgd_update"]):
        pods = [np.asarray(u[i], np.float64) for u in per_pod]
        bound = compression.quantization_bound(
            [torch.from_numpy(np.stack(pods))]) + 1e-7
        err = float(np.max(np.abs(upd - np.mean(pods, axis=0))))
        assert err <= bound, f"{tag} leaf {i}: {err} > {bound}"

    _, ref = _lm_steps(slice(None), opt.chain_clip(opt.adamw(LM_LR), 1.0),
                       LM_STEPS)
    for t, (p, loss, (rp, rl)) in enumerate(zip(got["adam"], got["losses"],
                                                ref)):
        d = _max_diff(p, rp)
        assert d <= 2 * 1.01 * LM_LR * (t + 1), f"{tag} step {t}: {d}"
        assert np.isfinite(loss)
        if t == 0:          # from the same weights
            assert loss == pytest.approx(rl, rel=1e-5, abs=1e-6)
    for o in outs:
        assert _max_diff(o["lm"][tag]["adam"][-1], got["adam"][-1]) == 0.0
