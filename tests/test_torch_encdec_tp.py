"""Tensor-parallel placement of the encoder-decoder and patch families on
DTensor (Whisper's encoder, cross attention, `CrossKV` and learned
positions; InternVL2's patch rows), held to the one-device program; the
one-device program to the JAX package's mesh-free steps; and a bf16
Whisper's serving state and training step to JAX's type promotion of its
float32 frames.

One spawn of 4 gloo ranks on the CPU (`spawn_ranks`; rank functions in
`tests/test_torch_tp_ranks.py`) runs the placed prefill, two decode steps
and one float32 AdamW step of:

* the smoke Whisper on (data 2, model 2): its 4 heads split 2 a rank;
* a Whisper built like full width on (model 4): 3 heads of 16 cannot
  take `model`, nor can its 22 frames, so the encoder's attention runs
  whole on every rank (its MLP split over `model`), the decoder's
  attention splits its 24 query rows and the cross keys and values are
  made whole (a rank's 12 `wk` columns are narrower than a head);
* the smoke InternVL2 on (data 2, model 2): its 8 patch rows ahead of a
  24-token prompt make 32 rows, which a 28-wide cache keeps the last of,
  so the prefill's cache write wraps into rank 0's slots, as 33,024 rows
  do into a 32,768-wide cache at prefill_32k.

Tolerances are `tests/test_torch_moe_tp.py`'s: logits within atol = rtol
= 1e-5 (a row whose bf16 key or probability sits at a rounding edge
reported and held within 2^-7 of the logits' scale), the loss within
1e-6 relative, the updated parameters within 2e-6, and every state leaf
after the prefill and after each decode step (the float32 cross keys and
values within 1e-5 of their largest value, the bf16 caches within one
bf16 step), on every rank. The bf16 tests hold the port to JAX within
`tests/test_torch_ssm_tp.py`'s bf16 logits tolerance (2e-2) and
`tests/test_torch_lm_train.py`'s bf16 step tolerance (2e-2).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_config as jget_config  # noqa: E402
from repro.launch import specs as jspecs  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import mesh as mesh_mod  # noqa: E402
from repro_torch.launch import specs, steps  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.train import optimizer as opt_lib  # noqa: E402

import test_torch_moe_tp as moe_tp  # noqa: E402
import test_torch_tp_ranks as ranks  # noqa: E402

DM = ((2, 2), ("data", "model"))
M4 = ((4,), ("model",))
CASES = {
    "whisper-data2-model2": ("whisper_tiny", DM, 8, None),
    "whisper-heads3-model4": ("whisper_tiny", M4, 4, {
        "num_heads": 3, "num_kv_heads": 3, "d_model": 48,
        "encoder_frames": 22}),
    "internvl2-data2-model2": ("internvl2_26b", DM, 8, None),
}
ARCHS = ("whisper_tiny", "internvl2_26b")
BF16_TOL = 2e-2        # a bf16 program's logits, both packages
BF16_STEP_TOL = 2e-2   # a bf16-compute step's loss, grad norm, gradients
MAX_LEN = 32


def plan(case):
    arch, mesh, batch, change = CASES[case]
    return ranks.moe_plan(arch, mesh, batch=batch, change=change)


@pytest.fixture(scope="module")
def placed_runs():
    """Every case's placed run, in one spawn of 4 gloo ranks: {case:
    every rank's result}."""
    outs = mesh_mod.spawn_ranks(ranks.moe_rank, 4,
                                [plan(c) for c in CASES], backend="gloo",
                                timeout_s=600)
    return {c: [o[i] for o in outs] for i, c in enumerate(CASES)}


@pytest.fixture(scope="module", params=list(CASES))
def runs(request, placed_runs):
    """(case, one-device result, every rank's placed result)."""
    got = placed_runs[request.param]
    return (request.param, moe_tp.one_device_of(plan(request.param), got[0]),
            got)


def test_the_cases_straddle_the_layouts():
    """The meshes split what the module docstring says they split."""
    cfg = ranks.plan_config(plan("whisper-heads3-model4"))
    hd = cfg.resolved_head_dim
    assert cfg.num_heads % 4 and cfg.encoder_frames % 4
    assert plan("whisper-heads3-model4")["tokens"].shape[1] % 4 == 0
    assert cfg.num_kv_heads * hd // 4 < hd and cfg.d_ff % 4 == 0
    vlm = ranks.plan_config(plan("internvl2-data2-model2"))
    rows = vlm.patch_tokens + plan("internvl2-data2-model2")["tokens"].shape[1]
    assert rows > rows - vlm.patch_tokens + ranks.MAX_LEN_PAD


def test_placed_prefill_and_decode_logits_equal_one_device(runs):
    case, want, got = runs
    moe_tp.check_logits(case, want, got[0])


def test_placed_state_leaves_equal_one_device_by_field(runs):
    """Every leaf of the state after the prefill and after each decode
    step, `CrossKV` included, on every rank, whole."""
    case, want, got = runs
    kinds = [k for seg in want["state_kinds"] for k in seg]
    assert kinds == ["AttnCache"]
    crosses = [dt for dt in want["state_dtypes"] if dt == torch.float32]
    assert len(crosses) == (2 if case.startswith("whisper") else 0)
    for out in got:
        for name in ("state", "after"):
            g = [out[name]] if name == "state" else out[name]
            w = [want[name]] if name == "state" else want[name]
            for gs, ws in zip(g, w, strict=True):
                moe_tp.assert_state_close(gs, ws, want["state_dtypes"],
                                          f"{case} {name}")


def test_placed_train_step_equals_one_device(runs):
    case, want, got = runs
    moe_tp.check_train(case, plan(case), want, got)


@pytest.mark.parametrize("arch", ARCHS)
def test_one_device_equals_jax_mesh_free_steps(arch):
    """The one-device program's prefill logits and first loss against the
    JAX package's prefill step and `lm_loss`, jitted without a mesh, on
    the same parameters, frames and patches."""
    moe_tp.check_one_device_equals_jax(arch)


# ---------------------------------------------------------------------------
# bf16 Whisper: float32 frames promote as in the JAX package
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def whisper_bf16():
    """(port cfg, JAX cfg, JAX float32 params, port float32 params) of the
    smoke Whisper, and float32 frames and tokens, drawn once."""
    arch = "whisper_tiny"
    jc, cfg = jget_config(arch, smoke=True), get_config(arch, smoke=True)
    jp = jt.init_params(jc, jax.random.PRNGKey(0))
    p = convert.lm_params_from_numpy(cfg, jax.tree.map(np.asarray, jp),
                                     device="cpu")
    rng = np.random.default_rng(5)
    data = {"frames": (rng.standard_normal((2, cfg.encoder_frames,
                                            cfg.d_model)) * 0.05
                       ).astype(np.float32),
            "tokens": rng.integers(0, cfg.vocab_size, (2, 17),
                                   dtype=np.int32),
            "next": rng.integers(0, cfg.vocab_size, (2, 2), dtype=np.int32)}
    return cfg, jc, jp, p, data


def test_bf16_prefill_with_float32_frames_keeps_jax_dtypes(whisper_bf16):
    """A bf16 prefill with float32 frames, then two decode steps, through
    JAX's and the port's steps: the encoder and the cross keys and values
    run in float32 as JAX's promotion runs them, so every leaf of the
    port's state has the dtype and shape of JAX's `serve_state_spec`
    (float32 cross leaves), and the logits stay within a bf16 program's
    tolerance of JAX's."""
    cfg, jc, jp, p, data = whisper_bf16
    jpb = jax.tree.map(lambda v: v.astype(jnp.bfloat16), jp)
    pb = steps.cast_tree(p, torch.bfloat16)
    toks, frames = data["tokens"][:, :16], data["frames"]
    jlog, jstate = jax.jit(jsteps.make_prefill_step(jc, max_len=MAX_LEN))(
        jpb, {"tokens": jnp.asarray(toks), "frames": jnp.asarray(frames)})
    plog, pstate = steps.make_prefill_step(cfg, max_len=MAX_LEN)(
        pb, {"tokens": torch.from_numpy(toks),
             "frames": torch.from_numpy(frames)})
    jspec = jax.tree_util.tree_flatten_with_path(jsteps.serve_state_spec(
        jc, 2, MAX_LEN, jspecs.param_specs(jc, jnp.bfloat16)))[0]
    got = specs.state_leaves(pstate)
    assert len(got) == len(jspec)
    for (path, t), (_, jl) in zip(got, jspec):
        assert tuple(t.shape) in (tuple(jl.shape), (1, *jl.shape)), path
        assert str(t.dtype).replace("torch.", "") == str(jl.dtype), \
            (path, t.dtype, jl.dtype)
    assert [t.dtype for path, t in got if path.startswith("cross")] == \
        [torch.float32] * 2
    np.testing.assert_allclose(plog.float().numpy(),
                               np.asarray(jlog, np.float32),
                               atol=BF16_TOL, rtol=BF16_TOL)
    jdec = jax.jit(jsteps.make_decode_step(jc))
    pdec = steps.make_decode_step(cfg)
    for i in range(2):
        tok = data["next"][:, i:i + 1]
        jlog, jstate = jdec(jpb, jnp.asarray(tok), jstate)
        plog, pstate = pdec(pb, torch.from_numpy(tok), pstate)
        assert plog.dtype == torch.bfloat16
        np.testing.assert_allclose(plog.float().numpy(),
                                   np.asarray(jlog, np.float32),
                                   atol=BF16_TOL, rtol=BF16_TOL)


def test_bf16_train_step_runs_the_encoder_in_float32(whisper_bf16,
                                                     monkeypatch):
    """One bf16-compute step with float32 frames over float32 masters:
    the loss, the grad norm and every gradient leaf's norm of difference
    (one SGD(1.0) step without clipping moves each master by minus its
    gradient) within the bf16 step tolerance of JAX's `make_train_step`
    (relative to the leaf's norm, or to a hundredth of the largest leaf's
    where the leaf's is smaller), and the encoder's output float32 while
    the compute copy is bf16."""
    cfg, jc, jp, p, data = whisper_bf16
    batch = {"tokens": data["tokens"][:, :-1], "labels": data["tokens"][:, 1:],
             "frames": data["frames"]}
    jo = jopt.sgd(1.0)
    jnew, _, jm = jax.jit(jsteps.make_train_step(
        jc, jo, compute_dtype=jnp.bfloat16, clip_norm=0.0))(
            jp, jo.init(jp), {k: jnp.asarray(v) for k, v in batch.items()})
    seen = []
    run_encoder = transformer.run_encoder

    def tapped(cfg_, params, frames):
        out = run_encoder(cfg_, params, frames)
        seen.append((params.embed.dtype, out.dtype))
        return out
    monkeypatch.setattr(transformer, "run_encoder", tapped)
    po = opt_lib.sgd(1.0)
    new, _, pm = steps.make_train_step(
        cfg, po, compute_dtype=torch.bfloat16, clip_norm=0.0)(
            p, po.init(steps.tree_leaves(p)),
            {k: torch.from_numpy(v) for k, v in batch.items()})
    assert seen and set(seen) == {(torch.bfloat16, torch.float32)}
    for key in ("loss", "grad_norm"):
        assert float(pm[key]) == pytest.approx(float(jm[key]),
                                               rel=BF16_STEP_TOL), key
    old = convert.lm_params_to_numpy(cfg, p)
    want = jax.tree_util.tree_flatten_with_path(jax.tree.map(
        lambda a, b: np.asarray(a) - np.asarray(b), jax.tree.map(
            np.asarray, jp), jnew))[0]
    got = dict(jax.tree_util.tree_flatten_with_path(jax.tree.map(
        lambda a, b: a - b, old, convert.lm_params_to_numpy(cfg, new)))[0])
    assert len(got) == len(want)
    # the key biases' gradients are 0 in exact arithmetic (a softmax over
    # keys ignores what every key adds alike): bf16 noise on both sides,
    # held within the tolerance of a hundredth of the largest leaf's norm
    top = max(np.linalg.norm(w) for _, w in want)
    for path, w in want:
        err = np.linalg.norm(got[path] - w)
        bound = BF16_STEP_TOL * max(np.linalg.norm(w), 1e-2 * top)
        assert err <= bound, (jax.tree_util.keystr(path), err, bound)
