"""Tensor-parallel placement of the SSM and hybrid families on DTensor
(`models/ssm.py`'s and `models/rglru.py`'s `placed_mixer`, RecurrentGemma's
local MQA through `dist.placed`), held to the one-device program; the
one-device program to the JAX package's mesh-free steps; and the bf16
serving state's dtypes to JAX's.

One spawn of 4 gloo ranks on the CPU (`spawn_ranks`; rank functions in
`tests/test_torch_tp_ranks.py`) runs the placed prefill, two decode steps
and one float32 AdamW step of:

* the smoke Mamba 2 on (data 2, model 2) and on (model 4): its 8 heads
  split 4 or 2 a rank, while `in_proj`'s 296 columns (z 128 | x 128 |
  B 16 | C 16 | dt 8) split 148 or 74 a rank and the conv's 160
  channels (x | B | C) 80 or 40, across the parts' boundaries, as
  10,576 over 16 ranks does at full width;
* the smoke RecurrentGemma on (data 2, model 2): the RG-LRU's 64
  channels and the local MQA's 4 heads over `model`;
* a RecurrentGemma of 3 query heads on (model 4): the heads cannot take
  `model`, so the local layer splits its 24 query rows (`ctx`) and a
  rank's 12 `wq` columns are narrower than a 16-wide head, as 10 heads
  of 256 over 16 ranks are. Its window of 16 over the 24-token prompt
  makes the prefill's ring write wrap, and the ring's 16 positions split
  4 a rank at decode.

Tolerances are `tests/test_torch_moe_tp.py`'s: logits within atol = rtol
= 1e-5 (a row whose bf16 key or probability sits at a rounding edge
reported and held within 2^-7 of the logits' scale), the loss within
1e-6 relative, the updated parameters within 2e-6, and every state leaf
after the prefill and after each decode step (the conv windows and SSD
and RG-LRU states within 1e-5 of their largest value, the bf16 ring
within one bf16 step).
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
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import mesh as mesh_mod  # noqa: E402
from repro_torch.launch import specs, steps  # noqa: E402
from repro_torch.models import ssm, transformer  # noqa: E402

import test_torch_moe_tp as moe_tp  # noqa: E402
import test_torch_tp_ranks as ranks  # noqa: E402

DM = ((2, 2), ("data", "model"))
M4 = ((4,), ("model",))
CASES = {
    "mamba-data2-model2": ("mamba2_2p7b", DM, None),
    "mamba-model4": ("mamba2_2p7b", M4, None),
    "rg-data2-model2": ("recurrentgemma_2b", DM, None),
    "rg-heads3-model4": ("recurrentgemma_2b", M4, {"num_heads": 3}),
}
ARCHS = ("mamba2_2p7b", "recurrentgemma_2b")
BF16_TOL = 2e-2        # a bf16 program's logits, both packages
MAX_LEN = 32


def plan(case):
    arch, mesh, change = CASES[case]
    return ranks.moe_plan(arch, mesh, change=change)


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
    cfg = ranks.plan_config(plan("mamba-model4"))
    d_in = cfg.ssm_expand * cfg.d_model
    cols = 2 * d_in + 2 * cfg.ssm_state + d_in // cfg.ssm_head_dim
    assert cols == 296 and cols % 4 == 0 and (cols // 2) % 128 != 0
    assert (cols // 4) % 128 != 0 and (d_in + 2 * cfg.ssm_state) // 4 == 40
    rg = ranks.plan_config(plan("rg-heads3-model4"))
    assert rg.num_heads % 4 and rg.num_heads * rg.resolved_head_dim // 4 \
        < rg.resolved_head_dim
    assert rg.local_window < plan("rg-heads3-model4")["tokens"].shape[1]


def test_placed_prefill_and_decode_logits_equal_one_device(runs):
    case, want, got = runs
    moe_tp.check_logits(case, want, got[0])


def test_placed_state_leaves_equal_one_device_by_field(runs):
    """Every leaf of the state after the prefill and after each decode
    step, named: the SSD and RG-LRU states and the conv windows (float32
    here) within 1e-5 of their largest value, every rank's copy whole."""
    case, want, got = runs
    kinds = [k for seg in want["state_kinds"] for k in seg]
    assert set(kinds) >= ({"SSMState"} if case.startswith("mamba")
                          else {"RGState", "AttnCache"})
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
    the same parameters."""
    moe_tp.check_one_device_equals_jax(arch)


def test_ssd_scan_blocks_equal_one_block(monkeypatch):
    """The scan's chunks taken a few at a time (the placed prefill's
    blocks at full width) give the one-block result: 13 chunks in
    blocks of 2, one chunk a block, and one block."""
    rng = np.random.default_rng(0)
    b, s, h, p, g, n, q = 2, 100, 4, 8, 2, 8, 8
    x = torch.from_numpy(rng.standard_normal((b, s, h, p)).astype(np.float32))
    dt = torch.from_numpy(np.log1p(np.exp(rng.standard_normal((b, s, h))))
                          .astype(np.float32))
    a = -torch.from_numpy(np.exp(rng.standard_normal(h) * 0.5)
                          .astype(np.float32))
    bb, cc = (torch.from_numpy(rng.standard_normal((b, s, g, n))
                               .astype(np.float32)) for _ in range(2))
    d = torch.ones(h)
    want = ssm.ssd_scan(x, dt, a, bb, cc, d, chunk=q)
    for per in (2, 1):
        monkeypatch.setattr(ssm, "SCAN_BLOCK_ELEMS", per * b * h * q * q)
        got = ssm.ssd_scan(x, dt, a, bb, cc, d, chunk=q)
        for gt, wt in zip(got, want):
            np.testing.assert_allclose(gt.numpy(), wt.numpy(), atol=1e-6,
                                       rtol=1e-6)


def _bf16_models(arch):
    """JAX's smoke parameters in bf16 and the port's copy of them."""
    jc = jget_config(arch, smoke=True)
    cfg = get_config(arch, smoke=True)
    jp = jax.tree.map(lambda v: v.astype(jnp.bfloat16),
                      jt.init_params(jc, jax.random.PRNGKey(0)))
    p = steps.cast_tree(convert.lm_params_from_numpy(
        cfg, jax.tree.map(lambda v: np.asarray(v.astype(jnp.float32)), jp),
        device="cpu"), torch.bfloat16)
    return cfg, jc, p, jp


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_prefill_state_takes_the_step_dtype_as_jax(arch):
    """A bf16 prefill leaves the conv windows in bf16, as JAX's prefill
    returns the block's own window: every leaf's shape and dtype equal
    JAX's `serve_state_spec` (the port's one-layer segments stacked on an
    axis of 1), and the decode that reads them stays within a bf16
    program's tolerance of JAX's over two steps. The float32 serving
    state keeps float32 windows (`test_torch_ssm.py`,
    `test_torch_hybrid.py`)."""
    cfg, jc, p, jp = _bf16_models(arch)
    rng = np.random.default_rng(3)
    prompts = rng.integers(0, cfg.vocab_size, (2, 20), dtype=np.int32)
    jlog, jstate = jax.jit(lambda pp, t: jt.forward_prefill(
        jc, pp, t, max_len=MAX_LEN))(jp, jnp.asarray(prompts))
    plog, pstate = transformer.forward_prefill(
        cfg, p, torch.from_numpy(prompts), max_len=MAX_LEN)
    jspec = jax.tree_util.tree_flatten_with_path(jsteps.serve_state_spec(
        jc, 2, MAX_LEN, jspecs.param_specs(jc, jnp.bfloat16)))[0]
    got = specs.state_leaves(pstate)
    assert len(got) == len(jspec)
    for (path, t), (jpath, jl) in zip(got, jspec):
        assert tuple(t.shape) in (tuple(jl.shape), (1, *jl.shape)), path
        assert str(t.dtype).replace("torch.", "") == str(jl.dtype), \
            (path, t.dtype, jl.dtype)
    convs = [t for path, t in got if path.endswith(".conv")]
    assert convs and all(t.dtype == torch.bfloat16 for t in convs)
    np.testing.assert_allclose(plog.float().numpy(),
                               np.asarray(jlog, np.float32),
                               atol=BF16_TOL, rtol=BF16_TOL)
    jdec = jax.jit(lambda pp, t, st: jt.forward_decode(jc, pp, t, st))
    tok = rng.integers(0, cfg.vocab_size, (2, 1), dtype=np.int32)
    for _ in range(2):
        jlog, jstate = jdec(jp, jnp.asarray(tok), jstate)
        plog, pstate = transformer.forward_decode(cfg, p,
                                                  torch.from_numpy(tok),
                                                  pstate)
        np.testing.assert_allclose(plog.float().numpy(),
                                   np.asarray(jlog, np.float32),
                                   atol=BF16_TOL, rtol=BF16_TOL)
        tok = np.asarray(jnp.argmax(jlog[:, -1], -1))[:, None].astype(
            np.int32)
    assert all(t.dtype == torch.bfloat16 for path, t in
               specs.state_leaves(pstate) if path.endswith(".conv"))
