"""Tensor- and expert-parallel placement of the MoE family on DTensor
(`models/moe.py`'s placed block, MLA and the banded window through
`dist.placed`), held to the one-device program, and the one-device
program to the JAX package's mesh-free steps.

One spawn of 4 gloo ranks on the CPU (`spawn_ranks`; rank functions in
`tests/test_torch_tp_ranks.py`) runs the placed prefill, two decode steps
and one float32 AdamW step of the smoke configs of Mixtral 8x7B (4
experts whose hidden dim splits over `model`, a window of 16 over a
24-token prompt: the prefill's ring write wraps) and DeepSeek-V2-Lite (a
dense layer, then MoE with 8 experts split over `model` and a shared
expert, MLA) on (data 2, model 2) and (model 4). With 8 rows of 24
tokens the MoE group (192 tokens at prefill, 8 at decode) spans the two
`data` ranks: each rank routes the group from its gathered choices. With
4 rows of 256 tokens each `data` rank's rows are one whole group, which
it routes alone. Every routing's capacity, choices and kept choices are
recorded on both sides (`run_tapped`).

Tolerances, as `test_torch_tp.py`'s: logits within atol = rtol = 1e-5,
the loss within 1e-6 relative, the updated parameters within 2e-6. The
states the two programs leave, after the prefill and after each decode
step, are held leaf by leaf: a bf16 cache within one bf16 step plus
STATE_ATOL (a key near zero whose float32 noise rounds to another bf16
value), a float32 one (MLA's latent) within F32_STATE_RTOL of its
largest value (the float32 noise of the placed sums), an integer one
exactly. A decode step runs from the placed run's state before it, so
each step's writes are checked where they land, in the prefill and in
every decode step: a write to another slot or rank, or one that is
missing, leaves a whole key where the other program has another key or
zeros. Two roundings are discontinuous, and each is checked where it
can flip: a decode step writes its new key (or latent rotary key) into
a bf16 cache and the GQA decode rounds its probabilities to that dtype,
so a row whose new key the two programs round apart (at the step's one
write position, which is asserted), or whose one-device probability
lies within FLIP_ULPS float32 ulps of a bf16 rounding edge, is reported
with its margin and held within 2^-7 of the logits' scale instead; at
most half of a step's rows may take that bound. And Adam's first step
moves an entry by lr·g/(|g| + eps), so an entry whose one-device update
is neither saturated nor zero (|g| between ~eps/1000 and ~1000 eps) is
held within 2·lr, the most a step moves it, and counted: at most
ADAM_SENSITIVE_MAX of all entries may be such.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_config as jget_config  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import mesh as mesh_mod  # noqa: E402
from repro_torch.models import transformer  # noqa: E402

import test_torch_tp_ranks as ranks  # noqa: E402

DM = ((2, 2), ("data", "model"))
M4 = ((4,), ("model",))
CASES = {
    "mixtral-data2-model2": ("mixtral_8x7b", DM, 8, 24),
    "mixtral-model4": ("mixtral_8x7b", M4, 8, 24),
    "mixtral-whole-groups": ("mixtral_8x7b", DM, 4, 256),
    "deepseek-data2-model2": ("deepseek_v2_lite_16b", DM, 8, 24),
    "deepseek-model4": ("deepseek_v2_lite_16b", M4, 8, 24),
    "deepseek-whole-groups": ("deepseek_v2_lite_16b", DM, 4, 256),
}
SPANNING = ("mixtral-data2-model2", "deepseek-data2-model2")
FLIP_ULPS = 64          # float32 ulps from a bf16 rounding edge
STATE_ATOL = 1e-6       # the caches' float32 noise before bf16
F32_STATE_RTOL = 1e-5   # a float32 state leaf, of its largest value
ADAM_SENSITIVE_MAX = 0.2  # of all entries (0.035 to 0.119 in these runs)
ADAM_SATURATED = 0.999  # |g| / (|g| + eps) of an update insensitive to g


def plan(case):
    arch, mesh, b, s = CASES[case]
    return ranks.moe_plan(arch, mesh, batch=b, seq=s)


@pytest.fixture(scope="module")
def placed_runs():
    """Every case's placed run, in one spawn of 4 gloo ranks: {case:
    every rank's result}."""
    outs = mesh_mod.spawn_ranks(ranks.moe_rank, 4,
                                [plan(c) for c in CASES], backend="gloo",
                                timeout_s=600)
    return {c: [o[i] for o in outs] for i, c in enumerate(CASES)}


def _bf16_edge_ulps(p: torch.Tensor) -> torch.Tensor:
    """Float32 ulps of each value from the nearest bf16 rounding edge
    (the midpoint of two bf16 neighbours)."""
    low = p.float().contiguous().view(torch.int32) & 0xFFFF
    return (low - 0x8000).abs()


def one_device(case, got):
    """`one_device_of` the case's plan."""
    return one_device_of(plan(case), got)


def one_device_of(p, got):
    """The one-device run of plan `p` from the placed run's decode states,
    with each decode step's rows' smallest distance (in float32 ulps) of
    a GQA decode probability from a bf16 rounding edge."""
    torch.set_num_threads(1)
    edges = []
    decode = transformer.decode_attention

    def tapped(q, k, v, *, kv_len, window=0, scale=None):
        b, hq, _, d = q.shape
        hkv = k.shape[1]
        s = torch.matmul(q.reshape(b, hkv, hq // hkv, d).float(),
                         k.float().transpose(-1, -2)) * (
                             scale if scale is not None else d ** -0.5)
        mask = torch.arange(k.shape[2])[None] < kv_len[:, None]
        p = torch.softmax(s.masked_fill(~mask[:, None, None], -1e30), -1)
        edges.append(_bf16_edge_ulps(p).reshape(b, -1).min(1).values)
        return decode(q, k, v, kv_len=kv_len, window=window, scale=scale)
    transformer.decode_attention = tapped
    try:
        want = ranks.run_tapped(p, decode_states=got["states"])
    finally:
        transformer.decode_attention = decode
    steps = len(got["states"])
    per = len(edges) // steps
    b = got["decode0"].shape[0]
    want["edge_ulps"] = [
        torch.stack(edges[i * per:(i + 1) * per]).min(0).values.numpy()
        if per else np.full(b, np.iinfo(np.int32).max) for i in range(steps)]
    return want


def assert_state_close(got, want, dtypes, what):
    """Every leaf of two programs' states, by its dtype (the module
    docstring's tolerances)."""
    for i, (g, w, dt) in enumerate(zip(got, want, dtypes, strict=True)):
        if dt == torch.bfloat16:
            ok = np.abs(g - w) <= np.abs(w) * 2.0 ** -7 + STATE_ATOL
        elif dt.is_floating_point:
            ok = np.abs(g - w) <= F32_STATE_RTOL * np.abs(w).max()
        else:
            ok = g == w
        assert np.all(ok), (what, i, dt, np.argwhere(~ok)[:4])


def rounded_apart(got, want, dtypes):
    """The batch rows (dim 1 of the stacked caches) whose new key a decode
    step wrote as another bf16 neighbour in the two programs. A row's
    keys may differ at the step's one write position only."""
    rows = np.False_
    for i, (g, w, dt) in enumerate(zip(got, want, dtypes, strict=True)):
        if dt != torch.bfloat16 or g.ndim < 3:
            continue
        # (L, B, ..., W, d) -> (B, W): the positions a row differs at
        at = np.moveaxis((g != w).any(-1), 1, 0)
        at = at.reshape(at.shape[0], -1, at.shape[-1]).any(1)
        assert np.all(at.sum(-1) <= 1), f"leaf {i}: a row differs at " \
            f"positions {[np.flatnonzero(r).tolist() for r in at]}"
        rows = rows | at.any(-1)
    return rows


@pytest.fixture(scope="module", params=list(CASES))
def runs(request, placed_runs):
    """(case, one-device result, every rank's placed result)."""
    got = placed_runs[request.param]
    return request.param, one_device(request.param, got[0]), got


def test_placed_prefill_and_decode_logits_equal_one_device(runs):
    case, want, got = runs
    check_logits(case, want, got[0])


def check_logits(case, want, got):
    """The placed run's prefill and decode logits and every state leaf
    against one device's (the module docstring's tolerances)."""
    dtypes = want["state_dtypes"]
    assert_state_close(got["state"], want["state"], dtypes, "prefill state")
    np.testing.assert_allclose(got["prefill"], want["prefill"], atol=1e-5,
                               rtol=1e-5)
    for i, edge in enumerate(want["edge_ulps"]):
        key = f"decode{i}"
        assert_state_close(got["after"][i], want["after"][i], dtypes,
                           f"state after {key}")
        rewritten = rounded_apart(got["after"][i], want["after"][i], dtypes)
        exact = (edge >= FLIP_ULPS) & ~rewritten
        np.testing.assert_allclose(got[key][exact], want[key][exact],
                                   atol=1e-5, rtol=1e-5, err_msg=key)
        if not exact.all():
            # a probability at a bf16 rounding edge, or a new key rounded
            # to the other bf16 neighbour: one bf16 step of one value,
            # carried through the later layers
            gap = np.abs(got[key][~exact] - want[key][~exact]).max()
            print(f"{case} {key}: rows {np.flatnonzero(~exact).tolist()}, "
                  f"{edge[~exact].tolist()} ulps from a bf16 rounding edge, "
                  f"new key rounded apart {rewritten[~exact].tolist()}, "
                  f"logits {gap:.3g} apart")
            assert (~exact).sum() <= exact.size // 2, key
            assert gap <= 2.0 ** -7 * np.abs(want[key]).max()


def test_placed_routing_equals_one_device(runs):
    """Every routing of the run (prefill, decode, train) has one device's
    capacity, choices and kept choices on every rank: where the rank
    routes whole groups of its own, its groups are one device's groups
    in its rows; where the group spans the batch shards, the whole
    group."""
    case, want, got = runs
    arch, mesh, b, s = CASES[case]
    data = dict(zip(mesh[1], mesh[0])).get("data", 1)
    for r, out in enumerate(got):
        assert len(out["taps"]) == len(want["taps"])
        for i, (g, w) in enumerate(zip(out["taps"], want["taps"])):
            assert g["cap"] == w["cap"], (r, i)
            gs = g["idx"].shape[0]
            first = (r // (4 // data)) * gs if gs < w["idx"].shape[0] else 0
            np.testing.assert_array_equal(g["idx"], w["idx"][first:first + gs])
            np.testing.assert_array_equal(g["keep"],
                                          w["keep"][first:first + gs])


@pytest.mark.parametrize("case", SPANNING)
def test_decode_group_spanning_data_keeps_one_device_capacity(placed_runs,
                                                              case):
    """The decode batch is one group of 8 tokens over the two `data`
    ranks: each rank routes all 8 (4 of them another rank's) with the
    group's capacity, which routing a rank's 4 tokens as a group would
    not give."""
    arch, _, b, _ = CASES[case]
    cfg = get_config(arch, smoke=True)
    layers = cfg.num_layers - cfg.first_dense_layers
    want = one_device(case, placed_runs[case][0])["taps"]
    for out in placed_runs[case]:
        decode = out["taps"][layers:3 * layers]
        assert len(decode) == 2 * layers
        for g, w in zip(decode, want[layers:3 * layers]):
            assert g["idx"].shape == w["idx"].shape == (1, b, cfg.top_k)
            assert g["cap"] == w["cap"]
            np.testing.assert_array_equal(g["keep"], w["keep"])
            np.testing.assert_array_equal(g["idx"], w["idx"])
        per_rank = max(1, int(cfg.capacity_factor * cfg.top_k * (b // 2)
                              / cfg.num_experts))
        assert per_rank != decode[0]["cap"]


def test_placed_train_step_equals_one_device(runs):
    case, want, got = runs
    check_train(case, plan(case), want, got)


def check_train(case, p, want, got):
    """Every rank's loss and rank 0's updated parameters against one
    device's (the module docstring's tolerances)."""
    losses = [o["loss"] for o in got]
    assert all(abs(v - want["loss"]) <= 1e-6 * abs(want["loss"])
               for v in losses), (losses, want["loss"])
    old = transformer.init_params(ranks.plan_config(p),
                                  torch.Generator().manual_seed(p["seed"]),
                                  device="cpu")
    sensitive = total = 0
    for i, (g, w, o) in enumerate(zip(got[0]["params"], want["params"],
                                      [t.detach().numpy() for t in
                                       old.parameters()], strict=True)):
        # Adam's first update of the entry, lr·g/(|g| + eps) plus decay
        u = np.abs((o * (1 - ranks.LR * 0.1) - w) / ranks.LR)
        flat = (u > 1 - ADAM_SATURATED) & (u < ADAM_SATURATED)
        sensitive += int(flat.sum())
        total += flat.size
        np.testing.assert_allclose(g[~flat], w[~flat], atol=2e-6, rtol=0,
                                   err_msg=f"leaf {i}")
        assert np.all(np.abs(g[flat] - w[flat]) <= 2 * ranks.LR), i
    print(f"{case}: {sensitive} of {total} entries with an unsaturated "
          f"Adam update")
    assert sensitive <= ADAM_SENSITIVE_MAX * total


@pytest.mark.parametrize("arch", ["mixtral_8x7b", "deepseek_v2_lite_16b"])
def test_one_device_equals_jax_mesh_free_steps(arch):
    """The one-device program's prefill logits and first loss against the
    JAX package's prefill step and `lm_loss`, jitted without a mesh, on
    the same parameters (`convert.lm_params_to_numpy`)."""
    check_one_device_equals_jax(arch)


def check_one_device_equals_jax(arch):
    """`test_one_device_equals_jax_mesh_free_steps` of `arch`."""
    p = ranks.moe_plan(arch, None)
    cfg = get_config(arch, smoke=True)
    torch.set_num_threads(1)
    want = ranks.run(cfg, p)
    params = transformer.init_params(
        cfg, torch.Generator().manual_seed(p["seed"]), device="cpu")
    jp = jax.tree.map(jnp.asarray, convert.lm_params_to_numpy(cfg, params))
    jc = jget_config(arch, smoke=True)
    s = p["tokens"].shape[1]
    extra = p.get("inputs", {})          # frames or patches
    logits, _ = jax.jit(jsteps.make_prefill_step(
        jc, max_len=s + ranks.MAX_LEN_PAD))(jp, {"tokens": p["tokens"],
                                                 **extra})
    np.testing.assert_allclose(want["prefill"], np.asarray(logits),
                               atol=1e-4, rtol=1e-4)
    _, (loss, _) = jax.jit(lambda q: jsteps.lm_loss(
        jc, q, p["tokens"], p["labels"], **extra))(jp)
    assert abs(want["loss"] - float(loss)) <= 1e-4 * abs(float(loss))
