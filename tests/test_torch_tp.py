"""Tensor- and data-parallel placement of the dense LM path on DTensor
(`dist.sharding.use_placement`, `launch.steps.place_params`,
`dist.placed`), held to the one-device program.

Gloo ranks on the CPU (`spawn_ranks`; rank functions in
`tests/test_torch_tp_ranks.py`) run the placed prefill, two decode steps
and one AdamW step (float32 compute) of llama3p2_3b's smoke config on
meshes (data 2, model 2) and (model 4), and of the same config with 6
heads of 16 (2 KV heads) on (model 4): there a `tp` shard of wq holds a
head and a half, as Llama's 24 heads do over 16, and the heads cannot
take `model`, so q is placed by rows (`ctx`). The one-device program
runs in this process. Tolerances: logits within atol = rtol = 1e-5 (the
float32 all-reduces' rounding), the loss within 1e-6 relative, the
updated parameters within 2e-6. The decode steps are held to the
one-device decode steps from the placed prefill's state: the state is a
bf16 cache, and a float32 key that two programs compute with other
summation orders can round to either bf16 neighbour (the two prefills'
caches are held within one bf16 step of each other instead).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch import mesh as mesh_mod  # noqa: E402

import test_torch_tp_ranks as ranks  # noqa: E402

CASES = {
    "smoke-data2-model2": (None, ((2, 2), ("data", "model"))),
    "smoke-model4": (None, ((4,), ("model",))),
    "split-heads-model4": ((6, 2, 16), ((4,), ("model",))),
}


@pytest.fixture(scope="module")
def placed_runs():
    """Every case's placed run, in one spawn of 4 gloo ranks: {case:
    (rank 0's result, every rank's loss)}."""
    plans = [ranks.plan_for(*CASES[c]) for c in CASES]
    outs = mesh_mod.spawn_ranks(ranks.placed_rank, 4, plans,
                                backend="gloo", timeout_s=300)
    return {c: (outs[0][i], [o[i]["loss"] for o in outs])
            for i, c in enumerate(CASES)}


@pytest.fixture(scope="module", params=list(CASES))
def runs(request, placed_runs):
    """(one-device result, rank 0's placed result, every rank's loss)."""
    heads, mesh = CASES[request.param]
    got, losses = placed_runs[request.param]
    torch.set_num_threads(1)
    want = ranks.run(ranks.config(heads), ranks.plan_for(heads, mesh),
                     state_after_prefill=got["state"])
    return want, got, losses


def test_placed_prefill_and_decode_logits_equal_one_device(runs):
    want, got, _ = runs
    assert len(got["state"]) == len(want["state"])
    for g, w in zip(got["state"], want["state"]):
        step = np.maximum(np.abs(w), 1e-30) * 2.0 ** -7     # a bf16 step
        assert np.all(np.abs(g - w) <= step), "prefill state"
    for key in ("prefill", "decode0", "decode1"):
        np.testing.assert_allclose(got[key], want[key], atol=1e-5,
                                   rtol=1e-5, err_msg=key)


def test_placed_train_step_equals_one_device(runs):
    want, got, losses = runs
    assert all(abs(l - want["loss"]) <= 1e-6 * abs(want["loss"])
               for l in losses)
    assert len(got["params"]) == len(want["params"])
    for i, (g, w) in enumerate(zip(got["params"], want["params"])):
        np.testing.assert_allclose(g, w, atol=2e-6, rtol=0,
                                   err_msg=f"leaf {i}")


def test_logical_constraint_outside_a_mesh_is_the_identity():
    from repro_torch.dist import sharding as sh
    x = torch.randn(3, 4)
    assert sh.logical_constraint(x, ("batch", None)) is x
