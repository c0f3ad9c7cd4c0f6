"""The port's optimizers and schedules against `repro.train.optimizer`, on
the CPU.

Trees are drawn once with numpy and given to both sides as float32
arrays; the port's trees are sequences of tensors in the JAX tree's leaf
order. Each transform runs a few steps from the same state on the same
gradients. Tolerances: schedules within 1e-7 relative or 1e-7 of their
peak (XLA's and torch's float32 cos may differ by an ulp, which 1 + cos
magnifies near the end of the decay); updates and states after several
steps within atol = rtol = 1e-6 (the same float32 operations, whose last
bits XLA's fusions may round otherwise); with bf16 first moments, one
bf16 step (2^-7 relative): XLA fuses `b1 * m + (1 - b1) * g` and rounds
once, torch rounds each bf16 operation.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.train import optimizer as jopt  # noqa: E402
from repro_torch.train import optimizer as opt  # noqa: E402

SHAPES = [(3, 5), (7,), (2, 3, 4), ()]
TOL = dict(atol=1e-6, rtol=1e-6)


def _trees(seed, n=4):
    rng = np.random.default_rng(seed)
    return [[rng.standard_normal(s).astype(np.float32) for s in SHAPES]
            for _ in range(n)]


def _t(tree):
    return tuple(torch.from_numpy(np.array(x)) for x in tree)


def _close(got, want, **tol):
    for g, w in zip(got, jax.tree.leaves(want), strict=True):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **(tol or TOL))


PEAKS = {"constant": 3e-4, "warmup_cosine": 1e-3, "warmup_cosine_floor": 2e-3,
         "warmup_cosine_no_warmup": 1e-3, "linear_warmup": 5e-4}


@pytest.mark.parametrize("name,make", [
    ("constant", lambda m: m.constant_schedule(3e-4)),
    ("warmup_cosine", lambda m: m.warmup_cosine_schedule(1e-3, 10, 50)),
    ("warmup_cosine_floor", lambda m: m.warmup_cosine_schedule(
        2e-3, 3, 20, floor=1e-4)),
    ("warmup_cosine_no_warmup", lambda m: m.warmup_cosine_schedule(
        1e-3, 0, 7)),
    ("linear_warmup", lambda m: m.linear_warmup_schedule(5e-4, 8)),
])
def test_schedules_match_jax(name, make):
    jsched, sched = make(jopt), make(opt)
    for step in list(range(0, 60)) + [1000]:
        want = float(jsched(jnp.asarray(step, jnp.int32)))
        got = sched(torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32 and got.shape == ()
        assert float(got) == pytest.approx(want, rel=1e-7,
                                           abs=1e-7 * PEAKS[name]), step


def _run(jo, po, params, grads, with_params):
    """Steps of both optimizers from their initial states, each on its
    own gradient tree: (port updates, port state, JAX updates, JAX
    state) after each step."""
    js, ps = jo.init(params), po.init(_t(params))
    out = []
    for g in grads:
        ju, js = jo.update(g, js, params if with_params else None)
        pu, ps = po.update(_t(g), ps, _t(params) if with_params else None)
        out.append((pu, ps, ju, js))
    return out


@pytest.mark.parametrize("name,make,with_params", [
    ("sgd", lambda m: m.sgd(0.1), False),
    ("sgd_momentum", lambda m: m.sgd(0.05, momentum=0.9), False),
    ("sgd_nesterov", lambda m: m.sgd(
        m.linear_warmup_schedule(0.1, 2), momentum=0.8, nesterov=True),
     False),
    ("adam", lambda m: m.adam(1e-3), False),
    ("adam_schedule", lambda m: m.adam(
        m.warmup_cosine_schedule(1e-2, 2, 6)), False),
    ("adam_decay", lambda m: m.adam(1e-3, weight_decay=0.01), True),
    ("adamw", lambda m: m.adamw(m.warmup_cosine_schedule(1e-3, 2, 6)),
     True),
    ("adamw_no_params", lambda m: m.adamw(1e-3), False),
    ("adamw_bf16_mu", lambda m: m.adamw(
        1e-3, mu_dtype=(torch.bfloat16 if m is opt else jnp.bfloat16)),
     True),
    ("chain_clip_adamw", lambda m: m.chain_clip(
        m.adamw(m.warmup_cosine_schedule(1e-3, 2, 6)), 1.0), True),
    ("chain_clip_sgd", lambda m: m.chain_clip(m.sgd(0.1), 0.5), False),
])
def test_transforms_match_jax(name, make, with_params):
    params, *grads = _trees(7, 5)
    # bf16 first moments: one bf16 step apart, of an update of size lr
    # (1e-3) and of a (1 - b1)·g term (g ~ N(0, 1)), where moments near 0
    # cancel
    bf16 = "bf16" in name
    tol = dict(atol=1e-3 * 2 ** -7, rtol=2 ** -7) if bf16 else {}
    mu_tol = dict(atol=0.1 * 2 ** -7, rtol=2 ** -7) if bf16 else {}
    for pu, ps, ju, js in _run(make(jopt), make(opt), params, grads,
                               with_params):
        _close(pu, ju, **tol)
        assert int(ps.step) == int(js.step)
        if isinstance(ps, opt.AdamState):
            _close([m.float() for m in ps.mu],
                   [np.asarray(m, np.float32) for m in js.mu], **mu_tol)
            _close(ps.nu, js.nu)
        elif ps.momentum is not None:
            _close(ps.momentum, js.momentum)
        else:
            assert js.momentum is None


def test_apply_updates_keeps_the_parameter_dtype():
    params, upd = _trees(3, 2)
    jp = jopt.apply_updates(params, upd)
    pp = opt.apply_updates(_t(params), _t(upd))
    _close(pp, jp, atol=0, rtol=0)
    half = opt.apply_updates((torch.ones(3, dtype=torch.bfloat16),),
                             (torch.full((3,), 0.5),))
    assert half[0].dtype == torch.bfloat16


@pytest.mark.parametrize("max_norm", [0.1, 1.0, 1e6])
def test_global_norm_and_clipping_match_jax(max_norm):
    (tree,) = _trees(11, 1)
    assert float(opt.global_norm(_t(tree))) == pytest.approx(
        float(jopt.global_norm(tree)), rel=1e-7)
    got, norm = opt.clip_by_global_norm(_t(tree), max_norm)
    want, jnorm = jopt.clip_by_global_norm(tree, max_norm)
    assert float(norm) == pytest.approx(float(jnorm), rel=1e-7)
    _close(got, want)
    if max_norm >= 1e6:          # under the limit: the tree unchanged
        _close(got, tree, atol=0, rtol=0)


def test_uleen_adam_call_unchanged():
    """The ULEEN trainer's `adam(lr)` and `update(grads, state)` (no
    parameters, a float lr): Adam without decay, the JAX arithmetic."""
    params, *grads = _trees(5, 3)
    po = opt.adam(0.01)
    jo = jopt.adam(0.01)
    ps, js = po.init(_t(params)), jo.init(params)
    for g in grads:
        pu, ps = po.update(_t(g), ps)
        ju, js = jo.update(g, js)
        _close(pu, ju)
