"""The port's int8 cross-pod gradient compression (`train/compression.py`)
against the JAX package's, on the CPU.

The port's `compressed_psum` runs over a `pod` mesh of 2 and 4 gloo rank
processes (one spawn per pod count, `test_torch_dist_ranks.py`), the JAX
package's `compressed_psum_leaf` under `shard_map` over a `pod` mesh of
the 8 forced host devices, on the same numpy inputs. Tolerance: exact —
the port keeps JAX's operation order (x / scale, round half to even,
clip, int32 sum, total · scale / n), so the means and the residuals are
bit-equal; every other claim is the JAX battery's own bound
(`quantization_bound`).
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.dist import sharding as sh  # noqa: E402
from repro.launch.mesh import make_mesh  # noqa: E402
from repro.train import compression as jcomp  # noqa: E402
from repro_torch.launch import mesh as mesh_mod  # noqa: E402
from repro_torch.train import compression  # noqa: E402

import test_torch_dist_ranks as ranks  # noqa: E402

SCALES = (-30, -3, 0, 3, 30)     # log10 gradient scales
FEEDBACK_ROUNDS = 20
JAX_ROUNDS = 2
needs8 = pytest.mark.skipif(
    jax.device_count() < 8,
    reason="needs XLA_FLAGS=--xla_force_host_platform_device_count=8")


def _tree(seed, npods, scale, shape=(6, 5)):
    """Two leaves, each (npods, ...) float32: row k is pod k's gradient."""
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((npods, *shape)) * scale).astype(np.float32),
            (rng.standard_normal((npods, shape[0])) * scale).astype(
                np.float32)]


def _cases(npods):
    cases = {f"1e{e}": {"stacked": _tree(100 + e, npods, 10.0 ** e)}
             for e in SCALES}
    cases["zero"] = {"stacked": [np.zeros_like(x)
                                 for x in _tree(0, npods, 1.0)]}
    cases["feedback"] = {"stacked": _tree(2, npods, 0.37, (5, 4)),
                         "rounds": FEEDBACK_ROUNDS}
    return cases


def _spawn(npods):
    return mesh_mod.spawn_ranks(ranks.compression_checks, npods,
                                _cases(npods), backend="gloo",
                                timeout_s=240)


@pytest.fixture(scope="module")
def pods2():
    return _spawn(2)


@pytest.fixture(scope="module")
def pods4():
    return _spawn(4)


@functools.lru_cache(maxsize=None)
def _jax_leaf_fn(npods):
    """JAX's `compressed_psum_leaf` under shard_map over a `pod` mesh of
    `npods` devices, built once: (stacked g, stacked err) -> (mean,
    stacked residuals). A zero residual is added exactly, so round 0
    passes zeros. It runs eagerly, one operation at a time: under
    `jax.jit` XLA's CPU backend contracts the residual's `g - q·scale`
    into a fused multiply-add, whose rounding the port's separate product
    and difference do not share (residuals off by up to an ulp of g; the
    means stay equal)."""
    mesh = make_mesh((npods,), ("pod",))

    def f(g, e):
        out, ne = jcomp.compressed_psum_leaf(g[0], "pod", e[0])
        return out, ne[None]
    return sh.shard_map(f, mesh, in_specs=(P("pod"), P("pod")),
                        out_specs=(P(), P("pod")))


def _jax_round(npods, stacked, err=None):
    """One reduction of each leaf by JAX: (means, residuals (npods, ...))."""
    fn = _jax_leaf_fn(npods)
    outs = [fn(jnp.asarray(x), jnp.zeros(x.shape, jnp.float32)
               if err is None else jnp.asarray(err[i]))
            for i, x in enumerate(stacked)]
    return ([np.asarray(o) for o, _ in outs],
            [np.asarray(ne) for _, ne in outs])


@needs8
@pytest.mark.parametrize("npods", [2, 4])
@pytest.mark.parametrize("case", [f"1e{e}" for e in SCALES] + ["zero"])
def test_compressed_mean_is_bit_equal_to_jax(npods, case, pods2, pods4):
    spawned = {2: pods2, 4: pods4}[npods]
    stacked = _cases(npods)[case]["stacked"]
    want_mean, want_err = _jax_round(npods, stacked)
    for k, o in enumerate(spawned):
        (mean, err), = o["cases"][case]
        for i in range(len(stacked)):
            np.testing.assert_array_equal(mean[i], want_mean[i],
                                          err_msg=f"rank {k} leaf {i}")
            np.testing.assert_array_equal(err[i], want_err[i][k],
                                          err_msg=f"rank {k} leaf {i}")
        for i, x in enumerate(stacked):
            exact = np.asarray(x, np.float64).mean(0)
            bound = compression.quantization_bound([torch.from_numpy(x)])
            assert float(np.max(np.abs(mean[i] - exact))) <= bound


@needs8
@pytest.mark.parametrize("npods", [2, 4])
def test_error_feedback_matches_jax_and_telescopes(npods, pods2, pods4):
    """20 reductions of the same gradient with the residual carried: the
    first JAX_ROUNDS bit-equal to JAX's (its eager shard_map takes seconds
    a round), and the cumulative error of all 20 within two grid steps
    (the JAX battery's bound), under half the naive accumulation's."""
    spawned = {2: pods2, 4: pods4}[npods]
    stacked = _cases(npods)["feedback"]["stacked"]
    rounds = spawned[0]["cases"]["feedback"]
    assert len(rounds) == FEEDBACK_ROUNDS
    err = None
    for r, (mean, _) in enumerate(rounds[:JAX_ROUNDS]):
        want_mean, err = _jax_round(npods, stacked, err)
        for i in range(len(stacked)):
            np.testing.assert_array_equal(mean[i], want_mean[i],
                                          err_msg=f"round {r} leaf {i}")
    for k, o in enumerate(spawned):
        _, res = o["cases"]["feedback"][JAX_ROUNDS - 1]
        for i in range(len(stacked)):
            np.testing.assert_array_equal(res[i], err[i][k],
                                          err_msg=f"rank {k} leaf {i}")
    bound = compression.quantization_bound(
        [torch.from_numpy(x) for x in stacked])
    for i, x in enumerate(stacked):
        exact = np.asarray(x, np.float64).mean(0)
        acc = sum(np.asarray(mean[i], np.float64) for mean, _ in rounds)
        cum = float(np.max(np.abs(acc - FEEDBACK_ROUNDS * exact)))
        assert cum <= 2 * bound + 1e-6 * FEEDBACK_ROUNDS
        assert cum < FEEDBACK_ROUNDS * bound / 2


def test_zero_tree_is_exact(pods2):
    for o in pods2:
        (mean, err), = o["cases"]["zero"]
        assert all(not np.any(m) for m in mean)
        assert all(not np.any(e) for e in err)


def test_denormal_small_rounds_to_zero_within_bound(pods2):
    stacked = _cases(2)["1e-30"]["stacked"]
    bound = compression.quantization_bound(
        [torch.from_numpy(x) for x in stacked])
    assert bound < 1e-14
    (mean, _), = pods2[0]["cases"]["1e-30"]
    assert all(float(np.max(np.abs(m))) <= bound for m in mean)


@pytest.mark.parametrize("npods", [2, 4])
def test_wire_payload_is_int8(npods, pods2, pods4):
    """Every all-gather that crossed the pod axis carried int8."""
    for o in {2: pods2, 4: pods4}[npods]:
        assert o["wire"] == ["torch.int8"]


def test_q8_matches_jax_with_ties_and_clipping():
    scale = np.float32(0.25)
    ties = np.array([-200.0, -127.5, -126.5, -2.5, -1.5, -0.5, 0.5, 1.5,
                     2.5, 126.5, 127.5, 300.0], np.float32) * scale
    rng = np.random.default_rng(0)
    rand = (rng.standard_normal(512) * 60.0).astype(np.float32) * scale
    for x in (ties, rand):
        want = np.asarray(jcomp._q8(jnp.asarray(x), jnp.float32(scale)))
        got = compression._q8(torch.from_numpy(x),
                              torch.tensor(scale)).numpy()
        assert got.dtype == np.int8
        np.testing.assert_array_equal(got, want)
    got = compression._q8(torch.from_numpy(ties), torch.tensor(scale))
    assert got.tolist() == [-127, -127, -126, -2, -2, 0, 0, 2, 2, 126,
                            127, 127]


def test_stochastic_rounding_stays_on_the_grid():
    x = torch.linspace(-3.0, 3.0, 101)
    q = compression._q8(x, torch.tensor(0.1),
                        generator=torch.Generator().manual_seed(0))
    assert q.dtype == torch.int8
    assert float((q.float() - x / 0.1).abs().max()) <= 1.0


@pytest.mark.parametrize("scale", [1e-3, 1.0, 1e3])
def test_quantization_bound_and_bytes_equal_jax(scale):
    tree = _tree(7, 2, scale)
    jtree = {"w": jnp.asarray(tree[0]), "b": jnp.asarray(tree[1])}
    ptree = [torch.from_numpy(x) for x in tree]
    assert compression.quantization_bound(ptree) == pytest.approx(
        jcomp.quantization_bound(jtree), rel=1e-12)
    for compressed in (False, True):
        assert compression.cross_pod_bytes(ptree, compressed) == \
            jcomp.cross_pod_bytes(jtree, compressed)
    assert compression.cross_pod_bytes(
        [torch.zeros(10, 4), torch.zeros(10)], True) == 50 + 8
