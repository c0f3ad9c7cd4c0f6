"""The port's logical-axis sharding rules against the JAX package's.

`ShardingRules.resolve` reads a mesh through its axis names and shape
only, so both sides resolve against stand-in meshes with no devices and
no process group: the JAX side's `.axis_names` / `.devices.shape`, the
port's `.mesh_dim_names` / `.shape`. The port returns a plain tuple of
entries where JAX returns a `PartitionSpec` of the same entries.
"""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

try:
    from hypothesis import given, settings
    from hypothesis import strategies as st
except ImportError:          # minimal containers: seeded deterministic shim
    from _hypothesis_compat import given, settings  # noqa: E402
    from _hypothesis_compat import strategies as st  # noqa: E402

from repro.dist import sharding as jsh  # noqa: E402
from repro_torch.dist import sharding as sh  # noqa: E402
from repro_torch.launch import mesh as mesh_mod  # noqa: E402

LOGICAL = sorted(jsh.TRAIN_RULES.rules) + [None]
AXES = {2: ("data", "model"), 3: ("pod", "data", "model")}
SIZES = (1, 2, 3, 4, 8, 16)
DIMS = (1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 128)


def meshes(shape, axes):
    """(JAX stand-in, port stand-in) of one mesh."""
    jm = types.SimpleNamespace(axis_names=axes,
                               devices=np.empty(shape, dtype=object))
    return jm, mesh_mod.HostMesh(axes, tuple(shape))


def jax_entries(spec) -> tuple:
    return tuple(spec)


@settings(deadline=None, max_examples=200)
@given(st.integers(0, 10 ** 9), st.sampled_from(["train", "serve"]),
       st.sampled_from([2, 3]), st.integers(1, 4), st.booleans())
def test_resolve_equals_jax_entry_for_entry(seed, mode, n_axes, n_dims,
                                            with_shape):
    rng = np.random.default_rng(seed)
    axes = AXES[n_axes]
    shape = tuple(int(rng.choice(SIZES)) for _ in axes)
    logical = tuple(LOGICAL[int(rng.integers(len(LOGICAL)))]
                    for _ in range(n_dims))
    dims = tuple(int(rng.choice(DIMS)) for _ in range(n_dims))
    rules, jrules = ((sh.TRAIN_RULES, jsh.TRAIN_RULES) if mode == "train"
                     else (sh.SERVE_RULES, jsh.SERVE_RULES))
    jm, pm = meshes(shape, axes)
    kw = {"shape": dims} if with_shape else {}
    got = rules.resolve(logical, pm, **kw)
    want = jax_entries(jrules.resolve(logical, jm, **kw))
    assert isinstance(got, tuple) and got == want
    for entry in got:
        assert sh.spec_degree(pm, entry) == jsh.spec_degree(jm, entry)


def test_rule_tables_equal_the_jax_packages():
    assert sh.TRAIN_RULES.rules == jsh.TRAIN_RULES.rules
    assert sh.SERVE_RULES.rules == jsh.SERVE_RULES.rules
    for ax in ("model", "data", "pod"):
        assert sh.strip_axis(sh.SERVE_RULES, ax).rules == \
            jsh.strip_axis(jsh.SERVE_RULES, ax).rules


@pytest.mark.parametrize("shape,axes", [
    ((1, 1), ("data", "model")), ((2, 4), ("data", "model")),
    ((1, 8), ("data", "model")), ((2, 2, 2), ("pod", "data", "model")),
    ((4, 1, 3), ("pod", "data", "model"))])
@pytest.mark.parametrize("n", [1, 2, 3, 8, 10, 12, 32, 2048])
def test_class_and_tenant_partition_fall_back_as_jax(shape, axes, n):
    jm, pm = meshes(shape, axes)
    for rules, jrules in ((sh.SERVE_RULES, jsh.SERVE_RULES),
                          (sh.TRAIN_RULES, jsh.TRAIN_RULES)):
        assert sh.class_partition(pm, n, rules) == \
            jsh.class_partition(jm, n, jrules)
        assert sh.tenant_partition(pm, n, rules) == \
            jsh.tenant_partition(jm, n, jrules)
    entry, degree = sh.class_partition(pm, n)
    # indivisible counts replicate: (None, 1), never a partial shard
    sizes = dict(zip(axes, shape))
    if sizes["model"] == 1 or n % sizes["model"]:
        assert (entry, degree) == (None, 1)
    else:
        assert (entry, degree) == ("model", sizes["model"])


def test_host_mesh_resolves_everything_to_replication():
    m = mesh_mod.make_host_mesh()
    assert m.mesh_dim_names == ("data", "model") and m.shape == (1, 1)
    assert mesh_mod.pods_in(m) == 1
    assert mesh_mod.pods_in(mesh_mod.HostMesh(("pod", "data"), (2, 1))) == 2
    for name in sh.SERVE_RULES.rules:
        assert sh.SERVE_RULES.resolve((name, None), m, shape=(8, 8)) == \
            (None, None)
    assert sh.class_partition(m, 10) == (None, 1)


def test_resolve_rejects_what_jax_rejects():
    jm, pm = meshes((2, 2), AXES[2])
    for logical, kw in (((("nope",)), {}),
                        (("batch", "classes"), {"shape": (4,)})):
        with pytest.raises(ValueError) as want:
            jsh.SERVE_RULES.resolve(logical, jm, **kw)
        with pytest.raises(ValueError) as got:
            sh.SERVE_RULES.resolve(logical, pm, **kw)
        assert str(got.value) == str(want.value)


def test_use_mesh_nests_and_restores():
    assert sh.current_context() is None
    a, b = mesh_mod.make_host_mesh(), mesh_mod.make_host_mesh(("model",))
    with sh.use_mesh(a, sh.SERVE_RULES):
        assert sh.current_context() == (a, sh.SERVE_RULES)
        with sh.use_mesh(b, sh.TRAIN_RULES) as inner:
            assert inner is b
            assert sh.current_context() == (b, sh.TRAIN_RULES)
        assert sh.current_context() == (a, sh.SERVE_RULES)
    assert sh.current_context() is None


def test_rules_key_is_content_not_identity():
    copy = sh.ShardingRules(rules=dict(sh.SERVE_RULES.rules))
    assert sh.rules_key(copy) == sh.rules_key(sh.SERVE_RULES)
    assert sh.rules_key(sh.TRAIN_RULES) != sh.rules_key(sh.SERVE_RULES)
    assert sh.entry_axes(None) == () and sh.entry_axes("model") == ("model",)
    assert sh.entry_axes(("pod", "data")) == ("pod", "data")
