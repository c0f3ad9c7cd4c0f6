"""The LM dry run of the SSM and hybrid families (`launch.dryrun.run_lm_cell`
on Mamba 2 2.7B and RecurrentGemma 2B, placed on DTensor) against the JAX
package's specs and rules.

Both archs at full width, cut as `--layers 2` cuts them: Mamba 2 to 2 of
its 64 layers and RecurrentGemma to 3 of its 26 (rounded up to one whole
(rec, rec, local) pattern: at 2 layers it would have no local layer, and
no flash operator), traced as rank 0 of the
production meshes: train_4k, prefill_32k and decode_32k on one pod,
decode_32k on two, and long_500k on one pod (both are subquadratic, so
`shapes_for` gives them the cell). Each record is ok with no wnnlint
error; each part of the rank's arguments (`args_bytes_by_kind`) equals
the bytes of the shards JAX's rules give the same leaves, exactly (the
bf16 conv windows included); the collectives show the placement a
layer:

* Mamba 2: four all-gathers over `model` (prefill: `in_proj`, the conv's
  weight and bias, gathered to be cut by heads, and the prompt's last
  inputs of the x channels for the conv window; decode: the `in_proj`
  product, the conv's weight and bias and the conv window) and two
  all-reduces (the gated RMSNorm's sum of squares and the row-parallel
  `out_proj`), beside the embedding's one;
* RecurrentGemma: a recurrent layer two all-reduces over `model` (its
  `w_out` and its MLP's) and no all-gather over `model`; the local layer
  the same two and three all-gathers over `model` (its K and V, whose
  one head cannot take `model`, made whole), and at decode the
  log-sum-exp combine's three all-reduces over the ring's positions;
  its flash operator once a local layer at prefill.

The ten cells trace in four processes at once; the training cells trace
the CPU program here, as their records say.
"""
import concurrent.futures
import multiprocessing

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402

import test_torch_lm_dryrun as dense  # noqa: E402

LAYERS = {"mamba2_2p7b": 2, "recurrentgemma_2b": 3}
CELLS = [(a, shape, multi) for a in LAYERS for shape, multi in dense.CELLS
         ] + [(a, "long_500k", False) for a in LAYERS]


def _cfg(arch):
    # `--layers 2`, rounded up to RecurrentGemma's whole pattern
    return dryrun._cut(get_config(arch), 2)


def local_layers(arch) -> int:
    cfg = _cfg(arch)
    pattern = cfg.block_pattern or ()
    return sum(pattern[i % len(pattern)] == "local"
               for i in range(cfg.num_layers)) if pattern else 0


@pytest.fixture(scope="module")
def records():
    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(4, mp_context=ctx) as pool:
        # the training cells first: they take the longest
        order = sorted(CELLS, key=lambda c: c[1] != "train_4k")
        futs = {c: pool.submit(dryrun.run_lm_cell, c[0], c[1], c[2], None,
                               analyze=True, device="cuda", cfg=_cfg(c[0]))
                for c in order}
        return {c: f.result() for c, f in futs.items()}


@pytest.mark.parametrize("arch,shape,multi", CELLS)
def test_cell_is_ok_with_no_lint_error(records, arch, shape, multi):
    rec = records[(arch, shape, multi)]
    assert rec["ok"], rec.get("error")
    assert rec["analysis"]["errors"] == 0
    assert rec["layers"] == LAYERS[arch]
    assert rec["mesh"] == ("2x16x16" if multi else "16x16")
    assert not rec["host_reads"]
    if shape != "train_4k":          # the card's program, fake CUDA
        assert rec["traced_device"] == "cuda:0"
    nodes = rec["op_nodes"].get("repro_torch::flash_attention", 0)
    assert nodes == {"prefill_32k": local_layers(arch), "decode_32k": 0,
                     "long_500k": 0}.get(shape, nodes)


@pytest.mark.parametrize("arch,shape,multi", CELLS)
def test_args_bytes_by_kind_equal_jax_shards(records, arch, shape, multi):
    assert records[(arch, shape, multi)]["args_bytes_by_kind"] == \
        dense.jax_parts(shape, multi, arch=arch, layers=LAYERS[arch])


def _collectives(rec):
    return {k: v["axes"] for k, v in
            rec["roofline"]["collectives_by_kind"].items()}


@pytest.mark.parametrize("shape", ["prefill_32k", "decode_32k", "long_500k"])
def test_collectives_show_the_ssd_placement(records, shape):
    coll = _collectives(records[("mamba2_2p7b", shape, False)])
    n = LAYERS["mamba2_2p7b"]
    assert coll["all-gather"]["model"] == 4 * n
    assert coll["all-reduce"] == {"model": 1 + 2 * n}
    train = _collectives(records[("mamba2_2p7b", "train_4k", False)])
    assert train["all-gather"]["data"] > 0           # fsdp
    assert train["reduce-scatter"]["model"] > 0      # in_proj's gradient


@pytest.mark.parametrize("shape", ["prefill_32k", "decode_32k", "long_500k"])
def test_collectives_show_the_hybrid_placement(records, shape):
    arch = "recurrentgemma_2b"
    coll = _collectives(records[(arch, shape, False)])
    n, local = LAYERS[arch], local_layers(arch)
    assert local == 1
    decode = shape != "prefill_32k"
    assert coll["all-reduce"] == {"model": 1 + 2 * n + 3 * local * decode}
    assert coll["all-gather"]["model"] == 3 * local
    train = _collectives(records[(arch, "train_4k", False)])
    assert train["all-gather"]["data"] > 0           # fsdp
    assert train["all-reduce"]["model"] > 0          # tp sums


def test_cut_depth_rounds_up_to_whole_block_patterns():
    """`launch.dryrun --layers N` (and `launch.sweep`'s): whole repeats of
    a block pattern, at most the arch's depth; no pattern, N itself."""
    rg, mamba = get_config("recurrentgemma_2b"), get_config("mamba2_2p7b")
    assert [dryrun._cut(rg, n).num_layers for n in (1, 2, 3, 4, 26, 40)] \
        == [3, 3, 3, 6, 26, 26]
    assert [dryrun._cut(mamba, n).num_layers for n in (1, 2, 3)] == [1, 2, 3]
    assert dryrun._cut(rg, None) is rg
