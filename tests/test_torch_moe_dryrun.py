"""The LM dry run of the MoE family (`launch.dryrun.run_lm_cell` on
Mixtral 8x7B and DeepSeek-V2-Lite, placed on DTensor) against the JAX
package's specs and rules.

Both archs at full width and 2 layers (DeepSeek: its dense layer and one
MoE + MLA layer), traced as rank 0 of the production meshes: train_4k,
prefill_32k and decode_32k on one pod, decode_32k on two, and Mixtral's
long_500k on one pod. Each record is
ok with no wnnlint error; each part of the rank's arguments
(`args_bytes_by_kind`) equals the bytes of the shards JAX's rules give
the same leaves, exactly; the collectives show the placement: one
reduction over `model` a layer for the FFN (Mixtral's tensor-parallel
experts' partial sums, DeepSeek's expert-parallel combine with its
shared experts, the dense layer's MLP) beside the attention's, and at
decode one more all-gather over `data` a MoE layer than at prefill (the
decode group's expert choices, read across the `data` ranks). The nine
cells trace in four processes at once; the training cells trace the CPU
program here, as their records say.
"""
import concurrent.futures
import dataclasses
import multiprocessing

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402

import test_torch_lm_dryrun as dense  # noqa: E402

LAYERS = 2
ARCHS = ("mixtral_8x7b", "deepseek_v2_lite_16b")
# and Mixtral's long_500k (its window makes it subquadratic, so
# `shapes_for` gives it the cell): one decode step against 524,288 cached
# positions, in the 4096-wide ring
CELLS = [(a, shape, multi) for a in ARCHS for shape, multi in dense.CELLS
         ] + [("mixtral_8x7b", "long_500k", False)]


def _cfg(arch):
    return dataclasses.replace(get_config(arch), num_layers=LAYERS)


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


def moe_layers(arch) -> int:
    return LAYERS - get_config(arch).first_dense_layers


@pytest.mark.parametrize("arch,shape,multi", CELLS)
def test_moe_cell_is_ok_with_no_lint_error(records, arch, shape, multi):
    rec = records[(arch, shape, multi)]
    assert rec["ok"], rec.get("error")
    assert rec["analysis"]["errors"] == 0
    assert rec["layers"] == LAYERS
    assert rec["mesh"] == ("2x16x16" if multi else "16x16")
    if shape != "train_4k":          # the card's program, fake CUDA
        assert rec["traced_device"] == "cuda:0"
    nodes = rec["op_nodes"].get("repro_torch::flash_attention", 0)
    assert nodes == {"prefill_32k": LAYERS, "decode_32k": 0,
                     "long_500k": 0}.get(shape, nodes)


@pytest.mark.parametrize("arch,shape,multi", CELLS)
def test_args_bytes_by_kind_equal_jax_shards(records, arch, shape, multi):
    assert records[(arch, shape, multi)]["args_bytes_by_kind"] == \
        dense.jax_parts(shape, multi, arch=arch, layers=LAYERS)


def _collectives(rec):
    return {k: v["axes"] for k, v in
            rec["roofline"]["collectives_by_kind"].items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_collectives_show_the_moe_placement(records, arch):
    prefill = _collectives(records[(arch, "prefill_32k", False)])
    decode = _collectives(records[(arch, "decode_32k", False)])
    # the vocabulary-parallel embedding's sum, then per layer the
    # attention's output projection and the FFN's partial sums
    assert prefill["all-reduce"] == {"model": 1 + 2 * LAYERS}
    # the decode group's routing gathers its choices across `data`
    assert decode["all-gather"]["data"] == \
        prefill["all-gather"]["data"] + moe_layers(arch)
    two = _collectives(records[(arch, "decode_32k", True)])
    assert two["all-gather"]["pod"] >= moe_layers(arch)
    train = _collectives(records[(arch, "train_4k", False)])
    assert train["all-gather"]["data"] > 0           # fsdp
    assert train["all-reduce"]["model"] > 0          # tp / ep sums
    assert train["all-reduce"]["data"] > 0           # the aux loss's sums
