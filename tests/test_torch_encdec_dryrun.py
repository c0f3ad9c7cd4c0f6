"""The LM dry run of the encoder-decoder and patch families
(`launch.dryrun.run_lm_cell` on Whisper tiny and InternVL2 26B, placed on
DTensor) against the JAX package's specs and rules.

Both archs at full width, cut as `--layers 2` cuts them: Whisper to 2 of
its 4 decoder layers with its 4 encoder layers whole (a cut is the
decoder's), InternVL2 to 2 of its 48; Whisper's training cell, the
suite's longest trace (16 microbatches through the encoder and the
decoder, twice for the decoder's recomputation), to 1 decoder layer
beside the 4 encoder layers (`chip_smoke.py` traces it at 2 on the
card, the full-depth sweep at 4). Traced as rank 0 of the production
meshes: train_4k, prefill_32k and decode_32k on one pod, decode_32k on
two (neither arch is subquadratic: no long_500k). Each record is ok with
no wnnlint error and no host read; each part of the rank's arguments
(`args_bytes_by_kind`) equals the bytes of the shards JAX's rules give
the same leaves, exactly, with a decode cell's inputs the token alone,
as `lower_cell` lowers it (Whisper's float32 cross keys and values
included); the collectives show the placement a layer:

* Whisper's encoder: its 6 heads and 1500 frames cannot take `model`, so
  its attention runs whole on every rank: three all-gathers over `model`
  make the column-parallel q, k and v whole, and `placed.attention` adds
  none; two all-reduces (the output projection and the MLP). A decoder
  layer at prefill: the self and the cross attention each split their
  query rows (an all-to-all of q from its column shard), gather K and V
  whole (for the cross attention, over the encoder's output) and the
  output's rows (six all-gathers over `model`), and three all-reduces
  (two output projections, the MLP). At decode: q, k and v of the new
  row and the cross queries gathered whole (four all-gathers), the
  log-sum-exp combine's three all-reduces, and three more as at prefill;
  the learned positions' rows move in one all-to-all over `data`.
* InternVL2: a layer's 48 query heads split 3 a rank; its 8 KV heads
  cannot take `model` and are gathered (two all-gathers; at decode q too,
  three), and two all-reduces (five at decode with the combine).
* Beside them the embedding's one all-reduce over `model`.

The flash operator runs once an attention layer at prefill (Whisper's
encoder and its decoder's self and cross attention, InternVL2's one a
layer), once a cross layer at a Whisper decode, and in a training cell
traced as the card's program once a forward (the decoder's twice, for
its recomputation) a microbatch.

The eight cells trace in four processes at once; the training cells
trace the CPU program here, as their records say.
"""
import concurrent.futures
import multiprocessing

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import SHAPES, get_config  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402

import test_torch_lm_dryrun as dense  # noqa: E402

LAYERS = {"whisper_tiny": 2, "internvl2_26b": 2}
TRAIN_LAYERS = {"whisper_tiny": 1, "internvl2_26b": 2}
CELLS = [(a, shape, multi) for a in LAYERS for shape, multi in dense.CELLS]
MICROBATCHES = 16           # train_4k on one pod: 256 rows over 16


def _layers(arch, shape) -> int:
    return (TRAIN_LAYERS if shape == "train_4k" else LAYERS)[arch]


def _cfg(arch, shape):
    return dryrun._cut(get_config(arch), _layers(arch, shape))


@pytest.fixture(scope="module")
def records():
    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(4, mp_context=ctx) as pool:
        # the training cells first, Whisper's longest: they set the wall
        order = sorted(CELLS, key=lambda c: (c[1] != "train_4k",
                                             c[0] != "whisper_tiny"))
        futs = {c: pool.submit(dryrun.run_lm_cell, c[0], c[1], c[2], None,
                               analyze=True, device="cuda",
                               cfg=_cfg(c[0], c[1]))
                for c in order}
        return {c: f.result() for c, f in futs.items()}


def flash_nodes(arch, shape, traced_device) -> int:
    """The flash operator nodes the module docstring counts."""
    cfg = _cfg(arch, shape)
    enc, n = cfg.encoder_layers, cfg.num_layers
    per_layer = 2 if cfg.cross_attention else 1
    if shape == "prefill_32k":
        return enc + per_layer * n
    if shape == "decode_32k":
        return n if cfg.cross_attention else 0
    if not traced_device.startswith("cuda"):
        return 0                      # the CPU program: the plain version
    return MICROBATCHES * (enc + 2 * per_layer * n)


@pytest.mark.parametrize("arch,shape,multi", CELLS)
def test_cell_is_ok_with_no_lint_error(records, arch, shape, multi):
    rec = records[(arch, shape, multi)]
    assert rec["ok"], rec.get("error")
    assert rec["analysis"]["errors"] == 0
    assert rec["layers"] == _layers(arch, shape)
    assert rec.get("encoder_layers", 0) == get_config(arch).encoder_layers
    assert rec["mesh"] == ("2x16x16" if multi else "16x16")
    assert not rec["host_reads"]
    if shape != "train_4k":          # the card's program, fake CUDA
        assert rec["traced_device"] == "cuda:0"
    assert rec["op_nodes"].get("repro_torch::flash_attention", 0) == \
        flash_nodes(arch, shape, rec["traced_device"])


@pytest.mark.parametrize("arch,shape,multi", CELLS)
def test_args_bytes_by_kind_equal_jax_shards(records, arch, shape, multi):
    assert records[(arch, shape, multi)]["args_bytes_by_kind"] == \
        dense.jax_parts(shape, multi, arch=arch,
                        layers=_layers(arch, shape))


def test_decode_inputs_are_the_token_alone(records):
    """A decode cell's one input is the token (4 bytes a row of the
    rank's batch): not Whisper's frames, which JAX's `input_specs` lists
    and `lower_cell` leaves out."""
    for arch in LAYERS:
        for multi in (False, True):
            rec = records[(arch, "decode_32k", multi)]
            rows = SHAPES["decode_32k"].global_batch // (32 if multi else 16)
            assert rec["args_bytes_by_kind"]["inputs"] == 4 * rows


def _collectives(rec):
    return {k: v["axes"] for k, v in
            rec["roofline"]["collectives_by_kind"].items()}


def test_collectives_show_the_encoder_decoder_placement(records):
    arch = "whisper_tiny"
    enc, n = _cfg(arch, "prefill_32k").encoder_layers, LAYERS[arch]
    prefill = _collectives(records[(arch, "prefill_32k", False)])
    assert prefill["all-gather"]["model"] == 3 * enc + 6 * n
    assert prefill["all-to-all"] == {"model": 2 * n}
    assert prefill["all-reduce"] == {"model": 1 + 2 * enc + 3 * n}
    decode = _collectives(records[(arch, "decode_32k", False)])
    assert decode["all-gather"]["model"] == 4 * n
    assert decode["all-reduce"] == {"model": 1 + 6 * n}
    assert decode["all-to-all"] == {"data": 1}
    train = _collectives(records[(arch, "train_4k", False)])
    assert train["all-gather"]["data"] > 0           # fsdp
    assert train["reduce-scatter"]["data"] > 0


def test_collectives_show_the_patch_model_placement(records):
    arch = "internvl2_26b"
    n = LAYERS[arch]
    prefill = _collectives(records[(arch, "prefill_32k", False)])
    assert prefill["all-gather"]["model"] == 2 * n
    assert prefill["all-reduce"] == {"model": 1 + 2 * n}
    assert "all-to-all" not in prefill
    decode = _collectives(records[(arch, "decode_32k", False)])
    assert decode["all-gather"]["model"] == 3 * n
    assert decode["all-reduce"] == {"model": 1 + 5 * n}
    train = _collectives(records[(arch, "train_4k", False)])
    assert train["all-gather"]["data"] > 0           # fsdp
    assert train["all-reduce"]["model"] > 0          # tp sums
