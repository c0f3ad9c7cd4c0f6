"""The port's copy of the FPGA/ASIC hardware model against the JAX
package's, on the CPU: the same numpy arithmetic, so every field is
equal exactly. These are the paper-calibrated accelerator models, not
GPU measurements."""
import dataclasses
import os

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.core import export as jexport  # noqa: E402
from repro.core import hwmodel as jhw  # noqa: E402
from repro_torch.core import export, hwmodel  # noqa: E402

GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                      "uln_s_artifact.npz")


def test_calibrated_platforms_equal_jax():
    got, want = hwmodel.calibrated_platforms(), jhw.calibrated_platforms()
    assert sorted(got) == sorted(want)
    for name in want:
        assert dataclasses.asdict(got[name]) == dataclasses.asdict(want[name])


def test_counts_from_golden_artifact_equal_jax():
    got = hwmodel.counts_from_artifact(export.load(GOLDEN))
    want = jhw.counts_from_artifact(jexport.load(GOLDEN))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.table_bytes == want.table_bytes
    assert got.compressed_input_bits == want.compressed_input_bits
    assert got.unary_input_bits == want.unary_input_bits


@pytest.mark.parametrize("platform", ["fpga", "fpga@85", "asic"])
@pytest.mark.parametrize("compress_input", [True, False])
def test_evaluate_design_golden_uln_s_equals_jax(platform, compress_input):
    got = hwmodel.evaluate_design(
        hwmodel.counts_from_artifact(export.load(GOLDEN)),
        hwmodel.calibrated_platforms()[platform], compress_input)
    want = jhw.evaluate_design(
        jhw.counts_from_artifact(jexport.load(GOLDEN)),
        jhw.calibrated_platforms()[platform], compress_input)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.mark.parametrize("name", ["ULN_S", "ULN_M", "ULN_L"])
def test_paper_design_points_equal_jax(name):
    """The published ULN-S/M/L counts and their modelled reports."""
    got_c, want_c = getattr(hwmodel, name), getattr(jhw, name)
    assert dataclasses.asdict(got_c) == dataclasses.asdict(want_c)
    for plat in ("fpga", "asic"):
        got = hwmodel.evaluate_design(got_c,
                                      hwmodel.calibrated_platforms()[plat])
        want = jhw.evaluate_design(want_c, jhw.calibrated_platforms()[plat])
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert np.isfinite(got.power_w) and got.throughput_kips > 0
