"""The port's three examples run end to end on the CPU at their own
sizes (the JAX examples' sizes), with their asserts."""
import math

import pytest

torch = pytest.importorskip("torch")

from repro_torch.examples import (distill_uleen_head, quickstart,  # noqa: E402
                                  uleen_edge_pipeline)

CPU = "cpu"


@pytest.fixture(autouse=True, scope="module")
def _four_torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(min(4, prev))
    yield
    torch.set_num_threads(prev)


def test_quickstart_trains_prunes_exports_and_models_hardware(capsys):
    out = quickstart.main(device=CPU)
    printed = capsys.readouterr().out
    assert "not a GPU measurement" in printed
    # ten classes: one-shot and multi-shot well above chance
    assert out["one_shot_acc"] > 0.3
    assert out["multi_shot_acc"] > 0.6 and out["pruned_acc"] > 0.6
    assert 0 < out["size_kib"] < 7.9          # 30 % of the filters pruned
    for r in out["hw_model"].values():
        assert r.throughput_kips > 0 and math.isfinite(r.power_w)


def test_uleen_edge_pipeline_serves_the_exported_artifact(capsys):
    out = uleen_edge_pipeline.main(backend="auto", device=CPU)
    assert "paper-calibrated" in capsys.readouterr().out
    assert out["scores"].dtype == torch.int32
    assert out["scores"].shape == (256, 10)
    assert out["trained_acc"] > 0.6 and out["served_acc"] > 0.6
    assert out["hw_model"]["asic"].area_mm2 > 0


def test_distill_uleen_head_learns_and_deploys(capsys):
    out = distill_uleen_head.main(backend="packed", device=CPU)
    printed = capsys.readouterr().out
    assert "packed-backend deployed head" in printed
    assert out["test_acc"] > 0.5 and out["deployed_acc"] > 0.5
    assert out["deployed_scores"].dtype == torch.int32
    assert len(out["losses"]) == 150
    assert all(math.isfinite(v) for v in out["losses"])
