"""The port's examples run end to end on the CPU at their own sizes (the
JAX examples' sizes), with their asserts; `serve_lm`'s tokens are held
against JAX `serve()` on parameters carried across."""
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.examples import (distill_uleen_head, quickstart,  # noqa: E402
                                  serve_lm, train_lm, uleen_edge_pipeline)

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


@pytest.mark.parametrize("arch", serve_lm.ARCHS)
def test_serve_lm_tokens_equal_jax_serve(arch, capsys):
    """The example's synchronous batch and its stream (the example asserts
    each request equal to `serve()` of it alone) on the JAX package's
    parameters: the batch's tokens equal JAX `serve()`'s where JAX's
    top-2 margin allows (`tests/test_torch_ssm.py`'s rule)."""
    import jax
    import jax.numpy as jnp

    from repro.configs import base as jcfgs
    from repro.launch import serve as jserve
    from repro.models import transformer as jt
    from repro_torch import convert
    from test_torch_encdec import jax_greedy
    from test_torch_ssm import assert_tokens_match

    cfg = serve_lm.smoke_config(arch)
    jc = dataclasses.replace(jcfgs.get_config(arch, smoke=True),
                             capacity_factor=cfg.capacity_factor)
    jp = jt.init_params(jc, jax.random.PRNGKey(0))
    p = convert.lm_params_from_numpy(cfg, jax.tree.map(np.asarray, jp),
                                     device=CPU)
    prompts = serve_lm.prompts_for(cfg)
    out = serve_lm.serve_arch(cfg, p, prompts, device=CPU)
    assert cfg.name in capsys.readouterr().out
    want = np.asarray(jserve.serve(jc, jp, jnp.asarray(prompts),
                                   max_len=serve_lm.MAX_LEN, gen=16))
    _, margins = jax_greedy(jc, jp, prompts, {}, 16, serve_lm.MAX_LEN)
    assert out["sync"].shape == want.shape == (4, 16)
    assert_tokens_match(out["sync"].numpy(), want, margins)
    assert out["stats"]["requests"] == 8 and len(out["stream"]) == 8


def test_train_lm_trains_the_25m_model_for_three_steps(capsys):
    """The example's ~25M-parameter model (the JAX example's CFG) through
    `launch.train.train` in float32 for three steps of 2 x 64 tokens: the
    example asserts that the loss fell."""
    out = train_lm.main(steps=3, batch=2, seq=64, device=CPU)
    printed = capsys.readouterr().out
    assert "llama-25m" in printed and "over 3 steps" in printed
    assert len(out["history"]) == 3 and not out["preempted"]
    assert all(math.isfinite(h["loss"]) for h in out["history"])
    assert all(p.dtype == torch.float32 for p in out["params"].parameters())
