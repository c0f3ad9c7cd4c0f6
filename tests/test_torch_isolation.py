"""The port stands alone: it imports neither JAX nor the JAX package, and
its entry points never fall back to the CPU on their own."""
import ast
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_SRC = os.path.join(REPO, "src", "repro_torch")
GOLDEN = os.path.join(REPO, "tests", "golden", "uln_s_artifact.npz")


def _forbidden(module: str) -> bool:
    """jax, jaxlib or the JAX package `repro` (not `repro_torch`)."""
    root = module.split(".")[0]
    return root in ("jax", "jaxlib", "repro")


def _port_sources():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for dirpath, _, files in os.walk(PORT_SRC):
        out += [os.path.join(dirpath, f) for f in files if f.endswith(".py")]
    return sorted(out)


def test_importing_every_port_module_loads_no_jax_and_no_repro():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "print(len([n for n in sys.modules if n.startswith('repro_torch')]))\n"
        "print(bad)\n"
        "print(' '.join(sorted(n for n in sys.modules "
        "if n.startswith('repro_torch'))))\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=REPO, timeout=300)
    assert out.returncode == 0, out.stderr
    n_modules, bad, names = out.stdout.strip().splitlines()
    assert int(n_modules) >= 20
    assert bad == "[]"
    assert {"repro_torch.data.synth", "repro_torch.core.head",
            "repro_torch.core.hwmodel", "repro_torch.examples.quickstart",
            "repro_torch.examples.uleen_edge_pipeline",
            "repro_torch.examples.distill_uleen_head",
            "repro_torch.models.moe", "repro_torch.launch.loadgen",
            "repro_torch.configs.mixtral_8x7b",
            "repro_torch.configs.deepseek_v2_lite_16b",
            "repro_torch.models.ssm", "repro_torch.models.rglru",
            "repro_torch.configs.mamba2_2p7b",
            "repro_torch.configs.recurrentgemma_2b",
            "repro_torch.configs.whisper_tiny",
            "repro_torch.configs.internvl2_26b",
            "repro_torch.examples.serve_lm",
            "repro_torch.launch.train", "repro_torch.train.fault",
            "repro_torch.examples.train_lm", "repro_torch.train.checkpoint",
            "repro_torch.train.compression", "repro_torch.launch.uleen_cell",
            "repro_torch.dist.collectives"} <= set(names.split())


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_source_imports_no_jax_and_no_repro(path):
    with open(path, encoding="utf-8") as fh:
        tree = ast.parse(fh.read(), filename=path)
    found = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            found += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            found.append(node.module)
    assert [m for m in found if _forbidden(m)] == []


def _no_gpu():
    if torch.cuda.is_available():
        pytest.skip("this check is for machines without a CUDA device")


def _entry_points():
    from repro_torch import convert
    from repro_torch.core import (encoding, export, model, multi_shot,
                                  one_shot, pruning)
    from repro_torch.kernels import ops
    from repro_torch.configs import get_config
    from repro_torch.launch import loadgen, serve
    from repro_torch.launch.scheduler import (Engine, WnnBatcher,
                                              WnnTenantBatcher)
    from repro_torch.core import head
    from repro_torch.data import synth
    from repro_torch.examples import (distill_uleen_head, quickstart,
                                      serve_lm, train_lm,
                                      uleen_edge_pipeline)
    from repro_torch.launch import train, uleen_cell
    from repro_torch.models import kvcache, rglru, ssm, transformer
    from repro_torch.packed import layout, runtime
    art = export.load(GOLDEN)
    pt = layout.from_artifact(art, device="cpu")
    bits = np.zeros((2, art.total_bits), np.uint8)
    spec = model.UleenSpec(num_classes=5, total_bits=art.total_bits,
                           submodels=())
    z = torch.zeros
    lm = get_config("llama3p2_3b", smoke=True)
    lm_params = transformer.init_params(lm, torch.Generator(), device="cpu")
    hcfg = head.UleenHeadConfig(num_classes=2, hidden_dim=4,
                                submodels=(model.SubmodelSpec(4, 3),))
    hstate = head.init_head(torch.Generator(), hcfg, device="cpu")
    st = layout.stack_tenants([pt])
    tids = np.zeros(2, np.int32)
    return {
        "artifact_scores": lambda: export.artifact_scores(art, bits),
        "prepare_artifact": lambda: export.prepare_artifact(art),
        "WnnBatcher": lambda: WnnBatcher(art, slots=4),
        "packed_scores": lambda: runtime.packed_scores(pt, bits),
        "from_artifact": lambda: layout.from_artifact(art),
        "wnn_scores": lambda: ops.wnn_scores(
            z((2, 3, 4), dtype=torch.int8), z((2, 4), dtype=torch.int32),
            z((5, 3, 8), dtype=torch.int8), z((5, 3), dtype=torch.int8),
            z(5, dtype=torch.int32)),
        "thermometer": lambda: ops.thermometer(z((2, 3)), z((3, 2))),
        "decompress": lambda: ops.decompress(z((2, 3), dtype=torch.uint8), 2),
        "forward_binary_fused": lambda: model.forward_binary_fused(
            None, [], [], [], z(5), z((2, 8))),
        "encoder_from_numpy": lambda: convert.encoder_from_numpy(
            np.zeros((3, 2), np.float32)),
        "fit_gaussian_thermometer": lambda: encoding.fit_gaussian_thermometer(
            np.zeros((4, 3), np.float32), 2),
        "fit_linear_thermometer": lambda: encoding.fit_linear_thermometer(
            np.zeros((4, 3), np.float32), 2),
        "fit_mean_binarizer": lambda: encoding.fit_mean_binarizer(
            np.zeros((4, 3), np.float32)),
        "h3_hash": lambda: ops.h3_hash(z((2, 3, 4), dtype=torch.int8),
                                       z((2, 4), dtype=torch.int32)),
        "compute_hashes": lambda: model.compute_hashes(spec, [], bits),
        "init_static": lambda: model.init_static(torch.Generator(), spec),
        "init_params": lambda: model.init_params(torch.Generator(), spec),
        "binarize_to_packed": lambda: model.binarize_to_packed(
            spec, [], model.UleenParams((), z(5), ())),
        "train_one_shot": lambda: one_shot.train_one_shot(
            spec, [], bits, [0, 1], bits, [0, 1]),
        "evaluate_one_shot": lambda: one_shot.evaluate_one_shot(
            spec, [], None, bits, [0, 1]),
        "train_multi_shot": lambda: multi_shot.train_multi_shot(
            spec, [], None, bits, [0, 1], bits, [0, 1]),
        "evaluate": lambda: multi_shot.evaluate(spec, [], None, bits, [0, 1]),
        "prune_and_finetune": lambda: pruning.prune_and_finetune(
            spec, [], None, bits, [0, 1], bits, [0, 1]),
        "statics_from_numpy": lambda: convert.statics_from_numpy(
            [(np.zeros((2, 3), np.int32), np.zeros((2, 3), np.uint32))]),
        "params_from_numpy": lambda: convert.params_from_numpy(
            ([], np.zeros(5, np.float32), [])),
        "one_shot_from_numpy": lambda: convert.one_shot_from_numpy(
            ([], np.int32(1), np.zeros(5, np.float32))),
        "lm_init_params": lambda: transformer.init_params(
            lm, torch.Generator()),
        "Engine": lambda: Engine(lm, lm_params, slots=2, max_len=16),
        "serve_main": lambda: serve.main(["--arch", "llama3p2_3b",
                                          "--smoke"]),
        "lm_params_from_numpy": lambda: convert.lm_params_from_numpy(
            lm, {"embed": np.zeros((4, 4), np.float32), "segments": []}),
        "make_mnist_like": lambda: synth.make_mnist_like(
            torch.Generator(), 4, 2, hw=4),
        "make_tabular": lambda: synth.make_tabular(torch.Generator(), 3, 2,
                                                   4, 2),
        "make_uci_like": lambda: synth.make_uci_like(torch.Generator(),
                                                     "iris"),
        "make_lm_tokens": lambda: synth.make_lm_tokens(0, 10, 20),
        "init_head": lambda: head.init_head(torch.Generator(), hcfg),
        "gaussian_thresholds": lambda: head.gaussian_thresholds(4),
        "apply_head": lambda: head.apply_head(hcfg, hstate, z((2, 4))),
        "head_loss": lambda: head.head_loss(hcfg, hstate, z((2, 4)),
                                            [0, 1]),
        "head_state_from_numpy": lambda: convert.head_state_from_numpy(
            (([], np.zeros(2, np.float32), []), [], np.zeros(4))),
        "wnn_infer": lambda: ops.wnn_infer(
            z((2, 3, 4), dtype=torch.int8), z((2, 4), dtype=torch.int32),
            z((5, 3, 8), dtype=torch.int8), z((5, 3), dtype=torch.int8),
            z(5, dtype=torch.int32)),
        "wnn_scores_tenant": lambda: ops.wnn_scores_tenant(
            bits, tids, st.perms[0], st.h3s[0], st.words[0], st.masks[0],
            entries=st.entries[0]),
        "stacked_scores": lambda: runtime.stacked_scores(st, bits, tids),
        "prepare_tenants": lambda: export.prepare_tenants([art]),
        "WnnTenantBatcher": lambda: WnnTenantBatcher(capacity=2, slots=2),
        "quickstart_main": lambda: quickstart.main(),
        "uleen_edge_pipeline_main": lambda: uleen_edge_pipeline.main(),
        "distill_uleen_head_main": lambda: distill_uleen_head.main(),
        "init_mla_cache": lambda: kvcache.init_mla_cache(1, 4, 8, 4),
        "init_paged_mla_cache": lambda: kvcache.init_paged_mla_cache(
            3, 4, 8, 4),
        "serve_stream": lambda: serve.serve_stream(lm, lm_params, [],
                                                   slots=2, max_len=16),
        "moe_serve_main": lambda: serve.main(["--arch", "mixtral_8x7b",
                                              "--smoke"]),
        "mla_init_params": lambda: transformer.init_params(
            get_config("deepseek_v2_lite_16b", smoke=True),
            torch.Generator()),
        "ssm_init_params": lambda: transformer.init_params(
            get_config("mamba2_2p7b", smoke=True), torch.Generator()),
        "hybrid_init_params": lambda: transformer.init_params(
            get_config("recurrentgemma_2b", smoke=True), torch.Generator()),
        "init_ssm_state": lambda: ssm.init_ssm_state(
            get_config("mamba2_2p7b", smoke=True), 1),
        "init_rg_state": lambda: rglru.init_rg_state(
            get_config("recurrentgemma_2b", smoke=True), 1),
        "hybrid_serve_main": lambda: serve.main(["--arch",
                                                 "recurrentgemma_2b",
                                                 "--smoke"]),
        "encdec_init_params": lambda: transformer.init_params(
            get_config("whisper_tiny", smoke=True), torch.Generator()),
        "init_cross_kv": lambda: kvcache.init_cross_kv(1, 2, 3, 4, layers=1),
        "encdec_serve_main": lambda: serve.main(["--arch", "whisper_tiny",
                                                 "--smoke"]),
        "vlm_serve_main": lambda: serve.main(["--arch", "internvl2_26b",
                                              "--smoke"]),
        "serve_lm_main": lambda: serve_lm.main(),
        "loadgen_run_scenario": lambda: loadgen.run_scenario(_SCENARIO),
        "loadgen_main": lambda: loadgen.main([
            "--suite", os.path.join(REPO, "tests", "golden", "scenarios"),
            "--out", os.devnull]),
        "train_lm": lambda: train.train(lm, steps_total=1, batch=1, seq=4),
        "train_main": lambda: train.main(["--arch", "llama3p2_3b",
                                          "--smoke", "--steps", "1"]),
        "data_iterator": lambda: next(train.data_iterator(lm, 1, 4, 0)),
        "train_lm_example_main": lambda: train_lm.main(steps=1),
        "uleen_smoke_problem": lambda: train.uleen_smoke_problem(0, 64),
        "train_uleen": lambda: train.train_uleen(
            uleen_cell.ULEEN_EXEC_SPEC, [], np.zeros((8, 512), np.int8),
            np.zeros(8, np.int64), steps_total=1, global_batch=8),
        "uleen_reference_params": lambda: train.uleen_reference_params(
            uleen_cell.ULEEN_EXEC_SPEC, [], np.zeros((8, 512), np.int8),
            np.zeros(8, np.int64), steps=1, global_batch=8),
        "uleen_parity_probe": lambda: train.uleen_parity_probe(),
        "train_main_uleen": lambda: train.main(["--arch", "uleen",
                                                "--steps", "1"]),
        "train_main_uleen_mesh": lambda: train.main([
            "--arch", "uleen", "--steps", "1", "--mesh", "pod=1,data=2"]),
        "block_generator": lambda: multi_shot.block_generator(0, 0, 0),
        "uleen_train_state_from_numpy":
            lambda: convert.uleen_train_state_from_numpy(
                [np.zeros((2, 3, 4), np.float32), np.zeros(2, np.float32),
                 np.zeros((2, 3), np.float32), np.int32(0)]
                + [np.zeros((2, 3, 4), np.float32), np.zeros(2, np.float32),
                   np.zeros((2, 3), np.float32)] * 2),
    }


_SCENARIO = {
    "schema": "scenario/v1", "name": "t", "arch": "deepseek_v2_lite_16b",
    "engine": {"slots": 2, "max_len": 32, "paged": True, "block_size": 8},
    "workload": {"requests": 2, "prompt_lens": [4], "gen_lens": [2]}}


@pytest.mark.parametrize("name", [
    "artifact_scores", "prepare_artifact", "WnnBatcher", "packed_scores",
    "from_artifact", "wnn_scores", "thermometer", "decompress",
    "forward_binary_fused", "encoder_from_numpy", "fit_gaussian_thermometer",
    "fit_linear_thermometer", "fit_mean_binarizer", "h3_hash",
    "compute_hashes", "init_static", "init_params", "binarize_to_packed",
    "train_one_shot", "evaluate_one_shot", "train_multi_shot", "evaluate",
    "prune_and_finetune", "statics_from_numpy", "params_from_numpy",
    "one_shot_from_numpy", "lm_init_params", "Engine", "serve_main",
    "lm_params_from_numpy", "make_mnist_like", "make_tabular",
    "make_uci_like", "make_lm_tokens", "init_head", "gaussian_thresholds",
    "apply_head", "head_loss", "head_state_from_numpy", "wnn_infer",
    "wnn_scores_tenant", "stacked_scores", "prepare_tenants",
    "WnnTenantBatcher", "quickstart_main", "uleen_edge_pipeline_main",
    "distill_uleen_head_main", "init_mla_cache", "init_paged_mla_cache",
    "serve_stream", "moe_serve_main", "mla_init_params", "ssm_init_params",
    "hybrid_init_params", "init_ssm_state", "init_rg_state",
    "hybrid_serve_main", "encdec_init_params", "init_cross_kv",
    "encdec_serve_main", "vlm_serve_main", "serve_lm_main",
    "loadgen_run_scenario", "loadgen_main", "train_lm", "train_main",
    "data_iterator", "train_lm_example_main", "uleen_smoke_problem",
    "train_uleen", "uleen_reference_params", "uleen_parity_probe",
    "train_main_uleen", "train_main_uleen_mesh", "block_generator",
    "uleen_train_state_from_numpy"])
def test_entry_points_raise_without_a_gpu_unless_asked_for_the_cpu(name):
    _no_gpu()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _entry_points()[name]()


@pytest.mark.parametrize("alone", [False, True],
                         ids=["in_repo", "script_alone"])
def test_chip_smoke_fails_without_a_gpu_or_without_the_repo(tmp_path, alone):
    _no_gpu()
    script = os.path.join(REPO, "chip_smoke.py")
    cwd = REPO
    if alone:
        cwd = str(tmp_path)
        script = shutil.copy(script, cwd)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, script], capture_output=True,
                         text=True, cwd=cwd, env=env, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
