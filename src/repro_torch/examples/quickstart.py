"""Quickstart: train a ULEEN ensemble end to end and export it.

The paper's full pipeline (Fig. 7b) through the port's public API:
encode -> one-shot baseline -> multi-shot STE training -> prune 30 % +
fine-tune -> binarize -> export a deployable bit-packed artifact ->
estimate its cost on the paper's FPGA/ASIC accelerator model.

    PYTHONPATH=src python -m repro_torch.examples.quickstart --device cuda
"""
import argparse
import os
import tempfile

import numpy as np
import torch

from repro_torch.core import export, hwmodel, one_shot
from repro_torch.core.encoding import fit_gaussian_thermometer
from repro_torch.core.model import (SubmodelSpec, UleenSpec, init_params,
                                    init_static)
from repro_torch.core.multi_shot import MultiShotConfig, train_multi_shot
from repro_torch.core.pruning import prune_and_finetune
from repro_torch.data.synth import make_mnist_like
from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.kernels import ops


def encode(enc, x):
    """(B, F) features -> (B, F·T) int8 thermometer bits (the encode kernel
    on a GPU)."""
    return ops.thermometer(x, enc.thresholds,
                           device=x.device).reshape(x.shape[0], -1)


def main(device=DEFAULT_DEVICE) -> dict:
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(0)
    # 1. data (synthetic MNIST stand-in) + encoding
    ds = make_mnist_like(gen, n_train=4000, n_test=1000, hw=16, device=dev)
    enc = fit_gaussian_thermometer(ds.x_train, bits=2, device=dev)
    bits_tr, bits_te = encode(enc, ds.x_train), encode(enc, ds.x_test)
    print(f"data: {tuple(ds.x_train.shape)} -> {bits_tr.shape[1]} "
          f"thermometer bits")

    # 2. model: additive ensemble of three Bloom-filter WiSARD submodels
    spec = UleenSpec(num_classes=10, total_bits=bits_tr.shape[1],
                     submodels=(SubmodelSpec(12, 6), SubmodelSpec(16, 6),
                                SubmodelSpec(20, 6)),
                     bits_per_input=2)
    statics = init_static(gen, spec, device=dev)

    # 3. one-shot baseline (counting Bloom + bleaching), then multi-shot STE
    osm = one_shot.train_one_shot(spec, statics, bits_tr, ds.y_train,
                                  bits_te, ds.y_test, device=dev)
    acc_os = one_shot.evaluate_one_shot(spec, statics, osm, bits_te,
                                        ds.y_test, device=dev)
    print(f"one-shot + bleach(b={int(osm.bleach)}): {acc_os:.1%}")

    params = init_params(gen, spec, init_scale=0.1, device=dev)
    res = train_multi_shot(spec, statics, params, bits_tr, ds.y_train,
                           bits_te, ds.y_test,
                           MultiShotConfig(epochs=15, batch_size=128,
                                           learning_rate=1e-2, verbose=True),
                           device=dev)
    print(f"multi-shot: {res.val_accuracy:.1%}")

    # 4. prune 30 % + fine-tune, binarize, export (and read it back)
    pruned = prune_and_finetune(spec, statics, res.params, bits_tr,
                                ds.y_train, bits_te, ds.y_test, ratio=0.3,
                                finetune=MultiShotConfig(epochs=4,
                                                         batch_size=128,
                                                         learning_rate=5e-3),
                                device=dev)
    art = export.export_model(spec, statics, pruned.params)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "uleen_quickstart.npz")
        export.save(art, path)
        loaded = export.load(path)
    for a, b in zip(art.submodels, loaded.submodels):
        assert np.array_equal(a.packed, b.packed)
    print(f"pruned: {pruned.val_accuracy:.1%} at {art.size_kib:.1f} KiB "
          f"(full: {spec.size_kib():.1f} KiB), saved and loaded back")

    # 5. edge-hardware cost on the paper-calibrated accelerator model
    counts = hwmodel.counts_from_artifact(art)
    plats = hwmodel.calibrated_platforms()
    reports = {}
    for name in ("fpga", "asic"):
        r = reports[name] = hwmodel.evaluate_design(counts, plats[name])
        print(f"{name} (paper-calibrated accelerator model, not a GPU "
              f"measurement): {r.throughput_kips:,.0f} kIPS, "
              f"{r.latency_us:.3f} us latency, "
              f"{r.energy_uj_steady * 1000:.1f} nJ/inference")
    return {"one_shot_acc": acc_os, "multi_shot_acc": res.val_accuracy,
            "pruned_acc": pruned.val_accuracy, "size_kib": art.size_kib,
            "hw_model": reports}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default=DEFAULT_DEVICE,
                    help="cuda (the default) or cpu")
    main(device=ap.parse_args().device)
