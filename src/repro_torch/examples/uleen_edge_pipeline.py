"""The paper's deployment story, end to end: classifier -> edge artifact.

1. Train the ULN-S-like ensemble (multi-shot) on synthetic MNIST.
2. Prune 30 %, binarize, export the bit-packed artifact (what the paper's
   RTL generator consumes).
3. Serve a batch through the backend-dispatched WNN pipeline
   (`export.artifact_scores`): on a GPU, --backend fused/packed/auto run
   the whole accelerator pipeline (permutation gather -> hash -> lookup ->
   AND -> popcount -> bias) as ONE hand-written kernel launch for the
   ensemble; --backend gather is the plain gather formulation; on the CPU
   every backend runs the plain versions.
4. Report the paper-calibrated FPGA/ASIC accelerator model next to the
   paper's FINN / Bit Fusion comparison points.

    PYTHONPATH=src python -m repro_torch.examples.uleen_edge_pipeline \\
        --backend fused --device cuda
"""
import argparse
import time

import torch

from repro_torch.core import export, hwmodel
from repro_torch.core.encoding import fit_gaussian_thermometer
from repro_torch.core.model import (SubmodelSpec, UleenSpec, init_params,
                                    init_static)
from repro_torch.core.multi_shot import MultiShotConfig, train_multi_shot
from repro_torch.core.pruning import prune_and_finetune
from repro_torch.data.synth import make_mnist_like
from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.examples.quickstart import encode


def main(backend: str = "auto", device=DEFAULT_DEVICE) -> dict:
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(0)
    ds = make_mnist_like(gen, n_train=4000, n_test=1000, hw=16, device=dev)
    enc = fit_gaussian_thermometer(ds.x_train, 2, device=dev)
    bits_tr, bits_te = encode(enc, ds.x_train), encode(enc, ds.x_test)

    spec = UleenSpec(num_classes=10, total_bits=bits_tr.shape[1],
                     submodels=(SubmodelSpec(12, 6), SubmodelSpec(16, 6),
                                SubmodelSpec(20, 6)), bits_per_input=2)
    statics = init_static(gen, spec, device=dev)
    params = init_params(gen, spec, init_scale=0.1, device=dev)
    res = train_multi_shot(spec, statics, params, bits_tr, ds.y_train,
                           bits_te, ds.y_test,
                           MultiShotConfig(epochs=15, batch_size=128,
                                           learning_rate=1e-2), device=dev)
    res = prune_and_finetune(spec, statics, res.params, bits_tr, ds.y_train,
                             bits_te, ds.y_test, ratio=0.3,
                             finetune=MultiShotConfig(epochs=4,
                                                      batch_size=128,
                                                      learning_rate=5e-3),
                             device=dev)
    art = export.export_model(spec, statics, res.params)
    print(f"trained: {res.val_accuracy:.1%} @ {art.size_kib:.1f} KiB "
          f"({art.packed_size_kib:.1f} KiB word-aligned packed); "
          f"{art.hash_ops_per_inference} hash ops + "
          f"{art.lookups_per_inference} lookups / inference")

    # --- serve through the backend-dispatched WNN pipeline ---
    # "packed"/"auto" serve the artifact's native uint32 bitplanes (no
    # int8 table is ever built); tables are prepared once
    # (export.prepare_artifact) and cached.
    batch = bits_te[:256]
    t0 = time.perf_counter()
    scores = export.artifact_scores(art, batch, backend=backend, device=dev)
    pred = torch.argmax(scores, -1)
    acc = float((pred == ds.y_test[:256]).float().mean())
    seconds = time.perf_counter() - t0
    where = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
             else "cpu, plain versions")
    print(f"{backend}-backend serving: {acc:.1%} on 256 requests "
          f"({seconds:.3f}s, first call with table preparation, {where})")

    # --- edge hardware report: the paper-calibrated accelerator model ---
    counts = hwmodel.counts_from_artifact(art)
    plats = hwmodel.calibrated_platforms()
    fpga = hwmodel.evaluate_design(counts, plats["fpga"])
    asic = hwmodel.evaluate_design(counts, plats["asic"])
    print(f"FPGA model (Z7045-class, paper-calibrated; not a GPU "
          f"measurement): {fpga.throughput_kips:,.0f} kIPS, "
          f"{fpga.latency_us:.3f} us, {fpga.energy_uj_steady:.3f} uJ/inf "
          f"(paper's FINN SFC: 12,361 kIPS, 0.31 us, 0.591 uJ)")
    print(f"ASIC model (45nm, paper-calibrated; not a GPU measurement): "
          f"{asic.throughput_kips:,.0f} kIPS, "
          f"{asic.energy_uj_steady * 1e3:.1f} nJ/inf, "
          f"{asic.area_mm2:.2f} mm2 "
          f"(paper's BitFusion BF32: 19.1 kIPS, 93,589 nJ)")
    return {"trained_acc": res.val_accuracy, "served_acc": acc,
            "size_kib": art.size_kib, "scores": scores,
            "hw_model": {"fpga": fpga, "asic": asic}}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--backend",
                    choices=["fused", "gather", "packed", "auto"],
                    default="auto", help="WNN inference backend")
    ap.add_argument("--device", default=DEFAULT_DEVICE,
                    help="cuda (the default) or cpu")
    args = ap.parse_args()
    main(backend=args.backend, device=args.device)
