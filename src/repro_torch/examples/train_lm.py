"""End-to-end LM training example (port of `examples/train_lm.py`).

Trains a ~25M-parameter llama-family model on the synthetic token stream
through the same driver as the zoo's archs (`launch.train.train`), in
float32 compute, with straggler monitoring and, given `--ckpt-dir`,
step-atomic checkpoints every 50 steps and a restart from the newest:

    PYTHONPATH=src python -m repro_torch.examples.train_lm --device cpu \\
        --steps 20 --batch 2 --seq 64 --ckpt-dir build/lm_ckpt

Without `--device` it runs on the GPU, and raises when there is none.
"""
import argparse

from repro_torch.configs.base import ArchConfig
from repro_torch.device import DEFAULT_DEVICE
from repro_torch.launch import train as train_mod
from repro_torch.train import fault

# ~25M params: CPU-trainable at a few steps/sec
CFG = ArchConfig(
    name="llama-25m", family="dense",
    num_layers=6, d_model=384, num_heads=6, num_kv_heads=2,
    d_ff=1024, vocab_size=8192,
    rope_theta=10000.0, head_dim=64,
)


def main(steps: int = 200, batch: int = 4, seq: int = 256,
         ckpt_dir: str | None = None, device=DEFAULT_DEVICE) -> dict:
    """Train CFG for `steps` steps; returns `train`'s dict. Raises unless
    the loss fell."""
    n_params = CFG.param_count()
    print(f"model: {CFG.name} ~{n_params / 1e6:.1f}M params, "
          f"{batch}x{seq} tokens/step")
    with fault.PreemptionGuard() as guard:
        out = train_mod.train(
            CFG, steps_total=steps, batch=batch, seq=seq, lr=1e-3,
            ckpt_dir=ckpt_dir, ckpt_every=50, compute_dtype=None,
            guard=guard, log_every=10, device=device)
    hist = out["history"]
    print(f"loss: {hist[0]['loss']:.3f} -> {hist[-1]['loss']:.3f} "
          f"over {len(hist)} steps "
          f"(stragglers flagged: {out['straggler_events']})")
    if not hist[-1]["loss"] < hist[0]["loss"]:
        raise AssertionError("training must make progress")
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default=DEFAULT_DEVICE,
                    help="cuda (the default) or cpu")
    args = ap.parse_args()
    main(steps=args.steps, batch=args.batch, seq=args.seq,
         ckpt_dir=args.ckpt_dir, device=args.device)
