"""UleenHead: attach the paper's technique to an LM backbone.

A Llama 3.2 3B backbone (its smoke-size config here) produces pooled
token embeddings for a synthetic sequence-classification task; a
weightless (Bloom-filter WiSARD) head is trained on those states with
STE, then served binarized through the WNN pipeline — the
"classification distillation to an extreme-edge artifact" use case.
`make_task`, `pooled_states` and `train_head` also drive the head at the
backbone's full width (`chip_smoke.py`).

    PYTHONPATH=src python -m repro_torch.examples.distill_uleen_head \\
        --backend packed --device cuda
"""
import argparse

import torch

from repro_torch.configs import get_config
from repro_torch.core.head import (UleenHeadConfig, apply_head, head_loss,
                                   init_head)
from repro_torch.core.model import SubmodelSpec
from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.models import transformer
from repro_torch.train import optimizer as opt_lib

NUM_CLASSES = 4
TEST_ROWS = 128


def make_task(cfg, generator: torch.Generator, n: int = 1536,
              seq: int = 32, pool: int | None = None):
    """Sequences whose class is the dominant vocabulary quartile: 95 % of
    the tokens fall in the class's quarter of the vocabulary (its first
    `pool` ids when given; by default all of it, as the JAX example
    draws). Returns (tokens (n, seq) int32, labels (n,) int64) on the
    generator's device."""
    dev = generator.device
    y = torch.randint(0, NUM_CLASSES, (n,), generator=generator, device=dev)
    span = cfg.vocab_size // NUM_CLASSES
    base = torch.randint(0, cfg.vocab_size, (n, seq), generator=generator,
                         device=dev)
    biased = y[:, None] * span + base % (pool or span)
    pick = torch.rand((n, seq), generator=generator, device=dev) < 0.95
    return torch.where(pick, biased, base).to(torch.int32), y


def pooled_states(params, tokens: torch.Tensor) -> torch.Tensor:
    """Mean-pooled token embeddings (B, D).

    A trained backbone would pool its final hidden states; with random
    weights the layers scramble the class signal, so the head reads the
    shallowest features, which is also the realistic early-exit
    attachment point."""
    return torch.mean(params.embed[tokens.long()], dim=1)


def head_config(hidden_dim: int) -> UleenHeadConfig:
    """4 thermometer bits a feature, two submodels of 64-entry filters."""
    return UleenHeadConfig(num_classes=NUM_CLASSES, hidden_dim=hidden_dim,
                           bits_per_feature=4,
                           submodels=(SubmodelSpec(8, 6),
                                      SubmodelSpec(16, 6)))


def init_scaled_head(generator, cfg, *, device):
    """`init_head` with tables scaled by 0.1, as the JAX example does."""
    state = init_head(generator, cfg, device=device)
    return state._replace(params=state.params._replace(
        tables=tuple(t * 0.1 for t in state.params.tables)))


def make_step(cfg, state, h, y, lr: float = 1e-2):
    """One Adam step of the head's loss on (h, y) with dropout:
    `step(params, opt_state, generator) -> (params, opt_state, loss)`,
    and the initial optimizer state."""
    opt = opt_lib.adam(lr)
    n_tables = len(state.params.tables)

    def step(params, ost, generator):
        leaves = [t.detach().requires_grad_(True)
                  for t in (*params.tables, params.bias)]
        params = params._replace(tables=tuple(leaves[:n_tables]),
                                 bias=leaves[n_tables])
        loss = head_loss(cfg, state._replace(params=params), h, y,
                         generator=generator, device=h.device)
        grads = torch.autograd.grad(loss, leaves)
        upd, ost = opt.update(grads, ost)
        new = opt_lib.apply_updates([x.detach() for x in leaves], upd)
        return (params._replace(tables=tuple(new[:n_tables]),
                                bias=new[n_tables]), ost, loss.detach())

    return step, opt.init([*state.params.tables, state.params.bias])


def train_head(cfg, state, h, y, generator, *, steps: int = 150,
               lr: float = 1e-2, log=print):
    """`steps` Adam steps at `lr` on all of (h, y); returns the trained
    params and the loss of every step."""
    step, ost = make_step(cfg, state, h, y, lr)
    params, losses = state.params, []
    for i in range(steps):
        params, ost, loss = step(params, ost, generator)
        losses.append(loss)
        if log is not None and i % 20 == 0:
            log(f"step {i}: head loss {float(loss):.4f}")
    return params, [float(x) for x in losses]


def main(backend: str = "auto", device=DEFAULT_DEVICE) -> dict:
    dev = resolve_device(device)
    cfg = get_config("llama3p2_3b", smoke=True)
    backbone = transformer.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    tokens, y = make_task(cfg, torch.Generator(device=dev).manual_seed(1))
    with torch.no_grad():
        h = pooled_states(backbone, tokens)
    h_te, y_te = h[-TEST_ROWS:], y[-TEST_ROWS:]
    h, y = h[:-TEST_ROWS], y[:-TEST_ROWS]
    print(f"backbone pooled states: {tuple(h.shape)}")

    head_cfg = head_config(cfg.d_model)
    gen = torch.Generator(device=dev).manual_seed(2)
    state = init_scaled_head(gen, head_cfg, device=dev)
    params, losses = train_head(head_cfg, state, h, y, gen)
    state = state._replace(params=params)

    with torch.no_grad():
        scores = apply_head(head_cfg, state, h_te, device=dev)
    acc = float((torch.argmax(scores, -1) == y_te).float().mean())
    bits = sum(int(m.sum()) * (1 << s.log2_entries) for m, s in
               zip(params.masks, head_cfg.submodels))
    print(f"weightless head: {acc:.1%} test accuracy, "
          f"{bits / 8 / 1024:.1f} KiB if exported standalone")
    assert acc > 0.5, f"head test accuracy {acc}"

    # deployed formulation: binarize the head and serve it through the
    # backend-dispatched WNN pipeline — what the exported edge artifact
    # would run
    dep = apply_head(head_cfg, state, h_te, backend=backend, device=dev)
    dep_acc = float((torch.argmax(dep, -1) == y_te).float().mean())
    print(f"{backend}-backend deployed head: {dep_acc:.1%} "
          "(binarized tables, int32 scores)")
    return {"test_acc": acc, "deployed_acc": dep_acc, "losses": losses,
            "deployed_scores": dep}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--backend",
                    choices=["fused", "gather", "packed", "auto"],
                    default="auto", help="deployed WNN inference backend")
    ap.add_argument("--device", default=DEFAULT_DEVICE,
                    help="cuda (the default) or cpu")
    args = ap.parse_args()
    main(backend=args.backend, device=args.device)
