"""Carry state between the JAX package and the port.

The two packages never import each other; state crosses as numpy arrays.
Each `*_from_numpy` function takes what the JAX package holds (converted
with `np.asarray`) and returns the port's object, and `params_to_numpy`
goes back, so both packages can compute on the same artifact, statics,
training state and thresholds; `lm_params_from_numpy` carries an LM's
parameters across for the tests (the chip path initialises on the card)
and `lm_params_to_numpy` carries them, their gradients or a train step's
update back, leaf by leaf; `head_state_from_numpy` carries a
`UleenHead`'s statics, tables and thresholds. Tenant fleets cross
artifact by artifact (`artifact_from_numpy`); a ULEEN training state
(params and Adam state, as a JAX checkpoint holds them) crosses with
`uleen_train_state_from_numpy`.
"""
from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np
import torch

from repro_torch.core import encoding, export, head, model, one_shot
from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.models import transformer
from repro_torch.packed import layout
from repro_torch.train import optimizer


def artifact_from_numpy(arrays: Mapping[str, np.ndarray]
                        ) -> export.InferenceArtifact:
    """An `InferenceArtifact` from the npz-keyed arrays of a JAX artifact:
    `meta`, `bias` and `sm{i}_{packed,mask,perm,h3,cfg}` — exactly what
    `repro.core.export.save` writes."""
    return export.from_arrays({k: np.asarray(v) for k, v in arrays.items()})


def packed_tables_from_binary(statics: Sequence, tables_bin: Sequence,
                              masks: Sequence, bias, entries: Sequence[int],
                              num_classes: int, *,
                              device=DEFAULT_DEVICE) -> layout.PackedTables:
    """The mirror of the JAX `packed.layout.from_binary_model`: statics as
    (perm (N_f, n), h3 (k, n)) numpy pairs, binarized (M, N_f, E) tables,
    masks and bias as numpy arrays."""
    dev = resolve_device(device)
    return layout.from_binary_model(
        statics_from_numpy(statics, device=dev),
        [torch.from_numpy(np.asarray(t) != 0) for t in tables_bin],
        [torch.from_numpy(np.asarray(m)) for m in masks],
        torch.from_numpy(np.asarray(bias)), entries, num_classes, device=dev)


def statics_from_numpy(statics: Sequence, *,
                       device=DEFAULT_DEVICE) -> list:
    """`SubmodelStatic`s from (perm (N_f, n), h3 (k, n)) pairs — a JAX
    `SubmodelStatic` unpacks to exactly that pair. H3 parameters become
    int32 (they lie below E <= 2^15)."""
    dev = resolve_device(device)
    return [model.SubmodelStatic(
        perm=torch.from_numpy(np.array(perm, np.int32)).to(dev),
        h3=torch.from_numpy(np.array(h3).astype(np.int32)).to(dev))
        for perm, h3 in statics]


def params_from_numpy(params, *, device=DEFAULT_DEVICE) -> model.UleenParams:
    """`UleenParams` from a (tables, bias, masks) triple of numpy arrays —
    the field order of the JAX `UleenParams`, which unpacks the same way."""
    dev = resolve_device(device)
    tables, bias, masks = params

    def t(a):
        return torch.from_numpy(np.array(a, np.float32)).to(dev)

    return model.UleenParams(tables=tuple(t(x) for x in tables), bias=t(bias),
                             masks=tuple(t(x) for x in masks))


def params_to_numpy(params: model.UleenParams) -> tuple:
    """(tables, bias, masks) as float32 numpy arrays, in the JAX
    `UleenParams` field order."""
    def a(t):
        return t.detach().cpu().numpy().astype(np.float32)

    return (tuple(a(t) for t in params.tables), a(params.bias),
            tuple(a(m) for m in params.masks))


def uleen_train_state_from_numpy(leaves: Sequence, *,
                                 device=DEFAULT_DEVICE) -> tuple:
    """(UleenParams, AdamState over (tables..., bias)) from the flat leaves
    of the JAX package's `(UleenParams(tables, bias, masks),
    AdamState(step, mu, nu))`, in the order of its `checkpoint.save`'s
    `arrays.npz` (`a0`, `a1`, ...): tables, bias, masks, step, then mu and
    nu each as (tables, bias, masks). With S submodels that is 6·S + 4
    leaves. The masks' moments must be zero (`apply_mask` passes them no
    gradient), and the port's Adam does not carry them."""
    leaves = [np.asarray(x) for x in leaves]
    n_sub, rem = divmod(len(leaves) - 4, 6)
    if rem or n_sub < 1:
        raise ValueError(f"{len(leaves)} leaves are not a ULEEN training "
                         "state (6·S + 4 for S submodels)")
    dev = resolve_device(device)
    per = 2 * n_sub + 1                 # tables, bias, masks

    def triple(flat):
        return (flat[:n_sub], flat[n_sub], flat[n_sub + 1:per])

    params = params_from_numpy(triple(leaves[:per]), device=dev)
    step = leaves[per]
    moments = []
    for flat in (leaves[per + 1:2 * per + 1], leaves[2 * per + 1:]):
        tables, bias, masks = triple(flat)
        if any(np.any(m != 0) for m in masks):
            raise ValueError("the masks' Adam moments are not zero: the "
                             "state does not come from multi-shot training")
        moments.append(tuple(torch.from_numpy(np.array(a, np.float32)).to(
            dev) for a in (*tables, bias)))
    state = optimizer.AdamState(
        step=torch.tensor(int(step), dtype=torch.int32, device=dev),
        mu=moments[0], nu=moments[1])
    return params, state


def one_shot_from_numpy(one_shot_model, *,
                        device=DEFAULT_DEVICE) -> one_shot.OneShotModel:
    """`OneShotModel` from a (counting, bleach, bias) triple of numpy
    arrays (the JAX `OneShotModel` field order)."""
    dev = resolve_device(device)
    counting, bleach, bias = one_shot_model
    return one_shot.OneShotModel(
        counting=tuple(torch.from_numpy(np.array(c, np.int32)).to(dev)
                       for c in counting),
        bleach=torch.tensor(int(np.asarray(bleach)), dtype=torch.int32,
                            device=dev),
        bias=torch.from_numpy(np.array(bias, np.float32)).to(dev))


def encoder_from_numpy(thresholds, *,
                       device=DEFAULT_DEVICE) -> encoding.ThermometerEncoder:
    """A `ThermometerEncoder` on fitted (F, T) thresholds, as float32 (the
    JAX package's dtype; float64 would move `>` at the edges)."""
    dev = resolve_device(device)
    thr = torch.tensor(np.asarray(thresholds, np.float32), device=dev)
    return encoding.ThermometerEncoder(thresholds=thr)


def head_state_from_numpy(state, *, device=DEFAULT_DEVICE
                          ) -> head.UleenHeadState:
    """A `UleenHeadState` from a (params, statics, thresholds) triple —
    the field order of the JAX `UleenHeadState`, which unpacks the same
    way: params as (tables, bias, masks), statics as (perm, h3) pairs,
    thresholds (T,) as float32."""
    dev = resolve_device(device)
    params, statics, thresholds = state
    return head.UleenHeadState(
        params=params_from_numpy(params, device=dev),
        statics=tuple(statics_from_numpy(statics, device=dev)),
        thresholds=torch.from_numpy(
            np.array(thresholds, np.float32)).to(dev))


def lm_params_from_numpy(cfg, tree, *, device=DEFAULT_DEVICE
                         ) -> transformer.ParamTree:
    """The port's parameter tree from a JAX LM parameter pytree converted
    leaf by leaf with `np.asarray` (nested dicts; a segment of repeat > 1
    stacks its layers on a leading (L,) axis, which is unstacked into the
    segment's list of layers; so does Whisper's encoder, one segment of
    `encoder_layers` layers beside its `final_norm`). Dtypes are kept."""
    dev = resolve_device(device)
    transformer.check_supported(cfg)

    def t(a):
        return torch.from_numpy(np.array(a)).to(dev)

    def tensors(node):
        if isinstance(node, Mapping):
            return {k: tensors(v) for k, v in node.items()}
        return t(node)

    def layer(node, li, stacked):
        if isinstance(node, Mapping):
            return {k: layer(v, li, stacked) for k, v in node.items()}
        return t(np.asarray(node)[li] if stacked else node)

    def segments(trees, repeats):
        return [{name: [layer(seg_tree[name], li, repeat > 1)
                        for li in range(repeat)]
                 for name in seg_tree}
                for repeat, seg_tree in zip(repeats, trees, strict=True)]

    out = {k: tensors(v) for k, v in tree.items()
           if k not in ("segments", "encoder")}
    out["segments"] = segments(
        tree["segments"],
        [seg.repeat for seg in transformer.arch_segments(cfg)])
    if "encoder" in tree:
        enc = tree["encoder"]
        out["encoder"] = {
            "segments": segments(enc["segments"], [cfg.encoder_layers]),
            "final_norm": tensors(enc["final_norm"])}
    return transformer.ParamTree(out)


def lm_params_to_numpy(cfg, params) -> dict:
    """The inverse of `lm_params_from_numpy`: the JAX package's LM
    parameter pytree (nested dicts of numpy arrays) from a port
    `ParamTree` — or any tree of its structure, such as the gradients
    or updated parameters of a train step (`steps.tree_with_leaves`). A
    segment of repeat > 1 stacks its layers on a leading (L,) axis, as
    does Whisper's encoder; dtypes are kept (bf16 as numpy's float32,
    numpy having no bf16)."""
    transformer.check_supported(cfg)

    def a(t):
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    def tree(mod):
        out = {name: a(p) for name, p in mod.named_parameters(recurse=False)}
        out.update({name: tree(child) for name, child in mod.named_children()
                    if not isinstance(child, torch.nn.ModuleList)})
        return out

    def stacked(layers, stack):
        trees = [tree(lp) for lp in layers]
        if not stack:
            return trees[0]

        def merge(nodes):
            if isinstance(nodes[0], dict):
                return {k: merge([n[k] for n in nodes]) for k in nodes[0]}
            return np.stack(nodes)
        return merge(trees)

    def segments(seg_mods, repeats):
        return [{name: stacked(list(getattr(seg_mod, name)), repeat > 1)
                 for name, _ in seg_mod.named_children()}
                for repeat, seg_mod in zip(repeats, seg_mods, strict=True)]

    out = tree(params)
    out.pop("segments", None)
    out.pop("encoder", None)
    out["segments"] = segments(
        list(params.segments),
        [seg.repeat for seg in transformer.arch_segments(cfg)])
    if hasattr(params, "encoder"):
        out["encoder"] = {
            "segments": segments(list(params.encoder.segments),
                                 [cfg.encoder_layers]),
            "final_norm": tree(params.encoder.final_norm)}
    return out
