"""The system under test, built as a user builds it from ``ssdx_torch``.

The benchmark takes from the program only its public entry points, its
counters and its kernels' names; whatever the program derives (folded
weights, int8 scales, priors) it derives itself.  The weights it is given
are the benchmark's: the demo bundle by path, or parameters drawn by
``portbench.reference.ssd300.init_params``, handed over in the layout the
program loads (a tree of HWIO kernels, as the bundle holds them).
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def jax_layout(params: dict) -> dict:
    """The benchmark's parameter dict as the tree of HWIO numpy arrays
    that the program's loaders take (``{'params', 'batch_stats'}``)."""
    hwio = lambda w: np.ascontiguousarray(w.detach().float().cpu().numpy().transpose(2, 3, 1, 0))
    npy = lambda t: t.detach().float().cpu().numpy()
    tree, stats = {}, {}
    for i, c in enumerate(params["convs"]):
        mod = {"Conv_0": {"kernel": hwio(c["w"]), "bias": npy(c["b"])}}
        if c["bn"] is not None:
            mod["BatchNorm_0"] = {"scale": npy(c["bn"]["gamma"]), "bias": npy(c["bn"]["beta"])}
            stats[f"ConvBNRelu_{i}"] = {"BatchNorm_0": {"mean": npy(c["bn"]["mean"]),
                                                        "var": npy(c["bn"]["var"])}}
        tree[f"ConvBNRelu_{i}"] = mod
    for i, (lh, ch) in enumerate(zip(params["loc"], params["conf"])):
        tree[f"box_head_{i}"] = {"kernel": hwio(lh["w"]), "bias": npy(lh["b"])}
        tree[f"cls_head_{i}"] = {"kernel": hwio(ch["w"]), "bias": npy(ch["b"])}
    return {"params": tree, "batch_stats": stats}


def detector(serve: dict, root: Path, device, params: dict | None = None):
    """The serving ``Detector`` of a configuration's ``serve`` section:
    BN folded, in its dtype, with the stem kernel where it asks for it;
    weights from the bundle at ``serve['weights']`` or from ``params``."""
    from ssdx_torch.api import Detector
    from ssdx_torch.serve.app import CLASS_TO_IDX

    kw = dict(fold_bn=True, stem_kernel=serve["stem_kernel"], dtype=DTYPES[serve["dtype"]],
              device=device, width_mult=serve.get("width_mult", 1.0))
    if params is None:
        return Detector.from_weights(root / serve["weights"], CLASS_TO_IDX, **kw)
    return Detector(CLASS_TO_IDX, variables=jax_layout(params), **kw)


def train_state(train: dict, params: dict, device, num_classes: int, schedule_step: int):
    """(TrainState, step function, {leaf name: (parameter, rows)}) for a
    configuration's ``train`` section, its learning-rate schedule at
    ``schedule_step`` as a resumed run holds it; the leaf map ties each
    program parameter (or its rows, for the fused heads) to the reference's
    leaf."""
    from ssdx_torch import priors as P
    from ssdx_torch.model import SSD300
    from ssdx_torch.train.schedule import build_optimizer
    from ssdx_torch.train.step import create_train_state, make_train_step

    model = SSD300(num_classes, dtype=DTYPES[train["dtype"]],
                   width_mult=train.get("width_mult", 1.0))
    model.to(device, memory_format=torch.channels_last)
    opt = train["optimizer"]
    optimizer, sched = build_optimizer(
        model.parameters(), steps_per_epoch=opt["steps_per_epoch"], max_epochs=opt["epochs"],
        warmup_epochs=opt["warmup_epochs"], base_lr=opt["base_lr"], min_lr=opt["min_lr"],
        momentum=opt["momentum"], weight_decay=opt["weight_decay"])
    state = create_train_state(model, optimizer, sched, jax_layout(params))
    sched.last_epoch = state.step = schedule_step
    for g, f in zip(optimizer.param_groups, sched.lr_lambdas):
        g["lr"] = g["initial_lr"] * f(schedule_step)
    pri = P.create_priors()
    step = make_train_step(model, pri, P.priors_xyxy(pri), iou_thresh=train["iou_thresh"],
                           neg_pos_ratio=train["neg_pos_ratio"], fused_stem=train["fused_stem"])
    leaves = {}
    for i, layer in enumerate(model.layers):
        leaves[f"conv{i}.w"] = (layer.conv.weight, None)
        leaves[f"conv{i}.b"] = (layer.conv.bias, None)
        if layer.bn is not None:
            leaves[f"conv{i}.gamma"] = (layer.bn.weight, None)
            leaves[f"conv{i}.beta"] = (layer.bn.bias, None)
    for i, (head, lh) in enumerate(zip(model.heads, params["loc"])):
        n = lh["w"].shape[0]
        leaves[f"loc{i}.w"] = (head.weight, slice(0, n))
        leaves[f"loc{i}.b"] = (head.bias, slice(0, n))
        leaves[f"conf{i}.w"] = (head.weight, slice(n, None))
        leaves[f"conf{i}.b"] = (head.bias, slice(n, None))
    return state, step, leaves


def batch(tensors: dict, device):
    """A ``Batch`` on ``device`` from pinned host tensors, copied without
    blocking, as the program's loader feeds its steps."""
    from ssdx_torch.train.step import Batch

    return Batch(*(tensors[k].to(device, non_blocking=True)
                   for k in ("images", "boxes", "labels", "valid")))
