"""Train and eval steps.

Torch counterpart of ``ssdx/train/step.py``: one train step is the forward
in training mode, batched matching, the multibox loss, the backward and the
optimizer update; one eval step is the forward with running statistics,
the losses (with ``img_valid`` for wrap-padded tails) and ``postprocess``,
which runs the NMS kernel on the card.

``fused_stem`` routes conv1_1 + BN + ReLU + conv1_2 + BN + ReLU + pool
through :func:`ssdx_torch.ops.stem_train.stem_train` (kernel B3 on a CUDA
device) and feeds the pooled map to the rest of the model; the two stem
BNs' running statistics are then updated from the batch statistics the
stem returns, with flax's formula.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, NamedTuple

import torch

from ..losses import multibox_loss
from ..matching import build_targets
from ..model import update_running_stats
from ..ops.stem_train import stem_train
from ..predict import Detections, postprocess
from ..weights import state_dict_from_jax

__all__ = ["Batch", "TrainState", "create_train_state", "make_train_step", "make_eval_step"]


def _fused_stem_supported(model) -> bool:
    """The stem kernel is specialised to the full-width 300x300 stem
    (64-channel convs with BN); narrow, folded or stem-input models take
    the plain path."""
    return model.width_mult == 1.0 and not model.fold_bn and not model.stem_input


class Batch(NamedTuple):
    """Fixed-shape training batch (padded GT).

    images:    [B, 300, 300, 3] float32, ImageNet-normalized.
    gt_boxes:  [B, G, 4] xyxy normalized to [0, 1].
    gt_labels: [B, G] int 0-based foreground labels.
    gt_valid:  [B, G] bool.
    """

    images: Any
    gt_boxes: Any
    gt_labels: Any
    gt_valid: Any


@dataclass
class TrainState:
    """The model (weights and running statistics), its optimizer, the LR
    scheduler stepped after every optimizer step (None for a plateau
    optimizer), and the number of steps taken."""

    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: Any = None
    step: int = 0


def create_train_state(model, optimizer, scheduler, variables: dict) -> TrainState:
    """A fresh :class:`TrainState` (``scheduler`` None for a plateau
    optimizer).  ``variables``, a JAX-layout tree such as
    :func:`ssdx_torch.model.init_variables` gives, are loaded into ``model``
    in place, so the optimizer keeps its parameters."""
    dev = _device(model)
    sd = state_dict_from_jax(variables, model.fold_bn)
    model.load_state_dict({k: v.to(dev) for k, v in sd.items()})
    return TrainState(model=model, optimizer=optimizer, scheduler=scheduler, step=0)


def _device(model) -> torch.device:
    return next(model.parameters()).device


def _on(dev, batch: Batch) -> Batch:
    return Batch(*(torch.as_tensor(t, device=dev) for t in batch))


def make_train_step(
    model,
    priors_cxcywh,
    priors_xyxy,
    iou_thresh: float = 0.5,
    neg_pos_ratio: float = 3.0,
    fused_stem: bool | None = None,
):
    """Build ``(state, batch) -> (state, metrics)``.

    ``fused_stem=None`` is on for the full-width model on a CUDA device and
    off on the CPU; ``True`` on another model raises.
    """
    dev = _device(model)
    if fused_stem is None:
        fused_stem = dev.type == "cuda" and _fused_stem_supported(model)
    if fused_stem and not _fused_stem_supported(model):
        raise ValueError("fused_stem requires the full-width SSD300 "
                         "(width_mult=1, no fold_bn/stem_input)")
    priors_cxcywh = torch.as_tensor(priors_cxcywh, device=dev)
    priors_xyxy = torch.as_tensor(priors_xyxy, device=dev)

    def forward(state: TrainState, images):
        m = state.model
        if not fused_stem:
            return m(images, train=True)
        l0, l1 = m.layers[0], m.layers[1]
        p, m1, v1, m2, v2 = stem_train(
            images, l0.conv.weight, l0.conv.bias, l0.bn.weight, l0.bn.bias,
            l1.conv.weight, l1.conv.bias, l1.bn.weight, l1.bn.bias, 1e-5, m.dtype)
        out = m(p, train=True, stem_input=True)
        update_running_stats(l0.bn, m1, v1)
        update_running_stats(l1.bn, m2, v2)
        return out

    def train_step(state: TrainState, batch: Batch):
        batch = _on(dev, batch)
        state.optimizer.zero_grad(set_to_none=True)
        loc, cls = forward(state, batch.images)
        tg = build_targets(batch.gt_boxes, batch.gt_labels, batch.gt_valid,
                           priors_cxcywh, priors_xyxy, iou_thresh)
        total, loc_l, conf_l = multibox_loss(loc, cls, tg.loc, tg.cls, tg.pos, neg_pos_ratio)
        total.backward()
        state.optimizer.step()
        if state.scheduler is not None:
            state.scheduler.step()
        state.step += 1
        metrics = {"loss": total.detach(), "loss_loc": loc_l.detach(),
                   "loss_conf": conf_l.detach()}
        return state, metrics

    return train_step


def make_eval_step(
    model,
    priors_cxcywh,
    priors_xyxy,
    iou_thresh: float = 0.5,
    neg_pos_ratio: float = 3.0,
    score_thresh: float = 0.05,
    nms_thresh: float = 0.5,
    max_per_img: int = 100,
):
    """Build ``(state, batch, img_valid) -> (metrics, Detections)``: the
    losses without a backward, and decoded detections from the same
    forward.  ``img_valid`` [B] bool marks real (non-padded) images; the
    padded tail is excluded from the loss."""
    dev = _device(model)
    priors_cxcywh = torch.as_tensor(priors_cxcywh, device=dev)
    priors_xyxy = torch.as_tensor(priors_xyxy, device=dev)

    @torch.no_grad()
    def eval_step(state: TrainState, batch: Batch, img_valid):
        batch = _on(dev, batch)
        img_valid = torch.as_tensor(img_valid, device=dev)
        loc, cls = state.model(batch.images, train=False)
        tg = build_targets(batch.gt_boxes, batch.gt_labels, batch.gt_valid,
                           priors_cxcywh, priors_xyxy, iou_thresh)
        total, loc_l, conf_l = multibox_loss(loc, cls, tg.loc, tg.cls, tg.pos, neg_pos_ratio,
                                             img_valid=img_valid)
        det: Detections = postprocess(loc, cls, priors_cxcywh, score_thresh=score_thresh,
                                      nms_thresh=nms_thresh, max_per_img=max_per_img)
        metrics = {"loss": total, "loss_loc": loc_l, "loss_conf": conf_l}
        return metrics, det

    return eval_step
