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

Under a ``mesh`` (:mod:`ssdx_torch.mesh`) every rank calls the step with its
slice of the global batch and the step computes what one device computes on
the whole batch: BatchNorm statistics are all-reduced (in the model and in
the stem kernel), the loss divides by the global batch's positive count, the
gradients are summed over the ranks in one flat buffer before the optimizer
step, and the reported metrics are the global ones on every rank.

On a CUDA device without a ``mesh`` or NaN checks, the forward, targets,
loss and backward of the first step's batch layout are replayed from a CUDA
graph (see :class:`_StepGraph`): the host then enqueues the step with one
call instead of the many small launches of Python and autograd, and the
card no longer waits between them.  The optimizer and the scheduler stay
eager, after the replay, so the learning rate stays a float in
``param_groups``.  A replay launches the same kernels on the same data in
the same order as the eager step, so the two agree bit for bit.

The step's phases (batch copy, forward, targets and loss, backward,
optimizer) are spans of :func:`ssdx_torch.utils.profiling.span`, which do
nothing unless a profiler runs.  The step's span counts ``steps`` (1),
``replayed`` (1 when the graph ran it), ``bn_layers`` (the train-mode BN
layers its forward runs through ``ConvBNRelu``, every one but the stem
kernel's) and ``bn_fused`` (how many of them ran on the BN + ReLU kernels,
the movement of ``ops.bn_relu_pool.launches_bn_relu`` over the step, which
a replay moves too); under a replay the forward, targets and loss and
backward spans do not run.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, NamedTuple

import torch

from ..losses import multibox_loss
from ..matching import build_targets
from ..mesh import all_reduce_sum, broadcast_
from ..model import _STEM_LAYERS, update_running_stats
from .. import ops
from ..ops import bn_relu_pool as bn_relu_ops
from ..ops.stem_train import stem_train
from ..predict import Detections, postprocess
from ..utils import debug
from ..utils.profiling import span
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


def create_train_state(model, optimizer, scheduler, variables: dict, mesh=None) -> TrainState:
    """A fresh :class:`TrainState` (``scheduler`` None for a plateau
    optimizer).  ``variables``, a JAX-layout tree such as
    :func:`ssdx_torch.model.init_variables` gives, are loaded into ``model``
    in place, so the optimizer keeps its parameters.  Under a ``mesh`` rank
    0's parameters and BN buffers are then broadcast to every rank."""
    dev = _device(model)
    sd = state_dict_from_jax(variables, model.fold_bn)
    model.load_state_dict({k: v.to(dev) for k, v in sd.items()})
    with torch.no_grad():
        for t in list(model.parameters()) + list(model.buffers()):
            broadcast_(t, mesh)
    return TrainState(model=model, optimizer=optimizer, scheduler=scheduler, step=0)


def _device(model) -> torch.device:
    return next(model.parameters()).device


def _on(dev, batch: Batch) -> Batch:
    return Batch(*(torch.as_tensor(t, device=dev) for t in batch))


def _global_pos(pos_mask, mesh, img_valid=None):
    """clamp(number of positive priors in the global batch, 1)."""
    posf = pos_mask.float()
    if img_valid is not None:
        posf = posf * img_valid.float()[:, None]
    return torch.clamp(all_reduce_sum(posf.sum(), mesh), min=1.0)


def _global_losses(total, loc_l, conf_l, mesh):
    """The three losses of the global batch, stacked: the ranks' shares
    added up."""
    return all_reduce_sum(torch.stack([total.detach(), loc_l.detach(), conf_l.detach()]), mesh)


def _metrics(m) -> dict:
    return {"loss": m[0], "loss_loc": m[1], "loss_conf": m[2]}


def _all_reduce_grads(params, mesh) -> None:
    """Sum every gradient over the ranks, through one flat buffer."""
    grads = [p.grad for p in params if p.grad is not None]
    flat = all_reduce_sum(torch.cat([g.reshape(-1) for g in grads]), mesh)
    for g, chunk in zip(grads, flat.split([g.numel() for g in grads])):
        g.copy_(chunk.view_as(g))


def _graphable(dev, mesh) -> bool:
    """Whether the steps of a model on ``dev`` under ``mesh`` replay from a
    CUDA graph (those without NaN checks): a CUDA device and no mesh, whose
    collectives stay eager."""
    return dev.type == "cuda" and mesh is None


def _storage(model) -> tuple:
    """Where the model's parameters and buffers live, and which parameters
    take a gradient: what a captured step reads and writes."""
    return (tuple((p.data_ptr(), p.requires_grad) for p in model.parameters())
            + tuple(b.data_ptr() for b in model.buffers()))


class _Captured(NamedTuple):
    """One captured step: the graph, the batch buffers it reads, the stacked
    losses and the gradients it writes, and the kernel launches it makes
    (:func:`ssdx_torch.ops.launches_since`)."""

    graph: Any
    batch: Batch
    losses: torch.Tensor
    params: list
    grads: list
    launched: dict


class _StepGraph:
    """A CUDA graph of ``losses(state, batch)`` (forward, targets, loss and
    backward) for the batch layout (shapes and dtypes) of the first step.

    The first step runs eagerly on the capture stream: the warm-up that
    capture needs (cuDNN's plans, cuBLAS's workspace on that stream).  The
    second step of that layout is captured, then replayed like every later
    one, so no step runs twice; a step of another layout runs eagerly.  A
    replay copies the batch into the graph's own buffers and writes the same
    gradient tensors every time, as an eager backward after
    ``zero_grad(set_to_none=True)`` writes fresh ones; the caller's
    optimizer reads them.  The running statistics' updates are in-place
    copies inside the graph.  Once the model's tensors move (or another
    model comes), the graph is dropped and the next step warms up anew."""

    def __init__(self, losses, dev):
        self.losses, self.dev = losses, dev
        self.layout = self.storage = self.graph = self.stream = None

    def __call__(self, state: TrainState, batch: Batch):
        """``(stacked losses, replayed)`` for one step."""
        layout = tuple((tuple(t.shape), t.dtype) for t in batch)
        storage = _storage(state.model)
        if storage != self.storage:
            self.layout, self.storage, self.graph = layout, storage, None
            return self._warm_up(state, batch), False
        if layout != self.layout:
            return self.losses(state, batch), False
        if self.graph is None:
            self.graph = self._capture(state, batch)
        return self._replay(self.graph, batch), True

    def _warm_up(self, state: TrainState, batch: Batch):
        if self.stream is None:
            self.stream = torch.cuda.Stream(self.dev)
        main = torch.cuda.current_stream(self.dev)
        self.stream.wait_stream(main)
        with torch.cuda.stream(self.stream):
            out = self.losses(state, batch)
        main.wait_stream(self.stream)
        return out

    def _capture(self, state: TrainState, batch: Batch) -> _Captured:
        static = Batch(*(torch.empty_like(t) for t in batch))
        graph = torch.cuda.CUDAGraph()
        before = ops.launch_counts()
        with torch.cuda.graph(graph, stream=self.stream, capture_error_mode="thread_local"):
            out = self.losses(state, static)
        launched = ops.launches_since(before)
        ops.add_launches(launched, -1)  # the capture ran none; each replay counts them
        params = list(state.model.parameters())
        return _Captured(graph, static, out, params, [p.grad for p in params], launched)

    def _replay(self, g: _Captured, batch: Batch):
        for dst, src in zip(g.batch, batch):
            dst.copy_(src)
        g.graph.replay()
        for p, grad in zip(g.params, g.grads):
            if p.grad is not grad:  # an eager step of another layout replaced it
                p.grad = grad
        ops.add_launches(g.launched)
        return g.losses.clone()


def make_train_step(
    model,
    priors_cxcywh,
    priors_xyxy,
    iou_thresh: float = 0.5,
    neg_pos_ratio: float = 3.0,
    fused_stem: bool | None = None,
    mesh=None,
):
    """Build ``(state, batch) -> (state, metrics)``.

    ``fused_stem=None`` is on for the full-width model on a CUDA device and
    off on the CPU; ``True`` on another model raises.  With a ``mesh``,
    ``batch`` is this rank's slice of the global batch.  After
    :func:`ssdx_torch.utils.debug.enable_nan_checks` a loss that is not
    finite raises ``FloatingPointError`` (the check reads the loss, which
    waits for the device).
    """
    dev = _device(model)
    if fused_stem is None:
        fused_stem = dev.type == "cuda" and _fused_stem_supported(model)
    if fused_stem and not _fused_stem_supported(model):
        raise ValueError("fused_stem requires the full-width SSD300 "
                         "(width_mult=1, no fold_bn/stem_input)")
    priors_cxcywh = torch.as_tensor(priors_cxcywh, device=dev)
    priors_xyxy = torch.as_tensor(priors_xyxy, device=dev)
    first = _STEM_LAYERS if fused_stem else 0
    bn_layers = sum(layer.bn is not None for layer in model.layers[first:])

    def forward(state: TrainState, images):
        m = state.model
        if not fused_stem:
            return m(images, train=True, mesh=mesh)
        l0, l1 = m.layers[0], m.layers[1]
        p, m1, v1, m2, v2 = stem_train(
            images, l0.conv.weight, l0.conv.bias, l0.bn.weight, l0.bn.bias,
            l1.conv.weight, l1.conv.bias, l1.bn.weight, l1.bn.bias, 1e-5, m.dtype, mesh)
        out = m(p, train=True, stem_input=True, mesh=mesh)
        update_running_stats(l0.bn, m1, v1)
        update_running_stats(l1.bn, m2, v2)
        return out

    def losses(state: TrainState, batch: Batch):
        """Forward, targets, loss and backward: the stacked losses, with the
        gradients in the parameters' ``grad``."""
        state.optimizer.zero_grad(set_to_none=True)
        with span("ssdx_torch.train.forward"):
            loc, cls = forward(state, batch.images)
        with span("ssdx_torch.train.targets_loss"):
            tg = build_targets(batch.gt_boxes, batch.gt_labels, batch.gt_valid,
                               priors_cxcywh, priors_xyxy, iou_thresh)
            total_pos = None if mesh is None else _global_pos(tg.pos, mesh)
            total, loc_l, conf_l = multibox_loss(loc, cls, tg.loc, tg.cls, tg.pos,
                                                 neg_pos_ratio, total_pos=total_pos)
        with span("ssdx_torch.train.backward"):
            total.backward()
        if mesh is not None:
            _all_reduce_grads(list(state.model.parameters()), mesh)
        return _global_losses(total, loc_l, conf_l, mesh)

    graph = _StepGraph(losses, dev) if _graphable(dev, mesh) else None

    def train_step(state: TrainState, batch: Batch):
        with span("ssdx_torch.train.step", steps=1, bn_layers=bn_layers) as step_span:
            fused_before = bn_relu_ops.launches_bn_relu
            with span("ssdx_torch.train.batch_copy"):
                batch = _on(dev, batch)
            if graph is not None and not debug.nan_checks_enabled():
                stacked, replayed = graph(state, batch)
            else:
                stacked, replayed = losses(state, batch), False
            step_span.count(replayed=int(replayed),
                            bn_fused=bn_relu_ops.launches_bn_relu - fused_before)
            metrics = _metrics(stacked)
            if debug.nan_checks_enabled():
                debug.check_finite_loss(metrics["loss"], state.step)
            with span("ssdx_torch.train.optimizer"):
                state.optimizer.step()
                if state.scheduler is not None:
                    state.scheduler.step()
            state.step += 1
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
    mesh=None,
):
    """Build ``(state, batch, img_valid) -> (metrics, Detections)``: the
    losses without a backward, and decoded detections from the same
    forward.  ``img_valid`` [B] bool marks real (non-padded) images; the
    padded tail is excluded from the loss.  With a ``mesh``, ``batch`` and
    ``img_valid`` are this rank's slices: the metrics are the global
    batch's, the detections this rank's images'."""
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
        total_pos = None if mesh is None else _global_pos(tg.pos, mesh, img_valid)
        total, loc_l, conf_l = multibox_loss(loc, cls, tg.loc, tg.cls, tg.pos, neg_pos_ratio,
                                             img_valid=img_valid, total_pos=total_pos)
        det: Detections = postprocess(loc, cls, priors_cxcywh, score_thresh=score_thresh,
                                      nms_thresh=nms_thresh, max_per_img=max_per_img)
        return _metrics(_global_losses(total, loc_l, conf_l, mesh)), det

    return eval_step
