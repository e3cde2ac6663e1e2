"""Epoch-level training orchestration.

Torch counterpart of ``ssdx/train/loop.py``, with the same observable
contract:

  * a results dict with ten series: train/test total+loc+conf losses,
    per-epoch mAP dicts, ``epochs`` and the train/test timing dicts;
  * one console log line per epoch;
  * checkpoint policy: rolling ``last`` every epoch, periodic ``epoch_NNN``,
    ``best`` keyed on validation total loss;
  * optional early stopping on val mAP@0.5, where improvement means mAP
    increased;
  * resumed runs merge the new series onto ``past_train_dict``.

Loaders are any iterables of :class:`~ssdx_torch.train.step.Batch`, or of
objects with ``batch`` and ``count`` (a wrap-padded tail batch).  Timing:
per-batch ``data wait`` and ``step`` times; reading the loss as a float
waits for the device, so the step time is the device's.

Under a ``mesh`` (:mod:`ssdx_torch.mesh`) every rank runs the same loop on
its slices of the global batches.  The step's metrics are global already;
``evaluate`` gathers every rank's detections and ground truth per batch, so
each rank accumulates the whole validation set and computes the same mAP,
and the checkpoint calls go to the directory format.
"""
from __future__ import annotations

import time
from pathlib import Path
from typing import Any, Callable, Iterable

import numpy as np
import torch

from ..eval.map import MeanAP
from ..mesh import all_gather_batch
from ..model import IMAGE_SIZE
from ..predict import Detections, to_pylist
from .checkpoint import save_checkpoint
from .schedule import get_learning_rate, set_learning_rate

__all__ = ["fit", "evaluate", "merge_results"]


def _unpack(item):
    """Accept either a bare Batch or a loaded batch with (batch, count)."""
    if hasattr(item, "batch") and hasattr(item, "count"):
        return item.batch, int(item.count)
    return item, int(item.images.shape[0])


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def merge_results(d1: dict, d2: dict) -> dict:
    """Key-wise concatenation of two homogeneous results dicts; ``epochs``
    takes d2's value.  Nested dicts merge recursively and sets merge
    insertion-style without duplicates; scalar-like leaves become a
    ``(v1, v2)`` tuple."""
    if set(d1.keys()) != set(d2.keys()):
        raise KeyError("Dicts must have identical key sets.")
    out = {}
    for k in d1:
        v1, v2 = d1[k], d2[k]
        if isinstance(v1, np.ndarray) and isinstance(v2, np.ndarray):
            out[k] = np.concatenate([v1, v2], axis=0)
        elif isinstance(v1, (list, tuple)) and isinstance(v2, (list, tuple)):
            out[k] = list(v2) if k == "epochs" else list(v1) + list(v2)
        elif isinstance(v1, dict) and isinstance(v2, dict):
            if set(v1.keys()) == set(v2.keys()):
                out[k] = merge_results(v1, v2)
            else:  # disjoint/partial keys: d2 entries win on overlap
                out[k] = {**v1, **v2}
        elif isinstance(v1, set) and isinstance(v2, set):
            out[k] = list(v1) + [x for x in v2 if x not in v1]
        else:
            out[k] = (v1, v2)
    return out


def _targets_for_map(gt_boxes, gt_labels, gt_valid) -> list[dict]:
    """Per-image GT dicts in 300x300 pixel coords for the mAP accumulator."""
    boxes = _np(gt_boxes) * IMAGE_SIZE
    labels = _np(gt_labels)
    valid = _np(gt_valid).astype(bool)
    return [{"boxes": boxes[i][valid[i]], "labels": labels[i][valid[i]]}
            for i in range(boxes.shape[0])]


def evaluate(eval_step: Callable, state, loader: Iterable, timing: bool = False,
             mesh=None) -> dict:
    """One evaluation pass: losses + mAP@0.5.  With a ``mesh``, ``loader``
    yields this rank's slices with the global ``count``, and ``eval_step``
    was built with the same mesh."""
    metric = MeanAP(iou_threshold=0.5)
    losses = {"loss": 0.0, "loss_loc": 0.0, "loss_conf": 0.0}
    n_batches = 0
    t_pred = 0.0
    rank = 0 if mesh is None else mesh.rank
    for item in loader:
        batch, count = _unpack(item)
        local = batch.images.shape[0]
        img_valid = rank * local + np.arange(local) < count
        t0 = time.perf_counter()
        metrics, det = eval_step(state, batch, img_valid)
        gt = (batch.gt_boxes, batch.gt_labels, batch.gt_valid)
        if mesh is not None:  # every rank's images, in rank order
            dev = det.valid.device
            det = Detections(*(all_gather_batch(t, mesh) for t in det))
            gt = tuple(all_gather_batch(torch.as_tensor(t, device=dev), mesh) for t in gt)
        preds = to_pylist(det)  # copies to the host: waits for the device
        t_pred += time.perf_counter() - t0
        for k in losses:
            losses[k] += float(metrics[k])
        # trim wrap-around padded tail images before metric accumulation
        metric.update(preds[:count], _targets_for_map(*gt)[:count])
        n_batches += 1
    n = max(n_batches, 1)
    t0 = time.perf_counter()
    map_dict = metric.compute()
    t_map = time.perf_counter() - t0
    return {
        "testing loss": losses["loss"] / n,
        "localization loss": losses["loss_loc"] / n,
        "classification loss": losses["loss_conf"] / n,
        "mAP": map_dict,
        "timing": {"model prediction": t_pred / n, "mAP time": t_map},
    }


def fit(
    train_step: Callable,
    eval_step: Callable,
    state,
    train_loader_fn: Callable[[], Iterable],
    val_loader_fn: Callable[[], Iterable],
    epochs: int,
    early_stopping_rounds: int | None = None,
    save_model: bool = False,
    save_best_model: bool = True,
    epoch_save_interval: int | None = None,
    save_dir: str | Path | None = None,
    timing: bool = False,
    past_train_dict: dict | None = None,
    initial_best_err: float | None = None,
    lr_controller=None,
    log: Callable[[str], None] = print,
    mesh=None,
) -> tuple[Any, dict]:
    """Run the train/eval cycle; returns (final_state, results dict).

    ``train_loader_fn``/``val_loader_fn`` are zero-arg callables returning a
    fresh iterable of batches per epoch.  ``lr_controller``: an optional
    :class:`~ssdx_torch.train.schedule.ReduceOnPlateau`, stepped once per
    epoch with the validation loss; the resulting LR is written into the
    optimizer's parameter groups (an optimizer built with
    ``scheduler="plateau"``).  ``mesh``: every rank calls ``fit`` with steps
    and loaders built on the same mesh.
    """
    if save_model and save_dir is None:
        raise TypeError("If the model is to be saved, save_dir must be specified.")

    # ``epochs[0]`` records *completed* epochs, so a checkpointed history
    # from an interrupted run carries the true completed count.
    past_epochs = past_train_dict["epochs"][0] if past_train_dict else 0

    results: dict[str, Any] = {
        "train_loss": [],
        "train_loss_loc": [],
        "train_loss_conf": [],
        "test_loss": [],
        "test_loss_loc": [],
        "test_loss_conf": [],
        "mAP": [],
        "epochs": [past_epochs],
        "training timing": [],
        "testing timing": [],
    }

    best_err = initial_best_err  # best (lowest) validation loss, "best" tag
    best_map = None
    stale_rounds = 0

    for epoch in range(epochs):
        # ---- train ----
        tr = {"loss": 0.0, "loss_loc": 0.0, "loss_conf": 0.0}
        n_batches = 0
        t_data = 0.0
        t_step = 0.0
        t0 = time.perf_counter()
        for item in train_loader_fn():
            batch, _ = _unpack(item)
            t1 = time.perf_counter()
            t_data += t1 - t0
            state, metrics = train_step(state, batch)
            for k in tr:
                tr[k] += float(metrics[k])  # waits for the device
            n_batches += 1
            t0 = time.perf_counter()
            t_step += t0 - t1
        n = max(n_batches, 1)
        train_dict = {
            "training loss": tr["loss"] / n,
            "localization loss": tr["loss_loc"] / n,
            "classification loss": tr["loss_conf"] / n,
            "timing": {"data wait": t_data / n, "step": t_step / n},
        }

        # ---- eval ----
        test_dict = evaluate(eval_step, state, val_loader_fn(), timing=timing, mesh=mesh)
        val_map = test_dict["mAP"]["map_50"]
        val_err = test_dict["testing loss"]

        # ---- per-epoch plateau LR step ----
        if lr_controller is not None:
            new_lr = lr_controller.step(val_err)
            cur_lr = get_learning_rate(state.optimizer)
            if abs(new_lr - cur_lr) > 1e-6 * max(new_lr, cur_lr):
                log(f"ReduceOnPlateau: lr -> {new_lr:.3e}")
                set_learning_rate(state.optimizer, new_lr)

        log(
            f"Epoch: {epoch + past_epochs}  |  mAP: {val_map:.4f}  |  "
            f"Train loc loss: {train_dict['localization loss']:.4f}  |  "
            f"Train class loss: {train_dict['classification loss']:.4f}  |  "
            f"Test loc loss: {test_dict['localization loss']:.4f}  |  "
            f"Test class loss: {test_dict['classification loss']:.4f}"
        )

        results["train_loss"].append(train_dict["training loss"])
        results["train_loss_loc"].append(train_dict["localization loss"])
        results["train_loss_conf"].append(train_dict["classification loss"])
        results["test_loss"].append(test_dict["testing loss"])
        results["test_loss_loc"].append(test_dict["localization loss"])
        results["test_loss_conf"].append(test_dict["classification loss"])
        results["mAP"].append(test_dict["mAP"])
        results["training timing"].append(train_dict["timing"])
        results["testing timing"].append(test_dict["timing"])
        results["epochs"][0] = epoch + past_epochs + 1  # completed so far

        def _loss_dict():
            return (merge_results(past_train_dict, results)
                    if past_train_dict is not None else results)

        # ---- early stopping on val mAP (higher is better) ----
        if early_stopping_rounds is not None:
            if best_map is None or val_map >= best_map:
                best_map = val_map
                stale_rounds = 0
            else:
                stale_rounds += 1
                if stale_rounds >= early_stopping_rounds:
                    log(f"Early stopping after {early_stopping_rounds} rounds "
                        "without improvement.")
                    if save_model:
                        save_checkpoint(epoch=epoch + past_epochs, state=state,
                                        loss_dict=_loss_dict(), best_metric=val_err,
                                        outdir=save_dir, tag="last", mesh=mesh)
                    break

        # ---- checkpointing (tag policy) ----
        if save_model:
            if best_err is None:
                best_err = val_err
            will_save_last = epoch_save_interval is None
            will_save_period = (epoch_save_interval is not None
                                and (epoch + 1) % epoch_save_interval == 0)
            will_save_best = save_best_model and (val_err < best_err)

            common = dict(epoch=epoch + past_epochs,  # 0-based index of completed epoch
                          state=state, loss_dict=_loss_dict(), outdir=save_dir, mesh=mesh)
            if will_save_last:
                save_checkpoint(best_metric=val_err, tag="last", **common)
            if will_save_period:
                save_checkpoint(best_metric=val_err,
                                tag=f"epoch_{epoch + past_epochs + 1:03d}", **common)
            if will_save_best:
                best_err = val_err
                save_checkpoint(best_metric=best_err, tag="best", **common)

    final = merge_results(past_train_dict, results) if past_train_dict is not None else results
    return state, final
