"""End-to-end training command.

The port's counterpart of ``ssdx/train/run.py``: builds the datasets with a
stratified group val split (25 % of train, seed 724), the bootstrap-
oversampled training loader with augmentation on the device, SGD + the
warmup-cosine schedule, auto-resume from ``{save_dir}/last.ckpt`` when
present, then runs the train/eval cycle with the reference's thresholds
(match IoU 0.4, eval score 0.2 / NMS 0.3 / max 100) and finally exports a
weights-only ``last.weights`` for serving, in the layout both packages'
``load_params`` read.

Data parallelism follows the launcher's environment (``RANK``,
``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``): under ``torchrun
--nproc-per-node N -m ssdx_torch.train.run ...`` every rank joins the process
group, ``batch_size`` is the global batch, and the mesh goes to both loaders,
both steps and the checkpoint calls; only rank 0 logs and writes
``last.weights``.  A bare ``python -m`` stays one process.

Usage: ``python -m ssdx_torch.train.run --train-dir data/train [--config
cfg.json] [--save-dir DIR] [--epochs N] [--no-resume] [--smoke] [--cpu]``
"""
from __future__ import annotations

import argparse
import dataclasses
from pathlib import Path

import torch

from .. import priors as P
from ..config import Config
from ..data.augment import AugmentConfig
from ..data.dataset import DetectionDataset
from ..data.pipeline import DetectionLoader
from ..data.split import make_train_test_split
from ..mesh import create_mesh, initialize_distributed
from ..model import SSD300, init_variables
from ..weights import variables_from_torch
from .checkpoint import load_checkpoint, save_params
from .loop import fit
from .schedule import build_optimizer
from .step import create_train_state, make_eval_step, make_train_step

__all__ = ["run", "train_on", "main"]


def run(cfg: Config, epochs: int | None = None, resume: bool = True, log=print, device=None):
    """Train per config; returns (state, results, detector_class_to_idx).

    ``device=None`` is the GPU (see :func:`ssdx_torch.resolve_device`).
    """
    d = cfg.data
    if create_mesh(device).rank != 0:
        log = lambda *_: None
    full = DetectionDataset(d.train_dir)
    train_ds, val_ds = make_train_test_split(full, test_size=d.val_fraction, rand_state=d.seed)
    log(f"dataset: {len(train_ds)} train / {len(val_ds)} val images, "
        f"classes={full.classes}")
    state, results = train_on(train_ds, val_ds, len(full.classes) + 1, cfg, epochs=epochs,
                              resume=resume, log=log, device=device)
    return state, results, full.class_to_idx


def train_on(train_ds, val_ds, num_classes: int, cfg: Config, epochs: int | None = None,
             resume: bool = True, log=print, device=None):
    """Everything of :func:`run` after the split: the two loaders over the
    given datasets, model, optimizer, auto-resume, ``fit`` and the
    ``last.weights`` export; returns (state, results).  Under
    ``torch.distributed`` every rank calls it with the same arguments."""
    d, t, e = cfg.data, cfg.train, cfg.eval
    epochs = epochs if epochs is not None else t.epochs
    mesh = create_mesh(device)
    dev = mesh.device
    if mesh.size == 1:
        mesh = None  # one process: the plain single-device path
    elif mesh.rank != 0:
        log = lambda *_: None

    aug = AugmentConfig(
        zoom_out_prob=d.zoom_out_prob,
        min_area_frac=d.min_area_frac,
        small_min_scale=d.small_min_scale,
        large_min_scale=d.large_min_scale,
    )
    common = dict(source_size=d.source_size, max_boxes=d.max_boxes, num_workers=d.num_workers,
                  seed=d.seed, cache_images=d.cache_images, device=dev, mesh=mesh)
    # Loader objects are persistent (their thread pools are reused); fit()
    # iterates them again every epoch.
    train_loader = DetectionLoader(train_ds, d.batch_size, train=True, bootstrap=d.bootstrap,
                                   augment_cfg=aug, **common)
    val_loader = DetectionLoader(val_ds, d.batch_size, train=False, **common)
    steps_per_epoch = max(1, len(train_loader))

    model = SSD300(num_classes, dtype=torch.bfloat16 if t.bfloat16 else torch.float32,
                   width_mult=t.width_mult).to(dev, memory_format=torch.channels_last)
    optimizer, sched = build_optimizer(
        model.parameters(),
        steps_per_epoch=steps_per_epoch,
        max_epochs=t.epochs,
        warmup_epochs=t.warmup_epochs,
        base_lr=t.base_lr,
        min_lr=t.min_lr,
        momentum=t.momentum,
        weight_decay=t.weight_decay,
        scheduler=t.scheduler,
        plateau_factor=t.plateau_factor,
        plateau_patience=t.plateau_patience,
    )
    plateau = t.scheduler == "plateau"
    state = create_train_state(model, optimizer, None if plateau else sched,
                               init_variables(num_classes, seed=t.seed, width_mult=t.width_mult),
                               mesh=mesh)

    past_train_dict = None
    best_err = None
    resume_path = Path(t.save_dir) / "last.ckpt"
    if resume and resume_path.exists():
        state, start_epoch, best_err, past_train_dict = load_checkpoint(resume_path, state,
                                                                        mesh=mesh)
        # start_epoch = number of completed epochs; only train the remainder
        # (running the same command again after an interruption must not
        # train the full configured count again).
        completed = start_epoch
        remaining = max(0, epochs - completed)
        log(
            f"resumed from {resume_path}: {completed} epochs done, "
            f"{remaining} of {epochs} remaining"
        )
        epochs = remaining

    pri = P.create_priors()
    kw = dict(iou_thresh=t.iou_thresh, neg_pos_ratio=t.neg_pos_ratio, mesh=mesh)
    train_step = make_train_step(model, pri, P.priors_xyxy(pri), fused_stem=t.fused_stem, **kw)
    eval_step = make_eval_step(model, pri, P.priors_xyxy(pri), score_thresh=e.score_thresh,
                               nms_thresh=e.nms_thresh, max_per_img=e.max_per_img, **kw)

    state, results = fit(
        train_step,
        eval_step,
        state,
        train_loader_fn=lambda: train_loader,
        val_loader_fn=lambda: val_loader,
        epochs=epochs,
        early_stopping_rounds=t.early_stopping_rounds,
        save_model=True,
        save_best_model=True,
        epoch_save_interval=t.epoch_save_interval,
        save_dir=t.save_dir,
        timing=True,
        past_train_dict=past_train_dict,
        initial_best_err=best_err,
        lr_controller=sched if plateau else None,
        log=log,
        mesh=mesh,
    )

    if mesh is None or mesh.rank == 0:
        variables = variables_from_torch(state.model)
        save_params(variables["params"], variables["batch_stats"],
                    Path(t.save_dir) / "last.weights")
    return state, results


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--config", help="JSON config overrides")
    ap.add_argument("--train-dir")
    ap.add_argument("--save-dir")
    ap.add_argument("--epochs", type=int)
    ap.add_argument("--no-resume", action="store_true")
    ap.add_argument("--smoke", action="store_true",
                    help="2 epochs, small batch: a sanity run of the pipeline")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU, not the GPU")
    args = ap.parse_args(argv)

    cfg = Config.from_json(args.config) if args.config else Config()
    if args.train_dir:
        cfg = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, train_dir=args.train_dir))
    if args.save_dir:
        cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, save_dir=args.save_dir))
    if args.smoke:
        cfg = dataclasses.replace(
            cfg,
            data=dataclasses.replace(cfg.data, batch_size=8, num_workers=2),
            train=dataclasses.replace(cfg.train, epochs=2),
        )
        args.epochs = 2

    device = "cpu" if args.cpu else None
    initialize_distributed(device=device)
    run(cfg, epochs=args.epochs, resume=not args.no_resume, device=device)


if __name__ == "__main__":
    main()
