"""Learning-loop check: overfit a tiny synthetic detection dataset.

    python -m ssdx_torch.tools.overfit_check [--epochs 40] [--eval-every 5]
        [--augment] [--min-map M] [--images 32] [--width-mult 1.0] [--device cpu]

The port's counterpart of ``scripts/overfit_check.py``.  Writes 32 images of
coloured rectangles on noise (numpy seed 0, the script's ``make_dataset``)
and runs the real training stack on them: ``DetectionLoader`` -> augmentation
on the device (the identity policy, or the real one with ``--augment``) ->
the bf16 train step (with the train-mode stem kernel B3 at full width on a
CUDA device) -> ``evaluate`` with the NMS kernel and mAP@0.5.  A healthy
stack overfits this to a high mAP within a few dozen epochs.  Prints
``epoch ... loss=... mAP@0.5=...`` at the first epoch and every
``--eval-every``, then ``RESULT: PASS|FAIL``; exits 1 on FAIL.  It passes
when the final mAP@0.5 is above ``--min-map`` (0.5, or 0.3 with
``--augment``) and above the first evaluation's.

Runs on the GPU unless ``--device cpu``, which takes the plain PyTorch path in
float32; ``--width-mult`` thins the network (tests use 0.25 on the CPU).
"""
from __future__ import annotations

import argparse
import sys
import tempfile
from pathlib import Path

import numpy as np
import pandas as pd
import torch

from .. import priors as P
from .. import resolve_device
from ..data.augment import AugmentConfig
from ..data.dataset import DetectionDataset
from ..data.pipeline import DetectionLoader
from ..model import SSD300, init_variables
from ..train.loop import evaluate
from ..train.schedule import build_optimizer
from ..train.step import create_train_state, make_eval_step, make_train_step

__all__ = ["make_dataset", "main"]

COLORS = {"car": (255, 40, 40), "truck": (40, 255, 40), "pedestrian": (40, 40, 255)}


def make_dataset(root: Path, n: int = 32, size: int = 256, seed: int = 0) -> None:
    """``n`` JPEGs of 1-3 coloured rectangles on dark noise, and their CSV."""
    import cv2

    rng = np.random.default_rng(seed)
    rows = []
    names = list(COLORS)
    for i in range(n):
        img = rng.integers(0, 60, (size, size, 3), np.uint8)
        name = f"s{i:03d}.jpg"
        for _ in range(rng.integers(1, 4)):
            cls = names[rng.integers(0, 3)]
            w, h = rng.integers(40, 90, 2)
            x = rng.integers(0, size - w)
            y = rng.integers(0, size - h)
            img[y : y + h, x : x + w] = COLORS[cls]
            rows.append(dict(filename=name, width=size, height=size,
                             **{"class": cls}, xmin=int(x), ymin=int(y),
                             xmax=int(x + w), ymax=int(y + h)))
        cv2.imwrite(str(root / name), img[:, :, ::-1])
    pd.DataFrame(rows).to_csv(root / "ann.csv", index=False)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--epochs", type=int, default=40)
    ap.add_argument("--eval-every", type=int, default=5)
    ap.add_argument("--augment", action="store_true",
                    help="train with the real crop/flip/photometric policy "
                         "instead of the identity config")
    ap.add_argument("--min-map", type=float, default=None,
                    help="pass threshold (default 0.5, or 0.3 with --augment)")
    ap.add_argument("--images", type=int, default=32)
    ap.add_argument("--width-mult", type=float, default=1.0)
    ap.add_argument("--device", default=None,
                    help="default: the GPU; 'cpu' runs the plain path in float32")
    return ap.parse_args(argv)


def main(argv=None, log=print) -> int:
    args = parse_args(argv)
    dev = resolve_device(args.device)
    with tempfile.TemporaryDirectory(prefix="ssdx_torch_overfit_") as tmp:
        make_dataset(Path(tmp), n=args.images)
        ds = DetectionDataset(tmp)
        where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
        log(f"dataset: {len(ds)} images, classes={ds.classes}, device={where}")
        return _train(args, ds, dev, log)


def _train(args, ds, dev, log) -> int:
    if args.augment:
        aug = AugmentConfig()  # the real training policy
    else:
        # light augmentation: no crop/flip/photometric so the model memorizes
        aug = AugmentConfig(small_sampler_options=(2.0,), large_sampler_options=(2.0,),
                            hflip_prob=0.0, photometric_prob=0.0)
    common = dict(source_size=256, max_boxes=8, num_workers=4, device=dev)
    train_loader = DetectionLoader(ds, 16, train=True, augment_cfg=aug, **common)
    val_loader = DetectionLoader(ds, 16, train=False, **common)

    num_classes = len(ds.classes) + 1
    dtype = torch.float32 if dev.type == "cpu" else torch.bfloat16
    model = SSD300(num_classes, dtype=dtype, width_mult=args.width_mult).to(
        dev, memory_format=torch.channels_last)
    steps = max(1, len(train_loader))
    optimizer, sched = build_optimizer(model.parameters(), steps_per_epoch=steps,
                                       max_epochs=args.epochs, warmup_epochs=2, base_lr=2e-3,
                                       min_lr=1e-4, weight_decay=5e-4)
    state = create_train_state(model, optimizer, sched,
                               init_variables(num_classes, seed=0, width_mult=args.width_mult))
    pri = P.create_priors()
    train_step = make_train_step(model, pri, P.priors_xyxy(pri), iou_thresh=0.4)
    eval_step = make_eval_step(model, pri, P.priors_xyxy(pri), iou_thresh=0.4,
                               score_thresh=0.2, nms_thresh=0.3, max_per_img=20)

    first_map = last_map = None
    for epoch in range(args.epochs):
        losses = []
        for item in train_loader:
            state, metrics = train_step(state, item.batch)
            losses.append(float(metrics["loss"]))
        if (epoch + 1) % args.eval_every == 0 or epoch == 0:
            m = float(evaluate(eval_step, state, val_loader)["mAP"]["map_50"])
            if first_map is None:
                first_map = m
            last_map = m
            log(f"epoch {epoch:3d}  loss={np.mean(losses):7.4f}  mAP@0.5={m:.4f}")

    min_map = args.min_map if args.min_map is not None else (0.3 if args.augment else 0.5)
    ok = last_map is not None and last_map > min_map and last_map > (first_map or 0)
    log(f"RESULT: {'PASS' if ok else 'FAIL'}  (first mAP={first_map:.4f}, "
        f"final mAP={last_map:.4f})")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
