"""Train demo weights for the serving app on the bundled-scene distribution.

    python -m ssdx_torch.tools.make_demo_weights [--epochs 60] [--images 64]
        [--size 512] [--eval-every 5] [--min-map 0.5]
        [--out saved_models/best.weights]
        [--bundle ssdx_torch/serve/demo_weights.npz] [--cpu]

The port's counterpart of ``scripts/make_demo_weights.py``, with its recipe:
64 SynthDrive scenes (``data/synth.py``, seed 1000, 512x512, no empty
frames: the renderer behind the app's example scenes), moderate
augmentation, bs=16 with 4 loader threads, warm-up-cosine SGD (2 warm-up
epochs, base LR 2e-3, min LR 1e-4, weight decay 5e-4), match IoU 0.4; an
evaluation on the same scenes (score 0.2, NMS 0.3, at most 50 detections)
every ``--eval-every`` epochs and at the last, keeping a host copy of the
best weights.  Those go to ``--out`` (``save_params``; the app's
``DEFAULT_WEIGHTS``) and to the float16 bundle ``--bundle``
(``save_params_npz``; '' writes none), which the app serves when
``--out`` is absent.  The bundle's default path is gitignored: a bundle is
made, never committed.  Exits 1 when the best mAP@0.5 is below
``--min-map``.

On the card the model trains in bfloat16 with the train-mode stem kernel B3
and evaluates with the NMS kernel B1; ``--cpu`` runs the plain float32 path.
"""
from __future__ import annotations

import argparse
import sys
import tempfile
import time

import numpy as np
import torch

from .. import priors as P
from .. import resolve_device
from ..data.augment import AugmentConfig
from ..data.dataset import DetectionDataset
from ..data.pipeline import DetectionLoader
from ..data.synth import generate_dataset
from ..model import SSD300, init_variables
from ..serve.app import CLASS_TO_IDX, DEFAULT_WEIGHTS, PORT_BUNDLE
from ..train.checkpoint import save_params, save_params_npz
from ..train.loop import evaluate
from ..train.schedule import build_optimizer
from ..train.step import create_train_state, make_eval_step, make_train_step
from ..weights import variables_from_torch

__all__ = ["main"]


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--epochs", type=int, default=60)
    ap.add_argument("--images", type=int, default=64)
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--eval-every", type=int, default=5)
    ap.add_argument("--min-map", type=float, default=0.5)
    ap.add_argument("--out", default=DEFAULT_WEIGHTS)
    ap.add_argument("--bundle", default=str(PORT_BUNDLE),
                    help="also write the float16 .npz demo bundle; '' writes none")
    ap.add_argument("--cpu", action="store_true", help="the plain float32 path on the CPU")
    return ap.parse_args(argv)


def main(argv=None, width_mult: float = 1.0, log=print) -> int:
    """The command; ``width_mult`` thins the network (tests)."""
    args = parse_args(argv)
    dev = resolve_device("cpu" if args.cpu else None)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="ssdx_torch_demo_scenes_") as tmp:
        # no empty frames: every scene has positives for the quick fit
        generate_dataset(tmp, args.images, seed=1000, size=args.size, empty_frac=0.0)
        ds = DetectionDataset(tmp)
        if ds.class_to_idx != CLASS_TO_IDX:
            raise ValueError(f"scene classes {ds.class_to_idx} must match the app's "
                             f"{CLASS_TO_IDX}")
        where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
        log(f"dataset: {len(ds)} scenes, classes={ds.classes}, device={where}")
        best, snap = _train(args, ds, dev, width_mult, log)
    wall = time.perf_counter() - t0

    out = save_params(snap["params"], snap["batch_stats"], args.out)
    if args.bundle:
        bundle = save_params_npz(snap["params"], snap["batch_stats"], args.bundle)
        log(f"bundle: {bundle} ({bundle.stat().st_size / 1e6:.1f} MB f16 npz)")
    ok = best >= args.min_map
    log(f"RESULT: {'PASS' if ok else 'FAIL'}  best mAP@0.5={best:.4f} -> {out}  "
        f"({wall:.1f} s)")
    return 0 if ok else 1


def _train(args, ds, dev, width_mult, log):
    """Train and evaluate; returns the best mAP@0.5 and a host copy of its
    weights (a JAX-layout tree of numpy arrays)."""
    # moderate augmentation: crops teach locality, but the identity option
    # stays dominant so that 64 scenes fit quickly
    aug = AugmentConfig(small_sampler_options=(0.1, 2.0, 2.0),
                        large_sampler_options=(0.3, 2.0, 2.0), photometric_prob=0.25)
    train_loader = DetectionLoader(ds, 16, train=True, num_workers=4, augment_cfg=aug,
                                   device=dev)
    val_loader = DetectionLoader(ds, 16, train=False, num_workers=4, device=dev)

    num_classes = len(ds.classes) + 1
    dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
    model = SSD300(num_classes, dtype=dtype, width_mult=width_mult).to(
        dev, memory_format=torch.channels_last)
    optimizer, sched = build_optimizer(model.parameters(), steps_per_epoch=max(1, len(train_loader)),
                                       max_epochs=args.epochs, warmup_epochs=2, base_lr=2e-3,
                                       min_lr=1e-4, weight_decay=5e-4)
    state = create_train_state(model, optimizer, sched,
                               init_variables(num_classes, seed=0, width_mult=width_mult))
    pri = P.create_priors()
    train_step = make_train_step(model, pri, P.priors_xyxy(pri), iou_thresh=0.4)
    eval_step = make_eval_step(model, pri, P.priors_xyxy(pri), iou_thresh=0.4,
                               score_thresh=0.2, nms_thresh=0.3, max_per_img=50)

    best = -1.0
    snap = variables_from_torch(state.model)  # numpy copies on the host
    for epoch in range(args.epochs):
        losses = []
        for item in train_loader:
            state, metrics = train_step(state, item.batch)
            losses.append(float(metrics["loss"]))
        if (epoch + 1) % args.eval_every == 0 or epoch == args.epochs - 1:
            m = float(evaluate(eval_step, state, val_loader)["mAP"]["map_50"])
            log(f"epoch {epoch:3d}  loss={np.mean(losses):7.4f}  mAP@0.5={m:.4f}")
            if m > best:
                best = m
                snap = variables_from_torch(state.model)
    return best, snap


if __name__ == "__main__":
    sys.exit(main())
