"""Test-set evaluation command.

The port's counterpart of ``ssdx/eval/run.py``: loads one or more weight
exports, runs batched inference and per-class NMS (the NMS kernel on the GPU)
over the test directory with the reference thresholds (score 0.2, NMS 0.3,
max 100) and reports mAP@0.5 with per-class APs.  Under ``torch.distributed``
(``torchrun``) the test set is split over the ranks, every rank computes the
same mAP and rank 0 prints it.

Usage: ``python -m ssdx_torch.eval.run --test-dir data/test [--cpu] WEIGHTS [WEIGHTS ...]``
"""
from __future__ import annotations

import argparse

import torch

from .. import priors as P
from ..data.dataset import DetectionDataset
from ..data.pipeline import DetectionLoader
from ..mesh import create_mesh, initialize_distributed
from ..model import SSD300
from ..train.loop import evaluate
from ..train.step import TrainState, make_eval_step
from ..weights import load_params, state_dict_from_jax

__all__ = ["evaluate_weights", "main"]


def evaluate_weights(
    weights_path,
    test_dir,
    batch_size: int = 32,
    score_thresh: float = 0.2,
    nms_thresh: float = 0.3,
    max_per_img: int = 100,
    iou_thresh: float = 0.4,
    bfloat16: bool = True,
    num_workers: int = 8,
    source_size: int | None = None,
    max_boxes: int | None = None,
    width_mult: float = 1.0,
    device=None,
) -> dict:
    """Return the ``evaluate()`` dict (losses + mAP) for one weight export.
    ``device=None`` is the GPU; ``width_mult`` must match the trained width."""
    ds = DetectionDataset(test_dir)
    num_classes = len(ds.classes) + 1
    mesh = create_mesh(device)
    dev = mesh.device
    if mesh.size == 1:
        mesh = None
    loader = DetectionLoader(ds, batch_size, train=False, num_workers=num_workers,
                             source_size=source_size, max_boxes=max_boxes, device=dev, mesh=mesh)
    model = SSD300(num_classes, dtype=torch.bfloat16 if bfloat16 else torch.float32,
                   width_mult=width_mult)
    blob = load_params(weights_path)
    model.load_state_dict(state_dict_from_jax(
        {"params": blob["params"], "batch_stats": blob["batch_stats"]}, False))
    model.requires_grad_(False).eval().to(dev, memory_format=torch.channels_last)
    state = TrainState(model=model, optimizer=None)
    pri = P.create_priors()
    eval_step = make_eval_step(model, pri, P.priors_xyxy(pri), iou_thresh=iou_thresh,
                               score_thresh=score_thresh, nms_thresh=nms_thresh,
                               max_per_img=max_per_img, mesh=mesh)
    out = evaluate(eval_step, state, loader, mesh=mesh)
    out["classes"] = ds.classes
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("weights", nargs="+")
    ap.add_argument("--test-dir", required=True)
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--score-thresh", type=float, default=0.2)
    ap.add_argument("--nms-thresh", type=float, default=0.3)
    ap.add_argument("--max-per-img", type=int, default=100)
    ap.add_argument("--width-mult", type=float, default=1.0,
                    help="must match the trained TrainConfig.width_mult")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU, not the GPU")
    args = ap.parse_args(argv)

    device = "cpu" if args.cpu else None
    initialize_distributed(device=device)
    for w in args.weights:
        out = evaluate_weights(
            w, args.test_dir, batch_size=args.batch_size,
            score_thresh=args.score_thresh, nms_thresh=args.nms_thresh,
            max_per_img=args.max_per_img, width_mult=args.width_mult, device=device,
        )
        m = out["mAP"]
        # m['classes'] holds the class *ids* actually present in GT or
        # predictions; look names up by id (zipping all dataset names against
        # map_per_class would misalign when a class is absent from the set).
        per_class = ", ".join(
            f"{out['classes'][int(c)]}={ap:.4f}"
            for c, ap in zip(m["classes"], m["map_per_class"])
        )
        if create_mesh(device).rank == 0:
            print(f"{w}: mAP@0.5={m['map_50']:.4f}  [{per_class}]  "
                  f"test loss={out['testing loss']:.4f}")


if __name__ == "__main__":
    main()
