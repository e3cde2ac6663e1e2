"""End-to-end training on the SynthDrive dataset.

    python -m ssdx_torch.tools.train_synthdrive --workdir DIR [--epochs 60]
        [--n-train 640] [--n-test 160] [--batch-size 16] [--base-lr 2e-3]
        [--warmup-epochs N] [--no-resume] [--seed 724] [--size 512]
        [--width-mult 1.0] [--device cpu]

The port's counterpart of ``scripts/train_synthdrive.py``: renders the
synthetic street scenes of ``ssdx_torch/data/synth.py`` (train seed 1, test
seed 2, as the script; no download), then drives the production path,
``ssdx_torch.train.run.run`` (dataset scan, stratified group val split,
bootstrap loader with augmentation on the device, the train step with the
train-mode stem kernel B3, per-epoch eval with the NMS kernel B1,
checkpoints), with the script's recipe: ``cache_images=True``, 4 loader
threads, warm-up ``min(3, epochs // 3)`` epochs, base LR 2e-3, weight decay
5e-4.  Re-running the same command resumes from ``{workdir}/ckpt/last.ckpt``.

Then it exports ``best.weights`` from ``best.ckpt`` (``save_params``) and,
for ``best`` and ``last``, the float16 bundle ``{tag}.npz``
(``save_params_npz``, the demo-weights format), scores both on the held-out
test directory (``eval.run.evaluate_weights``), and renders three prediction
panels through a BN-folded bf16 ``Detector`` with the serving stem kernel B2
and B1.
Writes:
  {workdir}/train/, {workdir}/test/    the generated datasets (reused if present)
  {workdir}/ckpt/                      checkpoints and weight exports
  {workdir}/curves.png                 loss and mAP curves
  {workdir}/panel_*.jpg                ground truth | prediction panels
  {workdir}/results.json               the script's keys, and the card and timing

Runs on the GPU unless ``--device cpu``, which takes the plain PyTorch path in
float32; ``--width-mult`` and ``--size`` shrink the run for tests, and
``--seed`` draws other initial weights (the split and the loader keep
theirs).  Only a
missing plotting library is tolerated: any other failure ends the run.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import pickle
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

from .. import resolve_device
from ..config import Config, DataConfig, EvalConfig, TrainConfig
from ..data.synth import generate_dataset
from ..train.checkpoint import load_params, save_params, save_params_npz

__all__ = ["main"]

SPLITS = (("train", 1), ("test", 2))  # split name, generator seed


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workdir", required=True)
    ap.add_argument("--epochs", type=int, default=60)
    ap.add_argument("--n-train", type=int, default=640)
    ap.add_argument("--n-test", type=int, default=160)
    ap.add_argument("--batch-size", type=int, default=16)
    ap.add_argument("--base-lr", type=float, default=2e-3)
    ap.add_argument("--warmup-epochs", type=int, default=None,
                    help="default: min(3, epochs // 3); the reference recipe uses 5")
    ap.add_argument("--no-resume", action="store_true")
    ap.add_argument("--seed", type=int, default=TrainConfig.seed,
                    help="seed of the initial weights")
    ap.add_argument("--size", type=int, default=512, help="side of the rendered scenes")
    ap.add_argument("--width-mult", type=float, default=1.0)
    ap.add_argument("--device", default=None,
                    help="default: the GPU; 'cpu' runs the plain path in float32")
    return ap.parse_args(argv)


def generate(wd: Path, counts: dict, size: int, log) -> None:
    """Render the splits that are not on disk yet."""
    for split, seed in SPLITS:
        out = wd / split
        if (out / "annotations.csv").exists():
            log(f"reusing existing {split} dataset at {out}")
            continue
        t0 = time.perf_counter()
        generate_dataset(out, counts[split], seed=seed, size=size)
        log(f"generated {split}: {counts[split]} images ({time.perf_counter() - t0:.1f}s)")


def card(dev) -> dict:
    """The card's name and power limit, as nvidia-smi gives them."""
    if dev.type != "cuda":
        return {"platform": "cpu"}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
            "nvidia_smi": smi.stdout.strip().splitlines()[0]}


def _js(o):  # the results' curves hold numpy arrays and scalars
    if isinstance(o, np.ndarray):
        return o.tolist()
    return float(o)


def main(argv=None, log=print) -> dict:
    args = parse_args(argv)
    dev = resolve_device(args.device)
    wd = Path(args.workdir)
    wd.mkdir(parents=True, exist_ok=True)
    generate(wd, {"train": args.n_train, "test": args.n_test}, args.size, log)

    from ..api import Detector
    from ..eval.run import evaluate_weights
    from ..train.run import run

    bf16 = dev.type == "cuda"
    cfg = Config(
        data=DataConfig(
            train_dir=str(wd / "train"),
            test_dir=str(wd / "test"),
            batch_size=args.batch_size,
            num_workers=4,
            cache_images=True,  # decode each image once, not once an epoch
        ),
        train=TrainConfig(
            epochs=args.epochs,
            warmup_epochs=(args.warmup_epochs if args.warmup_epochs is not None
                           else min(3, max(1, args.epochs // 3))),
            base_lr=args.base_lr,
            weight_decay=5e-4,
            save_dir=str(wd / "ckpt"),
            bfloat16=bf16,
            width_mult=args.width_mult,
            seed=args.seed,
        ),
        eval=EvalConfig(),
    )
    (wd / "config.json").write_text(json.dumps(dataclasses.asdict(cfg), indent=2))

    epoch_ends = []

    def run_log(msg):
        if msg.startswith("Epoch: "):
            epoch_ends.append(time.perf_counter())
        log(msg)

    t0 = time.perf_counter()
    state, results, class_to_idx = run(cfg, resume=not args.no_resume, log=run_log, device=dev)
    train_wall = time.perf_counter() - t0
    log(f"training wall time: {train_wall:.0f}s")

    try:
        import matplotlib

        matplotlib.use("Agg")
    except ImportError as e:  # the one failure that may not end the run
        log(f"no curves: {e}")
    else:
        from ..viz import plot_losses

        plot_losses(results).savefig(wd / "curves.png", dpi=110, bbox_inches="tight")
        log(f"wrote {wd / 'curves.png'}")

    n = len(epoch_ends)
    timing = results["training timing"][-n:] if n else []
    testing = results["testing timing"][-n:] if n else []
    walls = np.diff([t0] + epoch_ends).tolist()
    final = {
        "train_wall_s": round(train_wall, 1),
        "epochs": args.epochs,
        "val_curves": {k: results[k] for k in ("train_loss", "test_loss", "mAP", "epochs")},
        "val_map_50_per_epoch": [float(m["map_50"]) for m in results["mAP"]],
        "device": card(dev),
        "timing": {
            "epoch_wall_s": walls,  # train + eval + checkpoints, from the run's start
            "data_wait_ms": [t["data wait"] * 1e3 for t in timing],
            "step_ms": [t["step"] * 1e3 for t in timing],
            "train_images_per_s": [args.batch_size / (t["data wait"] + t["step"])
                                   for t in timing],
            "eval_batch_ms": [t["model prediction"] * 1e3 for t in testing],
            "map_s": [t["mAP time"] for t in testing],
            "train_steps": state.step,  # all epochs, resumed ones included
        },
    }

    ckpt = wd / "ckpt"
    if (ckpt / "best.ckpt").exists():
        # the loop checkpoints 'best' but exports only 'last'
        with open(ckpt / "best.ckpt", "rb") as f:
            ck = pickle.load(f)
        save_params(ck["params"], ck["batch_stats"], ckpt / "best.weights")
    for tag in ("best", "last"):
        wpath = ckpt / f"{tag}.weights"
        if not wpath.exists():
            continue
        blob = load_params(wpath)
        save_params_npz(blob["params"], blob["batch_stats"], ckpt / f"{tag}.npz")
        log(f"exported {wpath} and its float16 bundle {tag}.npz")
        out = evaluate_weights(wpath, wd / "test", batch_size=args.batch_size, bfloat16=bf16,
                               num_workers=4, width_mult=args.width_mult,
                               device=dev)
        m = out["mAP"]
        keep = {k: float(m[k]) for k in
                ("map_50", "map_small", "map_medium", "map_large", "mar_100")
                if k in m and hasattr(m[k], "__float__")}
        keep["per_class_ap50"] = {out["classes"][int(c)]: float(ap)
                                  for c, ap in zip(m["classes"], m["map_per_class"])}
        keep["test_loss"] = float(out["testing loss"])
        final[f"test_{tag}"] = keep
        log(f"[{tag}] test mAP@0.5 = {keep['map_50']:.4f}  per-class {keep['per_class_ap50']}")

    from PIL import Image

    from ..viz import side_by_side_prediction

    tag = "best" if (ckpt / "best.weights").exists() else "last"
    det = Detector.from_weights(ckpt / f"{tag}.weights", class_to_idx, fold_bn=True,
                                stem_kernel=True, dtype=torch.bfloat16 if bf16 else torch.float32,
                                device=dev, width_mult=args.width_mult)
    test_imgs = sorted((wd / "test").glob("*.jpg"))[:3]
    for i, p in enumerate(test_imgs):
        side_by_side_prediction(det, pil_img=Image.open(p), score_thresh=0.4).save(
            wd / f"panel_{i}.jpg")
    log(f"wrote {len(test_imgs)} prediction panels from {tag}.weights")

    (wd / "results.json").write_text(json.dumps(final, indent=2, default=_js))
    log(json.dumps({k: v for k, v in final.items() if k.startswith("test_")}, indent=2,
                   default=_js))
    return final


if __name__ == "__main__":
    main()
