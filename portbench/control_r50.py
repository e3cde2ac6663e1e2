"""Readings that set the limits of ``correct`` in the ResNet-50 cell: sound
runs of the program, its controls and the reference one precision down,
seed by seed, in one process.

    python -m portbench.control_r50 --modes MODE [MODE ...] --seeds S [S ...]
                                    [--workload r50coco_batch32] [--seconds 1]

Modes (each compared with the cell's reference as a run compares the
program, ``drivers/serve_batches_r50.py``):

* ``sound``: the cell as the benchmark runs it, with a short window;
* ``diou``: the program asked to suppress by DIoU in place of IoU;
* ``fp8_trunk``: the program with every trunk conv's input rounded to
  float8 e4m3 (one scale a tensor);
* ``no_shortcut``: the program with ``trunk.layer3.2`` run without its
  shortcut;
* ``ref_fp8``: the reference one precision below the configuration's
  (every conv's input, weight, bias and output and every residual sum in
  float8 e4m3, ``ssd300_resnet50.FP8``) in the program's place, its
  answers its own postprocess of its heads;
* ``ref_bf16``: the same in the configuration's own precision
  (``ssd300_resnet50.BF16``): a witness of how far bfloat16 rounding alone
  moves the heads, beside the sound runs.

One JSON line per seed and mode on standard output.  Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

from . import core, scenes
from .drivers import serve_batches_r50 as drv
from .reference import ssd300_resnet50 as ref

PROGRAM = {"sound": {}, "diou": {"nms": "diou"}, "fp8_trunk": {"fp8_trunk": True},
           "no_shortcut": {"drop_shortcut": "trunk.layer3.2"}}
REFERENCE = {"ref_fp8": ref.FP8, "ref_bf16": ref.BF16}


def reading(cell, mode: str, seed: int, seconds: float, device, root: Path) -> dict:
    if mode in PROGRAM:
        ov = {"program": PROGRAM[mode]}
        return drv.run(cell, seed, seconds, False, device, time.monotonic(), root, ov).numbers
    tr, serve, cfg = cell.traffic, cell.config["serve"], cell.config
    n = tr["batch"] * tr["distinct_batches"]
    cal = serve["bn_calibration"]
    timed, calib = scenes.render_async(seed, [(0, n), (cal["stream"], cal["scenes"])],
                                       tr["scene_size"], tr.get("workers", 4)).get()
    params = ref.init_params(seed, cfg["num_classes"], device, serve.get("width_mult", 1.0))
    with torch.no_grad(), ref.float32_matmuls():
        ref.calibrate_bn(params, torch.as_tensor(scenes.serve_images(calib), device=device))
    images = scenes.serve_images(timed)
    kw = {k: tr[k] for k in ("score_thresh", "nms_thresh", "max_per_img")}
    B = tr["batch"]
    want = drv.reference_heads(params, images, device, B)
    got = drv.reference_heads(params, images, device, B, q=REFERENCE[mode])
    answers = [(drv.detect(h, device, kw, tr), b) for b, h in enumerate(got)]
    return drv.judge(answers, got, want, kw, tr)[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m portbench.control_r50")
    ap.add_argument("--workload", default="r50coco_batch32")
    ap.add_argument("--modes", required=True, nargs="+", choices=(*PROGRAM, *REFERENCE))
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=1.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("portbench.control_r50: needs a CUDA card", file=sys.stderr)
        return 2
    root = Path(__file__).resolve().parents[1]
    cell = core.load_cell(args.workload, root)
    for seed in args.seeds:
        for mode in args.modes:
            numbers = reading(cell, mode, seed, args.seconds, torch.device("cuda"), root)
            limited = {k: numbers[k] for k in cell.limits}
            row = {"workload": cell.name, "mode": mode, "seed": seed, "numbers": limited,
                   "extra": {k: v for k, v in numbers.items() if k not in limited}}
            print(json.dumps(row, default=float), flush=True)
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
