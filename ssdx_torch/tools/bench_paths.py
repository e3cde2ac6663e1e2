"""The three paths that run the stem kernels, timed end to end on one GPU.

    python -m ssdx_torch.tools.bench_paths [--label NAME] [--windows N]
                                           [--paths train_step ...]

Times, by CUDA events after a warm-up, cycling over 4 distinct batches,
each path in ``--windows`` windows (printed with the best and the spread):
  * ``predict_batched`` at bs=32 in bf16 (``create_detector()``: the demo
    weights, BN folded, the stem kernel B2 and the NMS kernel), serving
    thresholds 0.2 / 0.3 / 100;
  * the same in int8 (``create_detector()`` under ``SSDX_INT8=1``: B2, then
    the post-stem backbone through the int8 conv kernels);
  * the full-width bf16 train step at bs=16 with the train-mode stem kernel
    B3 (16 GT boxes an image, SGD-Nesterov, match IoU 0.4), as
    ``chip_smoke.py`` phase 10 builds it.
``--paths`` runs only the named ones (``bf16_predict_batched``,
``int8_predict_batched``, ``train_step``).  Prints the card (nvidia-smi
name and power limit), one line per path, and last one JSON object of the
numbers with ``--label``.  Run it from two checkouts in turns (a, b, b, a)
to compare them on one card.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess

import numpy as np
import torch

from ssdx_torch import priors as P
from ssdx_torch.model import SSD300, init_variables
from ssdx_torch.serve.app import create_detector
from ssdx_torch.train.schedule import build_optimizer
from ssdx_torch.train.step import Batch, create_train_state, make_train_step

SERVE_KW = dict(score_thresh=0.2, nms_thresh=0.3, max_per_img=100)
BS, TRAIN_BS = 32, 16


def cuda_ms(fn, inputs, iters=20, warmup=3, windows=1) -> list[float]:
    """Mean ms per call of fn(x) in each of ``windows`` windows of ``iters``
    calls, cycling over distinct inputs."""
    for i in range(warmup):
        fn(inputs[i % len(inputs)])
    torch.cuda.synchronize()
    out = []
    for _ in range(windows):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(iters):
            fn(inputs[i % len(inputs)])
        end.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(end) / iters)
    return out


def serving_ms(int8: bool, windows: int = 1) -> list[float]:
    if int8:
        os.environ["SSDX_INT8"] = "1"
    try:
        det = create_detector()
    finally:
        os.environ.pop("SSDX_INT8", None)
    g = torch.Generator(device="cuda").manual_seed(1)
    batches = [torch.randn(BS, 300, 300, 3, generator=g, device="cuda") for _ in range(4)]
    return cuda_ms(lambda x: det.predict_batched(x, **SERVE_KW), batches, windows=windows)


def train_batch(seed, B=TRAIN_BS, G=16) -> Batch:
    rng = np.random.default_rng(seed)
    lo = rng.uniform(0.1, 0.6, (B, G, 2)).astype(np.float32)
    sz = rng.uniform(0.05, 0.3, (B, G, 2)).astype(np.float32)
    images = rng.normal(0, 1, (B, 300, 300, 3)).astype(np.float32)
    labels = rng.integers(0, 5, (B, G)).astype(np.int32)
    boxes = np.concatenate([lo, np.minimum(lo + sz, 1.0)], -1)
    return Batch(*(torch.as_tensor(a, device="cuda")
                   for a in (images, boxes, labels, np.ones((B, G), bool))))


def train_ms(windows: int = 1) -> list[float]:
    model = SSD300(6, dtype=torch.bfloat16).to("cuda", memory_format=torch.channels_last)
    opt, sched = build_optimizer(model.parameters(), steps_per_epoch=100, warmup_epochs=0,
                                 base_lr=1e-2)
    holder = {"state": create_train_state(model, opt, sched, init_variables(6, seed=0))}
    pri = P.create_priors()
    step = make_train_step(model, pri, P.priors_xyxy(pri), iou_thresh=0.4, neg_pos_ratio=3.0,
                           fused_stem=True)

    def one(b):
        holder["state"], _ = step(holder["state"], b)

    return cuda_ms(one, [train_batch(10 + i) for i in range(4)], iters=10, windows=windows)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--label", default="")
    ap.add_argument("--windows", type=int, default=1)
    ap.add_argument("--paths", nargs="+", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("bench_paths: needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])
    res = {"label": args.label}
    w = args.windows
    for key, fn, bs in (("bf16_predict_batched", lambda: serving_ms(False, w), BS),
                        ("int8_predict_batched", lambda: serving_ms(True, w), BS),
                        ("train_step", lambda: train_ms(w), TRAIN_BS)):
        if args.paths and key not in args.paths:
            continue
        each = fn()
        ms = min(each)
        res[key] = {"ms": ms, "images_per_s": bs * 1e3 / ms, "windows_ms": each}
        spread = f" (windows {min(each):.3f} .. {max(each):.3f} ms)" if len(each) > 1 else ""
        print(f"{args.label} {key} bs={bs}: {ms:.3f} ms, {bs * 1e3 / ms:.1f} images/s{spread}",
              flush=True)
        torch.cuda.empty_cache()
    print(json.dumps(res))


if __name__ == "__main__":
    main()
