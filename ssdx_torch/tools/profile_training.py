"""Where the device time of the port's train step goes, on one GPU.

    python -m ssdx_torch.tools.profile_training [--batch 16] [--iters 8] [--no-fused-stem]

Builds the full-width bf16 SSD300 train step (``make_train_step`` with the
train-mode stem kernel unless ``--no-fused-stem``; SGD-Nesterov with the
warmup-cosine schedule, match IoU 0.4, negative ratio 3) on random images
with 16 GT boxes each, warms it up, and traces ``--iters`` steps on
distinct batches with ``torch.profiler``.  It prints the card (nvidia-smi
name and power limit), the device time per step by group (stem kernels,
convolutions forward and backward, BatchNorm, optimizer, matching + loss,
everything else), the top kernels, the device's busy and idle share over
the traced window, and the host's enqueue time per step.  Needs a CUDA
device.
"""
from __future__ import annotations

import argparse
import subprocess
import time
from collections import defaultdict

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from ssdx_torch import priors as P
from ssdx_torch.model import SSD300, init_variables
from ssdx_torch.train.schedule import build_optimizer
from ssdx_torch.train.step import Batch, create_train_state, make_train_step

_STEM_KERNELS = ("conv1_stats_kernel", "stage2_kernel", "pool_kernel", "route_kernel",
                 "dw2_kernel", "dw1_kernel", "colsum_kernel")


def group(name: str) -> str:
    n = name.lower()
    if any(k in n for k in _STEM_KERNELS):
        return "stem kernels (csrc/stem_train.cu)"
    if any(k in n for k in ("wgrad", "dgrad", "conv", "xmma", "cudnn", "implicit", "gemm",
                            "sm90")):
        return "convolutions fwd + bwd (cuDNN)"
    if "batch_norm" in n or "batchnorm" in n or "welford" in n or "reduce" in n:
        return "reductions (BN statistics, sums)"
    if "multi_tensor" in n or "foreach" in n:
        return "optimizer (SGD foreach)"
    if "sort" in n or "radix" in n or "scan" in n:
        return "sorts (hard-negative mining)"
    return "other (elementwise, BN apply, ReLU, pools, casts, copies)"


def make_batch(seed: int, B: int, G: int = 16) -> Batch:
    rng = np.random.default_rng(seed)
    lo = rng.uniform(0.1, 0.6, (B, G, 2)).astype(np.float32)
    sz = rng.uniform(0.05, 0.3, (B, G, 2)).astype(np.float32)
    images = rng.normal(0, 1, (B, 300, 300, 3)).astype(np.float32)
    labels = rng.integers(0, 5, (B, G)).astype(np.int32)
    boxes = np.concatenate([lo, np.minimum(lo + sz, 1.0)], -1)
    return Batch(*(torch.as_tensor(a, device="cuda")
                   for a in (images, boxes, labels, np.ones((B, G), bool))))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--no-fused-stem", dest="fused", action="store_false")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_training: needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])

    model = SSD300(6, dtype=torch.bfloat16).to("cuda", memory_format=torch.channels_last)
    opt, sched = build_optimizer(model.parameters(), steps_per_epoch=100)
    state = create_train_state(model, opt, sched, init_variables(6, seed=0))
    pri = P.create_priors()
    step = make_train_step(model, pri, P.priors_xyxy(pri), iou_thresh=0.4, neg_pos_ratio=3.0,
                           fused_stem=args.fused)
    batches = [make_batch(s, args.batch) for s in range(4)]
    for b in batches:
        state, _ = step(state, b)
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(args.iters):
            state, _ = step(state, batches[i % len(batches)])
        t_enqueue = time.perf_counter() - t0
        torch.cuda.synchronize()
        t_wall = time.perf_counter() - t0

    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        raise SystemExit("profile_training: the profiler recorded no device activity")
    span = max(e.time_range.end for e in kernels) - min(e.time_range.start for e in kernels)
    busy = sum(e.time_range.elapsed_us() for e in kernels)
    by_group, by_name = defaultdict(float), defaultdict(lambda: [0.0, 0])
    for e in kernels:
        d = e.time_range.elapsed_us()
        by_group[group(e.name)] += d
        by_name[e.name][0] += d
        by_name[e.name][1] += 1

    n = args.iters
    route = "stem kernel" if args.fused else "fused_stem=False"
    print(f"train step bs={args.batch} bf16 ({route}): {t_wall / n * 1e3:.3f} ms/step wall "
          f"({args.batch * n / t_wall:.1f} images/s), host enqueue {t_enqueue / n * 1e3:.3f} "
          f"ms/step, {len(kernels) / n:.0f} device ops/step")
    print(f"device busy {busy / n / 1e3:.3f} ms/step over a {span / n / 1e3:.3f} ms/step "
          f"window: idle share {1 - busy / span:.3f}")
    for name, us in sorted(by_group.items(), key=lambda kv: -kv[1]):
        print(f"  {us / n / 1e3:8.4f} ms/step  {us / busy * 100:5.1f} %  {name}")
    print("top kernels:")
    for name, (us, cnt) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]:
        print(f"  {us / n / 1e3:8.4f} ms/step  x{cnt / n:<4.0f} {name[:110]}")


if __name__ == "__main__":
    main()
