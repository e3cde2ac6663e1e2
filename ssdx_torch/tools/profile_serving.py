"""Where the device time of the port's main path goes, on one GPU.

    python -m ssdx_torch.tools.profile_serving [--batch 32] [--iters 10] [--int8]

Builds the serving detector (``create_detector()``: BN-folded bf16 SSD300,
stem and NMS kernels, bundled demo weights; with ``--int8`` the int8
configuration that ``SSDX_INT8=1`` serves, its post-stem backbone running
through the int8 conv kernels), warms it up, and traces
``predict_batched`` on distinct random batches with ``torch.profiler``.
It prints the card (nvidia-smi name and power limit), the device time per
batch by group (stem kernel, NMS kernel, int8 conv kernels, convolutions,
everything else),
the top kernels, the device's busy and idle share over the traced window,
and the host's enqueue time per batch.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import time
from collections import defaultdict

import torch
from torch.profiler import ProfilerActivity, profile

from ssdx_torch.serve.app import create_detector

SERVE_KW = dict(score_thresh=0.2, nms_thresh=0.3, max_per_img=100)


def group(name: str) -> str:
    n = name.lower()
    if "stem_kernel" in n:
        return "stem kernel (csrc/stem.cu)"
    if "nms_" in n:
        return "nms kernel (csrc/nms.cu)"
    if "::conv_kernel<" in n:  # before the cuDNN test: "conv" is in its name
        return "int8 conv kernels (csrc/int8_conv.cu)"
    if any(k in n for k in ("conv", "xmma", "cudnn", "implicit", "gemm", "sm90", "wgrad", "dgrad")):
        return "convolutions (cuDNN)"
    if "sort" in n or "radix" in n:
        return "sorts (top-k)"
    return "other (elementwise, gathers, pools, copies)"


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--int8", action="store_true",
                    help="profile the int8 configuration (SSDX_INT8=1)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_serving: needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])

    if args.int8:
        os.environ["SSDX_INT8"] = "1"
    else:
        os.environ.pop("SSDX_INT8", None)
    det = create_detector()
    print(f"configuration: {'int8 post-stem backbone' if args.int8 else 'bf16'}")
    g = torch.Generator(device="cuda").manual_seed(0)
    xs = [torch.randn(args.batch, 300, 300, 3, generator=g, device="cuda") for _ in range(4)]
    for x in xs:
        det.predict_batched(x, **SERVE_KW)
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(args.iters):
            det.predict_batched(xs[i % len(xs)], **SERVE_KW)
        t_enqueue = time.perf_counter() - t0
        torch.cuda.synchronize()
        t_wall = time.perf_counter() - t0

    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        raise SystemExit("profile_serving: the profiler recorded no device activity")
    span = max(e.time_range.end for e in kernels) - min(e.time_range.start for e in kernels)
    busy = sum(e.time_range.elapsed_us() for e in kernels)
    by_group, by_name = defaultdict(float), defaultdict(lambda: [0.0, 0])
    for e in kernels:
        d = e.time_range.elapsed_us()
        by_group[group(e.name)] += d
        by_name[e.name][0] += d
        by_name[e.name][1] += 1

    n = args.iters
    print(f"predict_batched bs={args.batch}: {t_wall / n * 1e3:.3f} ms/batch wall "
          f"({args.batch * n / t_wall:.1f} images/s), host enqueue {t_enqueue / n * 1e3:.3f} "
          f"ms/batch, {len(kernels) / n:.0f} device ops/batch")
    print(f"device busy {busy / n / 1e3:.3f} ms/batch over a {span / n / 1e3:.3f} ms/batch "
          f"window: idle share {1 - busy / span:.3f}")
    for name, us in sorted(by_group.items(), key=lambda kv: -kv[1]):
        print(f"  {us / n / 1e3:8.4f} ms/batch  {us / busy * 100:5.1f} %  {name}")
    print("top kernels:")
    for name, (us, cnt) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]:
        print(f"  {us / n / 1e3:8.4f} ms/batch  x{cnt / n:<4.0f} {name[:110]}")


if __name__ == "__main__":
    main()
