"""Device time by launch of the NMS kernel B1 and the BN + ReLU + pool kernels B6.

    python -m ssdx_torch.tools.profile_split [nms|brp|all] [--iters 10]

B1 (``ops.nms.nms_core_sorted``, ``csrc/nms.cu``): B=32 at K=400 (serving)
and K=1600 (eval), candidates kept apart by the class offset, DIoU at
0.3, as ``chip_smoke.py`` phase 7 times it; then K=1600 by IoU at 0.5 over
5 labels handed to the kernel (the ResNet-50 network's postprocess).
B6 (``ops.bn_relu_pool.bn_relu_pool``, ``csrc/bn_relu_pool.cu``): one forward + backward, cotangents for all three
outputs, at the four shapes of ``tools/check_brp.py``'s ``BRP_CASES`` in bf16.

Each case runs ``--iters`` calls over distinct inputs inside one
``torch.profiler`` window and prints every kernel by name with its device
ms and launches per call; kernels that are not the op's own (PyTorch's
casts and copies around it) are summed as "glue".  A window that lost
records (each kernel must occur a whole number of times per call) is run
again, three times at most; then the case prints "not measured".  Beside
each case: its time by CUDA events and the bound (bytes or operations of
the function, each input read once and each output written once, at the
H100 SXM's peaks).  Prints the card (nvidia-smi name and power limit)
first, and last one JSON object of the numbers.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import collections
import json
import re
import subprocess
import time

import torch

from ssdx_torch.ops import bn_relu_pool as brp_ops
from ssdx_torch.ops import nms as nms_ops
from ssdx_torch.tools.check_brp import BRP_CASES, brp_inputs
from ssdx_torch.tools.check_nms import nms_inputs
from ssdx_torch.tools.roofline import PEAK_BYTES, PEAK_F32, bound_ms

NMS_OPS_PER_PAIR = 31  # float32 operations of one DIoU + compare
IOU_OPS_PER_PAIR = 14  # of one IoU + compare
WINDOW_PAD_S = 0.025   # idle seconds at each end of a window (tools/bench_int8_mm.py)
# (B, K, overlap, threshold, classes kept apart by)
NMS_CASES = ((32, 400, "diou", 0.3, "offset"), (32, 1600, "diou", 0.3, "offset"),
             (32, 1600, "iou", 0.5, "labels"))


def card() -> str:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    return smi.stdout.strip().splitlines()[0]


def nms_bound(valid, labels=None) -> tuple[float, str]:
    """Least ms of B1 on these inputs: the DIoU of every pair (i valid, j > i)
    at the float32 rate, against reading boxes and valid and writing keep;
    with ``labels``, a label compare for every such pair and the IoU of the
    same-label ones."""
    B, K = valid.shape
    n_valid = valid.sum(dim=1).tolist()
    pairs = sum(n * (K - 1) - n * (n - 1) // 2 for n in n_valid)
    if labels is None:
        ops = pairs * NMS_OPS_PER_PAIR
    else:
        same = (labels[:, :, None] == labels[:, None, :]).triu(1) & valid[:, :, None]
        ops = pairs + int(same.sum()) * IOU_OPS_PER_PAIR
    return bound_ms(ops, B * K * (16 + 1) + B * K, PEAK_F32)


def brp_bounds(shape, ceil, itemsize=2) -> dict:
    """Least ms by bytes of B6's forward and backward at ``shape``: each input
    read once and each output written once (x, p; x, g, dx), and with the
    second read of x that each BN barrier forces."""
    B, H, W, C = shape
    Hp, Wp = ((H + 1) // 2, (W + 1) // 2) if ceil else (H // 2, W // 2)
    xb, pb = B * H * W * C * itemsize, B * Hp * Wp * C * itemsize
    ms = lambda n: n / PEAK_BYTES * 1e3
    return {"forward": ms(xb + pb), "backward": ms(2 * xb + pb),
            "forward_two_reads": ms(2 * xb + pb), "backward_two_reads": ms(3 * xb + 2 * pb)}


BRP_MODES = ("stats", "apply", "reduce", "dx")  # csrc/bn_relu_pool.cu, enum Mode


def kernel_name(name: str) -> str:
    """A device record's short name: ``..::reduce_kernel<__nv_bfloat16>(...)``
    -> ``reduce``, ``..::pipe_kernel<__nv_bfloat16, 2>(...)`` -> ``reduce``
    (B6's passes by their mode); anything that is not a ``*_kernel`` of the
    op -> "glue"."""
    m = re.search(r"pipe_kernel<[^,<>]+, (\d)>", name)
    if m:
        return BRP_MODES[int(m.group(1))]
    m = re.search(r"(\w+)_kernel\b", name)
    return m.group(1) if m and "at::" not in name and "native" not in name else "glue"


def split(fn, inputs, iters=10, tries=3) -> dict | None:
    """{name: (device ms per call, launches per call)} over one profiler
    window of ``iters`` calls of fn(i); None if every window lost records."""
    from torch.profiler import ProfilerActivity, profile

    for i in range(2):
        fn(i % len(inputs))
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            time.sleep(WINDOW_PAD_S)
            for i in range(iters):
                fn(i % len(inputs))
            torch.cuda.synchronize()
            time.sleep(WINDOW_PAD_S)
        us, cnt = collections.defaultdict(float), collections.Counter()
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                k = kernel_name(e.name)
                us[k] += e.time_range.elapsed_us()
                cnt[k] += 1
        if cnt and all(c % iters == 0 for k, c in cnt.items() if k != "glue"):
            return {k: (us[k] / iters / 1e3, cnt[k] / iters) for k in us}
    return None


def events_ms(fn, n, iters=20, warmup=3) -> float:
    for i in range(warmup):
        fn(i % n)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(i % n)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def show(title, res, tail, log) -> float | None:
    if res is None:
        log(f"{title}: not measured (the profiler lost records in every window); {tail}")
        return None
    total = sum(ms for ms, _ in res.values())
    log(f"{title}: {total:.4f} ms on the device; {tail}")
    for k, (ms, n) in sorted(res.items(), key=lambda kv: -kv[1][0]):
        log(f"  {k:18s} {ms:8.4f} ms  x{n:g}")
    return total


def nms_split(iters=10, log=print) -> list:
    dev = torch.device("cuda")
    out = []
    for B, K, kind, thresh, classes in NMS_CASES:
        ins = [nms_inputs(dev, B, K, seed=K + s, class_aware=classes) for s in range(4)]
        fn = lambda i: nms_ops.nms_core_sorted(ins[i][0], ins[i][1], thresh, ins[i][2], kind)
        res = split(fn, ins, iters)
        ev = events_ms(fn, len(ins))
        bound, by = nms_bound(ins[0][1], ins[0][2])
        total = show(f"B1 B={B} K={K} {kind} by {classes}", res,
                     f"{ev:.4f} ms by events; bound {bound:.5f} ms by {by}", log)
        out.append({"B": B, "K": K, "kind": kind, "classes": classes, "device_ms": total,
                    "events_ms": ev, "bound_ms": bound, "split": res})
    return out


def brp_split(iters=10, log=print) -> list:
    dev = torch.device("cuda")
    out = []
    for shape, ceil, ties in BRP_CASES:
        cases = [brp_inputs(dev, shape, ceil, seed=16 + s, ties=ties) for s in range(3)]

        def both(i):
            ins, cots = cases[i]
            leaves = [a.detach().requires_grad_() for a in ins]
            outs = brp_ops.bn_relu_pool(*leaves, 1e-5, ceil, True)
            torch.autograd.backward(outs, cots)

        res = split(both, cases, iters)
        ev = events_ms(both, len(cases))
        b = brp_bounds(shape, ceil)
        total = show(f"B6 {shape} bf16 ceil={ceil} fwd+bwd", res,
                     f"{ev:.4f} ms by events; bound {b['forward'] + b['backward']:.4f} ms by "
                     f"bytes ({b['forward_two_reads'] + b['backward_two_reads']:.4f} with the "
                     f"second read of x at each BN barrier)", log)
        out.append({"shape": list(shape), "ceil": ceil, "device_ms": total, "events_ms": ev,
                    "bounds": b, "split": res})
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("what", nargs="?", choices=("nms", "brp", "all"), default="all")
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_split: needs a CUDA device")
    print(card(), flush=True)
    res = {}
    if args.what in ("nms", "all"):
        res["nms"] = nms_split(args.iters)
    if args.what in ("brp", "all"):
        res["brp"] = brp_split(args.iters)
    print(json.dumps(res))


if __name__ == "__main__":
    main()
