#!/usr/bin/env python3
"""Drive the PyTorch port (ssdx_torch) once on one NVIDIA GPU, end to end.

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a non-zero exit:
  1. print the card (nvidia-smi name and power limit, torch's device name);
  2. build the CUDA kernels from ssdx_torch/csrc with nvcc (sm_90a), in
     parallel, and print ptxas's register and spill lines;
  3. the stem kernel (csrc/stem.cu, on the wgmma core of csrc/stem_sm90.cuh)
     against its plain PyTorch version at B = 1, 3, 5, 8 and 32, 300x300,
     bf16 (tools/check_stem.py): max |k - r| / (|r| + 1) < 0.05, and every
     image bit-identical at every B;
  4. the NMS kernel (csrc/nms.cu) against its plain version
     (tools/check_nms.py): B = 32 and 1, K = 1, 64, 65, 400, 1600 and 8192,
     clustered and grid candidates, class-aware and agnostic, thresholds 0,
     0.3, 0.5, -0.2 and one that pairs reach exactly: keep masks equal bit
     for bit;
  5. the main path: create_detector() (BN-folded bf16 SSD300 with the stem
     kernel, the weights the app serves: the JAX package's demo bundle in a
     checkout) and predict_pil on the three example
     scenes, with the kernels' launch counters set to 0 just before and read
     just after; detections are compared with the same weights run in f32
     through the plain ops;
  6. serving: the HTTP app answers POST /predict with a PNG for each scene;
  7. timing with CUDA events after warm-up, on distinct inputs: bs=32
     predict_batched images/s, and each kernel beside its plain version,
     its library yardstick and its bound; the stem kernel also by profiler
     device time; the NMS kernel's device time by launch at K=400 and 1600
     (tools/profile_split.py) beside the split before its redesign;
  8. the train-mode stem kernels (csrc/stem_train.cu) against their plain
     version, forward and backward at bs=2 and bs=16 in bf16
     (tools/check_stem.py): p within max |k - r| / (|r| + 1) < 0.05, each
     batch statistic within 1e-3 of its largest magnitude, each of dw1, dg1,
     dbe1, dw2, dg2, dbe2 within 0.05 L2-relative, and dx, db1, db2 exactly
     0; and two runs at bs=16 identical bit for bit;
  9. the training path: full-width SSD300 in bf16 at bs=16 with 16 GT
     boxes per image, 5 train steps with the stem kernel against 5 with
     fused_stem=False from the same variables (losses finite, within 2 %
     step by step, step 5 below step 1), then fit for one epoch over 3
     batches with an eval pass (NMS kernel) and a checkpoint that
     load_checkpoint resumes at epoch 1; the launch counters are set to 0
     just before this path and read just after;
 10. timing: the bs=16 train step with and without the stem kernel, and
     the stem kernel's forward + backward beside its plain version, its
     library yardstick (cuDNN) and its bound; and its device time by launch
     (tools/profile_stem.py, traced right after phase 11, where the
     profiler keeps its records), each launch beside its own bound, with
     cuDNN's conv1_1 forward and weight gradient beside the two K = 27
     launches (conv1_stats, dw1); the stem_train row of the kernels line
     carries that split;
 11. the int8 conv kernel (csrc/int8_conv.cu, TMA + wgmma) against its plain
     version, bit for bit (int8 output and bf16 tap), at full width and bs=32 on one
     layer of each geometry: ConvBNRelu_2 (150x150, 64->128), _9 (38x38,
     512->512, both outputs), _13 (dilation 6), _16 (stride 2, both), _14
     (1x1, both), _22 (3x3 valid -> 1x1, tap only), operands from a seed over
     the full +-127 range; then the whole walk on the demo weights and the
     three scenes: every layer's kernel output against the plain version
     (bit for bit) and against the dividing requantization of
     quant.apply_int8 (at most one int8 step, counted), and the heads of
     apply_int8_kernels against quant.apply_int8 within 0.5 with under 5 %
     of elements past 0.05; then the bare matmuls of the int8 probe (S1,
     csrc/gemm_sm90.cu through tools/bench_int8_mm.py, 2048^3) against
     torch._int_mm and their plain versions: int8 exact, bf16 within 1e-3,
     timed by CUDA events and by profiler device time (which must be
     measured: a window that lost records of the kernel is run again, and
     three lost windows fail the phase) beside torch._int_mm, torch.matmul
     and torch.mm(out_dtype=float32), with the host cost of one call; and at
     a ragged shape (M=1000, N=48, K=80) exact and within 1e-3;
 12. the int8 path: create_detector() under SSDX_INT8=1 and predict_pil on
     the three scenes, the launch counters set to 0 just before and read
     just after (21 int8 conv launches per forward: 16 for the 3x3 layers, 5
     for the 1x1), detection_agreement with the bf16 detector of phase 5 at a
     match rate of at least 0.8, and POST /predict for each scene;
 13. timing: bs=32 predict_batched in int8 beside bf16, in turns; the
     post-stem walk in int8 beside the bf16 SSD300(stem_input=True) forward;
     and, taken right after phase 11 where the profiler keeps its records,
     the kernel on every one of the 21 layers at bs=32 by profiler device
     time (which must be measured, as in phase 11, for the kernel and its
     yardstick) and by CUDA events, beside its bound and its library
     yardstick by both (torch._int_mm plus the elementwise epilogue for the 1x1 layers;
     for the 3x3 layers cuDNN's bf16 conv of the same layer, since no single
     PyTorch call computes an int8 conv), and beside the float64 plain
     version on the six layers of phase 11;
 14. the 2x2 max pool kernels (csrc/pool.cu) against their plain version in
     bf16 at [16,300,300,64], at an odd shape and on an input with forced
     ties: forward and dy equal bit for bit;
 15. the fused BN + ReLU + pool kernels (csrc/bn_relu_pool.cu) against their
     plain version (tools/check_brp.py), forward and backward with non-zero
     cotangents for mean and var, in bf16 and f32, tie_split on and off, at
     [16,300,300,64], [16,150,150,128], [16,75,75,256] with ceil=True, a
     tie / ReLU-boundary input (4,61,59,64), and C = 2048 and C = 24: p
     within one bf16 step, mean and var within 1e-5 of their largest
     magnitude, dx within 0.02 L2-relative, dgamma and dbeta within 1e-3,
     and two runs of the kernels identical bit for bit;
 16. the kernels' path: the experiment tool (tools/stem_train_experiments.py)
     runs pool, brp, brp_nosplit and stem_fused beside the unfused bn, bnpool
     and stem at bs=16, the launch counters set to 0 just before and read
     just after; then each kernel beside its plain version, its library
     yardstick (F.max_pool2d; F.batch_norm + relu + max_pool2d) and its
     bound; and B6's device time by launch at the four shapes of phase 15
     (tools/profile_split.py, traced right after phase 11, where the
     profiler keeps its records) beside the split before its redesign;
 17. the data path: augment_batch and preprocess_batch on the card at bs=16
     from 512x512 uint8 scenes (finite, boxes in [0,1], valid boxes keep
     their labels, ms per batch), then the training command's entry point
     (train.run.main --config, what python -m ssdx_torch.train.run runs,
     in this process) for 1 epoch over a SynthDrive directory that
     data/synth.py writes (the stratified group split in numpy, which
     needs no scikit-learn: its train and val files printed and disjoint;
     JPEG decode, bootstrap loader, augmentation on the card, bf16 with the
     stem kernel, one launch a step), and train.run.run for a second epoch
     that resumes from last.ckpt;
 18. the probe kernels of the data-parallel repro tool (ew: csrc/repro.cu;
     mm: the nn kernel of csrc/gemm_sm90.cu) against their plain versions:
     ew = tanh(x) * 1.5 on [256,256] f32 and on an odd length within 1e-6,
     mm on 1024^3 bf16, on a 512-row shard and at a ragged shape (M=1008,
     N=192, K=96) within 1e-3 of the largest magnitude, and the shard equal
     bit for bit to the same rows of the whole product; then the tool
     (tools/repro_dist_kernels.py) with its three cases in a one-rank NCCL
     group: six ok lines, inside the mesh equal to outside bit for bit, the
     launch counters set to 0 just before and read just after; then both
     kernels beside their plain version, library call and bound, by CUDA
     events and by profiler device time (measured for mm, or the run fails;
     for ew null when the profiler lost its records in three windows), with
     the host cost of one call; the launch floor (an empty kernel, one block
     of 256 threads, in turns with ew at [256,256] in one profiler window)
     and ew at 2^22 and 2^26 values against their bounds, max(floor,
     bytes) (tools/bench_ew.py): these times are taken right
     after phase 11, where the profiler has kept every record in every run;
 19. the mesh path at one rank (the same NCCL group), full width:
     Detector(mesh=) on the three scenes equals phase 5's detections
     exactly; forward on B=5 equals the meshless forward; 3 bf16 bs=16
     train steps with the stem kernel equal phase 9's meshless steps loss
     for loss, exactly; save_checkpoint_sharded writes the directory format
     and load_checkpoint restores it; then the dry run's per-rank body
     (tools/dryrun.py, the counterpart of __graft_entry__.py) in the same
     group at full width: a train step on the synthetic batch and one on a
     loader batch (B3), Detector(mesh=) on 4 images (B2, B1), the launch
     counters set to 0 just before and read just after;
 20. two ranks on the one card: two worker processes over gloo, 8 of the 16
     images each, 3 train steps with the stem kernel's statistics
     all-reduced, against the one-process bs=16 steps: the stem BNs'
     running statistics after the first step within 1e-4 of their largest
     magnitude, losses within 1 %, both ranks' parameters bit-identical; then Detector(mesh=)
     at two ranks on B=5 (padded to 6) against one process: heads within
     0.05 of their largest magnitude; a worker that fails or outlives its
     time limit fails the run; then, in the same two workers, the dry
     run's per-rank body at full width over gloo: each rank's launches of
     B3, B2 and B1 above 0, both ranks' parameters bit-identical;
 21. eval: the C++ matcher is available and equals the numpy matcher on
     seeded boxes; python -m ssdx_torch.eval.run on the demo weights over a
     SynthDrive test directory prints its mAP line (finite, above 0.5);
 22. learning: tools/overfit_check.py at full width in bf16 on 32 images
     of rectangles for 40 epochs, the train step with the stem kernel (80
     launches, counted) and eval with the NMS kernel: final mAP@0.5 above
     0.5 and above the first evaluation, or the run fails;
 23. (run right after phase 13, while phase 5's and phase 12's detectors
     are alive) the serving bench: tools/bench_serving.py's function on the
     bf16 and the int8 detector behind the HTTP server with micro-batching,
     2 clients x 4 requests and 5 sequential: every request answered 200
     with a PNG, the batcher's image count equal to the requests sent, stem
     and NMS launches above 0 and, in int8, int8 conv launches above 0; its
     JSON on a log line.
Then it prints one {"kernels": [...]} line and, last, the device line.
Without a CUDA device it exits non-zero and prints no result.
"""
from __future__ import annotations

import contextlib
import io
import json
import os
import re
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import torch
import torch.nn.functional as F

from ssdx_torch import mesh as mesh_lib
from ssdx_torch import priors as P
from ssdx_torch import quant
from ssdx_torch.api import Detector
from ssdx_torch.config import EvalConfig, TrainConfig
from ssdx_torch.model import SSD300, init_variables
from ssdx_torch.ops import _build
from ssdx_torch.ops import bn_relu_pool as brp_ops
from ssdx_torch.ops import int8_conv as int8_ops
from ssdx_torch.ops import native as native_ops
from ssdx_torch.ops import nms as nms_ops
from ssdx_torch.ops import pool as pool_ops
from ssdx_torch.ops import repro as repro_ops
from ssdx_torch.ops import stem as stem_ops
from ssdx_torch.ops import stem_train as stem_train_ops
from ssdx_torch.serve.app import (BUNDLED_WEIGHTS, CLASS_TO_IDX, STATIC_DIR,
                                  create_detector, create_server, serving_weights)
from ssdx_torch.tools import bench_ew
from ssdx_torch.tools import bench_serving
from ssdx_torch.tools import bench_int8_mm
from ssdx_torch.tools import check_gemm
from ssdx_torch.tools import check_stem as stem_check
from ssdx_torch.tools import profile_stem
from ssdx_torch.tools import check_brp as brp_check
from ssdx_torch.tools import check_int8_conv as int8_check
from ssdx_torch.tools import check_nms as nms_check
from ssdx_torch.tools import dryrun
from ssdx_torch.tools import overfit_check
from ssdx_torch.tools import profile_split
from ssdx_torch.tools import repro_dist_kernels as repro_tool
from ssdx_torch.tools import stem_train_experiments as stem_tool
from ssdx_torch.tools.roofline import PEAK_BF16, PEAK_BYTES, PEAK_F32, PEAK_INT8, bound_ms
from ssdx_torch.train.checkpoint import load_checkpoint
from ssdx_torch.train.sharded_checkpoint import save_checkpoint_sharded
from ssdx_torch.train.loop import fit
from ssdx_torch.train.schedule import build_optimizer
from ssdx_torch.train.step import Batch, create_train_state, make_eval_step, make_train_step

# Device ms by launch of the kernels before this design, on an NVIDIA H100 80GB
# HBM3 at 700 W (tools/profile_split.py on commit fd70a8a; PERF.md)
BEFORE_NMS_SPLIT = {400: "scan 0.0768 + sup 0.0258 = 0.1026 ms",
                    1600: "scan 0.2215 + sup 0.1685 = 0.3900 ms"}
BEFORE_BRP_SPLIT = {
    (16, 300, 300, 64): "stats 0.0806, stats_finalize 0.0159, apply 0.0846, reduce 0.2038, "
                        "reduce_finalize 0.0142, dx 0.2351 = 0.6342 ms",
    (16, 150, 150, 128): "stats 0.0486, stats_finalize 0.0113, apply 0.0421, reduce 0.1131, "
                         "reduce_finalize 0.0137, dx 0.1211 = 0.3498 ms",
    (16, 75, 75, 256): "stats 0.0318, stats_finalize 0.0112, apply 0.0253, reduce 0.0698, "
                       "reduce_finalize 0.0133, dx 0.0685 = 0.2199 ms",
    (4, 61, 59, 64): "stats 0.0064, stats_finalize 0.0041, apply 0.0027, reduce 0.0064, "
                     "reduce_finalize 0.0026, dx 0.0047 = 0.0268 ms"}
ROOT = os.path.dirname(os.path.abspath(__file__))
SERVE_KW = dict(score_thresh=0.2, nms_thresh=0.3, max_per_img=100)
BS = 32


def log(*a):
    print(*a, flush=True)


def cuda_ms(fn, inputs, iters=20, warmup=3) -> float:
    """Mean ms per call of fn(x), cycling over distinct inputs."""
    for i in range(warmup):
        fn(inputs[i % len(inputs)])
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(inputs[i % len(inputs)])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ---------------------------------------------------------------- phase 3


def stem_inputs(dev, n_batches=4, seed=0):
    """Random bf16 images and stem weights at the scale of the JAX test."""
    g = torch.Generator(device=dev).manual_seed(seed)
    r = lambda *s, std: torch.randn(*s, generator=g, device=dev) * std
    w = (r(64, 3, 3, 3, std=0.15), r(64, std=0.3), r(64, 64, 3, 3, std=0.08), r(64, std=0.3))
    xs = [r(BS, 300, 300, 3, std=1.0).to(torch.bfloat16) for _ in range(n_batches)]
    return xs, w


def check_stem(dev) -> dict:
    res = stem_check.check_b2(dev, log=log)
    return {"max_abs_err": res[BS][1]}


# ---------------------------------------------------------------- phase 4


def check_nms(dev) -> dict:
    """tools/check_nms.py: every case bit for bit, or it raises."""
    nms_check.check(dev, log=log)
    return {"max_abs_err": 0.0}


# ---------------------------------------------------------------- phase 5


def iou(a, b):
    lt, rb = np.maximum(a[:2], b[:2]), np.minimum(a[2:], b[2:])
    inter = np.prod(np.clip(rb - lt, 0, None))
    area = lambda x: np.prod(np.clip(x[2:] - x[:2], 0, None))
    return inter / max(area(a) + area(b) - inter, 1e-7)


def agreement(p, q):
    """Greedy IoU>0.5 matching of p's boxes to q's: (matched, same label)."""
    used, matched, same = set(), 0, 0
    for bp, lp in zip(p["boxes"], p["labels"]):
        best, j = 0.5, None
        for k, bq in enumerate(q["boxes"]):
            if k not in used and (o := iou(bp, bq)) > best:
                best, j = o, k
        if j is not None:
            used.add(j)
            matched += 1
            same += int(lp == q["labels"][j])
    return matched, same


def main_path(dev):
    from PIL import Image

    from ssdx_torch.predict import postprocess, to_pylist

    det = create_detector()
    assert det.device.type == "cuda" and det.stem_kernel and det.dtype == torch.bfloat16
    scenes = sorted(STATIC_DIR.glob("example_*.jpg"))
    assert len(scenes) == 3, scenes
    stem_ops.launches = nms_ops.launches = 0
    preds = [det.predict_pil(Image.open(p), **SERVE_KW) for p in scenes]
    torch.cuda.synchronize()
    launches = {"stem": stem_ops.launches, "nms": nms_ops.launches}
    log(f"main path: detections per scene {[len(p['labels']) for p in preds]}, "
        f"kernel launches {launches}")
    assert launches["stem"] > 0 and launches["nms"] > 0, launches

    # the same weights in f32 through the plain ops: cuDNN convs (TF32 off)
    # on the card, post-processing with the plain NMS on host tensors
    torch.backends.cudnn.allow_tf32 = False
    ref_det = Detector.from_weights(det.weights_source, CLASS_TO_IDX, device=dev)
    images = np.concatenate([ref_det.preprocess_pil(Image.open(p)) for p in scenes])
    loc, conf = ref_det.forward(images)
    torch.backends.cudnn.allow_tf32 = True
    refs = to_pylist(postprocess(loc.cpu(), conf.cpu(), ref_det.priors.cpu(), **SERVE_KW))
    tot_m = tot_s = 0
    for i, (p, r) in enumerate(zip(preds, refs)):
        assert np.isfinite(p["boxes"]).all() and np.isfinite(p["scores"]).all()
        assert p["boxes"].shape == (len(p["labels"]), 4)
        m, s = agreement(p, r)
        tot_m, tot_s = tot_m + m, tot_s + s
        log(f"  scene {i + 1}: bf16 kernels {len(p['labels'])} dets, f32 plain "
            f"{len(r['labels'])} dets, {m} matched (IoU>0.5), {s} with the same label")
    n_ref = sum(len(r["labels"]) for r in refs)
    log(f"main path vs f32 plain: {tot_m}/{n_ref} f32 detections matched, "
        f"label agreement {tot_s}/{tot_m}")
    assert n_ref > 0 and tot_m >= 0.8 * n_ref and tot_s >= 0.9 * tot_m
    return det, launches, preds


# ---------------------------------------------------------------- phase 6


def serve(det):
    server = create_server(det, host="127.0.0.1", port=0, **SERVE_KW)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    opener = urllib.request.build_opener(urllib.request.ProxyHandler({}))  # local only
    try:
        for p in sorted(STATIC_DIR.glob("example_*.jpg")):
            boundary = "ssdxsmokeboundary"
            body = (f'--{boundary}\r\nContent-Disposition: form-data; name="file"; '
                    f'filename="{p.name}"\r\nContent-Type: image/jpeg\r\n\r\n').encode()
            body += p.read_bytes() + f"\r\n--{boundary}--\r\n".encode()
            req = urllib.request.Request(
                url + "/predict", data=body, method="POST",
                headers={"Content-Type": f"multipart/form-data; boundary={boundary}"})
            t0 = time.perf_counter()
            with opener.open(req, timeout=300) as r:
                status, ctype, png = r.status, r.headers["Content-Type"], r.read()
            log(f"POST /predict {p.name}: {status} {ctype}, {len(png)} bytes, "
                f"{(time.perf_counter() - t0) * 1e3:.1f} ms")
            assert status == 200 and ctype == "image/png" and png[:8] == b"\x89PNG\r\n\x1a\n"
        with opener.open(url + "/", timeout=60) as r:
            assert r.status == 200 and b"/predict" in r.read()
        log("GET /: 200")
    finally:
        server.shutdown()
        server.server_close()
        server.predictor.close()
        thread.join(timeout=10)


# ---------------------------------------------------------------- phase 7


def timing(dev, det, launches, errs):
    g = torch.Generator(device=dev).manual_seed(1)
    batches = [torch.randn(BS, 300, 300, 3, generator=g, device=dev) for _ in range(4)]
    ms = cuda_ms(lambda x: det.predict_batched(x, **SERVE_KW), batches)
    log(f"predict_batched bs={BS} (bf16, stem + NMS kernels): {ms:.3f} ms/batch, "
        f"{BS * 1e3 / ms:.1f} images/s")

    # stem: kernel, plain version, and cuDNN's two convs + pool as yardstick
    xs, w = stem_inputs(dev, seed=2)
    stem_ms = cuda_ms(lambda x: stem_ops.stem_conv_pool(x, *w), xs)
    stem_dev = bench_int8_mm.device_ms(lambda x: stem_ops.stem_conv_pool(x, *w),
                                       [(x,) for x in xs], kernel="stem_kernel")
    plain_ms = cuda_ms(lambda x: stem_ops.stem_conv_pool_ref(x, *w), xs)
    bf = torch.bfloat16
    w1, b1, w2, b2 = (t.to(bf) for t in w)
    w1, w2 = (t.contiguous(memory_format=torch.channels_last) for t in (w1, w2))
    xs_cl = [x.permute(0, 3, 1, 2) for x in xs]  # NCHW view, channels-last memory
    lib_ms = cuda_ms(lambda x: F.max_pool2d(F.relu(F.conv2d(
        F.relu(F.conv2d(x, w1, b1, padding=1)), w2, b2, padding=1)), 2), xs_cl)
    ops = 2 * BS * 300 * 300 * 64 * (27 + 576)
    nbytes = BS * 300 * 300 * 3 * 2 + BS * 150 * 150 * 64 * 2 + (64 * 27 + 64 * 576) * 2 + 128 * 4
    bound, bound_by = bound_ms(ops, nbytes)
    log(f"stem kernel bs={BS}: {stem_ms:.4f} ms by events, "
        f"{bench_int8_mm.fmt(stem_dev, '.4f')} ms on the device (profiler), "
        f"library (cuDNN conv+conv+pool, bf16) "
        f"{lib_ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound:.4f} ms "
        f"({ops / 1e9:.1f} GFLOP bf16), 1 launch per forward")
    kernels = [{
        "name": "stem_conv_pool", "route": "cuda", "source": "ssdx_torch/csrc/stem.cu",
        "replaces": "ssdx/ops/pallas_stem.py:293", "launches": launches["stem"],
        "max_abs_err": errs["stem"]["max_abs_err"], "ms": stem_ms, "plain_ms": plain_ms,
        "bound_ms": bound, "bound_by": bound_by, "library_ms": lib_ms,
    }]

    # nms at the serving (K=400) and eval (K=1600) candidate counts
    nms_row = None
    for K in (400, 1600):
        ins = [nms_check.nms_inputs(dev, BS, K, seed=K + s)[:2] for s in range(4)]
        k_ms = cuda_ms(lambda a: nms_ops.nms_core_sorted(*a, 0.3), ins)
        p_ms = cuda_ms(lambda a: nms_ops.nms_core_sorted_ref(*a, 0.3), ins, iters=4, warmup=1)
        bound, bound_by = profile_split.nms_bound(ins[0][1])
        log(f"nms kernel bs={BS} K={K}: {k_ms:.4f} ms, plain {p_ms:.4f} ms, bound "
            f"{bound:.5f} ms, library none (no single PyTorch call for greedy NMS), "
            f"1 launch per postprocess")
        if K == 400:
            nms_row = {
                "name": "nms_core_sorted", "route": "cuda", "source": "ssdx_torch/csrc/nms.cu",
                "replaces": "ssdx/ops/pallas_nms.py:157", "launches": launches["nms"],
                "max_abs_err": errs["nms"]["max_abs_err"], "ms": k_ms, "plain_ms": p_ms,
                "bound_ms": bound, "bound_by": bound_by, "library_ms": None,
            }
    # device time by launch, beside the split of the design before the shared-memory scan
    for res in profile_split.nms_split(log=log):
        log(f"  before (one-warp scan, full W x W grid; commit fd70a8a): "
            f"{BEFORE_NMS_SPLIT[res['K']]}")
        if res["K"] == 400:
            nms_row["device_ms"] = res["device_ms"]
    kernels.append(nms_row)
    return kernels


# ---------------------------------------------------------------- phase 8

TRAIN_BS = 16


def stem_train_inputs(dev, n_batches=4, seed=0):
    """bf16 images at bs=16 and the stem's weights at the scales of
    stem_inputs, plus BN scales near 1 and shifts near 0."""
    g = torch.Generator(device=dev).manual_seed(seed)
    r = lambda *s, std, mean=0.0: torch.randn(*s, generator=g, device=dev) * std + mean
    w = (r(64, 3, 3, 3, std=0.15), r(64, std=0.3), r(64, std=0.1, mean=1.0), r(64, std=0.1),
         r(64, 64, 3, 3, std=0.08), r(64, std=0.3), r(64, std=0.1, mean=1.0), r(64, std=0.1))
    xs = [r(TRAIN_BS, 300, 300, 3, std=1.0).to(torch.bfloat16) for _ in range(n_batches)]
    dps = [r(TRAIN_BS, 150, 150, 64, std=1.0).to(torch.bfloat16) for _ in range(n_batches)]
    return xs, dps, w


def check_stem_train(dev) -> dict:
    errs = {B: stem_check.check_b3(dev, B, log=log) for B in stem_check.B3_BATCHES}
    stem_check.check_b3_repeat(dev, TRAIN_BS, log=log)
    return {"max_abs_err": errs[TRAIN_BS]["max_abs_err"]}


# ---------------------------------------------------------------- phase 9

TRAIN_STEPS = 5
LOSS_RTOL = 0.02  # kernel route's loss against fused_stem=False, step by step
TRAIN_CFG, EVAL_CFG = TrainConfig(), EvalConfig()


def train_batch(dev, seed, B=TRAIN_BS, G=16) -> Batch:
    """A bs=16 batch with 16 GT boxes per image, drawn as benchmarks/run.py
    (bench_train) draws its batch."""
    rng = np.random.default_rng(seed)
    lo = rng.uniform(0.1, 0.6, (B, G, 2)).astype(np.float32)
    sz = rng.uniform(0.05, 0.3, (B, G, 2)).astype(np.float32)
    images = rng.normal(0, 1, (B, 300, 300, 3)).astype(np.float32)
    labels = rng.integers(0, 5, (B, G)).astype(np.int32)
    boxes = np.concatenate([lo, np.minimum(lo + sz, 1.0)], -1)
    return Batch(*(torch.as_tensor(a, device=dev)
                   for a in (images, boxes, labels, np.ones((B, G), bool))))


def train_setup(dev, fused, mesh=None):
    """Full-width bf16 SSD300 from init_variables(6, seed=0), SGD-Nesterov
    with the warmup-cosine schedule (no warmup, base_lr 1e-2)."""
    model = SSD300(6, dtype=torch.bfloat16).to(dev, memory_format=torch.channels_last)
    opt, sched = build_optimizer(model.parameters(), steps_per_epoch=100, warmup_epochs=0,
                                 base_lr=1e-2, momentum=TRAIN_CFG.momentum,
                                 weight_decay=TRAIN_CFG.weight_decay)
    state = create_train_state(model, opt, sched, init_variables(6, seed=0), mesh=mesh)
    pri = P.create_priors()
    step = make_train_step(model, pri, P.priors_xyxy(pri), iou_thresh=TRAIN_CFG.iou_thresh,
                           neg_pos_ratio=TRAIN_CFG.neg_pos_ratio, fused_stem=fused, mesh=mesh)
    ev = make_eval_step(model, pri, P.priors_xyxy(pri), iou_thresh=TRAIN_CFG.iou_thresh,
                        neg_pos_ratio=TRAIN_CFG.neg_pos_ratio,
                        score_thresh=EVAL_CFG.score_thresh, nms_thresh=EVAL_CFG.nms_thresh,
                        max_per_img=EVAL_CFG.max_per_img, mesh=mesh)
    return state, step, ev


class _Tail:
    """A wrap-padded tail batch: ``count`` real images."""

    def __init__(self, batch, count):
        self.batch, self.count = batch, count


def train_path(dev) -> dict:
    import tempfile

    batch = train_batch(dev, 0)
    state, step, _ = train_setup(dev, fused=False)
    plain = []
    for _ in range(TRAIN_STEPS):
        state, m = step(state, batch)
        plain.append(float(m["loss"]))
    del state, step
    torch.cuda.empty_cache()

    state, step, ev = train_setup(dev, fused=True)
    stem_train_ops.launches = stem_ops.launches = nms_ops.launches = 0
    kern = []
    for _ in range(TRAIN_STEPS):
        state, m = step(state, batch)
        kern.append(float(m["loss"]))
    torch.cuda.synchronize()
    per_steps = stem_train_ops.launches
    log(f"train steps (bs={TRAIN_BS}, bf16, 16 GT/image): losses with the stem kernel "
        f"{[round(v, 4) for v in kern]}, with fused_stem=False {[round(v, 4) for v in plain]}; "
        f"stem_train launches {per_steps} in {TRAIN_STEPS} steps")
    assert per_steps == TRAIN_STEPS, per_steps
    assert all(np.isfinite(kern)) and all(np.isfinite(plain)), (kern, plain)
    for i, (k, p) in enumerate(zip(kern, plain)):
        assert abs(k - p) <= LOSS_RTOL * abs(p), (i, k, p)
    assert kern[-1] < kern[0] and plain[-1] < plain[0], (kern, plain)

    batches = [batch, train_batch(dev, 1), train_batch(dev, 2)]
    val = [batches[1], _Tail(batches[2], TRAIN_BS // 2)]
    with tempfile.TemporaryDirectory() as d:
        state, results = fit(step, ev, state, lambda: batches, lambda: val, epochs=1,
                             save_model=True, save_dir=d, log=log)
        torch.cuda.synchronize()
        launches = {"stem_train": stem_train_ops.launches, "nms": nms_ops.launches,
                    "stem": stem_ops.launches}
        log(f"fit: 1 epoch over {len(batches)} batches, train loss "
            f"{results['train_loss'][0]:.4f}, test loss {results['test_loss'][0]:.4f}, "
            f"mAP@0.5 {results['mAP'][0]['map_50']:.4f}; kernel launches on the training "
            f"path {launches}")
        assert np.isfinite(results["train_loss"][0]) and np.isfinite(results["test_loss"][0])
        assert launches["stem_train"] == TRAIN_STEPS + len(batches), launches
        assert launches["nms"] > 0, launches
        fresh, _, _ = train_setup(dev, fused=True)
        fresh, start_epoch, best, _ = load_checkpoint(f"{d}/last.ckpt", fresh)
        log(f"load_checkpoint(last.ckpt): start_epoch {start_epoch}, step {fresh.step}")
        assert start_epoch == 1 and fresh.step == TRAIN_STEPS + len(batches)
    return {"launches": launches, "kern": kern, "plain": plain}


# --------------------------------------------------------------- phase 10


def stem_train_bound(B):
    """Least time for the stem's forward + backward on the card: operations
    of the five contractions at the bf16 peak against the bytes of the
    inputs (image, dp, weights) read once and outputs (p, statistics,
    gradients) written once."""
    ops = 2 * B * 300 * 300 * 64 * (27 + 576 + 576 + 576 + 27)
    params = 64 * 27 + 64 * 576 + 6 * 64
    nbytes = (B * 300 * 300 * 3 * 2 + B * 150 * 150 * 64 * 2 * 2  # x, dp, p
              + 2 * params * 4 + 4 * 64 * 4)                      # weights, grads, stats
    return (*bound_ms(ops, nbytes), ops, nbytes)


def b3_split_row(split, library) -> dict | None:
    """Phase 10's per-launch split of B3 for the kernels line: device ms,
    launches per forward + backward and bound of each named launch, and
    beside conv1_stats and dw1 the device ms of cuDNN's conv1_1 forward and
    weight gradient alone."""
    if split is None:
        return None
    row = {k: {"ms": v["ms"], "per_call": v["launches"], "bound_ms": v["bound_ms"]}
           for k, v in split.items() if isinstance(v, dict) and v["bound_ms"] is not None}
    row["conv1_stats"]["library_ms"] = library["conv1_1 forward"]["device_ms"]
    row["dw1"]["library_ms"] = library["conv1_1 weight gradient"]["device_ms"]
    return row


def train_timing(dev, launches, err, split_lines, split) -> dict:
    batches = [train_batch(dev, 10 + i) for i in range(4)]
    step_ms = {}
    for label, fused in (("kernel", True), ("plain", False), ("plain", False),
                         ("kernel", True)):  # in turns
        state, step, _ = train_setup(dev, fused)
        holder = {"state": state}

        def one(b):
            holder["state"], m = step(holder["state"], b)

        step_ms.setdefault(label, []).append(cuda_ms(one, batches, iters=10, warmup=3))
        del state, step, holder
        torch.cuda.empty_cache()
    for label, ms in step_ms.items():
        log(f"train step bs={TRAIN_BS} bf16 ({'stem kernel' if label == 'kernel' else 'fused_stem=False'}): "
            + ", ".join(f"{t:.3f} ms ({TRAIN_BS * 1e3 / t:.1f} images/s)" for t in ms))

    xs, dps, w = stem_train_inputs(dev, seed=4)
    ps = [t.detach().clone().requires_grad_() for t in w]

    def fwd_bwd(fn):
        def run(a):
            for p in ps:
                p.grad = None
            torch.autograd.backward(fn(a[0], *ps)[0], a[1])
        return run

    ins = list(zip(xs, dps))
    k_ms = cuda_ms(fwd_bwd(stem_train_ops.stem_train), ins, iters=20, warmup=3)
    p_ms = cuda_ms(fwd_bwd(stem_train_ops.stem_train_ref), ins, iters=5, warmup=1)
    bf = torch.bfloat16
    lw = [t.detach().to(bf).requires_grad_() if t.dim() == 4 else t.detach().clone().requires_grad_()
          for t in w]
    lw[0] = lw[0].detach().contiguous(memory_format=torch.channels_last).requires_grad_()
    lw[4] = lw[4].detach().contiguous(memory_format=torch.channels_last).requires_grad_()

    def library(a):
        w1, b1, g1, be1, w2, b2, g2, be2 = lw
        for t in lw:
            t.grad = None
        x = a[0].permute(0, 3, 1, 2)  # NCHW view, channels-last memory
        y = F.conv2d(x, w1, b1.to(bf), padding=1)
        y = F.relu(F.batch_norm(y, None, None, g1, be1, training=True, eps=1e-5))
        y = F.conv2d(y, w2, b2.to(bf), padding=1)
        y = F.relu(F.batch_norm(y, None, None, g2, be2, training=True, eps=1e-5))
        torch.autograd.backward(F.max_pool2d(y, 2), a[1].permute(0, 3, 1, 2))

    lib_ms = cuda_ms(library, ins, iters=20, warmup=3)
    bound, bound_by, ops, nbytes = stem_train_bound(TRAIN_BS)
    log(f"stem_train kernel fwd+bwd bs={TRAIN_BS}: {k_ms:.4f} ms, library (cuDNN conv+BN+ReLU "
        f"x2 + pool, fwd+bwd, bf16) {lib_ms:.4f} ms, plain {p_ms:.4f} ms, bound {bound:.4f} ms "
        f"by {bound_by} ({ops / 1e9:.1f} GFLOP bf16, {nbytes / 1e6:.1f} MB), "
        f"1 launch counted per forward")
    for line in split_lines:  # traced right after phase 11
        log(line)
    return {
        "name": "stem_train", "route": "cuda", "source": "ssdx_torch/csrc/stem_train.cu",
        "replaces": "ssdx/ops/pallas_stem_train.py:718", "launches": launches["stem_train"],
        "max_abs_err": err["max_abs_err"], "ms": k_ms, "plain_ms": p_ms, "bound_ms": bound,
        "bound_by": bound_by, "library_ms": lib_ms, "split": split,
    }


# --------------------------------------------------------------- phase 11

# One layer of each geometry of the int8 backbone, at full width, with the
# emit of the walk (tools/check_int8_conv.py, layers): ConvBNRelu_2 (150x150,
# 64->128), _9 (38x38, 512->512, both outputs), _13 (dilation 6), _16
# (stride 2, both), _14 (1x1, both), _22 (3x3 valid -> 1x1, tap only).
INT8_LAYERS = tuple(next(l for l in int8_check.layers() if l.name == f"ConvBNRelu_{i}")
                    for i in (2, 9, 13, 16, 14, 22))
KERNEL_NAME = "::conv_kernel<"  # the int8 conv kernel in the profiler's names
# Heads of the kernel walk (reciprocal multiply) against quant.apply_int8
# (division): max |diff|, and the share of elements past 0.05.  A handful of
# requantized values differ by one int8 step, each step is 1/127 of its
# channel's range, and every later rounding near a boundary can flip with it,
# so at full width both limits are looser than the 0.25 and 1 % that hold at
# width 0.25: twice what the three scenes show (0.24 and 2.5 %).
HEAD_ATOL, HEAD_FRAC = 0.5, 0.05


def check_int8_layers(dev) -> dict:
    worst = {"conv3": 0.0, "mm": 0.0}
    for layer in INT8_LAYERS:
        xs, w = int8_check.layer_inputs(dev, layer, BS)
        got = int8_check.call(int8_ops.int8_conv, xs[0], w, layer)
        ref = int8_check.call(int8_ops.int8_conv_ref, xs[0], w, layer)
        torch.cuda.synchronize()
        got, ref = (o if isinstance(o, tuple) else (o,) for o in (got, ref))
        parts = []
        for g, r in zip(got, ref):
            assert g.shape == r.shape and g.dtype == r.dtype, (g.shape, r.shape, g.dtype)
            bad = int((g != r).sum())
            err = (g.float() - r.float()).abs().max().item()
            kind = "int8" if g.dtype == torch.int8 else "bf16 tap"
            spread = f", {g.unique().numel()} distinct values" if g.dtype == torch.int8 else ""
            parts.append(f"{kind} {tuple(g.shape)}: {bad} mismatches{spread}")
            key = "mm" if layer.k == 1 else "conv3"
            worst[key] = max(worst[key], err)
            assert bad == 0 and torch.isfinite(g.float()).all(), (layer.name, kind, bad, err)
        log(f"int8 kernel vs plain, {layer.name} (bs={BS}, {layer.H}x{layer.H}, "
            f"{layer.cin}->{layer.cout}, k={layer.k} s={layer.stride} d={layer.dilation} "
            f"p={layer.pad}, emit={layer.emit}): " + "; ".join(parts))
    return {k: {"max_abs_err": v} for k, v in worst.items()}


def scene_images(det):
    from PIL import Image

    scenes = sorted(STATIC_DIR.glob("example_*.jpg"))
    assert len(scenes) == 3, scenes
    return np.concatenate([det.preprocess_pil(Image.open(p)) for p in scenes])


def check_int8_walk(det8):
    """The 21 layers of the demo network on the three scenes, layer by
    layer on the kernel walk's own int8 inputs, then the heads."""
    qp = det8.quant_params
    feats = det8._stem(torch.as_tensor(scene_images(det8), device=det8.device))
    topo = quant._TOPOLOGY
    xq = quant._quantize_act(feats.float(), qp.layers[topo[0].name].in_scale)
    steps = total = 0
    for i, spec in enumerate(topo):
        ql = qp.layers[spec.name]
        last = i + 1 == len(topo)
        ns = None if last else qp.layers[topo[i + 1].name].in_scale
        kw = dict(stride=spec.stride, dilation=spec.dilation, pad=spec.pad,
                  emit="f32" if last else "both", tap_dtype=torch.float32)
        got = int8_ops.int8_conv(xq, ql.kernel_q, ql.w_scale, ql.bias, ns, **kw)
        ref = int8_ops.int8_conv_ref(xq, ql.kernel_q, ql.w_scale, ql.bias, ns, **kw)
        if last:
            assert torch.equal(got, ref), spec.name
            break
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1]), spec.name
        divided = quant._quantize_act(ref[1], ns)  # quant.apply_int8's requantization
        d = (got[0].int() - divided.int()).abs()
        assert int(d.max()) <= 1, (spec.name, int(d.max()))
        steps, total = steps + int(d.sum()), total + d.numel()
        xq = quant._max_pool(got[0], spec.pool == "ceil") if spec.pool else got[0]
    log(f"int8 walk, demo weights, 3 scenes: all 21 layers equal their plain version bit "
        f"for bit (int8 and f32 tap); reciprocal against division: {steps} of {total} "
        f"requantized values differ, each by one int8 step")
    assert steps < 0.01 * total, (steps, total)

    torch.backends.cudnn.allow_tf32 = False  # the f32 heads of both walks in full f32
    loc_k, cls_k = int8_ops.apply_int8_kernels(qp, feats, torch.float32)
    loc_p, cls_p = quant.apply_int8(qp, feats, torch.float32, compute="int32")
    torch.backends.cudnn.allow_tf32 = True
    torch.cuda.synchronize()
    for name, k, p in (("loc", loc_k, loc_p), ("cls", cls_k, cls_p)):
        diff = (k - p).abs()
        frac = (diff > 0.05).float().mean().item()
        log(f"  apply_int8_kernels vs quant.apply_int8, {name} {tuple(k.shape)}: max |diff| "
            f"{diff.max().item():.4f} (limit {HEAD_ATOL}), {frac:.5f} of elements past 0.05 "
            f"(limit {HEAD_FRAC})")
        assert torch.isfinite(k).all() and diff.max().item() <= HEAD_ATOL and frac < HEAD_FRAC


# --------------------------------------------------------------- phase 12

INT8_CONV3_PER_FWD = sum(1 for s in quant._TOPOLOGY if s.kernel == 3)
INT8_MM_PER_FWD = sum(1 for s in quant._TOPOLOGY if s.kernel == 1)


def int8_detector():
    os.environ["SSDX_INT8"] = "1"
    try:
        det8 = create_detector()
    finally:
        del os.environ["SSDX_INT8"]
    assert getattr(det8, "int8", False) and det8.quant_params is not None
    assert det8.device.type == "cuda" and det8.stem_kernel and det8.dtype == torch.bfloat16
    return det8


def int8_path(det, det8) -> dict:
    from PIL import Image

    scenes = sorted(STATIC_DIR.glob("example_*.jpg"))
    stem_ops.launches = nms_ops.launches = 0
    int8_ops.launches = int8_ops.launches_conv3 = int8_ops.launches_mm = 0
    preds = [det8.predict_pil(Image.open(p), **SERVE_KW) for p in scenes]
    torch.cuda.synchronize()
    launches = {"stem": stem_ops.launches, "nms": nms_ops.launches,
                "int8_conv3": int8_ops.launches_conv3, "int8_mm": int8_ops.launches_mm}
    log(f"int8 path: detections per scene {[len(p['labels']) for p in preds]}, kernel "
        f"launches {launches} ({int8_ops.launches} int8 conv launches in {len(scenes)} "
        f"forwards)")
    assert launches["int8_conv3"] == INT8_CONV3_PER_FWD * len(scenes), launches
    assert launches["int8_mm"] == INT8_MM_PER_FWD * len(scenes), launches
    assert launches["stem"] == len(scenes) and launches["nms"] > 0, launches
    for p in preds:
        assert np.isfinite(p["boxes"]).all() and np.isfinite(p["scores"]).all()

    images = scene_images(det)
    agree = quant.detection_agreement(det.predict_batched(images, **SERVE_KW),
                                      det8.predict_batched(images, **SERVE_KW))
    n8 = sum(len(p["labels"]) for p in preds)
    log(f"int8 vs bf16 detector on the 3 scenes: match rate {agree['match_rate']:.4f} "
        f"(limit 0.8; {n8} int8 detections), mean matched IoU "
        f"{agree['mean_matched_iou']:.4f}, max score delta {agree['max_score_delta']:.4f}")
    assert n8 > 0 and agree["match_rate"] >= 0.8, agree
    return launches


# --------------------------------------------------------------- phase 13


def int8_bound(layer):
    """Least time for one layer at bs=32: its operations at the dense int8
    peak against input, weights, scales and outputs moved once."""
    Ho = (layer.H + 2 * layer.pad - layer.dilation * (layer.k - 1) - 1) // layer.stride + 1
    M = BS * Ho * Ho
    ops = 2 * M * layer.cout * layer.k * layer.k * layer.cin
    out_bytes = {"int8": 1, "f32": 2, "both": 3}[layer.emit]  # int8 + bf16 tap
    nbytes = (BS * layer.H * layer.H * layer.cin + layer.k * layer.k * layer.cin * layer.cout
              + 12 * layer.cout + M * layer.cout * out_bytes)
    return (*bound_ms(ops, nbytes, PEAK_INT8), ops)


def int8_layer_library(layer, w):
    """The yardstick of one layer: for a 1x1 layer torch._int_mm plus the
    elementwise epilogue; for a 3x3 layer cuDNN's bf16 conv + bias of the
    same layer, since no single PyTorch call computes an int8 conv.  Returns
    (name, fn of an int8 NHWC batch, fn's input from such a batch)."""
    kq, ws, bias, ns = w
    if layer.k == 1:
        wt = kq.reshape(layer.cout, layer.cin).t().contiguous()  # [K,N] for torch._int_mm
        inv = torch.reciprocal(ns)

        def library(x):
            y = torch.relu(torch._int_mm(x.reshape(-1, layer.cin), wt).float() * ws + bias)
            return torch.clamp(torch.round(y * inv), -127, 127).to(torch.int8), \
                y.to(torch.bfloat16)

        return "torch._int_mm + elementwise epilogue", library, lambda x: x
    wb, bb = kq.to(torch.bfloat16), bias.to(torch.bfloat16)
    return ("cuDNN bf16 conv + bias of the same layer (no int8 conv call in PyTorch)",
            lambda x: F.conv2d(x, wb, bb, layer.stride, layer.pad, layer.dilation),
            lambda x: x.to(torch.bfloat16).permute(0, 3, 1, 2))  # channels-last


def int8_layer_timing(dev) -> dict:
    """Every one of the 21 layers at bs=32 with its walk's emit: the
    kernel by CUDA events and by profiler device time, beside its bound and
    its library yardstick (both times); the float64 plain version by events
    for the six INT8_LAYERS only.  main() runs it right after phase 11,
    where the profiler keeps its records (section 7 of PERF.md)."""
    rows = {}
    for layer in int8_check.layers():
        xs, w = int8_check.layer_inputs(dev, layer, BS, n_batches=4, seed=7)
        fn = lambda x: int8_check.call(int8_ops.int8_conv, x, w, layer)
        k_ms = cuda_ms(fn, xs)
        k_dev, names = bench_int8_mm.device_time(fn, [(x,) for x in xs], kernel=KERNEL_NAME)
        assert k_dev is not None, (f"{layer.name}: the profiler lost records in every window "
                                   f"(records, calls): {bench_int8_mm.lost_windows[-3:]}")
        p_ms = None
        if layer in INT8_LAYERS:
            p_ms = cuda_ms(lambda x: int8_check.call(int8_ops.int8_conv_ref, x, w, layer), xs,
                           iters=2, warmup=1)
        bound, bound_by, ops = int8_bound(layer)
        lib_name, library, lib_in = int8_layer_library(layer, w)
        lxs = [lib_in(x) for x in xs]
        lib_ms = cuda_ms(library, lxs)
        lib_dev = bench_int8_mm.device_ms(library, [(x,) for x in lxs])
        assert lib_dev is not None, (f"{layer.name} library: the profiler lost records in every "
                                     f"window (records, calls): {bench_int8_mm.lost_windows[-3:]}")
        p = int8_ops.plan(xs[0].shape, layer.cout, layer.k, layer.stride, layer.dilation,
                          layer.pad)
        log(f"int8 kernel {layer.name} bs={BS} ({layer.H}x{layer.H}, {layer.cin}->"
            f"{layer.cout}, k={layer.k} s={layer.stride} d={layer.dilation}, "
            f"emit={layer.emit}, {p.loader} loader, tile {p.bm}x{p.bn}, {p.ctas} a SM): "
            f"device {k_dev:.4f} ms = {ops / k_dev / 1e9:.1f} TOP/s, {bound / k_dev:.2f} of its "
            f"bound, events {k_ms:.4f} ms; bound {bound:.4f} ms by {bound_by}"
            + ("" if p_ms is None else f", plain {p_ms:.3f} ms")
            + f"; library device {lib_dev:.4f} ms, events {lib_ms:.4f} ms ({lib_name}); "
            f"{lib_dev / k_dev:.2f}x the library's speed on the device")
        rows[layer.name] = {"layer": layer.name, "k": layer.k, "loader": p.loader,
                            "tile": f"{p.bm}x{p.bn}", "blocks_per_sm": p.ctas,
                            "ms": k_ms, "device_ms": k_dev, "plain_ms": p_ms,
                            "bound_ms": bound, "bound_by": bound_by, "library_ms": lib_ms,
                            "library_device_ms": lib_dev, "kernel": bench_int8_mm.short_name(names)}
        del xs, w, lxs
        torch.cuda.empty_cache()
    return rows


def int8_timing(dev, det, det8, launches, errs, layer_rows) -> list:
    """Phase 13: bs=32 predict_batched and the post-stem walk in int8 beside
    bf16, in turns; then the kernels line's rows from int8_layer_timing."""
    g = torch.Generator(device=dev).manual_seed(3)
    batches = [torch.randn(BS, 300, 300, 3, generator=g, device=dev) for _ in range(4)]
    e2e = {"int8": [], "bf16": []}
    for label, d in (("int8", det8), ("bf16", det), ("bf16", det), ("int8", det8)):  # in turns
        e2e[label].append(cuda_ms(lambda x: d.predict_batched(x, **SERVE_KW), batches))
    for label, ms in e2e.items():
        log(f"predict_batched bs={BS} ({label}): "
            + ", ".join(f"{t:.3f} ms/batch ({BS * 1e3 / t:.1f} images/s)" for t in ms))

    feats = [det8._stem(x) for x in batches]
    qp = det8.quant_params
    walk = {"int8": [], "bf16": []}
    fns = {"int8": lambda f: int8_ops.apply_int8_kernels(qp, f, torch.bfloat16),
           "bf16": lambda f: det.model(f, stem_input=True)}
    with torch.inference_mode():
        for label in ("int8", "bf16", "bf16", "int8"):
            walk[label].append(cuda_ms(fns[label], feats))
    log(f"post-stem walk bs={BS}: int8 kernels + int8 pools + bf16 heads "
        + ", ".join(f"{t:.3f}" for t in walk["int8"]) + " ms; bf16 SSD300(stem_input=True) "
        + ", ".join(f"{t:.3f}" for t in walk["bf16"]) + " ms")
    del feats, batches

    def row(name, replaces, layer, key, count):
        r = layer_rows[layer]
        layers = [v for v in layer_rows.values() if (v["k"] == 1) == (key == "mm")]
        return {"name": name, "route": "cuda", "source": "ssdx_torch/csrc/int8_conv.cu",
                "replaces": replaces, "launches": count,
                "max_abs_err": errs[key]["max_abs_err"], "ms": r["ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"], "library_ms": r["library_ms"],
                "device_ms": r["device_ms"], "library_device_ms": r["library_device_ms"],
                "shape": f"{layer} at bs={BS}", "kernel": r["kernel"],
                "device_ms_all_layers": sum(v["device_ms"] for v in layers),
                "layers": layers}

    return [
        row("int8_conv (3x3)", "ssdx/ops/pallas_int8_conv.py:104", "ConvBNRelu_9", "conv3",
            launches["int8_conv3"]),
        row("int8_conv (1x1)", "ssdx/ops/pallas_int8_conv.py:135", "ConvBNRelu_14", "mm",
            launches["int8_mm"]),
    ]


def int8_probe() -> dict:
    """The int8 matmul probe through its own entry point (phase 11's last
    part): checks both bare matmuls and times them; then both at a ragged
    shape."""
    int8_ops.launches_raw = 0
    res = bench_int8_mm.run(size=2048, iters=30, log=lambda *a: log(" ", *a))
    count = int8_ops.launches_raw
    assert count > 0, count
    log(f"int8 probe: {count} launches of the bare matmul kernels")
    for key in ("kernel_int8_device_ms", "kernel_bf16_device_ms"):
        assert res[key] is not None, f"{key}: the profiler lost records in every window"
    bad, rel = check_gemm.check_nt(1000, 48, 80, log=lambda m: log(" ", m))
    return {"name": "int8_mm_raw", "route": "cuda", "source": "ssdx_torch/csrc/gemm_sm90.cu",
            "replaces": "scripts/bench_int8_mxu.py:55", "launches": count,
            "max_abs_err": max(res["max_abs_err"], bad), "ms": res["kernel_int8_ms"],
            "plain_ms": res["plain_int8_ms"], "bound_ms": res["bound_int8_ms"],
            "bound_by": "operations", "library_ms": res["torch_int8_ms"],
            "device_ms": res["kernel_int8_device_ms"],
            "library_device_ms": res["torch_int8_device_ms"], "host_ms": res["kernel_host_ms"],
            "library_host_ms": res["torch_host_ms"], "kernel": res["kernel_int8_name"],
            "bf16_control": {"ms": res["kernel_bf16_ms"], "device_ms": res["kernel_bf16_device_ms"],
                             "kernel": res["kernel_bf16_name"],
                             "library_ms": res["torch_bf16_ms"],
                             "library_device_ms": res["torch_bf16_device_ms"],
                             "library_f32_out_ms": res["torch_bf16f32_ms"],
                             "library_f32_out_device_ms": res["torch_bf16f32_device_ms"],
                             "bound_ms": res["bound_bf16_ms"],
                             "rel_err": max(res["bf16_rel_err"], rel)}}


# --------------------------------------------------------------- phase 14

POOL_SHAPE = (TRAIN_BS, 300, 300, 64)


def pool_cases(dev):
    """(name, y, g): the tool's shape, an odd shape (the last row and column
    belong to no window), and forced ties: half-step values, with every
    window of the first image equal in all four positions."""
    gen = torch.Generator(device=dev).manual_seed(14)
    bf = torch.bfloat16
    r = lambda *s: torch.randn(*s, generator=gen, device=dev)
    y = r(*POOL_SHAPE).to(bf)
    odd = r(3, 75, 37, 24).to(bf)
    ties = (r(4, 60, 60, 64) * 2).round().div(2).to(bf)
    ties[0] = ties[0, ::2, ::2].repeat_interleave(2, 0).repeat_interleave(2, 1)
    cot = lambda t: r(t.shape[0], t.shape[1] // 2, t.shape[2] // 2, t.shape[3]).to(bf)
    return [(f"{tuple(POOL_SHAPE)}", y, cot(y)), ("odd (3, 75, 37, 24)", odd, cot(odd)),
            ("ties (4, 60, 60, 64)", ties, cot(ties))]


def check_pool(dev) -> dict:
    worst = 0.0
    for name, y, g in pool_cases(dev):
        (kp,), (kdy,) = brp_check.grads_of(pool_ops.max_pool_2x2, [y], [g])
        (rp,), (rdy,) = brp_check.grads_of(pool_ops.max_pool_2x2_ref, [y], [g])
        torch.cuda.synchronize()
        assert kp.shape == rp.shape and kdy.shape == y.shape and kp.dtype == torch.bfloat16
        bad_p, bad_dy = int((kp != rp).sum()), int((kdy != rdy).sum())
        worst = max(worst, (kp.float() - rp.float()).abs().max().item(),
                    (kdy.float() - rdy.float()).abs().max().item())
        up = g.repeat_interleave(2, 1).repeat_interleave(2, 2)
        up = F.pad(up, (0, 0, 0, y.shape[2] - up.shape[2], 0, y.shape[1] - up.shape[1]))
        shared = int(((kdy != 0) & (kdy != up)).sum())
        log(f"pool kernels vs plain, {name} bf16: forward {bad_p} mismatches, dy {bad_dy} "
            f"mismatches of {kdy.numel()} ({shared} positions hold a split share)")
        assert bad_p == 0 and bad_dy == 0 and torch.isfinite(kdy.float()).all(), name
    return {"max_abs_err": worst}


# --------------------------------------------------------------- phase 15

def check_brp(dev) -> dict:
    """tools/check_brp.py: BRP_CASES and its edge cases in bf16 and f32, tie_split
    on and off, within phase 15's limits and two runs bit for bit, or it raises."""
    worst = brp_check.check(dev, log=log)
    return {"max_abs_err": worst[torch.bfloat16]}

# --------------------------------------------------------------- phase 16

TOOL_VARIANTS = ("pool", "brp", "brp_nosplit", "stem_fused", "bn", "bnpool", "stem")
TOOL_ITERS = 10


def pool_brp_counts() -> dict:
    return {"pool_fwd": pool_ops.launches_fwd, "pool_bwd": pool_ops.launches,
            "brp_fwd": brp_ops.launches, "brp_bwd": brp_ops.launches_bwd}


def tool_path() -> dict:
    """The experiment tool's variants that run B5 and B6, and their unfused
    counterparts, through its own entry point."""
    pool_ops.launches = pool_ops.launches_fwd = brp_ops.launches = brp_ops.launches_bwd = 0
    ms = {v: stem_tool.run(v, bs=TRAIN_BS, iters=TOOL_ITERS, log=lambda *a: log(" ", *a))["ms"]
          for v in TOOL_VARIANTS}
    torch.cuda.synchronize()
    launches = pool_brp_counts()
    per = TOOL_ITERS + 3  # the tool warms up with 3 iterations
    log(f"tool path: kernel launches {launches} ({per} iterations per variant: pool and stem "
        f"run B5, brp, brp_nosplit and stem_fused run B6)")
    assert launches["pool_fwd"] == launches["pool_bwd"] == 2 * per, launches
    assert launches["brp_fwd"] == launches["brp_bwd"] == 3 * per, launches
    return {"launches": launches, "ms": ms}


def backward_only(fn, inputs, cots, needs_grad=(0,)):
    """Graphs of fn built once per input outside the timed region; the
    returned callable runs one backward."""
    graphs = []
    for args, cot in zip(inputs, cots):
        leaves = [a.detach().requires_grad_() if i in needs_grad else a
                  for i, a in enumerate(args)]
        out = fn(*leaves)
        graphs.append((out if isinstance(out, tuple) else (out,), cot,
                       [leaves[i] for i in needs_grad]))
    return lambda i: torch.autograd.grad(graphs[i][0], graphs[i][2], graphs[i][1],
                                         retain_graph=True)


def pool_brp_timing(dev, launches, errs, brp_split, brp_lines) -> list:
    bf = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(16)
    r = lambda *s, std=1.0, mean=0.0: torch.randn(*s, generator=gen, device=dev) * std + mean
    B, H, W, C = POOL_SHAPE
    idx = list(range(4))
    xs = [r(B, H, W, C).to(bf) for _ in idx]
    gs = [r(B, H // 2, W // 2, C).to(bf) for _ in idx]
    nchw = lambda t: t.permute(0, 3, 1, 2)  # channels-last memory, as the library takes it
    x_bytes, p_bytes = xs[0].numel() * 2, gs[0].numel() * 2
    rows = []

    # B5: forward alone, backward alone
    with torch.no_grad():
        f_ms = {"kernel": cuda_ms(lambda i: pool_ops.max_pool_2x2(xs[i]), idx),
                "plain": cuda_ms(lambda i: pool_ops.max_pool_2x2_ref(xs[i]), idx, iters=5),
                "library": cuda_ms(lambda i: F.max_pool2d(nchw(xs[i]), 2), idx)}
    one = lambda fn: backward_only(fn, [(x,) for x in xs], [(g,) for g in gs])
    b_ms = {"kernel": cuda_ms(one(pool_ops.max_pool_2x2), idx),
            "plain": cuda_ms(one(pool_ops.max_pool_2x2_ref), idx, iters=5),
            "library": cuda_ms(backward_only(lambda x: F.max_pool2d(nchw(x), 2),
                                             [(x,) for x in xs], [(nchw(g),) for g in gs]), idx)}
    f_bound = (x_bytes + p_bytes) / PEAK_BYTES * 1e3
    b_bound = (2 * x_bytes + 2 * p_bytes) / PEAK_BYTES * 1e3
    for what, ms, bound, count in (("forward", f_ms, f_bound, launches["pool_fwd"]),
                                   ("backward", b_ms, b_bound, launches["pool_bwd"])):
        log(f"max_pool_2x2 {what} kernel {tuple(POOL_SHAPE)} bf16: {ms['kernel']:.4f} ms, library "
            f"(F.max_pool2d {what}, channels-last) {ms['library']:.4f} ms, plain "
            f"{ms['plain']:.4f} ms, bound {bound:.4f} ms by bytes, 1 launch per {what}")
        rows.append({
            "name": f"max_pool_2x2 ({what})", "route": "cuda",
            "source": "ssdx_torch/csrc/pool.cu",
            "replaces": "ssdx/ops/pallas_pool.py:" + ("56" if what == "forward" else "124"),
            "launches": count, "max_abs_err": errs["pool"]["max_abs_err"], "ms": ms["kernel"],
            "plain_ms": ms["plain"], "bound_ms": bound, "bound_by": "bytes",
            "library_ms": ms["library"]})

    # B6: forward + backward, and each alone
    gamma, beta = r(C, std=0.2, mean=1.0), r(C, std=0.2)
    gstat = torch.full((C,), 1e-3, device=dev)
    ins = [(x, gamma, beta) for x in xs]
    cots = [(g, gstat, gstat) for g in gs]

    def library(x, ga, be):
        y = F.relu(F.batch_norm(nchw(x), None, None, ga, be, training=True, eps=1e-5))
        return F.max_pool2d(y, 2)

    fns = {"kernel": brp_ops.bn_relu_pool, "plain": brp_ops.bn_relu_pool_ref, "library": library}
    t = {}
    for label, fn in fns.items():
        it = 5 if label == "plain" else 20
        lib = label == "library"  # one output, in NCHW
        c = [(nchw(g),) for g in gs] if lib else cots
        with torch.no_grad():
            fwd = cuda_ms(lambda i: fn(*ins[i]), idx, iters=it)
        bwd = cuda_ms(backward_only(fn, ins, c, needs_grad=(0, 1, 2)), idx, iters=it)

        def both(i):
            leaves = [a.detach().requires_grad_() for a in ins[i]]
            out = fn(*leaves)
            torch.autograd.backward(out if isinstance(out, tuple) else (out,), c[i])

        t[label] = {"fwd": fwd, "bwd": bwd, "both": cuda_ms(both, idx, iters=it)}
    once = (2 * x_bytes + 2 * p_bytes + x_bytes) / PEAK_BYTES * 1e3   # x, p; x, g, dx
    passes = (4 * x_bytes + 2 * p_bytes + x_bytes + p_bytes) / PEAK_BYTES * 1e3  # x read 4 times
    k = t["kernel"]
    log(f"bn_relu_pool kernels {tuple(POOL_SHAPE)} bf16 fwd+bwd: {k['both']:.4f} ms (forward "
        f"{k['fwd']:.4f}, backward {k['bwd']:.4f}), library (F.batch_norm + relu + max_pool2d, "
        f"channels-last) {t['library']['both']:.4f} ms (forward {t['library']['fwd']:.4f}, "
        f"backward {t['library']['bwd']:.4f}), plain {t['plain']['both']:.4f} ms, bound "
        f"{once:.4f} ms by bytes with every input and output moved once ({passes:.4f} ms with "
        f"the second read of x that each BN barrier forces), 1 launch counted per forward "
        f"and per backward")
    rows.append({
        "name": "bn_relu_pool (fwd+bwd)", "route": "cuda",
        "source": "ssdx_torch/csrc/bn_relu_pool.cu", "replaces": "ssdx/ops/fused_bn_pool.py:518",
        "launches": launches["brp_fwd"], "launches_bwd": launches["brp_bwd"],
        "max_abs_err": errs["brp"]["max_abs_err"], "ms": k["both"],
        "plain_ms": t["plain"]["both"], "bound_ms": once, "bound_by": "bytes",
        "library_ms": t["library"]["both"], "bound_four_passes_ms": passes,
        "forward_ms": k["fwd"], "backward_ms": k["bwd"],
        "library_forward_ms": t["library"]["fwd"], "library_backward_ms": t["library"]["bwd"]})
    # device time by launch at the four BRP_CASES shapes (traced right after phase 11, where
    # the profiler keeps its records), beside the split before the pipeline
    for line in brp_lines:
        log(line)
    for res in brp_split:
        log(f"  before {tuple(res['shape'])} (four-kernel design; commit fd70a8a): "
            f"{BEFORE_BRP_SPLIT[tuple(res['shape'])]}")
        if tuple(res["shape"]) == POOL_SHAPE and res["split"] is not None:
            sp = res["split"]
            part = lambda names: sum(sp[n][0] for n in names if n in sp)
            rows[-1].update(device_ms=res["device_ms"],
                            forward_device_ms=part(("stats", "stats_finalize", "apply")),
                            backward_device_ms=part(("reduce", "reduce_finalize", "dx")))
    return rows


# --------------------------------------------------------------- phase 17

SYNTH_IMAGES = 44  # a SynthDrive directory, split 3:1 by the stratified group split


def check_augment(dev):
    """augment_batch and preprocess_batch at bs=16 from 512x512 scenes."""
    from ssdx_torch.data import synth
    from ssdx_torch.data.augment import AugmentConfig, augment_batch, preprocess_batch

    rng = np.random.default_rng(17)
    G = 16
    batches = []
    for _ in range(4):
        imgs = np.zeros((TRAIN_BS, 512, 512, 3), np.uint8)
        boxes = np.zeros((TRAIN_BS, G, 4), np.float32)
        labels = np.zeros((TRAIN_BS, G), np.int32)
        valid = np.zeros((TRAIN_BS, G), bool)
        for b in range(TRAIN_BS):
            imgs[b], bx, lb = synth.render_scene(rng, 512)
            n = min(len(lb), G)
            boxes[b, :n], labels[b, :n], valid[b, :n] = bx[:n], lb[:n], True
        batches.append(tuple(torch.as_tensor(a, device=dev) for a in (imgs, boxes, labels, valid)))
    gen = torch.Generator(device=dev).manual_seed(17)
    cfg = AugmentConfig(zoom_out_prob=0.5)  # every branch: zoom-out, crops, flip, photometric
    kept = total = 0
    for imgs, boxes, labels, valid in batches:
        img, b01, lab, val = augment_batch(gen, imgs, boxes, labels, valid, cfg)
        assert img.shape == (TRAIN_BS, 300, 300, 3) and img.dtype == torch.float32
        assert torch.isfinite(img).all() and torch.isfinite(b01).all()
        assert float(b01.min()) >= 0.0 and float(b01.max()) <= 1.0
        assert torch.equal(lab, labels) and not (val & ~valid).any()  # valid boxes keep labels
        assert (b01[val][:, 2:] > b01[val][:, :2]).all()
        kept, total = kept + int(val.sum()), total + int(valid.sum())
        pimg, pb = preprocess_batch(imgs, boxes)
        assert pimg.shape == img.shape and torch.isfinite(pimg).all()
        assert float(pb.min()) >= 0.0 and float(pb.max()) <= 1.0
    assert 0 < kept <= total
    a_ms = cuda_ms(lambda b: augment_batch(gen, *b, cfg), batches)
    p_ms = cuda_ms(lambda b: preprocess_batch(b[0], b[1]), batches)
    log(f"data path on the card, bs={TRAIN_BS} from 512x512 uint8: augment_batch {a_ms:.3f} "
        f"ms/batch ({kept} of {total} boxes kept over 4 batches), preprocess_batch "
        f"{p_ms:.3f} ms/batch")


def data_path(dev) -> dict:
    """SynthDrive on disk -> the training command's entry point,
    ``train.run.main(["--config", ...])`` (what ``python -m
    ssdx_torch.train.run --config`` runs), for one epoch: the stratified
    group split, the loaders, fit; then ``run`` of the same module for a
    second epoch, resumed from last.ckpt.  Both run in this process: a new
    process would add ~20 s of start-up (import torch, and torch._dynamo on
    the optimizer's first use; tools/profile_train_command.py) that no check
    reads."""
    import dataclasses
    import importlib.util
    import tempfile

    from ssdx_torch.config import Config
    from ssdx_torch.data import synth
    from ssdx_torch.data.dataset import DetectionDataset
    from ssdx_torch.data.split import stratified_group_split
    from ssdx_torch.train import run as run_mod

    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        synth.generate_dataset(f"{d}/train", SYNTH_IMAGES, seed=17)
        full = DetectionDataset(f"{d}/train")
        log(f"SynthDrive: {len(full)} scenes of 512x512 written and scanned in "
            f"{time.perf_counter() - t0:.1f} s, classes {full.classes}")
        cfg = Config()
        cfg = dataclasses.replace(
            cfg, data=dataclasses.replace(cfg.data, train_dir=f"{d}/train", batch_size=TRAIN_BS,
                                          num_workers=4),
            train=dataclasses.replace(cfg.train, save_dir=f"{d}/ckpt", warmup_epochs=0,
                                      epochs=2))
        assert cfg.train.bfloat16 and cfg.train.fused_stem is None and cfg.train.width_mult == 1.0
        train_files, val_files = stratified_group_split(full.annotate_df, cfg.data.val_fraction,
                                                        cfg.data.seed)
        assert not set(train_files) & set(val_files)
        assert len(train_files) + len(val_files) == len(full)
        sklearn = importlib.util.find_spec("sklearn") is not None
        log(f"stratified group split (numpy; scikit-learn importable: {sklearn}): "
            f"{len(train_files)} train / {len(val_files)} val files, disjoint")
        cfg.to_json(f"{d}/cfg.json")

        t0 = time.perf_counter()
        stem_train_ops.launches = 0
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            run_mod.main(["--config", f"{d}/cfg.json", "--epochs", "1"])
        torch.cuda.synchronize()
        first_launches = stem_train_ops.launches
        out = printed.getvalue().splitlines()
        for line in out:
            log(" ", line)
        assert f"dataset: {len(train_files)} train / {len(val_files)} val images, classes=" \
            f"{full.classes}" in out, out
        assert sum(l.startswith("Epoch: 0  |  mAP: ") for l in out) == 1, out
        assert os.path.exists(f"{d}/ckpt/last.ckpt") and os.path.exists(f"{d}/ckpt/last.weights")
        log(f"train.run.main --config {d}/cfg.json --epochs 1: 1 epoch in "
            f"{time.perf_counter() - t0:.1f} s, stem_train launches {first_launches}")

        t0 = time.perf_counter()
        stem_train_ops.launches = nms_ops.launches = 0
        logs = []
        say = lambda m: (logs.append(m), log(" ", m))
        state, results, _ = run_mod.run(cfg, epochs=2, resume=True, log=say, device=dev)
        torch.cuda.synchronize()
        launches = {"stem_train": stem_train_ops.launches, "nms": nms_ops.launches}
        assert f"resumed from {d}/ckpt/last.ckpt: 1 epochs done, 1 of 2 remaining" in logs, logs
        steps = state.step // 2  # the steps of each epoch
        assert steps >= 2 and state.step == 2 * steps, state.step
        assert first_launches == steps, (first_launches, steps)
        assert launches["stem_train"] == steps and launches["nms"] > 0, launches
        assert results["epochs"] == [2] and len(results["train_loss"]) == 2
        assert all(np.isfinite(results["train_loss"])) and all(np.isfinite(results["test_loss"]))
        train_t, test_t = results["training timing"][-1], results["testing timing"][-1]
        log(f"train.run.run resumed for epoch 2: {steps} bs={TRAIN_BS} batches (bf16, stem "
            f"kernel), train loss {results['train_loss'][0]:.4f} -> "
            f"{results['train_loss'][1]:.4f}, data wait {train_t['data wait'] * 1e3:.1f} ms and "
            f"step {train_t['step'] * 1e3:.1f} ms per batch, eval {test_t['model prediction'] * 1e3:.1f}"
            f" ms per batch and mAP {test_t['mAP time'] * 1e3:.1f} ms; kernel launches {launches}; "
            f"{time.perf_counter() - t0:.1f} s")
        from ssdx_torch.weights import load_params
        weights = load_params(f"{d}/ckpt/last.weights")
        assert set(weights) >= {"params", "batch_stats"}
    return launches


# --------------------------------------------------------------- phase 18

EW_ATOL = 1e-6   # tanhf against PyTorch's tanh need not agree in the last bit
MM_RTOL = 1e-3   # of the largest magnitude, as phase 11 holds bf16_mm_raw


def repro_inputs(dev, n=4, seed=18):
    g = torch.Generator(device=dev).manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=g, device=dev)
    xs = [r(256, 256) for _ in range(n)]
    ms = [(r(1024, 1024).to(torch.bfloat16), r(1024, 1024).to(torch.bfloat16)) for _ in range(n)]
    return xs, ms, r(1027)


def check_repro(dev) -> dict:
    xs, ms, odd = repro_inputs(dev)
    errs = {}
    for name, x in (("[256,256]", xs[0]), ("odd length 1027", odd)):
        got, ref = repro_ops.ew(x), repro_ops.ew_ref(x)
        torch.cuda.synchronize()
        e = (got - ref).abs().max().item()
        log(f"ew kernel vs plain, {name} f32: max |k-r| = {e:.3e} (limit {EW_ATOL})")
        assert got.shape == ref.shape and torch.isfinite(got).all() and e <= EW_ATOL, e
        errs["ew"] = max(errs.get("ew", 0.0), e)
    x, y = ms[0]
    g = torch.Generator(device=dev).manual_seed(18)
    xr, yr = (torch.randn(*s, generator=g, device=dev).to(torch.bfloat16)
              for s in ((1008, 96), (96, 192)))
    for name, a, b in (("1024^3", x, y), ("512-row shard", x[512:], y),
                       ("ragged 1008x192x96", xr, yr)):
        got, ref = repro_ops.mm(a, b), repro_ops.mm_ref(a, b)
        torch.cuda.synchronize()
        e, top = (got - ref).abs().max().item(), ref.abs().max().item()
        log(f"mm kernel vs plain, {name} bf16 -> f32: max |k-r| = {e:.3e}, max |r| = {top:.1f} "
            f"(limit {MM_RTOL} of it)")
        assert got.dtype == torch.float32 and torch.isfinite(got).all() and e <= MM_RTOL * top
        errs["mm"] = max(errs.get("mm", 0.0), e)
    check_gemm.check_shard(x, y, log=lambda m: log(" ", m))
    return {k: {"max_abs_err": v} for k, v in errs.items()}


def repro_path(mesh) -> dict:
    """The tool's three cases through its own entry point, in the mesh."""
    repro_ops.launches_ew = repro_ops.launches_mm = stem_ops.launches = 0
    lines = repro_tool.run(repro_tool.CASES, mesh, log=lambda m: log(" ", m))
    torch.cuda.synchronize()
    launches = {"ew": repro_ops.launches_ew, "mm": repro_ops.launches_mm,
                "stem": stem_ops.launches}
    log(f"repro tool in a {mesh.size}-rank {mesh.backend} group: "
        f"{sum(v['status'] == 'ok' for v in lines.values())} of {len(lines)} lines ok, kernel "
        f"launches {launches}")
    assert len(lines) == 6 and all(v["status"] == "ok" for v in lines.values()), lines
    for name, v in lines.items():
        if name.endswith("inside mesh"):
            assert v["max_diff"] == 0.0, (name, v)  # the same kernel on the same data
    assert launches == {"ew": 2, "mm": 2, "stem": 2}, launches
    return launches


def repro_timing(dev) -> dict:
    """Both probe kernels by CUDA events (the caller's wait, host cost
    included) and by profiler device time, beside plain, library and bound;
    the host cost of one call on inputs too small to keep the card busy.
    main() runs it right after phase 11: at phase 18's place, after phases
    12-17, the profiler has lost every record of these kernels in some runs
    (PERF.md, open questions), never at phase 11's."""
    xs, ms, _ = repro_inputs(dev, seed=19)
    device_ms, host_ms, fmt = bench_int8_mm.device_ms, bench_int8_mm.host_ms, bench_int8_mm.fmt
    device_time = bench_int8_mm.device_time
    n = xs[0].numel()
    ew_lib = lambda x: torch.tanh(x) * 1.5
    ew_ms = cuda_ms(repro_ops.ew, xs, iters=200, warmup=10)
    ew_plain = cuda_ms(repro_ops.ew_ref, xs, iters=200, warmup=10)
    t = time.perf_counter()
    floor, ew_dev = bench_ew.floor_and_ew([(x,) for x in xs])  # in turns, one window
    assert floor is not None, "the profiler lost the empty kernel's records in every window"
    ew_lib_dev = device_ms(ew_lib, [(x,) for x in xs], iters=50)
    ew_bytes, ew_ops = 2 * n * 4, 2 * n
    ew_bound = bound_ms(ew_ops, ew_bytes, PEAK_F32)[0]
    log(f"ew kernel [256,256] f32: {ew_ms:.5f} ms by events, {fmt(ew_dev, '.5f')} ms on the "
        f"device; plain and library (torch.tanh(x) * 1.5, two launches) {ew_plain:.5f} ms by "
        f"events, {fmt(ew_lib_dev, '.5f')} ms on the device; bound {ew_bound:.6f} ms by bytes "
        f"({ew_bytes / 1e3:.0f} KB)")
    # ew where bytes dominate (tools/bench_ew.py), against the same floor
    ew_bench = bench_ew.run(floor=floor, check_first=False, log=lambda m: log(" ", m))
    ew_large = {k: {f: v[f] for f in ("values", "device_ms", "ms", "library_device_ms",
                                      "bound_ms", "share")}
                for k, v in ew_bench["sizes"].items()}
    log(f"ew kernel: launch floor {floor:.5f} ms in the same window as ew's "
        f"{fmt(ew_dev, '.5f')}, so its [256,256] bound is max(floor, bytes) = "
        f"{max(floor, ew_bound):.5f} ms and it runs at {fmt(ew_dev and ew_dev / floor, '.2f')}x "
        f"the floor; at 2^26 values {fmt(ew_large['2^26']['device_ms'], '.5f')} ms on the device "
        f"against {ew_large['2^26']['bound_ms']:.5f} by bytes (share "
        f"{fmt(ew_large['2^26']['share'], '.3f')}); floor and large sizes "
        f"{time.perf_counter() - t:.1f} s")
    mm_f32 = lambda x, y: torch.mm(x, y, out_dtype=torch.float32)
    mm_ms = cuda_ms(lambda a: repro_ops.mm(*a), ms, iters=50, warmup=5)
    mm_plain = cuda_ms(lambda a: repro_ops.mm_ref(*a), ms, iters=50, warmup=5)
    mm_lib = cuda_ms(lambda a: torch.matmul(*a), ms, iters=50, warmup=5)
    mm_lib32 = cuda_ms(lambda a: mm_f32(*a), ms, iters=50, warmup=5)
    mm_dev, mm_names = device_time(repro_ops.mm, ms, iters=50, kernel="gemm_kernel")
    assert mm_dev is not None, "mm: the profiler lost records in every window"
    mm_lib_dev, mm_lib32_dev = (device_ms(f, ms, iters=50) for f in (torch.matmul, mm_f32))
    small = [(x[:64, :64].contiguous(), y[:64, :64].contiguous()) for x, y in ms]
    mm_host, lib_host = host_ms(repro_ops.mm, small), host_ms(mm_f32, small)
    M = N = K = 1024
    ops, nbytes = 2 * M * N * K, (M * K + K * N) * 2 + M * N * 4
    t_ops, t_bytes = ops / PEAK_BF16, nbytes / PEAK_BYTES
    mm_bound = max(t_ops, t_bytes) * 1e3
    log(f"mm kernel 1024^3 bf16 -> f32: {mm_ms:.5f} ms by events, {mm_dev:.5f} ms on the "
        f"device = {ops / mm_dev / 1e9:.1f} TFLOP/s; plain (x.float() @ y.float()) {mm_plain:.5f} ms; "
        f"library torch.mm(out_dtype=float32) {mm_lib32:.5f} ms by events, "
        f"{fmt(mm_lib32_dev, '.5f')} on the device; torch.matmul (bf16 out) {mm_lib:.5f} / "
        f"{fmt(mm_lib_dev, '.5f')}; bound "
        f"{mm_bound:.5f} ms ({t_ops * 1e3:.5f} by operations, {t_bytes * 1e3:.5f} by bytes); "
        f"host cost of one call (64^3) {mm_host * 1e3:.2f} us, library {lib_host * 1e3:.2f} us")
    return {
        "ew": {"name": "ew", "route": "cuda", "source": "ssdx_torch/csrc/repro.cu",
               "replaces": "scripts/repro_shardmap_pallas.py:68", "ms": ew_ms,
               "plain_ms": ew_plain, "bound_ms": ew_bound, "bound_by": "bytes",
               "library_ms": ew_plain, "device_ms": ew_dev, "library_device_ms": ew_lib_dev,
               "floor_ms": floor, "bound_with_floor_ms": max(floor, ew_bound),
               "large": ew_large},
        "mm": {"name": "mm", "route": "cuda", "source": "ssdx_torch/csrc/gemm_sm90.cu",
               "replaces": "scripts/repro_shardmap_pallas.py:88", "ms": mm_ms,
               "plain_ms": mm_plain, "bound_ms": mm_bound,
               "bound_by": "operations" if t_ops > t_bytes else "bytes", "library_ms": mm_lib32,
               "device_ms": mm_dev, "library_device_ms": mm_lib32_dev, "host_ms": mm_host,
               "library_host_ms": lib_host, "kernel": bench_int8_mm.short_name(mm_names),
               "bf16_out_library": {"ms": mm_lib, "device_ms": mm_lib_dev}},
    }


def repro_rows(timing, launches, errs) -> list:
    """Phase 18's rows of the kernels line: repro_timing's numbers with the
    launches of the tool's run and the errors of check_repro."""
    return [dict(timing[k], launches=launches[k], max_abs_err=errs[k]["max_abs_err"])
            for k in ("ew", "mm")]


# --------------------------------------------------------------- phase 19

MESH_STEPS = 3
MESH_B = 5  # an odd batch: two ranks pad it to 6


def mesh_detector(mesh):
    """create_detector()'s configuration and weights, in a mesh."""
    return Detector.from_weights(serving_weights(), CLASS_TO_IDX, stem_kernel=True,
                                 dtype=torch.bfloat16, mesh=mesh)


def mesh_images(dev):
    g = torch.Generator(device=dev).manual_seed(19)
    return torch.randn(MESH_B, 300, 300, 3, generator=g, device=dev)


def stem_bn_stats(model) -> dict:
    return {f"layers.{i}.bn.{k}": getattr(model.layers[i].bn, k).detach().float().cpu()
            for i in (0, 1) for k in ("running_mean", "running_var")}


def mesh_path(dev, mesh, det, preds5, plain_losses) -> dict:
    """Phase 19; returns what phase 20's ranks are held against."""
    import tempfile

    from PIL import Image

    scenes = sorted(STATIC_DIR.glob("example_*.jpg"))
    dm = mesh_detector(mesh)
    assert dm.mesh is mesh and dm.device.type == "cuda" and dm.stem_kernel
    stem_ops.launches = nms_ops.launches = stem_train_ops.launches = 0
    preds = [dm.predict_pil(Image.open(p), **SERVE_KW) for p in scenes]
    for i, (a, b) in enumerate(zip(preds, preds5)):
        for k in ("boxes", "scores", "labels"):
            assert np.array_equal(a[k], b[k]), (i, k)
    x = mesh_images(dev)
    loc_m, cls_m = dm.forward(x)
    loc_1, cls_1 = det.forward(x)
    assert torch.equal(loc_m, loc_1) and torch.equal(cls_m, cls_1)
    log(f"mesh path, {mesh.size} rank ({mesh.backend}): Detector(mesh=) gives phase 5's "
        f"detections exactly on the 3 scenes ({[len(p['labels']) for p in preds]}); forward on "
        f"B={MESH_B} equals the meshless forward bit for bit")
    del dm

    batch = train_batch(dev, 0)
    state, step, _ = train_setup(dev, fused=True, mesh=mesh)
    losses, bn = [], None
    for _ in range(MESH_STEPS):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
        bn = bn or stem_bn_stats(state.model)  # after the first step: the same weights
    torch.cuda.synchronize()
    launches = {"stem": stem_ops.launches, "nms": nms_ops.launches,
                "stem_train": stem_train_ops.launches}
    log(f"mesh path: {MESH_STEPS} train steps (bs={TRAIN_BS}, bf16, stem kernel) in the mesh, "
        f"losses {losses}; meshless (phase 9) {plain_losses[:MESH_STEPS]}; kernel launches "
        f"{launches}")
    assert losses == plain_losses[:MESH_STEPS], (losses, plain_losses)
    # the stem kernel: 3 scenes and B=5 in the mesh, and the meshless B=5 beside it
    assert launches["stem"] == len(scenes) + 2 and launches["nms"] == len(scenes), launches
    assert launches["stem_train"] == MESH_STEPS, launches
    ref = {"losses": losses, "bn": bn, "loc": loc_1.cpu(), "cls": cls_1.cpu()}

    holder = {"state": state}

    def one(b):
        holder["state"], _ = step(holder["state"], b)

    ms = cuda_ms(one, [train_batch(dev, 10 + i) for i in range(4)], iters=10, warmup=3)
    log(f"train step bs={TRAIN_BS} bf16 (stem kernel) in the {mesh.size}-rank {mesh.backend} mesh: "
        f"{ms:.3f} ms ({TRAIN_BS * 1e3 / ms:.1f} images/s); meshless: phase 10's stem-kernel line")
    state = holder["state"]
    steps_taken = state.step

    with tempfile.TemporaryDirectory() as d:
        path = save_checkpoint_sharded(epoch=0, state=state, loss_dict={"train_loss": losses},
                                       best_metric=losses[-1], outdir=d, tag="last", mesh=mesh)
        files = sorted(f.name for f in path.iterdir())
        fresh, _, _ = train_setup(dev, fused=True, mesh=mesh)
        fresh, start_epoch, best, loss_dict = load_checkpoint(path, fresh, mesh=mesh)
        same = all(torch.equal(a, b) for a, b in zip(fresh.model.state_dict().values(),
                                                     state.model.state_dict().values()))
        log(f"save_checkpoint_sharded -> {path.name}/ {files}; load_checkpoint on the directory: "
            f"start_epoch {start_epoch}, step {fresh.step}, weights restored bit for bit: {same}")
        assert path.is_dir() and files == ["arrays.pkl", "host_meta_p0.pkl"], files
        assert start_epoch == 1 and fresh.step == steps_taken and best == losses[-1] and same
        assert loss_dict == {"train_loss": losses}
    return ref


def dryrun_launches() -> dict:
    return {"stem_train": stem_train_ops.launches, "stem": stem_ops.launches,
            "nms": nms_ops.launches}


def check_dryrun(n: int, result: dict, launches: dict) -> None:
    """One rank's result of tools/dryrun.py's body at full width: two steps,
    a finite loss, B3 in the steps, B2 and B1 in Detector(mesh=)."""
    assert result["step"] == 2 and np.isfinite(result["loss"]), result
    assert np.isfinite(result["loader_loss"]) and result["boxes"] == [4 * n, 100, 4], result
    assert result["launches"] == launches and all(v > 0 for v in launches.values()), launches


def dryrun_path(mesh) -> None:
    """The dry run's per-rank body (tools/dryrun.py, the counterpart of
    __graft_entry__.py) in phase 19's one-rank NCCL group at full width."""
    stem_ops.launches = nms_ops.launches = stem_train_ops.launches = 0
    t = time.perf_counter()
    result = dryrun.rank_body(mesh)
    torch.cuda.synchronize()
    launches = dryrun_launches()
    log(dryrun.ok_line(mesh.size, result))
    log(f"  dry run at one rank ({mesh.backend}), full width: losses {result['loss']:.4f} "
        f"(synthetic batch) and {result['loader_loss']:.4f} (loader batch), kernel launches "
        f"{launches}, {time.perf_counter() - t:.1f} s")
    check_dryrun(mesh.size, result, launches)
    assert result["backend"] == "nccl", result


# --------------------------------------------------------------- phase 20

WORKER_TIMEOUT_S = 420
BN_RTOL, TWO_RANK_LOSS_RTOL, HEADS_RTOL = 1e-4, 0.01, 0.05


def mesh_worker(rank: int, port: int, outdir: str) -> int:
    """One of phase 20's two ranks: joins a gloo group on the shared card,
    takes its 8 of the 16 images, and writes what it computed to
    ``{outdir}/rank{rank}.pt``."""
    mesh_lib.initialize_distributed(backend="gloo", init_method=f"tcp://localhost:{port}",
                                    world_size=2, rank=rank)
    mesh = mesh_lib.create_mesh()
    dev = mesh.device
    assert mesh.size == 2 and mesh.backend == "gloo" and dev.type == "cuda"
    batch = mesh_lib.shard_batch(train_batch(dev, 0), mesh)
    assert batch.images.shape[0] == TRAIN_BS // 2
    state, step, _ = train_setup(dev, fused=True, mesh=mesh)
    stem_train_ops.launches = stem_ops.launches = 0
    losses, bn, t0 = [], None, time.perf_counter()
    for _ in range(MESH_STEPS):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
        bn = bn or stem_bn_stats(state.model)
    step_s = (time.perf_counter() - t0) / MESH_STEPS
    out = {"losses": losses, "bn": bn, "params": dryrun.params_digest(state.model),
           "step_s": step_s, "stem_train_launches": stem_train_ops.launches}
    del state, step
    torch.cuda.empty_cache()
    loc, cls = mesh_detector(mesh).forward(mesh_images(dev))
    out.update(loc=loc.cpu(), cls=cls.cpu(), stem_launches=stem_ops.launches)
    del loc, cls
    torch.cuda.empty_cache()
    stem_ops.launches = nms_ops.launches = stem_train_ops.launches = 0
    t = time.perf_counter()
    out["dryrun"] = dryrun.rank_body(mesh)  # tools/dryrun.py's body in this group
    torch.cuda.synchronize()
    out.update(dryrun_launches=dryrun_launches(), dryrun_s=time.perf_counter() - t)
    torch.save(out, f"{outdir}/rank{rank}.pt")
    mesh_lib.barrier(mesh)
    mesh_lib.finalize_distributed()
    return 0


def two_rank_path(ref) -> None:
    import tempfile

    port = repro_tool.free_port()
    with tempfile.TemporaryDirectory() as d:
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--mesh-worker",
                                   str(r), str(port), d], stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True) for r in range(2)]
        deadline = time.monotonic() + WORKER_TIMEOUT_S
        outs = []
        for p in procs:
            try:
                out, _ = p.communicate(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()
                out = (p.communicate()[0] or "") + f"\n(killed after {WORKER_TIMEOUT_S} s)"
            outs.append(out)
        for r, (p, out) in enumerate(zip(procs, outs)):
            assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{out[-4000:]}"
        got = [torch.load(f"{d}/rank{r}.pt") for r in range(2)]
    a, b = got
    assert a["params"] == b["params"], "the two ranks' parameters differ"
    assert a["losses"] == b["losses"] and a["stem_train_launches"] == MESH_STEPS
    rel = [abs(x - y) / abs(y) for x, y in zip(a["losses"], ref["losses"])]
    bn = {k: ((a["bn"][k] - v).abs().max() / v.abs().max()).item() for k, v in ref["bn"].items()}
    log(f"two ranks on one card (gloo, 8 + 8 of the 16 images, stem kernel with all-reduced "
        f"statistics): losses {a['losses']} against one process {ref['losses']}: relative "
        f"differences {[f'{x:.2e}' for x in rel]} (limit {TWO_RANK_LOSS_RTOL}); stem BN running "
        f"statistics after the first step (later the weights have drifted apart in bf16), max "
        f"|2r - 1p| / max |1p|: "
        + ", ".join(f"{k} {v:.2e}" for k, v in bn.items()) + f" (limit {BN_RTOL}); both ranks' "
        f"parameters bit-identical (sha256 {a['params'][:12]}); {a['step_s'] * 1e3:.0f} ms per "
        f"step per rank: the ranks share the card's SMs and gloo stages the gradients through "
        f"the host, so this is a correctness run, not a scaling result")
    assert all(np.isfinite(a["losses"])) and max(rel) <= TWO_RANK_LOSS_RTOL, rel
    assert max(bn.values()) <= BN_RTOL, bn
    for name in ("loc", "cls"):
        assert torch.equal(a[name], b[name]) and a[name].shape == ref[name].shape
        e = ((a[name] - ref[name]).abs().max() / ref[name].abs().max()).item()
        log(f"  Detector(mesh=) at two ranks, B={MESH_B} padded to {MESH_B + 1}: {name} "
            f"{tuple(a[name].shape)} max |2r - 1p| / max |1p| = {e:.3e} (limit {HEADS_RTOL}; a "
            f"rank's 3 images and the whole 5 may take other cuDNN algorithms in bf16)")
        assert torch.isfinite(a[name]).all() and e <= HEADS_RTOL, (name, e)
    assert a["stem_launches"] == 1, a["stem_launches"]
    da, db = a["dryrun"], b["dryrun"]
    log(dryrun.ok_line(2, da))
    log(f"  dry run at two ranks ({da['backend']}, the card shared), full width: losses "
        f"{da['loss']:.4f} and {da['loader_loss']:.4f} on both ranks, parameters bit-identical "
        f"(sha256 {da['params'][:12]}): {da['params'] == db['params']}; kernel launches per rank "
        f"{a['dryrun_launches']} and {b['dryrun_launches']}, {a['dryrun_s']:.1f} s")
    assert da["params"] == db["params"], "the dry run's ranks' parameters differ"
    assert da["loss"] == db["loss"] and da["backend"] == "gloo", (da, db)
    check_dryrun(2, da, a["dryrun_launches"])
    check_dryrun(2, db, b["dryrun_launches"])


# --------------------------------------------------------------- phase 21

EVAL_SCENES = 24
# The JAX package's own score of its bundle on the same 24 scenes (seed 21,
# 512^2, bs 8, bf16, score 0.2, NMS 0.3): ssdx.eval.run.evaluate_weights on
# the CPU, `python tests/torch_h2h.py bundle --root R --n 24 --render-seed 21
# --batch-size 8` (the port's evaluator on the CPU gives the same 0.7402).
# Phase 21 scores the JAX bundle, read by path, so the card's mAP is held to
# it within JAX_BUNDLE_MAP_TOL: on the first 100 of the 1,000 test scenes the
# two packages' bf16 evaluators differ by 0.0058 mAP, and agree exactly in
# float32 (the same tool, --n 100 [--float32]).
JAX_BUNDLE_MAP, JAX_BUNDLE_MAP_TOL = 0.7402039766311646, 0.02


def eval_path(dev) -> None:
    import tempfile

    from ssdx_torch.data import synth
    from ssdx_torch.eval import map as map_lib
    from ssdx_torch.eval import run as eval_run

    assert native_ops.available(), _build.build_logs.get("ssdx_native")
    rng = np.random.default_rng(21)
    flags = total = 0
    for _ in range(50):
        nd, ng = int(rng.integers(1, 40)), int(rng.integers(1, 12))
        lo = rng.uniform(0, 250, (ng, 2))
        gt = np.concatenate([lo, lo + rng.uniform(5, 120, (ng, 2))], 1)
        det = gt[rng.integers(0, ng, nd)] + rng.normal(0, 8, (nd, 4))  # near a GT, in score order
        ig = rng.random(ng) < 0.3
        for thresh in (0.5, 0.75):
            tp, mig = native_ops.match_detections_ignore(det, gt, ig, thresh)
            rtp, rmig = map_lib._match_with_ignore(det, gt, ig, thresh)
            assert np.array_equal(tp, rtp) and np.array_equal(mig, rmig)
            flags, total = flags + int(tp.sum() + mig.sum()), total + nd
    log(f"C++ matcher (csrc/ssdx_native.cpp, g++) equals the numpy matcher on 100 seeded groups "
        f"({flags} of {total} detections matched)")

    with tempfile.TemporaryDirectory() as d:
        synth.generate_dataset(f"{d}/test", EVAL_SCENES, seed=21)
        nms_ops.launches = 0
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            eval_run.main(["--test-dir", f"{d}/test", "--batch-size", "8", str(BUNDLED_WEIGHTS)])
        torch.cuda.synchronize()
    line = buf.getvalue().strip()
    log(f"eval.run on {EVAL_SCENES} SynthDrive scenes, demo weights (bf16, NMS kernel launches "
        f"{nms_ops.launches}):")
    log(" ", line.replace(f"{BUNDLED_WEIGHTS}", BUNDLED_WEIGHTS.name))
    m = re.fullmatch(r".*: mAP@0\.5=([0-9.]+)  \[(.+)\]  test loss=([0-9.]+)", line)
    assert m, line
    assert nms_ops.launches == EVAL_SCENES // 8, nms_ops.launches
    assert np.isfinite(float(m.group(3))) and float(m.group(1)) > 0.5, line
    gap = abs(float(m.group(1)) - JAX_BUNDLE_MAP)
    log(f"  against the JAX package's {JAX_BUNDLE_MAP:.4f} on the same scenes: |difference| "
        f"{gap:.4f} (limit {JAX_BUNDLE_MAP_TOL})")
    assert gap <= JAX_BUNDLE_MAP_TOL, (line, JAX_BUNDLE_MAP)


# --------------------------------------------------------------- phase 22

OVERFIT_EPOCHS, OVERFIT_STEPS = 40, 2  # 32 images at bs=16: 2 steps an epoch


def overfit_path() -> None:
    """tools/overfit_check.py through its entry point at full width on the
    card: 32 images, 40 epochs, the train step with B3; it must pass."""
    stem_train_ops.launches = nms_ops.launches = 0
    lines = []
    t0 = time.perf_counter()
    rc = overfit_check.main(["--epochs", str(OVERFIT_EPOCHS), "--eval-every", "5"],
                            log=lambda m: (lines.append(m), log(" ", m)))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = {"stem_train": stem_train_ops.launches, "nms": nms_ops.launches}
    m = re.fullmatch(r"RESULT: (PASS|FAIL)  \(first mAP=([0-9.]+), final mAP=([0-9.]+)\)",
                     lines[-1])
    assert m, lines[-1]
    first, final = float(m.group(2)), float(m.group(3))
    log(f"overfit check, full width bf16 on the card: {m.group(1)}, mAP@0.5 {first:.4f} -> "
        f"{final:.4f}, stem_train (B3) launches {launches['stem_train']}, NMS launches "
        f"{launches['nms']}, {secs:.1f} s")
    assert rc == 0 and m.group(1) == "PASS" and final > 0.5 and final > first, lines[-1]
    assert launches["stem_train"] == OVERFIT_EPOCHS * OVERFIT_STEPS, launches
    assert launches["nms"] > 0, launches


# --------------------------------------------------------------- phase 23

BENCH_CLIENTS, BENCH_REQUESTS, BENCH_SEQUENTIAL = 2, 4, 5


def bench_path(det, det8) -> None:
    """tools/bench_serving.py's function, short, on the bf16 detector of
    phase 5 and the int8 detector of phase 12 (run right after phase 13,
    while both are alive)."""
    for name, d in (("bf16", det), ("int8", det8)):
        stem_ops.launches = nms_ops.launches = 0
        int8_ops.launches = int8_ops.launches_conv3 = int8_ops.launches_mm = 0
        t = time.perf_counter()
        out = bench_serving.bench(d, clients=BENCH_CLIENTS, requests=BENCH_REQUESTS,
                                  sequential=BENCH_SEQUENTIAL)
        torch.cuda.synchronize()
        launches = {"stem": stem_ops.launches, "nms": nms_ops.launches,
                    "int8_conv3": int8_ops.launches_conv3, "int8_mm": int8_ops.launches_mm}
        log(f"serving bench, {name} ({BENCH_CLIENTS} clients x {BENCH_REQUESTS} requests, "
            f"{BENCH_SEQUENTIAL} sequential): {json.dumps(out)}")
        log(f"  kernel launches {launches} (bucket warm-up included), "
            f"{time.perf_counter() - t:.1f} s")
        sent = 1 + BENCH_SEQUENTIAL + BENCH_CLIENTS * BENCH_REQUESTS
        assert out["requests_sent"] == sent and out["batcher_stats"]["images"] == sent, out
        assert out["concurrent"]["requests"] == BENCH_CLIENTS * BENCH_REQUESTS, out
        assert out["int8"] == (name == "int8"), out
        assert launches["stem"] > 0 and launches["nms"] > 0, launches
        if name == "int8":
            assert launches["int8_conv3"] > 0 and launches["int8_mm"] > 0, launches


def main() -> int:
    if len(sys.argv) > 1 and sys.argv[1] == "--mesh-worker":
        return mesh_worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on a GPU",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    log(smi.stdout.strip().splitlines()[0])
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}")

    t = time.perf_counter()
    _build.build("stem", "nms", "stem_train", "int8_conv", "pool", "bn_relu_pool", "repro",
                 "gemm_sm90")
    assert _build.build_host("ssdx_native") is not None, _build.build_logs.get("ssdx_native")
    for name, out in sorted(_build.build_logs.items()):
        for line in out.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas[{name}]: {line.strip()}")
    log(f"built csrc/stem.cu, nms.cu, stem_train.cu, int8_conv.cu, pool.cu, bn_relu_pool.cu, "
        f"repro.cu and gemm_sm90.cu for sm_90a, and ssdx_native.cpp with g++, in "
        f"{time.perf_counter() - t:.1f} s")

    errs = {"stem": check_stem(dev), "nms": check_nms(dev)}
    det, launches, preds5 = main_path(dev)
    serve(det)
    kernels = timing(dev, det, launches, errs)
    errs.update(check_int8_layers(dev))
    det8 = int8_detector()
    check_int8_walk(det8)
    probe_row = int8_probe()
    repro_times = repro_timing(dev)
    layer_rows = int8_layer_timing(dev)
    b3_lines = []  # phase 10's split of the stem_train launches, printed there
    b3_split = b3_split_row(profile_stem.b3_split(TRAIN_BS, log=b3_lines.append),
                            profile_stem.b3_library(TRAIN_BS, log=b3_lines.append))
    brp_lines = []  # phase 16's split of the bn_relu_pool launches, printed there
    brp_split = profile_split.brp_split(log=brp_lines.append)
    launches8 = int8_path(det, det8)
    serve(det8)
    kernels += int8_timing(dev, det, det8, launches8, errs, layer_rows)
    kernels.append(probe_row)
    t = time.perf_counter()
    bench_path(det, det8)
    log(f"phase 23's serving bench: {time.perf_counter() - t:.1f} s")
    del det8
    torch.cuda.empty_cache()
    errs["stem_train"] = check_stem_train(dev)
    train = train_path(dev)
    kernels.append(train_timing(dev, train["launches"], errs["stem_train"], b3_lines, b3_split))
    errs["pool"], errs["brp"] = check_pool(dev), check_brp(dev)
    tool = tool_path()
    kernels += pool_brp_timing(dev, tool["launches"], errs, brp_split, brp_lines)
    check_augment(dev)
    t = time.perf_counter()
    data_path(dev)
    log(f"phase 17's training command and resume: {time.perf_counter() - t:.1f} s")
    errs.update(check_repro(dev))
    mesh_lib.initialize_distributed(init_method=f"tcp://localhost:{repro_tool.free_port()}",
                                    world_size=1, rank=0)
    mesh = mesh_lib.create_mesh()
    assert mesh.size == 1 and mesh.backend == "nccl", mesh
    kernels += repro_rows(repro_times, repro_path(mesh), errs)
    ref = mesh_path(dev, mesh, det, preds5, train["kern"])
    dryrun_path(mesh)
    mesh_lib.finalize_distributed()
    del det
    torch.cuda.empty_cache()
    two_rank_path(ref)
    eval_path(dev)
    overfit_path()
    log(f"chip_smoke phases done in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
