"""Closed-loop batched inference: one caller, ``Detector.predict_batched``
then ``to_pylist``, batch after batch, cycling over a few distinct batches
of scenes held in host memory as float32 NHWC arrays (the API's input, so
every batch pays its host-to-device copy).

Traffic parameters: ``batch`` (images a call), ``distinct_batches``,
``scene_size`` (rendered pixels), ``score_thresh``, ``nms_thresh``,
``max_per_img``, ``check_batches`` (calls of the window compared with the
reference, drawn from the seed), ``trace_batches`` (calls in the traced
sub-window).  The configuration's ``serve`` section says how the program
runs the network; with ``int8`` it is quantized first on
``calibration_scenes`` scenes that are not the timed ones.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from .. import program, scenes
from ..reference import compare
from ..reference import ssd300 as ref
from .common import Outcome, profile_window


def run(cell, seed: int, seconds: float, trace: bool, device, t0: float, root,
        overrides: dict | None = None) -> Outcome:
    cfg, tr = cell.config, dict(cell.traffic, **(overrides or {}).get("traffic", {}))
    serve = dict(cfg["serve"], **(overrides or {}).get("serve", {}))
    prog = dict(serve, **(overrides or {}).get("program", {}))  # a control's program
    B, nb = tr["batch"], tr["distinct_batches"]
    kw = dict(score_thresh=tr["score_thresh"], nms_thresh=tr["nms_thresh"],
              max_per_img=tr["max_per_img"])
    int8 = prog.get("int8", False)
    n_calib = prog.get("calibration_scenes", 0)
    jobs = scenes.render_async(seed, [(0, B * nb), (1, n_calib)], tr["scene_size"], tr.get("workers", 4))

    params = None
    if serve["weights"] == "seed":
        params = ref.init_params(seed, cfg["num_classes"], device, serve.get("width_mult", 1.0))
    det = program.detector(prog, root, device, params)
    timed, calib = jobs.get()
    images = scenes.serve_images(timed)
    batches = [np.ascontiguousarray(images[i * B:(i + 1) * B]) for i in range(nb)]
    calib_images = scenes.serve_images(calib) if calib else None
    if int8:
        det.quantize_int8(calib_images, calib_batch=prog.get("calibration_batch", 16))

    from ssdx_torch.predict import to_pylist

    def call(x):
        return to_pylist(det.predict_batched(x, **kw))

    for _ in range(2):  # every shape this traffic uses, twice
        for x in batches:
            call(x)
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

    outs = []
    start = time.monotonic()
    while True:
        outs.append(call(batches[len(outs) % nb]))
        now = time.monotonic()
        if now - start >= seconds:
            break
    elapsed = now - start
    n = len(outs)
    peak = torch.cuda.max_memory_allocated() if device.type == "cuda" else 0

    traced = None
    if trace:
        det.forward = _spanned(det.forward, "portbench.forward")

        def traced_call(i):
            with torch.profiler.record_function("portbench.predict_batched"):
                d = det.predict_batched(batches[i % nb], **kw)
            with torch.profiler.record_function("portbench.to_pylist"):
                to_pylist(d)

        traced = profile_window(traced_call, tr["trace_batches"], device)

    del det
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # the reference, once the program's state is freed
    rng = np.random.default_rng([seed, 7])
    sample = sorted(rng.choice(n, size=min(n, tr["check_batches"]), replace=False).tolist())
    refs = reference_detections(cfg, serve, root, device, images, calib_images, kw, params)
    answers, ref_rows = [], []
    for i in sample:
        b = i % nb
        answers += outs[i] if len(outs[i]) == B else [None] * B
        ref_rows += refs[b * B:(b + 1) * B]
    numbers = compare.detection_numbers(answers, ref_rows, kw["score_thresh"])
    facts = {"nms_candidates": [[r["n_candidates"] for r in refs[b * B:(b + 1) * B]]
                                for b in range(nb)]}
    return Outcome(
        end_to_end={"serve_images_per_s": n * B / elapsed}, start=start, attempted=n * B,
        failed=sum(len(o) != B for o in outs) * B, numbers=numbers, memory_peak=peak,
        trace=traced, traced_iters=tr["trace_batches"], batch=B,
        window={"seconds": elapsed, "images": n * B, "iters": n}, facts=facts,
        int8=int8)


def _spanned(fn, name):
    def wrapped(*a, **k):
        with torch.profiler.record_function(name):
            return fn(*a, **k)
    return wrapped


def reference_detections(cfg, serve, root, device, images, calib_images, kw, params=None,
                         bits=None, chunk: int = 16) -> list[dict]:
    """The reference's detections of every image, in float32 (TF32 off); an
    int8 configuration (or ``bits``) runs the reference's own quantized
    network, calibrated on ``calib_images``."""
    int8 = serve.get("int8", False) or bits is not None
    bits = bits or serve.get("bits", 8)
    with torch.no_grad(), ref.float32_matmuls():
        p = ref.load_bundle(root / serve["weights"], device) if params is None else params
        pri = ref.priors().to(device)
        folded = ref.fold_bn(p)
        q = None
        if int8:
            amax = ref.calibrate(folded, torch.as_tensor(calib_images, device=device))
            q = ref.quantize(folded, amax, bits)
        out = []
        for s in range(0, len(images), chunk):
            x = torch.as_tensor(images[s:s + chunk], device=device)
            loc, conf = (ref.forward_quantized(folded, q, x, bits) if int8
                         else ref.forward(folded, x))
            out += ref.detect(loc, conf, pri, kw["score_thresh"], kw["nms_thresh"],
                              kw["max_per_img"])
    return out
