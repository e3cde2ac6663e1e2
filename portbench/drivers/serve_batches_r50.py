"""Closed-loop batched inference of NVIDIA's SSD300 v1.1 (ResNet-50 trunk,
81 classes): one caller, ``Detector.predict_batched`` then ``to_pylist``,
batch after batch, cycling over a few distinct batches of scenes held in
host memory as float32 NHWC arrays, as ``serve_batches`` plays the VGG16
network.

Before it renders a scene it asks the program for this network (a
``Detector(..., architecture="resnet50")`` at width 0.125 on the CPU) and
exits at once, with a message, where the program has none.  The weights
are drawn from the seed with the published initialisers
(``reference.ssd300_resnet50.init_params``) and BatchNorm's statistics
are those of ``bn_calibration.scenes`` untimed scenes of stream 1, taken
by the reference in float32; the program is handed that tree unfolded and
folds it itself.

Traffic parameters: those of ``serve_batches`` (``batch``,
``distinct_batches``, ``scene_size``, ``score_thresh``, ``nms_thresh``,
``max_per_img``, ``check_batches``, ``trace_batches``, ``workers``) and
``prior_top_k`` / ``pair_top_k``, the reference's candidate stages.  The
traced window wraps ``Detector.forward`` in ``portbench.forward`` and the
model's trunk and heads in ``portbench.trunk`` and ``portbench.heads``.

Overrides (``program``) that the controls use (``portbench/control_r50.py``):
``nms`` (the overlap the program is asked to suppress by), ``fp8_trunk``
(every trunk conv's input rounded to float8 e4m3, one scale a tensor) and
``drop_shortcut`` (a bottleneck, as ``trunk.layer3.2``, run without its
shortcut); ``dtype`` and ``width_mult`` for the CPU tests.
"""
from __future__ import annotations

import time

import numpy as np
import torch
import torch.nn.functional as F

from .. import scenes
from ..reference import compare_r50
from ..reference import ssd300_resnet50 as ref
from .common import Outcome, profile_window
from .serve_batches import _spanned

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def class_to_idx(cfg: dict) -> dict:
    """The configuration's foreground classes (background is column 0)."""
    return {name: i for i, name in enumerate(cfg["classes"][1:])}


def check_program(cfg: dict) -> None:
    """Build this network small on the CPU, or exit: a program without it
    fails here, before any scene is rendered."""
    try:
        from ssdx_torch.api import Detector

        Detector(class_to_idx(cfg), architecture="resnet50", width_mult=0.125, device="cpu",
                 fold_bn=True)
    except (ImportError, TypeError, ValueError) as e:
        raise SystemExit(f"portbench: the program cannot build {cfg['name']} "
                         f"(Detector(..., architecture='resnet50')): {e}") from None


def tree(params: dict) -> dict:
    """The reference's parameters as the weights tree the program loads
    (``ssdx_torch.model_resnet``: HWIO kernels keyed by module path)."""
    hwio = lambda w: np.ascontiguousarray(w.detach().float().cpu().numpy().transpose(2, 3, 1, 0))
    npy = lambda t: t.detach().float().cpu().numpy()
    p, stats = {}, {}
    for path, c in params["convs"].items():
        bn = c["bn"]
        p[path] = {"Conv_0": {"kernel": hwio(c["w"])},
                   "BatchNorm_0": {"scale": npy(bn["gamma"]), "bias": npy(bn["beta"])}}
        stats[path] = {"BatchNorm_0": {"mean": npy(bn["mean"]), "var": npy(bn["var"])}}
    for i, (lh, ch) in enumerate(zip(params["loc"], params["conf"])):
        p[f"box_head_{i}"] = {"kernel": hwio(lh["w"]), "bias": npy(lh["b"])}
        p[f"cls_head_{i}"] = {"kernel": hwio(ch["w"]), "bias": npy(ch["b"])}
    return {"params": p, "batch_stats": stats}


def _fp8_input(module, args):
    x = args[0]
    scale = x.abs().amax().float().clamp(min=1e-30) / 448.0
    return ((x.float() / scale).to(torch.float8_e4m3fn).float() * scale).to(x.dtype),


def detector(cfg: dict, prog: dict, params: dict, device):
    """The program's detector of this configuration, with a control's fault
    where ``prog`` asks for one."""
    from ssdx_torch.api import Detector

    det = Detector(class_to_idx(cfg), variables=tree(params), fold_bn=prog["fold_bn"],
                   dtype=DTYPES[prog["dtype"]], device=device, architecture="resnet50",
                   width_mult=prog.get("width_mult", 1.0))
    if prog.get("fp8_trunk"):
        from ssdx_torch.model_resnet import ConvBN

        for m in det.model.trunk.modules():
            if isinstance(m, ConvBN):
                m.register_forward_pre_hook(_fp8_input)
    if prog.get("drop_shortcut"):
        block = det.model.get_submodule(prog["drop_shortcut"])
        block.register_forward_hook(lambda m, args, out: F.relu(m.branch(args[0])))
    return det


def run(cell, seed: int, seconds: float, trace: bool, device, t0: float, root,
        overrides: dict | None = None) -> Outcome:
    cfg, tr = cell.config, dict(cell.traffic, **(overrides or {}).get("traffic", {}))
    serve = dict(cfg["serve"], **(overrides or {}).get("serve", {}))
    prog = dict(serve, **(overrides or {}).get("program", {}))
    check_program(cfg)
    B, nb = tr["batch"], tr["distinct_batches"]
    kw = dict(score_thresh=tr["score_thresh"], nms_thresh=tr["nms_thresh"],
              max_per_img=tr["max_per_img"])
    calib = serve["bn_calibration"]
    jobs = scenes.render_async(seed, [(0, B * nb), (calib["stream"], calib["scenes"])],
                               tr["scene_size"], tr.get("workers", 4))

    width = serve.get("width_mult", 1.0)
    params = ref.init_params(seed, cfg["num_classes"], device, width)
    timed, calib_scenes = jobs.get()
    images = scenes.serve_images(timed)
    batches = [np.ascontiguousarray(images[i * B:(i + 1) * B]) for i in range(nb)]
    with torch.no_grad(), ref.float32_matmuls():
        ref.calibrate_bn(params, torch.as_tensor(scenes.serve_images(calib_scenes), device=device))
    det = detector(cfg, prog, params, device)

    from ssdx_torch.predict import to_pylist

    pkw = dict(kw, nms_kind=prog.get("nms", cfg["postprocess"]["nms"]))

    def call(x):
        return to_pylist(det.predict_batched(x, **pkw))

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
        det.model.trunk.forward = _spanned(det.model.trunk.forward, "portbench.trunk")
        det.model.heads.forward = _spanned(det.model.heads.forward, "portbench.heads")

        def traced_call(i):
            with torch.profiler.record_function("portbench.predict_batched"):
                d = det.predict_batched(batches[i % nb], **pkw)
            with torch.profiler.record_function("portbench.to_pylist"):
                to_pylist(d)

        traced = profile_window(traced_call, tr["trace_batches"], device)

    heads = [det.forward(x) for x in batches]  # the network of the window, once more
    del det
    if device.type == "cuda":
        torch.cuda.empty_cache()

    rng = np.random.default_rng([seed, 7])
    sample = sorted(rng.choice(n, size=min(n, tr["check_batches"]), replace=False).tolist())
    ref_heads = reference_heads(params, images, device, B)
    numbers, post = judge([(outs[i], i % nb) for i in sample], heads, ref_heads, kw, tr)
    rows = lambda key: [[r[key] for r in dets] for dets in post]
    facts = {"nms_candidates": rows("n_candidates"), "same_class_pairs": rows("same_class_pairs"),
             "pair_top_k": tr["pair_top_k"]}
    return Outcome(
        end_to_end={"serve_images_per_s": n * B / elapsed}, start=start, attempted=n * B,
        failed=sum(len(o) != B for o in outs) * B, numbers=numbers, memory_peak=peak,
        trace=traced, traced_iters=tr["trace_batches"], batch=B,
        window={"seconds": elapsed, "images": n * B, "iters": n}, facts=facts)


def reference_heads(params, images, device, batch: int, q=None, chunk: int = 16) -> list:
    """The reference's (loc, conf) of every image, BatchNorm folded, summed
    in float32 (TF32 off), in chunks of ``chunk`` on ``device``, one pair a
    batch of ``batch`` images; ``q`` rounds what the network keeps
    (``ref.forward``: a control one precision down)."""
    with torch.no_grad(), ref.float32_matmuls():
        folded = ref.fold_bn(params)
        parts = [ref.forward(folded, torch.as_tensor(images[s:s + chunk], device=device), q=q)
                 for s in range(0, len(images), chunk)]
    loc, conf = torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])
    return [(loc[s:s + batch], conf[s:s + batch]) for s in range(0, len(images), batch)]


def detect(heads, device, kw, tr) -> list[dict]:
    """The reference's postprocess of one batch's (loc, conf)."""
    loc, conf = heads
    return ref.detect(loc.float(), conf.float(), ref.priors().to(device), kw["score_thresh"],
                      kw["nms_thresh"], kw["max_per_img"], tr["prior_top_k"], tr["pair_top_k"])


def judge(checked: list, heads: list, ref_heads: list, kw, tr) -> tuple[dict, list]:
    """The numbers of the checked calls ``(answers, batch index)`` and the
    reference's postprocess of the program's heads of every batch.

    A random-weight ResNet-50 with calibrated BatchNorm grows any rounding
    difference through its 13 residual blocks (the heads of a bfloat16 run
    and of the float32 reference differ by ~20 % by norm), so the
    reference's own detections are another set of detections.  So the two
    stages are held apart: the answers against the reference's postprocess
    of the program's heads of the same batch (``compare_r50``; unprefixed
    numbers), and the program's heads against the reference's
    (``head_gap``).  The answers against the reference's own detections
    are reported beside them (``e2e_``)."""
    dev = heads[0][0].device
    post = [detect(h, dev, kw, tr) for h in heads]
    answers, rows, e2e_rows = [], [], []
    want = {}
    for out, b in checked:
        if b not in want:
            want[b] = detect(ref_heads[b], dev, kw, tr)
        answers += out if len(out) == len(post[b]) else [None] * len(post[b])
        rows += post[b]
        e2e_rows += want[b]
    args = (kw["score_thresh"], kw["max_per_img"], kw["nms_thresh"])
    numbers = compare_r50.detection_numbers(answers, rows, *args)
    e2e = compare_r50.detection_numbers(answers, e2e_rows, *args)
    numbers.update({f"e2e_{k}": e2e[k] for k in
                    ("box_gap_p90", "wrong_answers", "unpaired_share", "logit_gap_mean")})
    numbers.update(compare_r50.head_gap(heads, ref_heads))
    return numbers, post
