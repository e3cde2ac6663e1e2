"""Training steps: the program's train step (``make_train_step``) at a fixed
batch, cycling over a few distinct batches of scenes with their ground
truth, each copied to the card through pinned memory without blocking, as
the program's loader feeds it; every step ends with its losses read back,
as the program's epoch loop reads them.

Set-up builds one train state from weights drawn from the seed, its
learning-rate schedule at step ``schedule_step`` (as a run resumed there
holds it, so that the steps move the parameters as training does), and
drives it through its first ``checked_steps`` steps (the window's own call
and feed, on distinct batches), recording each step's loss, the first
gradient as the optimizer holds it and the parameters' change; the same
state then runs the window.  Once the window has closed and the program's
state is freed, the reference follows the same steps in float32.

Traffic parameters: ``batch``, ``distinct_batches``, ``scene_size``,
``schedule_step``, ``checked_steps``, ``trace_steps``.
"""
from __future__ import annotations

import math
import time

import torch

from .. import program, scenes
from ..reference import compare
from ..reference import ssd300 as ref
from .common import Outcome, profile_window


def _norms(leaves: dict, tensors: dict) -> dict:
    out = {}
    for name, (param, rows) in leaves.items():
        t = tensors[param]
        out[name] = float((t if rows is None else t[rows]).float().norm())
    return out


def run(cell, seed: int, seconds: float, trace: bool, device, t0: float, root,
        overrides: dict | None = None) -> Outcome:
    cfg = cell.config
    tr = dict(cell.traffic, **(overrides or {}).get("traffic", {}))
    train = dict(cfg["train"], **(overrides or {}).get("train", {}))
    B, nb, k = tr["batch"], tr["distinct_batches"], tr["checked_steps"]
    jobs = scenes.render_async(seed, [(2, B * nb)], tr["scene_size"], tr.get("workers", 4))

    params = ref.init_params(seed, cfg["num_classes"], device, train.get("width_mult", 1.0))
    s0 = tr["schedule_step"]
    state, step, leaves = program.train_state(train, params, device, cfg["num_classes"], s0)
    host = scenes.train_batches(jobs.get()[0], B)
    pin = device.type == "cuda"
    feed = [{k_: (torch.from_numpy(v).pin_memory() if pin else torch.from_numpy(v))
             for k_, v in b.items()} for b in host]

    losses = []

    def one(i):
        nonlocal state
        state, m = step(state, program.batch(feed[i % nb], device))
        loss = float(m["loss"])  # waits for the device
        float(m["loss_loc"]), float(m["loss_conf"])
        return loss

    params_p = [p for p, _ in {id(p): (p, 0) for p, _ in leaves.values()}.values()]
    p0 = {p: p.detach().clone() for p in params_p}
    wd = train["optimizer"]["weight_decay"]
    grad1 = None
    for i in range(k):  # the checked steps: warm-up through the window's own call
        losses.append(one(i))
        if i == 0:
            opt = state.optimizer
            buf = lambda p: opt.state.get(p, {}).get("momentum_buffer", wd * p0[p])
            grad1 = {p: buf(p) - wd * p0[p] for p in params_p}  # no buffer: no gradient
            grad1 = _norms(leaves, grad1)
    change = _norms(leaves, {p: p.detach() - p0[p] for p in params_p})
    prog_numbers = {"losses": losses, "grad_norms": grad1, "change_norms": change}
    del p0
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

    n, failed = 0, 0
    start = time.monotonic()
    while True:
        failed += not math.isfinite(one(k + n))
        n += 1
        now = time.monotonic()
        if now - start >= seconds:
            break
    elapsed = now - start
    peak = torch.cuda.max_memory_allocated() if device.type == "cuda" else 0

    traced = None
    if trace:
        def traced_step(i):
            with torch.profiler.record_function("portbench.train_step"):
                one(k + n + i)

        traced = profile_window(traced_step, tr["trace_steps"], device)

    del state, step, leaves, params_p, feed
    if device.type == "cuda":
        torch.cuda.empty_cache()
    ref_numbers = reference_steps(train, params, [host[i % nb] for i in range(k)], device,
                                  s0)
    numbers = compare.train_numbers(prog_numbers, ref_numbers)
    return Outcome(
        end_to_end={"train_images_per_s": n * B / elapsed}, start=start, attempted=n,
        failed=failed, numbers=numbers, memory_peak=peak, trace=traced,
        traced_iters=tr["trace_steps"], batch=B,
        window={"seconds": elapsed, "images": n * B, "iters": n},
        facts={"norms": {"prog": prog_numbers, "ref": ref_numbers}})


def reference_steps(train: dict, params: dict, batches: list, device, schedule_step: int,
                    q=None, keep=None, fault=None) -> dict:
    """The reference's steps ``schedule_step``, ``schedule_step + 1``, ... of the schedule
    from ``params`` on ``batches``: each step's loss, the first step's
    gradient norms and the parameters' change norms, leaf by leaf.  ``q``
    runs the steps in other precisions (the control, ``ssd300.Fp8``);
    ``keep`` maps a batch to the rows it trains on and ``fault`` maps
    (leaf names, gradients) to the gradients the step applies (faults)."""
    opt = train["optimizer"]
    warm = opt["warmup_epochs"] * opt["steps_per_epoch"]
    total = opt["epochs"] * opt["steps_per_epoch"]
    with ref.float32_matmuls():
        p = {"convs": [{"w": c["w"].clone(), "b": c["b"].clone(), "bn": None if c["bn"] is None
                        else {k: v.clone() for k, v in c["bn"].items()}} for c in params["convs"]],
             "loc": [{k: v.clone() for k, v in h.items()} for h in params["loc"]],
             "conf": [{k: v.clone() for k, v in h.items()} for h in params["conf"]]}
        names, tensors = zip(*ref.leaves(p))
        keep_in = getattr(q, "param_dtype", None)  # the control's parameter storage
        if keep_in is not None:
            for t in tensors:
                t.copy_(t.to(keep_in))
        start = [t.clone() for t in tensors]
        for t in tensors:
            t.requires_grad_(True)
        pri = ref.priors().to(device)
        bufs = [None] * len(tensors)
        losses, grad_norms = [], None
        for s, b in enumerate(batches):
            b = {k: torch.as_tensor(v, device=device) for k, v in b.items()}
            if keep is not None:
                b = keep(b)
            loc, conf = ref.forward(p, b["images"], train=True, q=q)
            t, cls, pos = ref.targets(b["boxes"], b["labels"], b["valid"], pri,
                                      train["iou_thresh"])
            loss = ref.multibox_loss(loc, conf, t, cls, pos, train["neg_pos_ratio"])
            grads = torch.autograd.grad(loss, tensors)
            if fault is not None:
                grads = fault(names, grads)
            if s == 0:
                grad_norms = {n: float(g.norm()) for n, g in zip(names, grads)}
            lr = ref.warmup_cosine(schedule_step + s, opt["base_lr"], warm, total, opt["min_lr"])
            ref.sgd_nesterov(tensors, grads, bufs, lr, opt["momentum"], opt["weight_decay"])
            if keep_in is not None:
                with torch.no_grad():
                    for t, b_ in zip(tensors, bufs):
                        t.copy_(t.to(keep_in))
                        b_.copy_(b_.to(keep_in))
            losses.append(float(loss.detach()))
        change = {n: float((t.detach() - t0).norm()) for n, t, t0 in zip(names, tensors, start)}
    return {"losses": losses, "grad_norms": grad_norms, "change_norms": change}
