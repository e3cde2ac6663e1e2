"""The port's counterpart of ``__graft_entry__.py``: a forward to compile-check
and a data-parallel dry run over N ranks.

    python -m ssdx_torch.tools.dryrun N [--cpu]

``entry()`` returns ``(fn, example_args)``: the eval-mode forward of
``SSD300(num_classes=6)`` and zeros ``[8,300,300,3]``, on the card.

``dryrun_multichip(n)`` starts ``n`` worker processes of this module (a free
localhost port, a time limit after which every worker is killed), each of
which joins one process group and runs :func:`rank_body`:

1. one data-parallel train step on one image per rank, on the synthetic
   batch of ``__graft_entry__.py`` (``np.random.default_rng(0)``, B = n,
   G = 4; ``build_optimizer(steps_per_epoch=10, max_epochs=1,
   warmup_epochs=0)``, match IoU 0.4): a finite loss and ``step == 1``;
2. one real loader batch through the same step (2n random 64x64 JPEGs and
   their CSV, ``source_size=64``, ``max_boxes=4``): ``step == 2``;
3. ``Detector(mesh=)`` on 4n images: boxes ``[4n,100,4]``, finite scores.

Backends: NCCL with one card per rank when there are n cards; gloo with
every rank on card 0 when there are fewer (NCCL refuses two ranks on one
device); gloo on the CPU with ``--cpu``.  On the card the model trains in
bfloat16 with the train-mode stem kernel B3 at full width (the port's
training configuration) and the detector serves BN-folded bfloat16 with the
stem kernel B2 and the NMS kernel B1; on the CPU everything is float32
through the plain versions.  The run fails unless every rank ends with
bit-identical parameters.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from .. import resolve_device
from .repro_dist_kernels import free_port

__all__ = ["entry", "rank_body", "dryrun_multichip", "ok_line", "main"]

CLASS_TO_IDX = {"biker": 0, "car": 1, "pedestrian": 2, "trafficLight": 3, "truck": 4}
NUM_CLASSES = 6
G = 4  # boxes per image of the synthetic and the loader batch
TIMEOUT_S = 600.0


def entry(device=None, width_mult: float = 1.0):
    """Return ``(fn, example_args)``: ``fn(model, images)`` is the eval-mode
    forward of ``SSD300(num_classes=6)``; the arguments are that model, with
    the initial weights of seed 0, and zeros ``[8,300,300,3]``."""
    from ..model import SSD300, init_variables
    from ..weights import state_dict_from_jax

    dev = resolve_device(device)
    model = SSD300(NUM_CLASSES, width_mult=width_mult)
    model.load_state_dict(state_dict_from_jax(init_variables(NUM_CLASSES, 0, width_mult), False))
    model = model.to(dev, memory_format=torch.channels_last).eval()
    images = torch.zeros(8, 300, 300, 3, device=dev)

    @torch.no_grad()
    def forward(model, images):
        return model(images, train=False)

    return forward, (model, images)


def params_digest(model) -> str:
    """sha256 over the bytes of every tensor of ``model.state_dict()``."""
    digest = hashlib.sha256()
    for t in model.state_dict().values():
        digest.update(t.detach().cpu().contiguous().reshape(-1).view(torch.uint8).numpy()
                      .tobytes())
    return digest.hexdigest()


def _write_toy_dir(d: Path, rng, n: int) -> None:
    """``n`` random 64x64 JPEGs with one car box each, and their CSV."""
    import pandas as pd
    from PIL import Image

    rows = []
    for i in range(n):
        name = f"d{i:02d}.jpg"
        Image.fromarray(rng.integers(0, 255, (64, 64, 3), np.uint8)).save(d / name, quality=90)
        rows.append({"filename": name, "width": 64, "height": 64, "class": "car",
                     "xmin": 4, "ymin": 4, "xmax": 40, "ymax": 40})
    pd.DataFrame(rows).to_csv(d / "ann.csv", index=False)


def rank_body(mesh, width_mult: float = 1.0) -> dict:
    """This rank's part of the dry run (the module docstring's three steps)
    in ``mesh``; returns the losses, the step count, the parameters' digest,
    the detections' shape and the kernels' launches on this rank."""
    from .. import priors as P
    from ..api import Detector
    from ..data.dataset import DetectionDataset
    from ..data.pipeline import DetectionLoader
    from ..mesh import shard_batch
    from ..model import SSD300, init_variables
    from ..ops import nms as nms_ops
    from ..ops import stem as stem_ops
    from ..ops import stem_train as stem_train_ops
    from ..train.schedule import build_optimizer
    from ..train.step import Batch, create_train_state, make_train_step
    from ..weights import variables_from_torch

    counters = (stem_train_ops, stem_ops, nms_ops)
    before = [m.launches for m in counters]
    dev, n = mesh.device, mesh.size
    on_gpu = dev.type == "cuda"
    dtype = torch.bfloat16 if on_gpu else torch.float32
    model = SSD300(NUM_CLASSES, dtype=dtype, width_mult=width_mult).to(
        dev, memory_format=torch.channels_last)
    optimizer, sched = build_optimizer(model.parameters(), steps_per_epoch=10, max_epochs=1,
                                       warmup_epochs=0)
    state = create_train_state(model, optimizer, sched,
                               init_variables(NUM_CLASSES, 0, width_mult), mesh=mesh)
    pri = P.create_priors()
    train_step = make_train_step(model, pri, P.priors_xyxy(pri), iou_thresh=0.4, mesh=mesh)

    B = n
    rng = np.random.default_rng(0)
    lo = rng.uniform(0.1, 0.6, (B, G, 2)).astype(np.float32)
    sz = rng.uniform(0.1, 0.3, (B, G, 2)).astype(np.float32)
    batch = Batch(
        images=rng.normal(0, 1, (B, 300, 300, 3)).astype(np.float32),
        gt_boxes=np.concatenate([lo, np.minimum(lo + sz, 1.0)], -1),
        gt_labels=rng.integers(0, 5, (B, G)).astype(np.int32),
        gt_valid=np.ones((B, G), bool),
    )
    state, metrics = train_step(state, shard_batch(batch, mesh))
    loss = float(metrics["loss"])
    assert np.isfinite(loss), loss
    assert state.step == 1, state.step

    # one real input-pipeline batch through the same step: JPEG decode,
    # fixed-shape assembly, this rank's slice, augmentation on the device
    with tempfile.TemporaryDirectory() as td:
        _write_toy_dir(Path(td), rng, 2 * B)
        loader = DetectionLoader(DetectionDataset(td), batch_size=B, train=True, source_size=64,
                                 max_boxes=G, num_workers=2, prefetch=False, mesh=mesh)
        lb = next(iter(loader))
        state, metrics = train_step(state, lb.batch)
        loader_loss = float(metrics["loss"])
        assert np.isfinite(loader_loss), loader_loss
        assert state.step == 2, state.step

    digest = params_digest(state.model)
    det = Detector(CLASS_TO_IDX, variables=variables_from_torch(state.model), fold_bn=on_gpu,
                   stem_kernel=on_gpu, dtype=dtype, width_mult=width_mult, mesh=mesh)
    del state, train_step
    imgs = rng.normal(0, 1, (4 * n, 300, 300, 3)).astype(np.float32)
    dets = det.predict_batched(imgs, score_thresh=0.1, nms_thresh=0.5)
    assert tuple(dets.boxes.shape) == (4 * n, 100, 4), tuple(dets.boxes.shape)
    assert torch.isfinite(dets.scores).all()
    if on_gpu:
        torch.cuda.synchronize(dev)
    launches = {name: m.launches - b for name, m, b in
                zip(("stem_train", "stem", "nms"), counters, before)}
    return {"loss": loss, "loader_loss": loader_loss, "step": 2, "params": digest,
            "boxes": list(dets.boxes.shape), "launches": launches, "backend": mesh.backend,
            "device": str(dev)}


def ok_line(n: int, result: dict) -> str:
    return (f"dryrun_multichip({n}): ok, loss={result['loss']:.4f}, infer bs={4 * n} dets ok "
            f"(backend {result['backend']})")


def _worker(jobdir: str, rank: int) -> int:
    from .. import mesh as M

    job = json.loads((Path(jobdir) / "job.json").read_text())
    n = job["n"]
    if job["device"] == "cpu":
        torch.set_num_threads(2)  # a check, not a timing: keep N ranks off each other's cores
    M.initialize_distributed(backend=job["backend"], init_method=f"tcp://localhost:{job['port']}",
                             world_size=n, rank=rank, device=job["device"])
    mesh = M.create_mesh(job["device"])
    assert (mesh.size, mesh.rank, mesh.backend) == (n, rank, job["backend"]), mesh
    out = rank_body(mesh, job["width_mult"])
    (Path(jobdir) / f"rank{rank}.json").write_text(json.dumps(out))
    M.barrier(mesh)
    M.finalize_distributed()
    return 0


def dryrun_multichip(n: int, device=None, width_mult: float = 1.0,
                     timeout: float = TIMEOUT_S, log=print) -> dict:
    """Run :func:`rank_body` on ``n`` worker processes; print and return
    rank 0's result (with ``"ranks"``, every rank's).  Raises when a worker
    fails or outlives ``timeout`` seconds, or when the ranks' parameters
    differ."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        backend, wdev = "gloo", "cpu"
    elif torch.cuda.device_count() >= n:
        backend, wdev = "nccl", None  # rank r on card r
    else:
        backend, wdev = "gloo", "cuda:0"  # the ranks share card 0
    root = Path(__file__).resolve().parents[2]
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [str(root)] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p])}
    with tempfile.TemporaryDirectory() as jobdir:
        job = {"n": n, "port": free_port(), "backend": backend, "device": wdev,
               "width_mult": width_mult}
        (Path(jobdir) / "job.json").write_text(json.dumps(job))
        procs = [subprocess.Popen(
            [sys.executable, "-m", "ssdx_torch.tools.dryrun", "--worker", jobdir, str(r)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(n)]
        deadline = time.monotonic() + timeout
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(timeout=max(1.0, deadline - time.monotonic()))[0])
        except subprocess.TimeoutExpired:
            raise RuntimeError(f"dryrun_multichip({n}): workers still running after "
                               f"{timeout:.0f} s, killed") from None
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for r, (p, out) in enumerate(zip(procs, outs)):
            if p.returncode != 0:
                raise RuntimeError(f"dryrun_multichip({n}): rank {r} exited {p.returncode}:\n"
                                   f"{out[-4000:]}")
        ranks = [json.loads((Path(jobdir) / f"rank{r}.json").read_text()) for r in range(n)]
    digests = {r["params"] for r in ranks}
    if len(digests) != 1:
        raise RuntimeError(f"dryrun_multichip({n}): the ranks' parameters differ: {digests}")
    result = {**ranks[0], "ranks": ranks}
    log(ok_line(n, result))
    return result


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--worker"]:
        return _worker(argv[1], int(argv[2]))
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("n", type=int, help="number of ranks")
    ap.add_argument("--cpu", action="store_true", help="gloo on the CPU, float32")
    args = ap.parse_args(argv)
    result = dryrun_multichip(args.n, device="cpu" if args.cpu else None)
    print(json.dumps({k: v for k, v in result.items() if k != "ranks"}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
