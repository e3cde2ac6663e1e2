"""Two-process jobs for the port's data-parallel tests (tests/test_torch_*.py).

``run_ranks(jobs, outdir)`` starts ``nproc`` worker processes of this file
(free localhost port, gloo on the CPU, a time limit after which every worker
is killed) and each worker runs the named jobs on its rank and writes
``{outdir}/{job}_rank{K}.pkl``.  The workers import ``torch`` and
``ssdx_torch`` only; inputs come from numpy seeds or from files the test
wrote into ``outdir`` (``variables.pkl``: a JAX-layout tree of numpy arrays).
The same input functions are imported by the tests for the one-process side.
"""
from __future__ import annotations

import os
import pickle
import random
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
CLASSES = {"biker": 0, "car": 1, "pedestrian": 2, "trafficLight": 3, "truck": 4}
WM = 0.25
OPT = dict(steps_per_epoch=10, max_epochs=2, warmup_epochs=0, base_lr=1e-2)
EVAL_KW = dict(iou_thresh=0.4, score_thresh=0.05, nms_thresh=0.5, max_per_img=50)
LOADER_KW = dict(source_size=64, max_boxes=4, num_workers=2, seed=11, prefetch=False)
GLOBAL_BATCH = 8


# ------------------------------------------------------------------ inputs


def images(b, seed=0):
    return np.random.default_rng(seed).normal(0, 1, (b, 300, 300, 3)).astype(np.float32)


def train_arrays(B=4, G=8, n_valid=3, seed=0):
    """(images, boxes, labels, valid) of tests/test_torch_train_step.py's batch."""
    rng = np.random.default_rng(seed)
    imgs = rng.normal(0, 1, (B, 300, 300, 3)).astype(np.float32)
    lo = rng.uniform(0.1, 0.5, (B, G, 2))
    sz = rng.uniform(0.1, 0.4, (B, G, 2))
    boxes = np.concatenate([lo, np.minimum(lo + sz, 1.0)], -1).astype(np.float32)
    labels = rng.integers(0, 5, (B, G)).astype(np.int32)
    valid = np.zeros((B, G), bool)
    valid[:, :n_valid] = True
    return imgs, boxes, labels, valid


IMG_VALID = np.array([True, True, True, False])  # a wrap-padded tail of one image


def stem_inputs(B=2):
    """Images, the eight stem parameters (OIHW) and a cotangent for p."""
    rng = np.random.default_rng(0)
    x = rng.normal(0, 1, (B, 300, 300, 3)).astype(np.float32)
    x[1:] = 2 * x[1:] + 0.5  # a shard's own statistics are far from the batch's
    shapes = ((64, 3, 3, 3), 64, 64, 64, (64, 64, 3, 3), 64, 64, 64)
    means = (0, 0, 1, 0, 0, 0, 1, 0)
    args = [rng.normal(m, 0.1, s).astype(np.float32) for s, m in zip(shapes, means)]
    dp = rng.normal(0, 1, (B, 150, 150, 64)).astype(np.float32)
    return x, args, dp


def flat(tree, pre=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{pre}/{k}"))
        return out
    return {pre: np.asarray(tree)}


# ------------------------------------------------------------------- launcher


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_ranks(jobs, outdir, nproc: int = 2, timeout: float = 420.0) -> list[str]:
    """Run ``jobs`` on ``nproc`` ranks; returns each rank's output.  Fails
    the calling test when a rank fails or outlives ``timeout`` seconds."""
    env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "2"}
    port = free_port()
    procs = [subprocess.Popen(
        [sys.executable, __file__, str(r), str(nproc), str(port), str(outdir), ",".join(jobs)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(nproc)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        raise AssertionError(f"workers still running after {timeout} s: killed")
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{out[-4000:]}"
        assert f"[{r}] ok" in out, out[-2000:]
    return outs


def load(outdir, job, rank):
    return pickle.loads((Path(outdir) / f"{job}_rank{rank}.pkl").read_bytes())


# ----------------------------------------------------------------------- jobs


def _state(variables, mesh, width_mult=WM):
    from ssdx_torch.model import SSD300
    from ssdx_torch.train.schedule import build_optimizer
    from ssdx_torch.train.step import create_train_state

    model = SSD300(6, width_mult=width_mult)
    optimizer, sched = build_optimizer(model.parameters(), **OPT)
    return create_train_state(model, optimizer, sched, variables, mesh=mesh)


def job_sync_bn(mesh, outdir, variables):
    """Train-mode forward on this rank's 4 of 8 images: the updated stats."""
    import torch

    from ssdx_torch.mesh import shard_batch
    from ssdx_torch.weights import variables_from_torch

    state = _state(variables, mesh)
    with torch.no_grad():
        loc, _ = state.model(torch.as_tensor(shard_batch(images(8), mesh)), train=True, mesh=mesh)
    return {"stats": flat(variables_from_torch(state.model)["batch_stats"]), "loc": loc.numpy()}


def job_stem_train(mesh, outdir, variables):
    """The plain B3 with a mesh on this rank's shard, f32: p, stats, grads."""
    import torch

    from ssdx_torch.mesh import shard_batch
    from ssdx_torch.ops.stem_train import stem_train

    x, args, dp = stem_inputs()
    ps = [torch.as_tensor(a).requires_grad_() for a in args]
    out = stem_train(torch.as_tensor(shard_batch(x, mesh)), *ps, 1e-5, torch.float32, mesh)
    torch.autograd.backward(out[0], torch.as_tensor(shard_batch(dp, mesh)))
    return {"out": [o.detach().numpy() for o in out], "grads": [p.grad.numpy() for p in ps]}


def job_train_step(mesh, outdir, variables):
    """One train step and one padded eval step on this rank's half."""
    from ssdx_torch import priors as P
    from ssdx_torch.mesh import shard_batch
    from ssdx_torch.train.step import Batch, make_eval_step, make_train_step
    from ssdx_torch.weights import variables_from_torch

    pri = P.create_priors()
    state = _state(variables, mesh)
    batch = shard_batch(Batch(*train_arrays()), mesh)
    ev = make_eval_step(state.model, pri, P.priors_xyxy(pri), mesh=mesh, **EVAL_KW)
    em, det = ev(state, batch, shard_batch(IMG_VALID, mesh))
    step = make_train_step(state.model, pri, P.priors_xyxy(pri), iou_thresh=0.4,
                           fused_stem=False, mesh=mesh)
    state, m = step(state, batch)
    return {"metrics": {k: float(v) for k, v in m.items()},
            "eval_metrics": {k: float(v) for k, v in em.items()},
            "det": [t.numpy() for t in det],
            "variables": flat(variables_from_torch(state.model))}


def job_loader(mesh, outdir, variables):
    """Both loaders over the toy directory: per-image checksums per batch."""
    from ssdx_torch.data.dataset import DetectionDataset
    from ssdx_torch.data.pipeline import DetectionLoader

    ds = DetectionDataset(Path(outdir) / "toy")
    out = {}
    for train in (False, True):
        loader = DetectionLoader(ds, GLOBAL_BATCH, train=train, mesh=mesh, **LOADER_KW)
        out[train] = {"batches": [loader_record(item) for item in loader],
                      "decoded": loader.stats["decoded"], "len": len(loader)}
    return out


def loader_record(item) -> dict:
    b = item.batch
    return {"count": item.count, "sums": b.images.double().sum((1, 2, 3)).numpy(),
            "labels": b.gt_labels.numpy(), "boxes": b.gt_boxes.numpy(),
            "valid": b.gt_valid.numpy()}


def job_detector(mesh, outdir, variables):
    from ssdx_torch.api import Detector

    det = Detector(CLASSES, variables=variables, width_mult=WM, mesh=mesh)
    assert det.device.type == "cpu"
    loc8, cls8 = det.forward(images(8))
    loc5, cls5 = det.forward(images(5, seed=2))  # 5 % 2 != 0: padded to 6, cut to 5
    return {"loc8": loc8.numpy(), "cls8": cls8.numpy(), "loc5": loc5.numpy(),
            "cls5": cls5.numpy(),
            "preds": det.predict(images(8, seed=1), score_thresh=0.1, nms_thresh=0.5)}


def job_checkpoint(mesh, outdir, variables):
    """Directory-format round trip with per-rank host RNG, a tag overwrite
    and a stale staging directory; asserts in place."""
    import torch

    from ssdx_torch.mesh import barrier
    from ssdx_torch.train.checkpoint import load_checkpoint, save_checkpoint

    ckdir = Path(outdir) / "ckpt"
    state = _state(variables, mesh)
    state.step = 7
    random.seed(1000 + mesh.rank)  # per-rank host RNG must round-trip
    np.random.seed(2000 + mesh.rank)
    torch.manual_seed(3000)
    py_state, np_state, t_state = random.getstate(), np.random.get_state(), torch.get_rng_state()
    path = save_checkpoint(epoch=3, state=state, loss_dict={"train_loss": [1.0, 0.5]},
                           best_metric=0.25, outdir=ckdir, tag="last", mesh=mesh)
    assert path.is_dir(), path
    random.seed(0), np.random.seed(0), torch.manual_seed(0)
    fresh = _state(init_tree(variables, 0.0), mesh)
    fresh, start_epoch, best, loss_dict = load_checkpoint(path, fresh, mesh=mesh)
    assert (start_epoch, best, loss_dict) == (4, 0.25, {"train_loss": [1.0, 0.5]})
    assert fresh.step == 7
    assert random.getstate() == py_state
    assert np.random.get_state()[1].tolist() == np_state[1].tolist()
    assert torch.equal(torch.get_rng_state(), t_state)
    for a, b in zip(state.model.state_dict().values(), fresh.model.state_dict().values()):
        assert torch.equal(a, b)

    # a crashed earlier save left a staging directory; overwrite the same tag
    barrier(mesh)
    if mesh.rank == 0:
        stale = ckdir / "last.ckpt.staging"
        stale.mkdir()
        (stale / "arrays.pkl").write_bytes(b"garbage")
    barrier(mesh)
    state.step = 8
    save_checkpoint(epoch=4, state=state, loss_dict=None, outdir=ckdir, tag="last", mesh=mesh)
    fresh, start_epoch, _, _ = load_checkpoint(path, fresh, mesh=mesh)
    assert start_epoch == 5 and fresh.step == 8
    assert not (ckdir / "last.ckpt.staging").exists() and not (ckdir / "last.ckpt.old").exists()
    return {"files": sorted(p.name for p in path.iterdir())}


def init_tree(tree, value):
    if isinstance(tree, dict):
        return {k: init_tree(v, value) for k, v in tree.items()}
    return np.full_like(np.asarray(tree), value)


JOBS = {f.__name__[4:]: f for f in (job_sync_bn, job_stem_train, job_train_step, job_loader,
                                    job_detector, job_checkpoint)}


def main() -> None:
    rank, nproc, port, outdir = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    jobs = sys.argv[5].split(",")
    import torch

    from ssdx_torch import mesh as M

    torch.set_num_threads(2)
    M.initialize_distributed(init_method=f"tcp://localhost:{port}", world_size=nproc, rank=rank,
                             device="cpu")
    mesh = M.create_mesh("cpu")
    assert (mesh.size, mesh.rank, mesh.backend) == (nproc, rank, "gloo"), mesh
    vpath = Path(outdir) / "variables.pkl"
    variables = pickle.loads(vpath.read_bytes()) if vpath.exists() else None
    for job in jobs:
        out = JOBS[job](mesh, outdir, variables)
        (Path(outdir) / f"{job}_rank{rank}.pkl").write_bytes(pickle.dumps(out))
    M.barrier(mesh)
    M.finalize_distributed()
    print(f"[{rank}] ok", flush=True)


if __name__ == "__main__":
    main()
