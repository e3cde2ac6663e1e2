"""Checkpoint save/load with the JAX package's schema, tag policy and resume.

Torch counterpart of ``ssdx/train/checkpoint.py``.  A checkpoint is one
``{outdir}/{tag}.ckpt`` file, a pickle written atomically (temporary file +
rename) of:

  * ``format`` 2 and ``epoch``, the 0-based index of the last completed
    epoch (``load_checkpoint`` returns ``start_epoch = epoch + 1``), and
    ``step``;
  * ``params`` and ``batch_stats`` as float32 numpy trees in the JAX layout
    (:func:`ssdx_torch.weights.variables_from_torch`);
  * the optimizer's and the LR scheduler's ``state_dict`` (tensors on the
    CPU);
  * ``best_metric``, the RNG states (python, numpy, torch and, where there
    is one, CUDA) and the loss-history dict.

``save_params`` writes the weights-only pickle that both this package's and
the JAX package's ``load_params`` read.
"""
from __future__ import annotations

import pickle
import random
from pathlib import Path

import numpy as np
import torch

from ..weights import load_params, state_dict_from_jax, variables_from_torch

__all__ = ["save_checkpoint", "load_checkpoint", "save_params", "load_params"]


def _cpu(tree):
    """Every tensor in a (nested) state dict moved to the CPU."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_cpu(v) for v in tree)
    return tree


def _atomic_write(payload: bytes, path: Path) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(path.suffix + ".tmp")
    tmp.write_bytes(payload)
    tmp.replace(path)  # atomic on the same filesystem


def save_checkpoint(
    epoch: int,
    state,  # TrainState
    loss_dict: dict | None,
    best_metric: float | None = None,
    outdir: str | Path = "checkpoints",
    tag: str = "last",
) -> Path:
    """Write ``{outdir}/{tag}.ckpt`` atomically; returns the path."""
    variables = variables_from_torch(state.model)
    rng = {"python": random.getstate(), "numpy": np.random.get_state(),
           "torch": torch.get_rng_state(), "cuda": None}
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        rng["cuda"] = torch.cuda.get_rng_state_all()
    ckpt = {
        "format": 2,  # epoch = 0-based last-completed index
        "epoch": int(epoch),
        "step": int(state.step),
        "params": variables["params"],
        "batch_stats": variables["batch_stats"],
        "optimizer": _cpu(state.optimizer.state_dict()),
        "scheduler": None if state.scheduler is None else _cpu(state.scheduler.state_dict()),
        "best_metric": best_metric,
        "rng_state": rng,
        "loss_dict": loss_dict,
    }
    path = Path(outdir) / f"{tag}.ckpt"
    _atomic_write(pickle.dumps(ckpt, protocol=pickle.HIGHEST_PROTOCOL), path)
    return path


def load_checkpoint(path: str | Path, state, restore_rng: bool = True):
    """Restore a checkpoint into ``state`` (a :class:`TrainState` whose model,
    optimizer and scheduler have the checkpoint's structure), in place.

    Returns ``(state, start_epoch, best_metric, loss_dict)``.
    """
    with open(path, "rb") as f:
        ckpt = pickle.load(f)  # a file this package wrote
    if ckpt.get("format") != 2:
        raise ValueError(f"{path}: unsupported checkpoint format {ckpt.get('format')!r}")
    model = state.model
    dev = next(model.parameters()).device
    sd = state_dict_from_jax({"params": ckpt["params"], "batch_stats": ckpt["batch_stats"]},
                             model.fold_bn)
    model.load_state_dict({k: v.to(dev) for k, v in sd.items()})
    state.optimizer.load_state_dict(ckpt["optimizer"])
    if state.scheduler is not None and ckpt["scheduler"] is not None:
        state.scheduler.load_state_dict(ckpt["scheduler"])
    state.step = int(ckpt["step"])

    rng = ckpt.get("rng_state") or {}
    if restore_rng and rng:
        random.setstate(rng["python"])
        np.random.set_state(rng["numpy"])
        torch.set_rng_state(rng["torch"])
        if rng.get("cuda") is not None and torch.cuda.is_available():
            torch.cuda.set_rng_state_all(rng["cuda"])

    start_epoch = int(ckpt["epoch"]) + 1
    return state, start_epoch, ckpt.get("best_metric"), ckpt.get("loss_dict")


def save_params(params: dict, batch_stats: dict, path: str | Path) -> Path:
    """Weights-only export (``{'params', 'batch_stats'}`` numpy trees in the
    JAX layout, e.g. from :func:`ssdx_torch.weights.variables_from_torch`)."""
    path = Path(path)
    to_np = lambda t: {k: to_np(v) for k, v in t.items()} if isinstance(t, dict) \
        else np.asarray(t, np.float32)
    payload = pickle.dumps({"params": to_np(params), "batch_stats": to_np(batch_stats)},
                           protocol=pickle.HIGHEST_PROTOCOL)
    _atomic_write(payload, path)
    return path
