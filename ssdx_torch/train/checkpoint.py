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

With more than one rank (``mesh.size > 1``) ``save_checkpoint`` writes the
directory format of ``ssdx_torch/train/sharded_checkpoint.py`` instead, and
``load_checkpoint`` reads whichever it finds: a file here, a directory there.

``save_params`` writes the weights-only pickle, and ``save_params_npz`` the
compressed float16 ``.npz`` bundle that ``ssdx/serve/demo_weights.npz`` is;
``load_params`` (:func:`ssdx_torch.weights.load_params`) reads either, as the
JAX package's ``load_params`` does.
"""
from __future__ import annotations

import io
import pickle
import random
import shutil
from pathlib import Path

import numpy as np
import torch

from ..weights import load_params, state_dict_from_jax, variables_from_torch

__all__ = ["save_checkpoint", "load_checkpoint", "save_params", "save_params_npz",
           "load_params"]


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
    if path.is_dir():
        # The tag holds a directory-format checkpoint (a multi-rank run
        # resumed by one process).  rename() cannot replace a non-empty
        # directory, so drop it first: this one transition is not atomic.
        shutil.rmtree(path)
    tmp.replace(path)  # atomic on the same filesystem


def state_arrays(state) -> dict:
    """The arrays of a :class:`TrainState` in checkpoint format 2."""
    variables = variables_from_torch(state.model)
    return {
        "format": 2,  # epoch = 0-based last-completed index
        "step": int(state.step),
        "params": variables["params"],
        "batch_stats": variables["batch_stats"],
        "optimizer": _cpu(state.optimizer.state_dict()),
        "scheduler": None if state.scheduler is None else _cpu(state.scheduler.state_dict()),
    }


def restore_arrays(ckpt: dict, state, source) -> None:
    """Load :func:`state_arrays`' dict into ``state`` in place."""
    if ckpt.get("format") != 2:
        raise ValueError(f"{source}: unsupported checkpoint format {ckpt.get('format')!r}")
    model = state.model
    dev = next(model.parameters()).device
    sd = state_dict_from_jax({"params": ckpt["params"], "batch_stats": ckpt["batch_stats"]},
                             model.fold_bn)
    model.load_state_dict({k: v.to(dev) for k, v in sd.items()})
    state.optimizer.load_state_dict(ckpt["optimizer"])
    if state.scheduler is not None and ckpt["scheduler"] is not None:
        state.scheduler.load_state_dict(ckpt["scheduler"])
    state.step = int(ckpt["step"])


def torch_rng_state() -> dict:
    rng = {"torch": torch.get_rng_state(), "cuda": None}
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        rng["cuda"] = torch.cuda.get_rng_state_all()
    return rng


def restore_rng_state(rng: dict) -> None:
    """Set whichever of the python, numpy, torch and CUDA states ``rng`` has."""
    if rng.get("python") is not None:
        random.setstate(rng["python"])
    if rng.get("numpy") is not None:
        np.random.set_state(rng["numpy"])
    if rng.get("torch") is not None:
        torch.set_rng_state(rng["torch"])
    if rng.get("cuda") is not None and torch.cuda.is_available():
        torch.cuda.set_rng_state_all(rng["cuda"])


def save_checkpoint(
    epoch: int,
    state,  # TrainState
    loss_dict: dict | None,
    best_metric: float | None = None,
    outdir: str | Path = "checkpoints",
    tag: str = "last",
    mesh=None,
) -> Path:
    """Write ``{outdir}/{tag}.ckpt`` atomically; returns the path.  With a
    ``mesh`` of more than one rank every rank must call it, and the result
    is a directory (``sharded_checkpoint.save_checkpoint_sharded``)."""
    if mesh is not None and mesh.size > 1:
        from .sharded_checkpoint import save_checkpoint_sharded

        return save_checkpoint_sharded(epoch, state, loss_dict, best_metric, outdir, tag, mesh)
    ckpt = {
        **state_arrays(state),
        "epoch": int(epoch),
        "best_metric": best_metric,
        "rng_state": {"python": random.getstate(), "numpy": np.random.get_state(),
                      **torch_rng_state()},
        "loss_dict": loss_dict,
    }
    path = Path(outdir) / f"{tag}.ckpt"
    _atomic_write(pickle.dumps(ckpt, protocol=pickle.HIGHEST_PROTOCOL), path)
    return path


def load_checkpoint(path: str | Path, state, restore_rng: bool = True, mesh=None):
    """Restore a checkpoint into ``state`` (a :class:`TrainState` whose model,
    optimizer and scheduler have the checkpoint's structure), in place.  A
    directory is read by ``sharded_checkpoint.load_checkpoint_sharded``,
    which restores the host RNG that rank ``mesh.rank`` saved.

    Returns ``(state, start_epoch, best_metric, loss_dict)``.
    """
    if Path(path).is_dir():
        from .sharded_checkpoint import load_checkpoint_sharded

        return load_checkpoint_sharded(path, state, restore_rng=restore_rng, mesh=mesh)
    with open(path, "rb") as f:
        ckpt = pickle.load(f)  # a file this package wrote
    restore_arrays(ckpt, state, path)
    if restore_rng:
        restore_rng_state(ckpt.get("rng_state") or {})

    start_epoch = int(ckpt["epoch"]) + 1
    return state, start_epoch, ckpt.get("best_metric"), ckpt.get("loss_dict")


def _to_numpy(tree):
    """A nested dict of arrays or tensors as float32 numpy arrays."""
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        tree = tree.detach().cpu()
    return np.asarray(tree, np.float32)


def save_params(params: dict, batch_stats: dict, path: str | Path) -> Path:
    """Weights-only export (``{'params', 'batch_stats'}`` numpy trees in the
    JAX layout, e.g. from :func:`ssdx_torch.weights.variables_from_torch`)."""
    path = Path(path)
    payload = pickle.dumps({"params": _to_numpy(params), "batch_stats": _to_numpy(batch_stats)},
                           protocol=pickle.HIGHEST_PROTOCOL)
    _atomic_write(payload, path)
    return path


def save_params_npz(params: dict, batch_stats: dict, path: str | Path) -> Path:
    """Compressed float16 weights bundle (.npz), the shippable demo-artifact
    format (~45 MB against 93 MB of pickle for the full SSD300).  Keys are
    slash-joined tree paths; ``load_params`` rebuilds the nested dict and
    casts back to float32."""
    path = Path(path)
    flat: dict[str, np.ndarray] = {}

    def walk(tree, prefix):
        if isinstance(tree, dict):
            for k, v in tree.items():
                walk(v, f"{prefix}/{k}")
        else:
            flat[prefix] = tree.astype(np.float16)

    walk(_to_numpy(params), "params")
    walk(_to_numpy(batch_stats), "batch_stats")
    buf = io.BytesIO()
    np.savez_compressed(buf, **flat)
    _atomic_write(buf.getvalue(), path)
    return path
