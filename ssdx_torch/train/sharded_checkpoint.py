"""Multi-rank checkpointing: the directory format.

The port's counterpart of ``ssdx/train/sharded_checkpoint.py``.  With several
ranks the single-file format of ``ssdx_torch/train/checkpoint.py`` is wrong
twice over: every rank would write the same file, and each rank's host RNG
(python, numpy) is its own.  This module keeps the JAX package's directory
layout and its crash-safety protocol:

    {outdir}/{tag}.ckpt/arrays.pkl       the arrays in checkpoint format 2
                                         (step, params, batch_stats, optimizer
                                         and scheduler state)
    {outdir}/{tag}.ckpt/host_meta_p{K}.pkl
                                         rank K's host state: python + numpy
                                         RNG; on rank 0 also epoch,
                                         best_metric, loss_dict and the torch
                                         (and CUDA) generator state

The training state is replicated in the port (every rank holds the same
parameters and optimizer state), so there is no shard for a rank to own:
rank 0 writes the arrays once.  The JAX package stores them with orbax, which
the port does not use; the file is a pickle this package reads back.  It is
not readable by ``ssdx``: ``save_params`` remains the interchange format.

Protocol (every rank calls ``save_checkpoint_sharded``):

    1. rank 0 removes a stale ``{tag}.ckpt.staging`` or ``{tag}.ckpt.old``;
       barrier;
    2. rank 0 writes the arrays into ``{tag}.ckpt.staging`` (temporary file +
       rename); barrier;
    3. every rank drops its ``host_meta_p{K}.pkl`` into the staging directory
       (temporary file + rename); barrier;
    4. rank 0 swaps directories: ``{tag}.ckpt`` -> ``{tag}.ckpt.old``, staging
       -> ``{tag}.ckpt``, delete ``.old``; barrier.  A crash between the two
       renames leaves ``.old`` and the finished staging directory on disk for
       recovery by hand.
"""
from __future__ import annotations

import pickle
import random
import shutil
from pathlib import Path
from typing import Any

import numpy as np

from ..mesh import barrier
from .checkpoint import restore_arrays, restore_rng_state, state_arrays, torch_rng_state

__all__ = ["save_checkpoint_sharded", "load_checkpoint_sharded"]


def _write(payload: Any, path: Path) -> None:
    tmp = path.with_suffix(path.suffix + ".tmp")
    tmp.write_bytes(pickle.dumps(payload, protocol=pickle.HIGHEST_PROTOCOL))
    tmp.replace(path)


def save_checkpoint_sharded(
    epoch: int,
    state,  # TrainState
    loss_dict: dict | None,
    best_metric: float | None = None,
    outdir: str | Path = "checkpoints",
    tag: str = "last",
    mesh=None,
) -> Path:
    """Write the directory ``{outdir}/{tag}.ckpt/`` per the module protocol;
    ``mesh=None`` is one rank."""
    final = Path(outdir).resolve() / f"{tag}.ckpt"
    staging = final.with_suffix(".ckpt.staging")
    old = final.with_suffix(".ckpt.old")
    rank = 0 if mesh is None else mesh.rank

    if rank == 0:
        final.parent.mkdir(parents=True, exist_ok=True)
        for stale in (staging, old):
            if stale.exists():
                shutil.rmtree(stale)
    barrier(mesh)

    if rank == 0:
        staging.mkdir()
        _write(state_arrays(state), staging / "arrays.pkl")
    barrier(mesh)

    meta: dict[str, Any] = {
        "rng_state": {"python": random.getstate(), "numpy": np.random.get_state()},
    }
    if rank == 0:
        meta["rng_state"].update(torch_rng_state())
        meta.update(epoch=int(epoch), best_metric=best_metric, loss_dict=loss_dict)
    _write(meta, staging / f"host_meta_p{rank}.pkl")
    barrier(mesh)

    if rank == 0:
        if final.is_dir():
            final.replace(old)
        elif final.exists():  # a single-file checkpoint under the same tag
            final.unlink()
        staging.replace(final)
        if old.exists():
            shutil.rmtree(old)
    barrier(mesh)
    return final


def load_checkpoint_sharded(path: str | Path, state, restore_rng: bool = True, mesh=None):
    """Restore a checkpoint directory into ``state`` in place.  Every rank
    reads the arrays; the host RNG restored is the one this rank saved (rank
    0's where this rank saved none, as when fewer ranks wrote than read).

    Returns ``(state, start_epoch, best_metric, loss_dict)``, the contract
    of ``checkpoint.load_checkpoint``.
    """
    path = Path(path).resolve()
    rank = 0 if mesh is None else mesh.rank
    restore_arrays(pickle.loads((path / "arrays.pkl").read_bytes()), state, path)

    meta0 = pickle.loads((path / "host_meta_p0.pkl").read_bytes())
    mine = path / f"host_meta_p{rank}.pkl"
    meta_local = pickle.loads(mine.read_bytes()) if mine.exists() else meta0
    if restore_rng:
        rng0 = meta0.get("rng_state") or {}
        restore_rng_state({**(meta_local.get("rng_state") or {}),
                           "torch": rng0.get("torch"), "cuda": rng0.get("cuda")})
    start_epoch = int(meta0["epoch"]) + 1
    return state, start_epoch, meta0.get("best_metric"), meta0.get("loss_dict")
