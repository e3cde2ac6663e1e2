"""Where the training command's seconds go, on one GPU.

    python -m ssdx_torch.tools.profile_train_command

Writes a SynthDrive directory of 44 scenes (``data/synth.py``, seed 17)
and a config of bs=16, 4 loader threads, full-width bf16 with the
train-mode stem kernel, as ``chip_smoke.py`` phase 17 does, then times:
  start    new processes: ``python -c pass``, ``import torch``, and
           ``import ssdx_torch.train.run`` with a CUDA context;
  command  ``python -m ssdx_torch.train.run --config CFG --epochs 1``, a new
           process, whole;
  stages   ``train.run.main`` with the same arguments in this process, first
           (cold: nothing of the training stack has run in it yet), then
           twice resumed for one more epoch (warm); for each run the seconds
           of each stage (the dataset scan, split, loaders, model, optimizer,
           initial weights, the first train step and the later ones, the
           loader's wait, evaluation, checkpoints, the weights export), each
           stage waited for on the device.
Prints one line a measurement.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import functools
import shutil
import subprocess
import sys
import tempfile
import time

import torch

from ..config import Config
from ..data import synth
from ..train import loop
from ..train import run as run_mod

STAGES = {run_mod: ("DetectionDataset", "make_train_test_split", "DetectionLoader", "SSD300",
                    "build_optimizer", "init_variables", "create_train_state", "load_checkpoint",
                    "save_params"),
          loop: ("evaluate", "save_checkpoint")}
SCENES = 44  # as chip_smoke.py phase 17
START = ("pass", "import torch",
         "import torch, ssdx_torch.train.run; torch.zeros(1, device='cuda')")


def _timed(fn, name, secs, calls):
    @functools.wraps(fn)
    def inner(*a, **k):
        t = time.perf_counter()
        out = fn(*a, **k)
        torch.cuda.synchronize()
        secs[name] += time.perf_counter() - t
        calls[name] += 1
        return out
    return inner


def stages(argv) -> tuple[float, dict, dict]:
    """Wall seconds of ``run_mod.main(argv)`` and the seconds and calls of
    each stage, with every stage function wrapped for the call."""
    secs, calls = collections.defaultdict(float), collections.Counter()
    saved = {(m, n): getattr(m, n) for m, names in STAGES.items() for n in names}
    make, fit = run_mod.make_train_step, run_mod.fit

    def make_train_step(*a, **k):
        step = make(*a, **k)
        first, later = (_timed(step, f"train step ({w})", secs, calls) for w in ("first", "later"))
        return lambda *b, **kw: (later if calls["train step (first)"] else first)(*b, **kw)

    def fit_and_read(*a, **k):  # the loader's wait, which fit measures
        state, results = fit(*a, **k)
        steps = calls["train step (first)"] + calls["train step (later)"]
        secs["loader wait"] += results["training timing"][-1]["data wait"] * steps
        calls["loader wait"] += steps
        return state, results

    try:
        for (m, n), fn in saved.items():
            setattr(m, n, _timed(fn, n, secs, calls))
        run_mod.make_train_step, run_mod.fit = make_train_step, fit_and_read
        t = time.perf_counter()
        run_mod.main(argv)
        return time.perf_counter() - t, secs, calls
    finally:
        for (m, n), fn in saved.items():
            setattr(m, n, fn)
        run_mod.make_train_step, run_mod.fit = make, fit


def main(argv=None) -> None:
    argparse.ArgumentParser(description=__doc__,
                            formatter_class=argparse.RawDescriptionHelpFormatter).parse_args(argv)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])
    for code in START:
        t = time.perf_counter()
        subprocess.run([sys.executable, "-c", code], check=True)
        print(f"start: python -c {code!r}: {time.perf_counter() - t:.2f} s")
    with tempfile.TemporaryDirectory() as d:
        synth.generate_dataset(f"{d}/train", SCENES, seed=17)
        cfg = Config()
        cfg = dataclasses.replace(
            cfg, data=dataclasses.replace(cfg.data, train_dir=f"{d}/train", batch_size=16,
                                          num_workers=4),
            train=dataclasses.replace(cfg.train, save_dir=f"{d}/ckpt", warmup_epochs=0))
        cfg.to_json(f"{d}/cfg.json")
        command = [sys.executable, "-m", "ssdx_torch.train.run", "--config", f"{d}/cfg.json"]
        t = time.perf_counter()
        subprocess.run([*command, "--epochs", "1"], check=True, capture_output=True)
        print(f"command: {' '.join(command[1:])} --epochs 1 in a new process: "
              f"{time.perf_counter() - t:.2f} s")
        shutil.rmtree(f"{d}/ckpt")
        for epochs, label in ((1, "cold"), (2, "resumed, warm"), (3, "resumed, warm")):
            wall, secs, calls = stages(["--config", f"{d}/cfg.json", "--epochs", str(epochs)])
            print(f"stages: train.run.main --epochs {epochs} in this process ({label}): "
                  f"{wall:.2f} s, of which")
            for name, s in sorted(secs.items(), key=lambda kv: -kv[1]):
                print(f"  {name:24s} {s:7.3f} s  x{calls[name]}")


if __name__ == "__main__":
    main()
