"""Head-to-head training of the JAX package and the port on the CPU.

Both packages train on one rendered SynthDrive directory through their own
commands, and one evaluator (the JAX package's ``evaluate_weights``) scores
every result on one test set, so that only the training differs:

    python tests/torch_h2h.py render --root R            # scenes, once
    python tests/torch_h2h.py c7 --root R --pkg jax --seed 724
    python tests/torch_h2h.py c7 --root R --pkg torch --seed 724
    python tests/torch_h2h.py c8 --root R --pkg jax --seed 0
    python tests/torch_h2h.py c8 --root R --pkg torch --seed 0
    python tests/torch_h2h.py score --root R             # -> R/scores.json
    python tests/torch_h2h.py bundle --root R --n 100    # the JAX bundle, both evaluators
    python tests/torch_h2h.py bundle --root R --n 24 --render-seed 21 --batch-size 8

``c7`` writes one JSON config (width 0.25, bfloat16, the SynthDrive tool's
recipe: base LR 2e-3, weight decay 5e-4, warm-up min(3, epochs // 3), bs=16,
the image cache) and runs ``python -m ssdx.train.run --config`` or ``python
-m ssdx_torch.train.run --config --cpu`` on it; ``TrainConfig.seed`` draws
the initial weights, the loader keeps its seed; ``--card`` runs the port's
command on the GPU instead (bring ``last.weights`` back to score it here).
``c8`` runs each package's
demo-weights recipe (``scripts/make_demo_weights.py``,
``ssdx_torch/tools/make_demo_weights.py``: 64 scenes at seed 1000, 60 epochs
of 4 steps) at width 0.25 in bfloat16, with the initial weights drawn from
``--seed``.  ``score`` evaluates every ``last.weights`` of ``c7`` (and of
``c7_e{epochs}``, runs of another ``--epochs``) on the test set and every
``best.weights`` of ``c8`` on its 64 scenes (the scenes its recipe
evaluates on), and summarises each package by the mean and the spread over
seeds of mAP@0.5 and of the last three epochs' train loss.
``bundle`` scores ``ssdx/serve/demo_weights.npz`` on the first ``--n`` test
scenes (or on ``--n`` scenes rendered at ``--render-seed``, as
``chip_smoke.py`` phase 21 renders them) with both packages'
``evaluate_weights`` in bfloat16 (``--float32``: in float32).

Two runs of ``tools/train_synthdrive.py`` on the card (arguments after
``--``), for C7's ablations at the JAX run's sizes:

    python tests/torch_h2h.py ablate --set fused_stem=false -- --workdir W --seed 724 ...
    python tests/torch_h2h.py ablate --set bfloat16=false --set fused_stem=false -- ...
    python tests/torch_h2h.py cut --kill-after 15 --resume-epochs 20 -- --epochs 60 ...

``ablate`` runs the tool with ``TrainConfig`` fields changed (JSON values);
``cut`` kills a run with ``tools/resume_synthdrive.py``'s watcher once
``last.ckpt`` holds ``--kill-after`` epochs and finishes it in a fresh
process with ``--epochs`` set to ``--resume-epochs``, which cuts its
warm-up-cosine schedule at the first resumed step.

A helper, not a test: pytest does not collect it (``tests/test_torch_h2h.py``
checks its patches and subcommands).  It runs for minutes to
hours; ``OMP_NUM_THREADS`` and ``taskset`` share the cores between runs.
"""
from __future__ import annotations

import argparse
import contextlib
import csv
import dataclasses
import functools
import importlib.util
import json
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

import numpy as np

REPO = Path(__file__).resolve().parents[1]
WM = 0.25
EPOCH_RE = re.compile(r"Epoch: (\d+)\s+\|\s+mAP: ([\d.]+)\s+\|\s+Train loc loss: ([\d.]+)"
                      r"\s+\|\s+Train class loss: ([\d.]+)")


def _render(out: Path, n: int, seed: int, **kw) -> None:
    """``generate_dataset(out, n, seed, size=512, **kw)`` unless it is there."""
    from ssdx_torch.data.synth import generate_dataset  # the same renderer as ssdx's

    if not (out / "annotations.csv").exists():
        t0 = time.perf_counter()
        generate_dataset(out, n, seed=seed, size=512, **kw)
        print(f"rendered {out}: {n} scenes at seed {seed} ({time.perf_counter() - t0:.1f} s)")


def render(args) -> None:
    root = Path(args.root)
    _render(root / "train", args.n_train, 1)
    _render(root / "test", args.n_test, 2)
    _render(root / "c8_scenes", 64, 1000, empty_frac=0.0)


def c7_config(root: Path, pkg: str, seed: int, epochs: int) -> Path:
    # runs of another length go to a directory of their own, outside `score`
    save = root / ("c7" if epochs == 10 else f"c7_e{epochs}") / f"{pkg}_s{seed}"
    save.mkdir(parents=True, exist_ok=True)
    cfg = {
        "data": {"train_dir": str(root / "train"), "test_dir": str(root / "test"),
                 "batch_size": 16, "num_workers": 4, "cache_images": True},
        "train": {"epochs": epochs, "warmup_epochs": min(3, max(1, epochs // 3)),
                  "base_lr": 2e-3, "weight_decay": 5e-4, "save_dir": str(save),
                  "bfloat16": True, "width_mult": WM, "seed": seed},
    }
    path = save / "h2h.json"
    path.write_text(json.dumps(cfg, indent=2))
    return path


def c7(args) -> None:
    root = Path(args.root)
    cfg = c7_config(root, args.pkg, args.seed, args.epochs)
    if args.pkg == "jax":
        cmd = [sys.executable, "-m", "ssdx.train.run", "--config", str(cfg), "--no-resume"]
    else:
        cmd = [sys.executable, "-m", "ssdx_torch.train.run", "--config", str(cfg),
               "--no-resume", *([] if args.card else ["--cpu"])]
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO))
    t0 = time.perf_counter()
    with open(cfg.parent / "log.txt", "w") as log:
        rc = subprocess.run(cmd, cwd=REPO, env=env, stdout=log, stderr=subprocess.STDOUT).returncode
    print(f"{args.pkg} seed {args.seed}: rc {rc}, {time.perf_counter() - t0:.0f} s")
    sys.exit(rc)


def _load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def c8_patches(pkg: str, seed: int) -> contextlib.ExitStack:
    """Patches under which each package's demo-weights recipe trains at width
    0.25 in bfloat16 from the initial weights that ``seed`` draws; leaving the
    returned stack undoes them."""
    stack = contextlib.ExitStack()
    if pkg == "jax":
        import jax

        import ssdx.model
        import ssdx.train.step as jstep

        create = jstep.create_train_state
        stack.enter_context(mock.patch.object(
            ssdx.model, "SSD300", functools.partial(ssdx.model.SSD300, width_mult=WM)))
        stack.enter_context(mock.patch.object(
            jstep, "create_train_state",
            lambda model, tx, rng: create(model, tx, jax.random.key(seed))))
    else:
        import torch

        from ssdx_torch import model as tmodel
        from ssdx_torch.tools import make_demo_weights as tool

        # the tool's CPU route is float32; bfloat16 here, as the JAX recipe
        stack.enter_context(mock.patch.object(
            tool, "SSD300", lambda n, dtype, width_mult: tmodel.SSD300(
                n, dtype=torch.bfloat16, width_mult=width_mult)))
        draw = seed  # in place of the recipe's seed 0
        stack.enter_context(mock.patch.object(
            tool, "init_variables", lambda n, seed, width_mult: tmodel.init_variables(
                n, seed=draw, width_mult=width_mult)))
    return stack


def c8(args) -> None:
    out = Path(args.root) / "c8" / f"{args.pkg}_s{args.seed}"
    out.mkdir(parents=True, exist_ok=True)
    argv = ["--out", str(out / "best.weights"), "--bundle", ""]
    if args.pkg == "jax":
        os.environ["JAX_PLATFORMS"] = "cpu"
        os.environ.setdefault("TMPDIR", str(out))
    t0 = time.perf_counter()
    with open(out / "log.txt", "w") as log, contextlib.redirect_stdout(log), \
            c8_patches(args.pkg, args.seed):
        if args.pkg == "jax":
            script = _load_module(REPO / "scripts" / "make_demo_weights.py", "jax_demo")
            sys.argv = ["make_demo_weights.py", *argv]
            try:
                script.main()
                rc = 0
            except SystemExit as e:
                rc = int(e.code or 0)
        else:
            from ssdx_torch.tools import make_demo_weights as tool

            rc = tool.main(["--cpu", *argv], width_mult=WM, log=print)
    print(f"{args.pkg} seed {args.seed}: rc {rc}, {time.perf_counter() - t0:.0f} s")


def _parse_field(text: str) -> tuple[str, object]:
    """``NAME=VALUE`` with VALUE in JSON (``false``, ``2e-3``, ``null``)."""
    name, _, value = text.partition("=")
    return name, json.loads(value)


def ablate(args) -> None:
    from ssdx_torch.tools import train_synthdrive
    from ssdx_torch.train import run as trun

    fields = dict(_parse_field(f) for f in args.set)
    run = trun.run

    def changed(cfg, *a, **kw):
        print(f"TrainConfig changed: {fields}", flush=True)
        train = dataclasses.replace(cfg.train, **fields)
        return run(dataclasses.replace(cfg, train=train), *a, **kw)

    with mock.patch.object(trun, "run", changed):
        train_synthdrive.main([a for a in args.tool_args if a != "--"])


def cut(args) -> None:
    from ssdx_torch.tools import resume_synthdrive as rs

    tool_args = [a for a in args.tool_args if a != "--"]
    env = {**os.environ, "PYTHONUNBUFFERED": "1"}
    rs._kill_at(tool_args, rs._workdir(tool_args) / "ckpt" / "last.ckpt", args.kill_after, env)
    resumed = [*tool_args, "--epochs", str(args.resume_epochs)]  # the last --epochs wins
    sys.exit(subprocess.run(rs._command(resumed), env=env).returncode)


def _epochs(log: Path) -> list[dict]:
    rows = []
    for line in log.read_text().splitlines():
        m = EPOCH_RE.search(line)
        if m:
            rows.append({"epoch": int(m[1]), "val_map": float(m[2]),
                         "train_loss": float(m[3]) + float(m[4])})
    return rows


def _jax_eval(weights: Path, test_dir: Path, width_mult: float) -> dict:
    from ssdx.eval.run import evaluate_weights

    out = evaluate_weights(weights, test_dir, batch_size=16, bfloat16=True, num_workers=4,
                           width_mult=width_mult)
    return {"map_50": float(out["mAP"]["map_50"]), "test_loss": float(out["testing loss"])}


def _summary(vals: list[float]) -> dict:
    a = np.asarray(vals, np.float64)
    return {"n": len(a), "mean": float(a.mean()), "std": float(a.std(ddof=1)) if len(a) > 1
            else 0.0, "min": float(a.min()), "max": float(a.max())}


def score(args) -> None:
    os.environ["JAX_PLATFORMS"] = "cpu"
    root = Path(args.root)
    path = root / "scores.json"
    scores = json.loads(path.read_text()) if path.exists() else {}
    c7_kinds = ["c7"] + sorted(d.name for d in root.glob("c7_e*"))  # other lengths
    kinds = [(k, "last.weights", root / "test") for k in c7_kinds]
    for kind, name, test in kinds + [("c8", "best.weights", root / "c8_scenes")]:
        for run in sorted((root / kind).glob("*_s*")):
            w = run / name
            key = f"{kind}/{run.name}"
            if not w.exists() or key in scores:
                continue
            rec = _jax_eval(w, test, WM)
            rec["epochs"] = _epochs(run / "log.txt") if kind != "c8" else []
            if kind == "c8":
                rec["own"] = [ln for ln in (run / "log.txt").read_text().splitlines()
                              if ln.startswith(("epoch", "RESULT"))]
            scores[key] = rec
            print(key, {k: v for k, v in rec.items() if k in ("map_50", "test_loss")})
            path.write_text(json.dumps(scores, indent=1))
    summary = {}
    for kind in c7_kinds + ["c8"]:
        for pkg in ("jax", "torch"):
            recs = [v for k, v in scores.items() if k.startswith(f"{kind}/{pkg}_s")]
            if not recs:
                continue
            s = {"map_50": _summary([r["map_50"] for r in recs]),
                 "test_loss": _summary([r["test_loss"] for r in recs])}
            if kind != "c8":
                s["last3_train_loss"] = _summary(
                    [np.mean([e["train_loss"] for e in r["epochs"][-3:]]) for r in recs])
            summary[f"{kind}/{pkg}"] = s
    (root / "summary.json").write_text(json.dumps(summary, indent=1))
    print(json.dumps(summary, indent=1))


def _subset(src: Path, dst: Path, n: int) -> Path:
    """The first ``n`` scenes of ``src`` (in render order) as a directory."""
    with open(src / "annotations.csv") as f:
        rows = list(csv.DictReader(f))
    names = sorted({r["filename"] for r in rows})[:n]
    dst.mkdir(parents=True, exist_ok=True)
    for name in names:
        if not (dst / name).exists():
            shutil.copy(src / name, dst / name)
    keep = set(names)
    with open(dst / "annotations.csv", "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0]))
        w.writeheader()
        w.writerows(r for r in rows if r["filename"] in keep)
    return dst


def bundle(args) -> None:
    os.environ["JAX_PLATFORMS"] = "cpu"
    root = Path(args.root)
    if args.render_seed is None:
        tag = f"first{args.n}"
        test = _subset(root / "test", root / f"test_{tag}", args.n)
    else:
        tag = f"seed{args.render_seed}_n{args.n}"
        test = root / f"test_{tag}"
        _render(test, args.n, args.render_seed, empty_frac=0.05)
    weights = REPO / "ssdx" / "serve" / "demo_weights.npz"
    res = {}
    from ssdx.eval.run import evaluate_weights as jax_eval
    from ssdx_torch.eval.run import evaluate_weights as torch_eval

    for pkg, fn, kw in (("jax", jax_eval, {}), ("torch", torch_eval, {"device": "cpu"})):
        t0 = time.perf_counter()
        out = fn(weights, test, batch_size=args.batch_size, bfloat16=not args.float32,
                 num_workers=4, **kw)
        res[pkg] = {"map_50": float(out["mAP"]["map_50"]),
                    "test_loss": float(out["testing loss"]),
                    "per_class_ap50": [float(a) for a in out["mAP"]["map_per_class"]],
                    "seconds": time.perf_counter() - t0}
        print(pkg, res[pkg])
    tag += "_f32" if args.float32 else ""
    (root / f"bundle_{tag}.json").write_text(json.dumps(res, indent=1))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("render")
    p.add_argument("--n-train", type=int, default=500)
    p.add_argument("--n-test", type=int, default=1000)
    for name in ("c7", "c8"):
        p = sub.add_parser(name)
        p.add_argument("--pkg", choices=("jax", "torch"), required=True)
        p.add_argument("--seed", type=int, required=True)
        if name == "c7":
            p.add_argument("--epochs", type=int, default=10)
            p.add_argument("--card", action="store_true",
                           help="the port on the GPU (its own command's default)")
    sub.add_parser("score")
    p = sub.add_parser("bundle")
    p.add_argument("--n", type=int, default=100)
    p.add_argument("--render-seed", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--float32", action="store_true", help="evaluate in float32, not bfloat16")
    for p in sub.choices.values():
        p.add_argument("--root", required=True)
    p = sub.add_parser("ablate")
    p.add_argument("--set", action="append", required=True, metavar="FIELD=JSON")
    p = sub.add_parser("cut")
    p.add_argument("--kill-after", type=int, required=True)
    p.add_argument("--resume-epochs", type=int, required=True)
    for name in ("ablate", "cut"):
        sub.choices[name].add_argument("tool_args", nargs=argparse.REMAINDER)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(REPO))
    {"render": render, "c7": c7, "c8": c8, "score": score, "bundle": bundle,
     "ablate": ablate, "cut": cut}[args.cmd](args)


if __name__ == "__main__":
    main()
