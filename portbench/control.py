"""Readings that set the limits of ``correct``: sound runs of the program,
the control and faults, seed by seed, in one process.

    python -m portbench.control --workload CELL --modes MODE [MODE ...]
                                --seeds S [S ...] [--seconds 1] [--leaves]

Modes:

* ``sound``: the cell as the benchmark runs it, with a short window; the
  numbers it compares give the lower readings.
* ``control``: the nearest lower precision in the program's place.  The
  bf16 cells switch on the program's own int8 path (``quantize_int8`` on
  64 scenes of the seed); the int8 cell puts the reference's network at 4
  bits in place of the program; the training cell runs the reference's
  steps with every stated precision one step down (``ssd300.Fp8``).
  Each is compared with the cell's reference as a run compares the program.

Training only:

* ``fp8_convs``: the reference with float8 convolutions alone;
* ``half_batch``: the reference's steps on half of each batch, the loss
  taken over that half (the fault of a step that leaves rows out);
* ``zero_dw1``: the reference with conv1_1's weight gradient zeroed (a
  fault of kernel B3's backward);
* ``ref_bf16``: the reference with the configuration's bfloat16 roundings
  emulated (``ssd300.Bf16``): where the program's gaps come from;
* ``plain_stem``, ``program_f32``: the program with its plain stem in
  place of kernel B3, in bfloat16 and in float32 (second witnesses).

One JSON line per seed and mode on standard output; ``--leaves`` adds the
leaf-by-leaf norms of both sides (training).  Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

from . import core, scenes
from .reference import compare
from .reference import ssd300 as ref

INT8_PROGRAM = {"program": {"int8": True, "calibration_scenes": 64, "calibration_batch": 16}}
TRAIN_PROGRAM = {"sound": None, "plain_stem": {"train": {"fused_stem": False}},
                 "program_f32": {"train": {"fused_stem": False, "dtype": "float32"}}}


def _half(b):
    return {k: v[: len(v) // 2] for k, v in b.items()}


def _zero_dw1(names, grads):
    return tuple(torch.zeros_like(g) if n == "conv0.w" else g for n, g in zip(names, grads))


TRAIN_REFERENCE = {"control": {"q": ref.fake_quant_fp8}, "fp8_convs": {"q": ref.Fp8Convs()},
                   "ref_bf16": {"q": ref.Bf16()}, "half_batch": {"keep": _half},
                   "zero_dw1": {"fault": _zero_dw1}}
MODES = ("sound", "control", *(m for m in TRAIN_PROGRAM if m != "sound"),
         *(m for m in TRAIN_REFERENCE if m != "control"))


def _train_inputs(cell, seed, device):
    tr, cfg = cell.traffic, cell.config
    sc = scenes.render_many(seed, 2, tr["batch"] * tr["distinct_batches"], tr["scene_size"])
    host = scenes.train_batches(sc, tr["batch"])
    params = ref.init_params(seed, cfg["num_classes"], device)
    return params, [host[i % len(host)] for i in range(tr["checked_steps"])]


def reading(cell, mode: str, seed: int, seconds: float, device, root: Path):
    """(the numbers compared, the two sides' leaf norms or None)."""
    from .drivers import serve_batches, train_steps

    kind = cell.traffic["driver"]
    if kind == "train_steps" and mode in TRAIN_PROGRAM:
        out = train_steps.run(cell, seed, seconds, False, device, time.monotonic(), root,
                              TRAIN_PROGRAM[mode])
        return out.numbers, out.facts["norms"]
    if kind == "train_steps" and mode in TRAIN_REFERENCE:
        train = cell.config["train"]
        params, batches = _train_inputs(cell, seed, device)
        start = cell.traffic["schedule_step"]
        want = train_steps.reference_steps(train, params, batches, device, start)
        got = train_steps.reference_steps(train, params, batches, device, start,
                                          **TRAIN_REFERENCE[mode])
        return compare.train_numbers(got, want), {"prog": got, "ref": want}
    if mode == "sound" or (mode == "control" and not cell.config["serve"].get("int8")):
        ov = INT8_PROGRAM if mode == "control" else None
        return core.driver(kind).run(cell, seed, seconds, False, device, time.monotonic(),
                                     root, ov).numbers, None
    if kind == "serve_batches" and mode == "control":  # int8 cell: 4 bits for 8
        tr, serve = cell.traffic, cell.config["serve"]
        n = tr["batch"] * tr["distinct_batches"]
        timed = scenes.serve_images(scenes.render_many(seed, 0, n, tr["scene_size"]))
        calib = scenes.serve_images(scenes.render_many(seed, 1, serve["calibration_scenes"],
                                                       tr["scene_size"]))
        kw = {k: tr[k] for k in ("score_thresh", "nms_thresh", "max_per_img")}
        args = (cell.config, serve, root, device, timed, calib, kw)
        want = serve_batches.reference_detections(*args)
        got = serve_batches.reference_detections(*args, bits=4)
        return compare.detection_numbers(got, want, kw["score_thresh"]), None
    raise SystemExit(f"mode {mode!r} does not apply to {cell.name}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m portbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--modes", required=True, nargs="+", choices=MODES)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--leaves", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("portbench.control: needs a CUDA card", file=sys.stderr)
        return 2
    root = Path(__file__).resolve().parents[1]
    cell = core.load_cell(args.workload, root)
    for seed in args.seeds:
        for mode in args.modes:
            numbers, norms = reading(cell, mode, seed, args.seconds, torch.device("cuda"), root)
            limited = {k: numbers[k] for k in cell.limits}
            row = {"workload": cell.name, "mode": mode, "seed": seed, "numbers": limited,
                   "extra": {k: v for k, v in numbers.items() if k not in limited}}
            if args.leaves and norms is not None:
                row["norms"] = norms
            print(json.dumps(row, default=float), flush=True)
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
