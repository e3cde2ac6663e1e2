"""The benchmark of ``ssdx_torch``: one run of one cell.

    python -m portbench.run --workload CELL --seed N --seconds S --trace 0|1

Finds the cell in ``BENCHMARK.json`` and its configuration, traffic and
limits in ``portbench/`` (``portbench/core.py``), checks that the card is
there, lets the traffic's driver build the program, make the inputs from
the seed, warm up and measure for ``--seconds``, then compares what the
timed path produced with the plain reference.  With ``--trace 0`` the
metrics are the cell's end-to-end ones; with ``--trace 1`` a profiled
sub-window follows the window and the metrics are the cell's per-layer
ones.  The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, ``breakdown`` (traced
runs) and ``checks`` (each number compared, beside its limit); the last
lines of standard error repeat the checks.

Needs a CUDA card: without one, or with fewer cards than the cell asks
for, it exits with code 2 and prints no result.  Caches of the program's
builds stay inside the checkout (``ssdx_torch/_build``; the Triton and
extension caches under ``.portbench_cache``).
"""
from __future__ import annotations

import time

T0 = time.monotonic()  # before torch is imported: set-up counts from here

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402


def _args(argv):
    ap = argparse.ArgumentParser(prog="python -m portbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def power_limit() -> str:
    try:
        p = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True, text=True,
                           timeout=30)
        return p.stdout.strip().splitlines()[0] if p.returncode == 0 and p.stdout else "unknown"
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"


def execute(cell, seed: int, seconds: float, trace: bool, device, root: Path,
            overrides: dict | None = None, t0: float | None = None) -> tuple[dict, list[str]]:
    """Run ``cell`` and return (the result line's object, stderr check lines)."""
    from . import core
    from .reference import compare

    t0 = T0 if t0 is None else t0
    drv = core.driver(cell.traffic["driver"])
    out = drv.run(cell, seed, seconds, trace, device, t0, root, overrides)
    ok, checks = compare.judge(out.numbers, cell.limits)
    if trace:
        ctx = core.Context(cell=cell, trace=out.trace, traced_iters=out.traced_iters,
                           batch=out.batch, window=out.window, counters=out.counters,
                           facts=dict(out.facts, int8=out.int8))
        metrics = core.per_layer_metrics(ctx, root)
    else:
        # ``<quantity>.<cells>`` (as ``serve_images_per_s.int8``) reports the
        # driver's ``<quantity>`` in the cells that have a bound of their own
        e2e = dict(out.end_to_end, setup_s=out.start - t0)
        metrics = {m["name"]: {"value": float(e2e[m["name"].split(".")[0]]), "unit": m["unit"]}
                   for m in cell.end_to_end}
    device_obj = (core.device_info(cell.chips, out.memory_peak, out.trace)
                  if device.type == "cuda" else {"platform": "cpu", "kind": "cpu", "count": 0,
                                                 "memory_peak_bytes": 0})
    line = {"correct": ok and out.failed == 0, "attempted": out.attempted,
            "failed": out.failed, "metrics": metrics, "device": device_obj}
    if trace and out.trace is not None:
        line["breakdown"] = out.trace.breakdown()
    line["checks"] = checks
    extra = {k: v for k, v in out.numbers.items() if k not in checks}
    lines = ["compared " + json.dumps(extra)]
    lines += [f"check {k} {c['value']!r} limit {c['limit']!r}" for k, c in checks.items()]
    return line, lines


def main(argv=None) -> int:
    args = _args(argv)
    root = Path(__file__).resolve().parents[1]
    cache = root / ".portbench_cache"
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_extensions"))
    from . import core

    cell = core.load_cell(args.workload, root)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: cell {cell.name} needs {cell.chips} CUDA card(s), found {n}",
              file=sys.stderr)
        return 2
    print(f"card: {power_limit()}", file=sys.stderr)
    line, lines = execute(cell, args.seed, args.seconds, bool(args.trace),
                          torch.device("cuda"), root)
    bad = core.forbidden_modules()
    if bad:
        print(f"portbench: the run loaded JAX or the JAX package: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    for s in lines:
        print(s, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
