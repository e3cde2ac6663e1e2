"""What every cell shares: finding a cell's files by name, the per-layer
metric readers, the guard against JAX, the device's description.

A cell of ``BENCHMARK.json`` names a configuration and a traffic mix.  The
harness reads ``portbench/configs/<config>.json``, ``portbench/traffic/
<traffic>.json`` (whose ``driver`` names the general generator in
``portbench/drivers/`` that plays it) and ``portbench/limits/<cell>.json``
(the limits of the numbers that decide ``correct``), and loads each
per-layer metric that the cell reports from ``portbench/metrics/<name>.py``
(a ``read(ctx)`` returning a number, or None where it finds nothing to
read).  A new cell, mix or metric is new files and entries; nothing here
changes.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import sys
from dataclasses import dataclass, field
from pathlib import Path

PKG = Path(__file__).resolve().parent
ROOT = PKG.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "ssdx")


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list  # metric entries of BENCHMARK.json this cell reports
    per_layer: list


@dataclass
class Context:
    """What a per-layer reader may read: the cell, the traced window's
    ``Trace`` (``portbench/trace.py``) with the iterations it holds, the
    measured window's counts, the program's counters, and facts the run
    worked out (such as the NMS's candidates per traced batch)."""

    cell: Cell
    trace: object = None
    traced_iters: int = 0
    batch: int = 0
    window: dict = field(default_factory=dict)
    counters: dict = field(default_factory=dict)
    facts: dict = field(default_factory=dict)


def _read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, root: Path = ROOT) -> Cell:
    bench = _read_json(root / "BENCHMARK.json")
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise SystemExit(f"portbench: no workload {name!r} in BENCHMARK.json "
                         f"(have {', '.join(sorted(work))})")
    w = work[name]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    pkg = root / "portbench"
    config = _read_json(root / cfg_entry["file"])
    traffic = _read_json(pkg / "traffic" / f"{w['traffic']}.json")
    limits = _read_json(pkg / "limits" / f"{name}.json")
    e2e = [m for m in bench["end_to_end"] if "workloads" not in m or name in m["workloads"]]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m else m["moves"] in reported)]
    return Cell(name, int(w["chips"]), config, traffic, limits, e2e, per_layer)


def reader(metric: str, root: Path = ROOT):
    """The ``read`` function of ``portbench/metrics/<metric>.py``."""
    path = root / "portbench" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"portbench.metrics.{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def driver(name: str):
    return importlib.import_module(f"portbench.drivers.{name}")


def forbidden_modules() -> list[str]:
    """Modules loaded in this process whose top-level name is JAX's or the
    JAX package's, compared whole (``ssdx_torch`` is not ``ssdx``)."""
    return sorted({m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN})


def device_info(chips: int, peak: int, trace=None) -> dict:
    import torch

    d = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
         "memory_peak_bytes": int(peak)}
    if trace is not None:
        d["busy_s"] = trace.busy_s
        d["window_s"] = trace.window_s
    return d


def per_layer_metrics(ctx: Context, root: Path = ROOT) -> dict:
    out = {}
    for m in ctx.cell.per_layer:
        v = reader(m["name"], root)(ctx)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out
