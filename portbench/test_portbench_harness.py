"""The harness on the CPU: finding cells by name, the yardstick's arithmetic,
the generators, the result line, and what the benchmark imports."""
from __future__ import annotations

import ast
import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from portbench import core, flops, scenes

ROOT = Path(__file__).resolve().parents[1]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_finds_its_files(name):
    cell = core.load_cell(name, ROOT)
    assert cell.chips == 1
    assert (ROOT / "portbench" / "drivers" / f"{cell.traffic['driver']}.py").exists()
    assert set(cell.limits) and all(v >= 0 for v in cell.limits.values())
    assert cell.per_layer, "every cell reports a per-layer metric"
    reported = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2
    for m in cell.per_layer:
        assert m["moves"] in reported
        assert callable(core.reader(m["name"], ROOT))


def test_benchmark_json_keys_and_files():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    for c in BENCH["configs"]:
        assert (ROOT / c["file"]).exists() and c["reduced"] == []
    for m in BENCH["per_layer"]:
        assert (ROOT / "portbench" / "metrics" / f"{m['name']}.py").exists()
        if m["unit"] == "%" and ("roofline" in m["name"] or "mfu" in m["name"]):
            assert m["better"] == "higher"
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_a_cell_added_as_files_alone_is_found(tmp_path):
    """A later change adds a cell, a traffic mix and a per-layer metric as
    new files and entries; no file of the harness changes."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    pkg = tmp_path / "portbench"
    traffic = json.loads((pkg / "traffic" / "batch32_closed.json").read_text())
    (pkg / "traffic" / "batch8_closed.json").write_text(json.dumps(dict(traffic, batch=8)))
    (pkg / "limits" / "bf16_batch8.json").write_text(
        (pkg / "limits" / "bf16_batch32.json").read_text())
    (pkg / "metrics" / "launches.serve8.py").write_text(
        "def read(ctx):\n    return 42.0\n")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "bf16_batch8", "config": "ssd300_vgg16bn",
                               "traffic": "batch8_closed", "chips": 1, "why": "a test"})
    bench["end_to_end"][0]["workloads"].append("bf16_batch8")
    bench["per_layer"].append({"name": "launches.serve8", "unit": "launches",
                               "better": "lower", "source": "device_trace", "layer": "device",
                               "moves": "serve_images_per_s", "workloads": ["bf16_batch8"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = core.load_cell("bf16_batch8", tmp_path)
    assert cell.traffic["batch"] == 8 and cell.traffic["driver"] == "serve_batches"
    assert [m["name"] for m in cell.per_layer] == ["launches.serve8"]
    assert {m["name"] for m in cell.end_to_end} == {"serve_images_per_s", "setup_s"}
    ctx = core.Context(cell=cell)
    assert core.per_layer_metrics(ctx, tmp_path) == {
        "launches.serve8": {"value": 42.0, "unit": "launches"}}


def test_flop_and_byte_counts():
    assert flops.model_flops() == pytest.approx(61.25e9, rel=1e-3)
    assert flops.stem_bound_s(32) * 1e3 == pytest.approx(0.2248, abs=1e-4)
    assert flops.stem_train_bound_s(16) * 1e3 == pytest.approx(0.3321, abs=1e-4)
    assert flops.nms_bound_s([400] * 32) * 1e3 == pytest.approx(0.00118, abs=1e-5)
    layers = flops.int8_layers()
    assert len(layers) == 21 and [x["emit"] for x in layers].count("both") == 5
    assert layers[-1]["emit"] == "tap" and layers[-1]["h_out"] == 1
    # the int8 backbone at the int8 peak takes less time than at the bf16 peak
    assert flops.seconds_at_peak(int8_backbone=True) < flops.seconds_at_peak()


def test_scenes_are_a_function_of_the_seed():
    a = scenes.render_many(2**33 + 5, 0, 3, 128, workers=1)
    b = scenes.render_many(2**33 + 5, 0, 3, 128, workers=2)
    c = scenes.render_many(2**33 + 6, 0, 3, 128, workers=1)
    for (ia, ba, la), (ib, bb, lb) in zip(a, b):
        assert np.array_equal(ia, ib) and np.array_equal(ba, bb) and np.array_equal(la, lb)
    assert not np.array_equal(a[0][0], c[0][0])
    batch = scenes.train_batches(a, 3)[0]
    assert batch["boxes"].shape == (3, scenes.MAX_OBJECTS, 4)
    assert (batch["boxes"][batch["valid"]] <= 1).all()


def _imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_nothing_the_benchmark_runs_imports_jax():
    for path in (ROOT / "portbench").rglob("*.py"):
        assert not _imports(path) & set(core.FORBIDDEN), path
    for path in (ROOT / "portbench" / "reference").glob("*.py"):
        assert not _imports(path) & (set(core.FORBIDDEN) | {"ssdx_torch", "portbench"}), path
    # what the program loads at run time, compared by whole top-level names
    code = ("import sys; import portbench.run, portbench.control; "
            "from portbench.drivers import serve_batches, train_steps; "
            "import ssdx_torch.api, ssdx_torch.serve.app, ssdx_torch.train.step, "
            "ssdx_torch.train.schedule; from portbench import core; "
            "print(core.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
    assert "ssdx_torch" not in core.FORBIDDEN and "ssdx_torch".split(".")[0] != "ssdx"
