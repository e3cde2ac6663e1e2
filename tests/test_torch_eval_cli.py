"""The port's eval command against the JAX package's on the same files.

The toy directory of tests/test_eval_cli.py (16 random 64x64 JPEGs, two
classes), one ``save_params`` file written by the port from
``init_variables(3, 0, 0.25)`` and read by both ``evaluate_weights``, f32 on
the CPU.  mAP@0.5 and the per-class APs within 1e-4, the test loss within
1e-4 relative: the two run the same network on the same pixels with convs
summed in another order.  The command line prints the JAX package's line.
The JAX package's C++ matcher is a private build of this module
(``torch_parity.jax_native_private``).
"""
import re

import numpy as np
import pandas as pd
import pytest

from ssdx.eval.run import evaluate_weights as jax_evaluate_weights
from ssdx_torch.eval import run as eval_run
from ssdx_torch.model import init_variables
from ssdx_torch.train.checkpoint import save_params
from torch_parity import jax_native_private  # noqa: F401 (autouse fixture)

KW = dict(batch_size=8, bfloat16=False, num_workers=2, source_size=64, max_boxes=4,
          width_mult=0.25)


@pytest.fixture(scope="module")
def eval_dir(tmp_path_factory):
    import cv2

    d = tmp_path_factory.mktemp("eval_cli")
    rng = np.random.default_rng(5)
    rows = []
    for i in range(16):
        name = f"v{i:02d}.jpg"
        cv2.imwrite(str(d / name), rng.integers(0, 255, (64, 64, 3), np.uint8))
        rows.append(dict(filename=name, width=64, height=64,
                         **{"class": "car" if i % 2 else "truck"},
                         xmin=8, ymin=8, xmax=40, ymax=40))
    pd.DataFrame(rows).to_csv(d / "ann.csv", index=False)
    return d


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    v = init_variables(3, seed=0, width_mult=0.25)
    return save_params(v["params"], v["batch_stats"],
                       tmp_path_factory.mktemp("w") / "m.weights")


@pytest.fixture(scope="module")
def port_out(eval_dir, weights):
    return eval_run.evaluate_weights(weights, eval_dir, device="cpu", **KW)


def test_evaluate_weights_end_to_end(port_out):
    assert np.isfinite(port_out["testing loss"])
    m = port_out["mAP"]
    assert "map_50" in m and "map_per_class" in m
    assert port_out["classes"] == ["car", "truck"]
    assert -1.0 <= m["map_50"] <= 1.0


def test_evaluate_weights_equals_the_jax_package(port_out, eval_dir, weights):
    # low thresholds, so that random weights give detections to match
    kw = dict(KW, score_thresh=0.01, nms_thresh=0.5)
    ref = jax_evaluate_weights(weights, eval_dir, **kw)
    got = eval_run.evaluate_weights(weights, eval_dir, device="cpu", **kw)
    assert got["classes"] == ref["classes"]
    for out in (port_out, got):
        np.testing.assert_allclose(out["testing loss"], ref["testing loss"], rtol=1e-4)
    for k in ("localization loss", "classification loss"):
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-4)
    assert abs(got["mAP"]["map_50"] - ref["mAP"]["map_50"]) <= 1e-4
    np.testing.assert_array_equal(got["mAP"]["classes"], ref["mAP"]["classes"])
    np.testing.assert_allclose(got["mAP"]["map_per_class"], ref["mAP"]["map_per_class"],
                               atol=1e-4)


def test_command_prints_the_reference_line(eval_dir, weights, capsys, monkeypatch):
    monkeypatch.setattr(eval_run, "evaluate_weights",
                        lambda w, d, **kw: {"mAP": {"map_50": 0.5, "classes": np.array([1]),
                                                    "map_per_class": np.array([0.25])},
                                            "classes": ["car", "truck"],
                                            "testing loss": 1.5, "kw": kw})
    eval_run.main(["--test-dir", str(eval_dir), "--cpu", "--batch-size", "4", "a.w", "b.w"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines == ["a.w: mAP@0.5=0.5000  [truck=0.2500]  test loss=1.5000",
                     "b.w: mAP@0.5=0.5000  [truck=0.2500]  test loss=1.5000"]


def test_command_end_to_end_on_the_cpu(eval_dir, weights, capsys):
    eval_run.main(["--test-dir", str(eval_dir), "--cpu", "--batch-size", "8", "--width-mult",
                   "0.25", str(weights)])
    line = capsys.readouterr().out.strip()
    assert re.fullmatch(rf"{re.escape(str(weights))}: mAP@0\.5=-?[0-9.]+  \[.*\]  "
                        r"test loss=[0-9.]+", line), line
