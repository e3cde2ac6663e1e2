"""The port's learning checks on the CPU at width 0.25: the overfit tool
(``ssdx_torch.tools.overfit_check``) prints the JAX script's lines and its
loss falls; the SynthDrive tool (``ssdx_torch.tools.train_synthdrive``)
trains one epoch, resumes on a rerun, writes ``results.json`` with the JAX
script's keys, and exports a float16 bundle that the JAX package's
``load_params`` reads.
"""
import json
import re

import numpy as np
import pytest

from ssdx.train.checkpoint import load_params as jax_load_params
from ssdx_torch.tools import overfit_check, train_synthdrive
from ssdx_torch.train.checkpoint import load_params

from torch_parity import REPO, flatten

EPOCH_LINE = re.compile(r"epoch +(\d+)  loss= *([0-9.]+)  mAP@0\.5=([0-9.]+)")


def test_overfit_check_output_and_falling_loss():
    lines = []
    rc = overfit_check.main(["--device", "cpu", "--width-mult", "0.25", "--images", "16",
                             "--epochs", "4", "--eval-every", "2"],
                            log=lines.append)
    assert lines[0].startswith("dataset: 16 images, classes=['car', 'pedestrian', 'truck']")
    epochs = [EPOCH_LINE.fullmatch(l) for l in lines[1:-1]]
    assert all(epochs) and [int(m.group(1)) for m in epochs] == [0, 1, 3]
    losses = [float(m.group(2)) for m in epochs]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    result = re.fullmatch(r"RESULT: (PASS|FAIL)  \(first mAP=([0-9.]+), final mAP=([0-9.]+)\)",
                          lines[-1])
    assert result and rc == (0 if result.group(1) == "PASS" else 1)
    assert result.group(2) == epochs[0].group(3) and result.group(3) == epochs[-1].group(3)


def test_overfit_check_dataset_matches_the_script(tmp_path):
    import importlib.util

    spec = importlib.util.spec_from_file_location("overfit_script",
                                                  REPO / "scripts" / "overfit_check.py")
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    overfit_check.make_dataset(tmp_path / "a", n=6)
    script.make_dataset(tmp_path / "b", n=6)
    assert (tmp_path / "a" / "ann.csv").read_text() == (tmp_path / "b" / "ann.csv").read_text()
    for i in range(6):
        name = f"s{i:03d}.jpg"
        assert (tmp_path / "a" / name).read_bytes() == (tmp_path / "b" / name).read_bytes()


ARGS = ["--device", "cpu", "--width-mult", "0.25", "--n-train", "12", "--n-test", "4",
        "--size", "96", "--batch-size", "4"]


def test_train_synthdrive_trains_resumes_and_exports(tmp_path):
    wd = tmp_path / "sd"
    lines = []
    first = train_synthdrive.main(["--workdir", str(wd), "--epochs", "1", *ARGS],
                                  log=lines.append)
    assert any(l.startswith("dataset: ") and "val images" in l for l in lines)
    assert sum(l.startswith("Epoch: ") for l in lines) == 1
    assert len(first["val_map_50_per_epoch"]) == 1

    lines.clear()
    final = train_synthdrive.main(["--workdir", str(wd), "--epochs", "2", *ARGS],
                                  log=lines.append)
    assert "reusing existing train dataset at " + str(wd / "train") in lines
    assert any(f"resumed from {wd / 'ckpt' / 'last.ckpt'}: 1 epochs done, 1 of 2 remaining" in l
               for l in lines)
    assert sum(l.startswith("Epoch: ") for l in lines) == 1

    results = json.loads((wd / "results.json").read_text())
    reference = json.loads((REPO / "docs" / "synthdrive" / "results.json").read_text())
    assert set(results) >= {"train_wall_s", "epochs", "val_curves", "test_last"}
    assert set(results) >= set(reference) - {"test_best"} and results["epochs"] == 2
    assert set(results["val_curves"]) == {"train_loss", "test_loss", "mAP", "epochs"}
    assert len(results["val_curves"]["train_loss"]) == 2 == len(results["val_map_50_per_epoch"])
    for tag in ("best", "last"):
        if f"test_{tag}" in results:
            assert set(results[f"test_{tag}"]) == set(reference[f"test_{tag}"])
            assert np.isfinite(results[f"test_{tag}"]["test_loss"])
    timing = results["timing"]
    assert len(timing["epoch_wall_s"]) == len(timing["train_images_per_s"]) == 1
    assert results["device"] == {"platform": "cpu"}
    assert (wd / "curves.png").exists()
    assert sorted(p.name for p in wd.glob("panel_*.jpg")) == ["panel_0.jpg", "panel_1.jpg",
                                                              "panel_2.jpg"]

    bundle = wd / "ckpt" / "last.npz"
    theirs, ours = flatten(jax_load_params(bundle)), flatten(load_params(wd / "ckpt" / "last.weights"))
    assert sorted(theirs) == sorted(ours)
    for k, v in theirs.items():
        np.testing.assert_array_equal(v, ours[k].astype(np.float16).astype(np.float32), err_msg=k)
