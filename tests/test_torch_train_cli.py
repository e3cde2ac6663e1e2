"""The port's training command (ssdx_torch.train.run) end to end on the toy
on-disk dataset of tests/test_train_cli.py, at width 0.25 in float32 on the
CPU: it trains, writes ``last.ckpt`` and ``last.weights``, a rerun resumes
and says so, and the exported weights load through the JAX package's
``load_params``.
"""
import dataclasses
import json

import numpy as np
import pandas as pd
import pytest

from ssdx.train.checkpoint import load_params as jax_load_params
from ssdx_torch.config import Config
from ssdx_torch.train import run as run_mod

from torch_parity import flatten


@pytest.fixture(scope="module")
def toy_train_dir(tmp_path_factory):
    import cv2

    d = tmp_path_factory.mktemp("torch_cli_train")
    rng = np.random.default_rng(3)
    rows = []
    for i in range(24):
        img = rng.integers(0, 255, (64, 64, 3), np.uint8)
        name = f"c{i:02d}.jpg"
        cv2.imwrite(str(d / name), img)
        rows.append(dict(filename=name, width=64, height=64,
                         **{"class": ["car", "truck", "pedestrian"][i % 3]},
                         xmin=5, ymin=5, xmax=45, ymax=45))
    pd.DataFrame(rows).to_csv(d / "ann.csv", index=False)
    return d


def _config(train_dir, save_dir) -> Config:
    cfg = Config()
    return dataclasses.replace(
        cfg,
        data=dataclasses.replace(cfg.data, train_dir=str(train_dir), batch_size=8, num_workers=2,
                                 source_size=64, max_boxes=8, val_fraction=0.25),
        train=dataclasses.replace(cfg.train, epochs=1, warmup_epochs=0, save_dir=str(save_dir),
                                  bfloat16=False, width_mult=0.25),
    )


def test_run_trains_resumes_and_exports(toy_train_dir, tmp_path):
    cfg = _config(toy_train_dir, tmp_path)
    logs = []
    state, results, class_to_idx = run_mod.run(cfg, epochs=1, resume=False, log=logs.append,
                                               device="cpu")
    assert set(class_to_idx) == {"car", "truck", "pedestrian"}
    assert len(results["train_loss"]) == 1 and np.isfinite(results["train_loss"][0])
    assert state.step > 0
    assert (tmp_path / "last.ckpt").exists() and (tmp_path / "last.weights").exists()
    assert any("mAP" in l for l in logs) and any(l.startswith("dataset:") for l in logs)

    # the exported weights are the JAX package's tree, with the trained values
    variables = jax_load_params(tmp_path / "last.weights")
    from ssdx_torch.weights import variables_from_torch
    want = flatten(variables_from_torch(state.model))
    got = flatten({k: variables[k] for k in ("params", "batch_stats")})
    assert got.keys() == want.keys() and len(got) > 100
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)

    # the same command again after completion trains nothing more
    logs_noop = []
    _, results_noop, _ = run_mod.run(cfg, epochs=1, resume=True, log=logs_noop.append,
                                     device="cpu")
    line = f"resumed from {tmp_path / 'last.ckpt'}: 1 epochs done, 0 of 1 remaining"
    assert line in logs_noop
    assert len(results_noop["train_loss"]) == 1  # history only, no new epochs

    # a higher total picks up the checkpoint and extends the curves
    logs2 = []
    state2, results2, _ = run_mod.run(cfg, epochs=2, resume=True, log=logs2.append, device="cpu")
    assert any("1 of 2 remaining" in l for l in logs2)
    assert len(results2["train_loss"]) == 2 and results2["epochs"] == [2]
    assert state2.step == 2 * state.step


def test_main_parses_the_flags_of_the_jax_command(toy_train_dir, tmp_path, monkeypatch):
    calls = []
    monkeypatch.setattr(run_mod, "run", lambda cfg, epochs, resume, device: calls.append(
        (cfg, epochs, resume, device)))
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(json.dumps({"train": {"width_mult": 0.25, "epochs": 7}}))
    run_mod.main(["--config", str(cfg_path), "--train-dir", str(toy_train_dir), "--save-dir",
                  str(tmp_path / "out"), "--epochs", "3", "--no-resume"])
    cfg, epochs, resume, device = calls[-1]
    assert (cfg.data.train_dir, cfg.train.save_dir) == (str(toy_train_dir), str(tmp_path / "out"))
    assert cfg.train.width_mult == 0.25 and cfg.train.epochs == 7 and epochs == 3 and not resume
    assert device is None  # the GPU
    run_mod.main(["--train-dir", str(toy_train_dir), "--smoke", "--cpu"])
    cfg, epochs, resume, device = calls[-1]
    assert (cfg.data.batch_size, cfg.data.num_workers, cfg.train.epochs) == (8, 2, 2)
    assert epochs == 2 and resume and device == "cpu"


def test_run_needs_a_gpu_unless_asked_for_the_cpu(toy_train_dir, tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA GPU"):
        run_mod.run(_config(toy_train_dir, tmp_path), epochs=1)


def test_command_trains_where_scikit_learn_is_missing(toy_train_dir, tmp_path):
    """``python -m ssdx_torch.train.run`` in a process that cannot import
    scikit-learn: the stratified group split is the port's own."""
    import subprocess
    import sys

    from torch_parity import REPO

    cfg = _config(toy_train_dir, tmp_path / "ckpt")
    cfg.to_json(tmp_path / "cfg.json")
    code = ("import sys, runpy; sys.modules['sklearn'] = None; "
            "sys.argv = ['run', '--config', sys.argv[1], '--cpu']; "
            "runpy.run_module('ssdx_torch.train.run', run_name='__main__')")
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path / "cfg.json")],
                         capture_output=True, text=True, cwd=REPO, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.splitlines()
    assert "dataset: 18 train / 6 val images, classes=['car', 'pedestrian', 'truck']" in lines
    assert sum(l.startswith("Epoch: 0  |  mAP: ") for l in lines) == 1
    assert (tmp_path / "ckpt" / "last.ckpt").exists()
    assert (tmp_path / "ckpt" / "last.weights").exists()


def test_stage_timer_covers_one_epoch_and_puts_the_command_back(toy_train_dir, tmp_path,
                                                                 monkeypatch):
    """tools/profile_train_command.py times every stage of the command's
    epoch, inside the command's own wall time, and leaves ``train.run`` and
    ``train.loop`` as it found them."""
    from ssdx_torch.tools import profile_train_command as ptc

    monkeypatch.setattr(ptc.torch.cuda, "synchronize", lambda *a, **k: None)  # no card here
    before = {(m, n): getattr(m, n) for m, names in ptc.STAGES.items() for n in names}
    before_step, before_fit = run_mod.make_train_step, run_mod.fit
    _config(toy_train_dir, tmp_path / "ckpt").to_json(tmp_path / "cfg.json")
    wall, secs, calls = ptc.stages(["--config", str(tmp_path / "cfg.json"), "--cpu"])
    assert calls["train step (first)"] == 1 and calls["train step (later)"] >= 1
    assert calls["DetectionLoader"] == 2 and calls["evaluate"] == 1 and calls["save_params"] == 1
    assert calls["save_checkpoint"] >= 1 and "load_checkpoint" not in calls
    assert secs["loader wait"] > 0 and 0 < sum(secs.values()) <= wall
    assert all(getattr(m, n) is fn for (m, n), fn in before.items())
    assert (run_mod.make_train_step, run_mod.fit) == (before_step, before_fit)
    assert (tmp_path / "ckpt" / "last.weights").exists()
