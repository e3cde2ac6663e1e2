"""The head-to-head harness (tests/torch_h2h.py) on the CPU, at no training.

``c8`` patches both packages' demo-weights recipes to width 0.25, bfloat16
and another seed's initial weights: the patches must reach the names each
recipe calls and be undone after.  ``ablate`` must hand ``train.run.run``
the SynthDrive tool's config with only the named ``TrainConfig`` fields
changed, and ``cut`` must finish a killed run with the cut epoch count.
"""
import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_h2h
from test_torch_resume_synthdrive import STAND_IN

REPO = Path(__file__).resolve().parents[1]


def test_c8_patches_reach_the_jax_recipe_and_are_undone(monkeypatch):
    import jax
    import jax.numpy as jnp

    import ssdx.model
    import ssdx.train.step as jstep

    script = (REPO / "scripts" / "make_demo_weights.py").read_text()
    for call in ("from ssdx.model import SSD300", "SSD300(num_classes=",
                 "from ssdx.train.step import create_train_state",
                 "create_train_state(model, tx, jax.random.key(0))"):
        assert call in script, call
    seen = []
    monkeypatch.setattr(jstep, "create_train_state", lambda model, tx, rng: seen.append(rng))
    wrapped = jstep.create_train_state
    with torch_h2h.c8_patches("jax", 5):
        from ssdx.model import SSD300
        from ssdx.train.step import create_train_state

        assert SSD300(num_classes=6, dtype=jnp.bfloat16).width_mult == torch_h2h.WM
        create_train_state(None, None, jax.random.key(0))
    np.testing.assert_array_equal(jax.random.key_data(seen[0]),
                                  jax.random.key_data(jax.random.key(5)))
    assert jstep.create_train_state is wrapped
    assert isinstance(ssdx.model.SSD300, type)  # the class again, not the partial


def test_c8_patches_reach_the_port_recipe_and_are_undone():
    from ssdx_torch import model as tmodel
    from ssdx_torch.tools import make_demo_weights as tool

    with torch_h2h.c8_patches("torch", 5):
        # the tool's own calls, with the CPU route's float32 and seed 0
        model = tool.SSD300(6, dtype=torch.float32, width_mult=torch_h2h.WM)
        variables = tool.init_variables(6, seed=0, width_mult=torch_h2h.WM)
    assert model.dtype == torch.bfloat16  # the compute dtype of the activations
    assert model.width_mult == torch_h2h.WM
    want = tmodel.init_variables(6, seed=5, width_mult=torch_h2h.WM)
    got, ref = (jax_leaves(v) for v in (variables, want))
    assert len(got) == len(ref) and all(np.array_equal(a, b) for a, b in zip(got, ref))
    assert tool.SSD300 is tmodel.SSD300 and tool.init_variables is tmodel.init_variables


def jax_leaves(tree):
    """The arrays of a nested dict, in key order."""
    if isinstance(tree, dict):
        return [a for k in sorted(tree) for a in jax_leaves(tree[k])]
    return [np.asarray(tree)]


def test_ablate_changes_only_the_named_fields(tmp_path, monkeypatch):
    from ssdx_torch.train import run as trun

    seen = []

    def spy(cfg, *a, **kw):
        seen.append(cfg)
        raise KeyboardInterrupt  # stop before training

    monkeypatch.setattr(trun, "run", spy)
    wd = tmp_path / "sd"
    with pytest.raises(KeyboardInterrupt):
        torch_h2h.main(["ablate", "--set", "fused_stem=false", "--set", "base_lr=0.001", "--",
                        "--workdir", str(wd), "--n-train", "2", "--n-test", "1",
                        "--size", "64", "--epochs", "2", "--device", "cpu"])
    written = json.loads((wd / "config.json").read_text())  # the tool's own config
    assert dataclasses.asdict(seen[0].train) == {**written["train"], "fused_stem": False,
                                                 "base_lr": 0.001}
    assert dataclasses.asdict(seen[0].data) == written["data"]


def test_cut_finishes_the_killed_run_with_the_cut_epoch_count(tmp_path, capfd, monkeypatch):
    from ssdx_torch.tools import resume_synthdrive

    tool = tmp_path / "stand_in.py"
    tool.write_text(STAND_IN)
    monkeypatch.setattr(resume_synthdrive, "GRACE_S", 0.0)
    monkeypatch.setattr(resume_synthdrive, "_command",
                        lambda args: [sys.executable, "-u", str(tool), *args])
    wd = tmp_path / "sd"
    with pytest.raises(SystemExit) as done:
        torch_h2h.main(["cut", "--kill-after", "1", "--resume-epochs", "2", "--",
                        "--workdir", str(wd), "--epochs", "5"])
    out = capfd.readouterr().out
    assert done.value.code == 0, out
    assert out.splitlines() == [
        "Epoch: 0  |  mAP: 0.5",
        "killed with SIGKILL (rc -9); last.ckpt holds 1 epochs",
        f"resumed from {wd / 'ckpt' / 'last.ckpt'}: 1 epochs done, 1 of 2 remaining",
        "Epoch: 1  |  mAP: 0.5",
        "done",
    ], out
