"""Every cell's run on the CPU at a small size, sound and with the timed path
broken underneath: a sound run is ``correct``; each fault the cell can
have makes it not ``correct``.

The serving cells run the real configuration (the trained demo bundle at
full width) in float32 on two images, so that faults meet confident
detections; the training cell runs at width 0.25.  The card's own check
is skipped: ``portbench.run.execute`` is given the CPU.
"""
from __future__ import annotations

import json
import time
from pathlib import Path

import pytest
import torch

from portbench import core, run

ROOT = Path(__file__).resolve().parents[1]
SEED = 2**31 + 77  # more than 32 signed bits
CPU = torch.device("cpu")
SERVE = {"serve": {"dtype": "float32", "stem_kernel": False},
         "traffic": {"batch": 2, "distinct_batches": 1, "check_batches": 1, "trace_batches": 1,
                     "workers": 2}}
TRAIN = {"train": {"dtype": "float32", "fused_stem": False, "width_mult": 0.25},
         "traffic": {"batch": 4, "distinct_batches": 3, "scene_size": 256, "trace_steps": 1,
                     "workers": 2}}
INT8 = {"serve": {"calibration_scenes": 2}}


def _run(name: str, overrides: dict, seconds: float = 0.5, trace: bool = False) -> dict:
    cell = core.load_cell(name, ROOT)
    line, lines = run.execute(cell, SEED, seconds, trace, CPU, ROOT, overrides,
                              t0=time.monotonic())
    assert lines[-1].startswith("check ")
    return line


def _overrides(name):
    ov = TRAIN if name == "train_bs16" else SERVE
    if name == "int8_batch32":
        ov = {**SERVE, "serve": {**SERVE["serve"], **INT8["serve"]}}
    return ov


@pytest.mark.parametrize("name", ["bf16_batch32", "int8_batch32", "train_bs16"])
def test_sound_run_is_correct_and_its_line_has_the_contract_shape(name):
    line = _run(name, _overrides(name))
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert line["correct"], line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert "setup_s" in line["metrics"] and len(line["metrics"]) == 2
    json.dumps(line)


def _blank_half(monkeypatch):
    """The detector answers the first half of each batch and nothing for the rest."""
    from ssdx_torch.api import Detector

    real = Detector.predict_batched

    def half(self, images=None, **kw):
        d = real(self, images, **kw)
        with torch.inference_mode():
            d.valid[d.valid.shape[0] // 2:] = False
        return d

    monkeypatch.setattr(Detector, "predict_batched", half)


def _alter_answer(monkeypatch):
    """The top detection of every batch's first image reads another score."""
    from ssdx_torch.api import Detector

    real = Detector.predict_batched

    def altered(self, images=None, **kw):
        d = real(self, images, **kw)
        with torch.inference_mode():
            s = d.scores[0, 0]
            d.scores[0, 0] = s - 0.5 if s > 0.5 else s + 0.5
        return d

    monkeypatch.setattr(Detector, "predict_batched", altered)


@pytest.mark.parametrize("name", ["bf16_batch32", "int8_batch32"])
@pytest.mark.parametrize("fault", [_blank_half, _alter_answer])
def test_a_serving_fault_is_not_correct(name, fault, monkeypatch):
    fault(monkeypatch)
    line = _run(name, _overrides(name))
    assert not line["correct"], line["checks"]


def _state_unchanged(monkeypatch):
    monkeypatch.setattr(torch.optim.SGD, "step", lambda self, closure=None: None)


def _half_batch(monkeypatch):
    """The step trains on the first half of its rows, the mean over those."""
    import ssdx_torch.train.step as S

    real = S.make_train_step

    def make(*a, **k):
        step = real(*a, **k)
        return lambda state, b: step(state, S.Batch(*(t[: len(t) // 2] for t in b)))

    monkeypatch.setattr(S, "make_train_step", make)


def _zero_dw1(monkeypatch):
    """Kernel B3's backward hands conv1_1's weight a gradient of zeros."""
    from portbench import program

    real = program.train_state

    def train_state(*a, **k):
        state, step, leaves = real(*a, **k)
        state.model.layers[0].conv.weight.register_hook(torch.zeros_like)
        return state, step, leaves

    monkeypatch.setattr(program, "train_state", train_state)


def _alter_loss(monkeypatch):
    """The step reports a loss 10 % off the one it trained on."""
    import ssdx_torch.train.step as S

    real = S.make_train_step

    def make(*a, **k):
        step = real(*a, **k)

        def altered(state, b):
            state, m = step(state, b)
            return state, dict(m, loss=m["loss"] * 1.1)

        return altered

    monkeypatch.setattr(S, "make_train_step", make)


@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch, _zero_dw1, _alter_loss])
def test_a_training_fault_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    line = _run("train_bs16", TRAIN)
    assert not line["correct"], line["checks"]
