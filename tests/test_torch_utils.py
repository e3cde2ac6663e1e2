"""ssdx_torch.utils (profiling, debug) on the CPU, beside their ssdx twins.

``StepTimer`` and ``time_fn`` keep the JAX package's interface (``times``,
``mean``, ``total``; mean seconds per call) and on the CPU time with the host
clock, so both packages' timers must see a 20 ms sleep.  The CUDA-event path
runs only on a GPU.  ``enable_nan_checks`` turns on autograd's anomaly mode
and the train step's loss check; ``enable_x64`` switches the default dtype.
"""
import time

import numpy as np
import pytest
import torch

from ssdx.utils import profiling as jax_prof
from ssdx_torch import priors as P
from ssdx_torch.model import SSD300, init_variables
from ssdx_torch.train.schedule import build_optimizer
from ssdx_torch.train.step import Batch, create_train_state, make_train_step
from ssdx_torch.utils import debug, profiling
from torch_dist import OPT, train_arrays


def test_step_timer_measures_like_the_jax_package():
    t, jt = profiling.StepTimer(device="cpu"), jax_prof.StepTimer()
    assert t.mean == 0.0 == jt.mean
    for timer in (t, jt):
        for _ in range(2):
            with timer:
                time.sleep(0.02)
    for timer in (t, jt):
        assert len(timer.times) == 2 and all(0.015 < x < 0.5 for x in timer.times)
        assert np.isclose(timer.total, sum(timer.times))
        assert np.isclose(timer.mean, timer.total / 2)


def test_time_fn_counts_warmup_and_iterations():
    calls = []
    fn = lambda x: (calls.append(x), time.sleep(0.005))[0]
    mean = profiling.time_fn(fn, 3, n_warmup=2, n_iters=4, device="cpu")
    assert len(calls) == 6 and 0.004 < mean < 0.2
    ref = jax_prof.time_fn(lambda x: (time.sleep(0.005), np.zeros(1))[1], 3, n_warmup=2,
                           n_iters=4)
    assert 0.004 < ref < 0.2


def test_timers_need_a_gpu_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        profiling.StepTimer()
    with pytest.raises(RuntimeError, match="CUDA"):
        profiling.time_fn(lambda: None)


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path / "tr"), device="cpu") as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert (tmp_path / "tr" / "trace.json").stat().st_size > 0
    assert any("mm" in e.key or "matmul" in e.key for e in prof.key_averages())


def test_x64_switch():
    try:
        debug.enable_x64()
        assert torch.zeros(1).dtype == torch.float64
    finally:
        debug.enable_x64(False)
    assert torch.zeros(1).dtype == torch.float32


def _step():
    model = SSD300(6, width_mult=0.25)
    opt, sched = build_optimizer(model.parameters(), **OPT)
    state = create_train_state(model, opt, sched, init_variables(6, 0, 0.25))
    pri = P.create_priors()
    return state, make_train_step(model, pri, P.priors_xyxy(pri), iou_thresh=0.4)


def test_nan_checks_switch_and_the_loss_check(monkeypatch):
    imgs, boxes, labels, valid = train_arrays(B=1)
    bad = Batch(np.full_like(imgs, np.nan), boxes, labels, valid)
    assert not debug.nan_checks_enabled() and not torch.is_anomaly_enabled()
    state, step = _step()
    _, m = step(state, bad)  # off: a NaN loss passes silently
    assert not np.isfinite(float(m["loss"]))
    try:
        debug.enable_nan_checks()
        assert debug.nan_checks_enabled() and torch.is_anomaly_enabled()
        state, step = _step()
        with pytest.raises((FloatingPointError, RuntimeError)):
            step(state, bad)  # anomaly mode or the loss check, whichever sees it first
        torch.autograd.set_detect_anomaly(False)  # the loss check alone
        state, step = _step()
        with pytest.raises(FloatingPointError, match="step 0"):
            step(state, bad)
        state, m = step(state, Batch(imgs, boxes, labels, valid))
        assert np.isfinite(float(m["loss"])) and state.step == 1
    finally:
        debug.disable_nan_checks()
    assert not debug.nan_checks_enabled() and not torch.is_anomaly_enabled()
    debug.check_finite_loss(torch.tensor(1.0), 3)
