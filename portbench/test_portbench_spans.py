"""The readers of the program's spans (``portbench/spans.py`` and the
``host_*`` / ``nms_slot_share`` metrics) on the CPU, from a synthetic
traced window and a synthetic span log: the milliseconds and the share
they give, the host-recorded window's spans left out, and ``None`` where
the program logged no span (as a program without spans does)."""
from __future__ import annotations

import sys
import types
from pathlib import Path

import pytest

from portbench import core, spans
from portbench.trace import DeviceOp, Trace
from ssdx_torch.utils import profiling
from ssdx_torch.utils.profiling import SpanRecord

ROOT = Path(__file__).resolve().parents[1]
MS = 1_000_000


def _trace():
    ops = [DeviceOp("k", "kernel", 10 * MS, 5 * MS), DeviceOp("copy", "memcpy", 60 * MS, 40 * MS)]
    return Trace(window_s=0.1, busy_s=0.045, ops=ops)


def _rec(name, start_ms, dur_ms, i, root=None, **counts):
    s = int(start_ms * MS)
    return SpanRecord(name, i, 0 if root is None else root, i if root is None else root, 1, s,
                      s + int(dur_ms * MS), counts)


def _ctx(cell, log, monkeypatch, iters=2, trace=True):
    monkeypatch.setattr(profiling, "recent_spans", lambda: list(log))
    return core.Context(cell=core.load_cell(cell, ROOT), trace=_trace() if trace else None,
                        traced_iters=iters)


def _serve_log():
    """Two batches in the host-recorded window (before 100 ms, with long
    spans that must not count) and two in the device-only one."""
    log = []
    for i, t0 in enumerate((20, 70)):
        log += [_rec("ssdx_torch.api.input_copy", t0, 30.0, 10 * i + 1),
                _rec("ssdx_torch.predict.to_pylist.unpack", t0 + 5, 9.0, 10 * i + 2),
                _rec("ssdx_torch.predict.postprocess", t0 + 2, 1.0, 10 * i + 3,
                     nms_candidates=100, nms_slots=12_800)]
    for i, (t0, copy, unpack, cands) in enumerate(((200, 5.0, 0.5, 640), (300, 6.0, 0.7, 1280))):
        log += [_rec("ssdx_torch.api.input_copy", t0, copy, 100 + 10 * i + 1),
                _rec("ssdx_torch.predict.to_pylist.unpack", t0 + 8, unpack, 100 + 10 * i + 2),
                _rec("ssdx_torch.predict.postprocess", t0 + 7, 0.3, 100 + 10 * i + 3,
                     nms_candidates=cands, nms_slots=12_800)]
    return log


@pytest.mark.parametrize("cell,suffix", [("bf16_batch32", "serve"), ("int8_batch32", "int8")])
def test_serving_readers_take_the_device_only_window(cell, suffix, monkeypatch):
    ctx = _ctx(cell, _serve_log(), monkeypatch)
    got = core.per_layer_metrics(ctx, ROOT)
    assert got[f"host_input_copy_ms.{suffix}"]["value"] == pytest.approx(5.5)
    assert got[f"host_unpack_ms.{suffix}"]["value"] == pytest.approx(0.6)
    # every traced batch counts towards the share: (2 x 100 + 640 + 1280) / (4 x 12,800)
    assert got[f"nms_slot_share.{suffix}"]["value"] == pytest.approx(100 * 2120 / 51_200)
    assert got[f"nms_slot_share.{suffix}"]["unit"] == "%"


def _train_log():
    phases = (("batch_copy", 0.5), ("forward", 12.0), ("targets_loss", 5.0),
              ("backward", 20.0), ("optimizer", 3.0))
    log = [_rec("ssdx_torch.train.step", 10, 80.0, 1)]  # host-recorded: slowed, left out
    for i, t0 in enumerate((150, 250)):
        log.append(_rec("ssdx_torch.train.step", t0, 45.0 + i, 100 * (i + 1)))
        t = t0
        for j, (name, ms) in enumerate(phases):
            log.append(_rec(f"ssdx_torch.train.{name}", t, ms + i, 100 * (i + 1) + j + 1))
            t += ms + i
    return log


def test_train_readers_give_the_mean_phase_times(monkeypatch):
    ctx = _ctx("train_bs16", _train_log(), monkeypatch)
    got = {k: v["value"] for k, v in core.per_layer_metrics(ctx, ROOT).items()}
    want = {"host_step_ms.train": 45.5, "host_forward_ms.train": 12.5,
            "host_targets_loss_ms.train": 5.5, "host_backward_ms.train": 20.5,
            "host_optimizer_ms.train": 3.5}
    for k, v in want.items():
        assert got[k] == pytest.approx(v), k


def test_the_log_is_read_once_a_run(monkeypatch):
    calls = []
    log = _train_log()
    monkeypatch.setattr(profiling, "recent_spans", lambda: calls.append(1) or list(log))
    ctx = core.Context(cell=core.load_cell("train_bs16", ROOT), trace=_trace(), traced_iters=2)
    core.per_layer_metrics(ctx, ROOT)
    assert len(calls) == 1
    other = core.Context(cell=ctx.cell, trace=_trace(), traced_iters=2)
    assert spans.host_ms(other, "ssdx_torch.train.step") == pytest.approx(45.5)
    assert len(calls) == 2


def test_a_window_not_told_apart_gives_none(monkeypatch):
    """Three step spans after the host-recorded window for two traced
    iterations: the windows were not told apart, so no number."""
    log = _train_log() + [_rec("ssdx_torch.train.step", 400, 45.0, 999)]
    ctx = _ctx("train_bs16", log, monkeypatch)
    assert spans.host_ms(ctx, "ssdx_torch.train.step") is None
    assert spans.host_ms(ctx, "ssdx_torch.train.forward") == pytest.approx(12.5)


def test_a_span_belongs_to_the_window_of_its_outermost_span(monkeypatch):
    """The host-recorded window's last readback: its ``to_pylist`` starts
    before that window's last copy ends, its ``unpack`` a little after (the
    copies it waits on are short); both stay out of the device-only window."""
    log = _serve_log() + [
        _rec("ssdx_torch.predict.to_pylist", 95, 5.5, 50),
        _rec("ssdx_torch.predict.to_pylist.unpack", 100.02, 0.4, 51, root=50)]
    ctx = _ctx("bf16_batch32", log, monkeypatch)
    assert spans.host_ms(ctx, "ssdx_torch.predict.to_pylist.unpack") == pytest.approx(0.6)


@pytest.mark.parametrize("cell", ["bf16_batch32", "train_bs16"])
def test_no_spans_give_none_not_zero(cell, monkeypatch):
    new = {"host_step_ms.train", "host_forward_ms.train", "host_targets_loss_ms.train",
           "host_backward_ms.train", "host_optimizer_ms.train", "host_input_copy_ms.serve",
           "host_unpack_ms.serve", "nms_slot_share.serve"}
    ctx = _ctx(cell, [], monkeypatch)
    names = {m["name"] for m in ctx.cell.per_layer} & new
    assert names
    assert {n: core.reader(n, ROOT)(ctx) for n in names} == dict.fromkeys(names)
    # spans but no traced window (a run off the card)
    ctx = _ctx(cell, _serve_log() + _train_log(), monkeypatch, trace=False)
    assert {n: core.reader(n, ROOT)(ctx) for n in names} == dict.fromkeys(names)


def test_a_program_without_spans_gives_none(monkeypatch):
    """The parent of the spans: ``ssdx_torch.utils.profiling`` has no
    ``recent_spans``."""
    old = types.ModuleType("ssdx_torch.utils.profiling")
    monkeypatch.setitem(sys.modules, "ssdx_torch.utils.profiling", old)
    ctx = core.Context(cell=core.load_cell("bf16_batch32", ROOT), trace=_trace(),
                       traced_iters=2)
    assert spans.records(ctx) is None
    assert core.reader("host_input_copy_ms.serve", ROOT)(ctx) is None
    assert core.reader("nms_slot_share.serve", ROOT)(ctx) is None


def test_every_new_reader_is_an_entry_of_its_cells():
    cells = {"bf16_batch32": "serve", "int8_batch32": "int8"}
    for cell, suffix in cells.items():
        names = {m["name"] for m in core.load_cell(cell, ROOT).per_layer}
        assert {f"host_input_copy_ms.{suffix}", f"host_unpack_ms.{suffix}",
                f"nms_slot_share.{suffix}"} <= names
    names = {m["name"] for m in core.load_cell("train_bs16", ROOT).per_layer}
    assert {f"host_{p}_ms.train" for p in
            ("step", "forward", "targets_loss", "backward", "optimizer")} <= names


CLOCK_TOL_NS = 50_000


@pytest.mark.chip
def test_the_spans_share_the_device_trace_clock(cuda, capsys):
    """In a host-recorded window of 4 bf16 batches at bs=8, each batch's
    host-to-device copy lies inside its ``ssdx_torch.api.input_copy`` span
    (within 50 us), and the benchmark's reduction counts no span of the
    program as a device operation."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from portbench import program
    from portbench.trace import reduce
    from ssdx_torch.predict import to_pylist

    cell = core.load_cell("bf16_batch32", ROOT)
    det = program.detector(cell.config["serve"], ROOT, cuda)
    rng = np.random.default_rng(2**33 + 1)
    batches = [rng.normal(0, 1, (8, 300, 300, 3)).astype(np.float32) for _ in range(4)]
    for x in batches * 2:
        to_pylist(det.predict_batched(x))
    torch.cuda.synchronize()
    profiling.recent_spans()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with torch.profiler.record_function("portbench.trace_window"):
            for x in batches:
                to_pylist(det.predict_batched(x))
            torch.cuda.synchronize()
    copies = sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                    for e in prof.profiler.kineto_results.events()
                    if e.device_type() == torch.autograd.DeviceType.CUDA
                    and e.name().startswith("Memcpy HtoD"))
    recs = [r for r in profiling.recent_spans() if r.name == "ssdx_torch.api.input_copy"]
    assert len(recs) == 4
    margins = []
    for r in recs:
        mine = [c for c in copies if r.start_ns - 1_000_000 <= c[0] <= r.end_ns + 1_000_000]
        assert len(mine) == 1, (r, copies)
        (a, b), = mine
        margins.append((a - r.start_ns, r.end_ns - b))
        assert a >= r.start_ns - CLOCK_TOL_NS and b <= r.end_ns + CLOCK_TOL_NS, margins
    with capsys.disabled():
        print("input_copy span start -> copy start, copy end -> span end (us):",
              [(x / 1e3, y / 1e3) for x, y in margins])
    t = reduce(prof)
    assert t.ops and not [o.name for o in t.ops if o.name.startswith("ssdx_torch.")]
