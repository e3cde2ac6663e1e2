"""The train step's CUDA graph (``ssdx_torch.train.step._StepGraph``), the
kernel modules' launch counters under it, and the reader of its count.

On the CPU:
* a CPU model never captures: every step runs eagerly and its span counts
  ``steps=1, replayed=0``;
* the route, with a stub in place of the graphs and the device taken for a
  CUDA one: a plain step goes to the graphs, a step under a ``mesh`` or
  with NaN checks stays eager, and each equals the eager step bit for bit;
* the graph's bookkeeping, with stubs for warm-up, capture and replay: the
  first step warms up, the second of its layout captures and replays, later
  ones replay, a step of another layout runs eagerly; a model whose tensors
  moved, or another model, warms up again;
* ``ssdx_torch.ops``' launch counters: read, differenced and moved at once,
  whichever kernel module keeps them;
* ``graph_replay_share.train`` gives None for a program without the
  count, and 100 or 50 from span logs with all or half the steps replayed.

On a CUDA card (``chip``; skipped without one): a graph twin against an
eager twin (NaN checks on, which keep the eager route) from one seed, the
full-width fused-stem model and a width-0.25 unfused one, 5 steps of which
steps 2-5 replay: every parameter, momentum buffer and running statistic
and the three losses equal bit for bit after every step, and every kernel
module's launch counters move as the eager twin's do, the step's span
counting every BN layer outside the stem kernel on the BN + ReLU kernels; a batch of another
shape runs eagerly, bit-equal, between replays; losses kept from step 2
unchanged after step 4; B3's launch counter counting every step.  Run there with
``python -m pytest --noconftest -p no:cacheprovider tests/test_torch_train_graph.py``.
This file imports neither JAX nor the JAX package.
"""
from __future__ import annotations

from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from portbench import core
from portbench.trace import DeviceOp, Trace
from ssdx_torch import ops
from ssdx_torch import priors as P
from ssdx_torch.mesh import Mesh
from ssdx_torch.model import SSD300, init_variables
from ssdx_torch.ops import stem_train as stem_train_ops
from ssdx_torch.train import step as step_mod
from ssdx_torch.train.schedule import build_optimizer
from ssdx_torch.train.step import Batch, create_train_state, make_train_step
from ssdx_torch.utils import debug, profiling
from ssdx_torch.utils.profiling import SpanRecord

ROOT = Path(__file__).resolve().parents[1]
PRI = P.create_priors()
PRI_XYXY = P.priors_xyxy(PRI)
STEP = "ssdx_torch.train.step"
METRIC = "graph_replay_share.train"


def _state(width_mult, dev, dtype=torch.float32, seed=0):
    model = SSD300(6, width_mult=width_mult, dtype=dtype).to(dev,
                                                              memory_format=torch.channels_last)
    opt, sched = build_optimizer(model.parameters(), steps_per_epoch=10, max_epochs=2,
                                 warmup_epochs=0, base_lr=1e-2)
    return create_train_state(model, opt, sched, init_variables(6, seed, width_mult))


def _batch(seed, B, dev, G=6):
    rng = np.random.default_rng(seed)
    lo = rng.uniform(0.1, 0.6, (B, G, 2))
    sz = rng.uniform(0.05, 0.3, (B, G, 2))
    arrays = (rng.normal(0, 1, (B, 300, 300, 3)).astype(np.float32),
              np.concatenate([lo, np.minimum(lo + sz, 1.0)], -1).astype(np.float32),
              rng.integers(0, 5, (B, G)).astype(np.int32), rng.uniform(0, 1, (B, G)) < 0.8)
    return Batch(*(torch.as_tensor(a, device=dev) for a in arrays))


def _counted_step(step, state, batch):
    """One step under a CPU profiler: (metrics, the step span's counts)."""
    profiling.recent_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        state, m = step(state, batch)
    (rec,) = [r for r in profiling.recent_spans() if r.name == STEP]
    return m, rec.counts


def _snapshot(state, m) -> dict:
    """Every tensor a step changes: parameters, momentum buffers, running
    statistics and the three losses, copied."""
    out = {f"param {k}": v.detach().clone() for k, v in state.model.named_parameters()}
    out.update({f"buffer {k}": v.clone() for k, v in state.model.named_buffers()})
    for k, p in state.model.named_parameters():
        buf = state.optimizer.state.get(p, {}).get("momentum_buffer")
        if buf is not None:
            out[f"momentum {k}"] = buf.clone()
    out.update({k: v.clone() for k, v in m.items()})
    return out


def _assert_equal(a: dict, b: dict, where):
    assert a.keys() == b.keys(), where
    bad = [k for k in a if not torch.equal(a[k], b[k])]
    assert not bad, (where, bad[:5])


# ---- on the CPU ----


def test_a_cpu_model_never_captures():
    state = _state(0.25, "cpu")
    step = make_train_step(state.model, PRI, PRI_XYXY, iou_thresh=0.4)
    assert not step_mod._graphable(torch.device("cpu"), None)
    for i in range(2):
        _, counts = _counted_step(step, state, _batch(i, 2, "cpu"))
        assert counts == {"steps": 1, "replayed": 0, "bn_layers": 20, "bn_fused": 0}


class _EagerGraph:
    """Stands in for ``_StepGraph``: runs the step's losses eagerly and
    reports it replayed, so a test sees which steps the route gave it."""

    calls = 0

    def __init__(self, losses, dev):
        self.losses = losses

    def __call__(self, state, batch):
        type(self).calls += 1
        return self.losses(state, batch), True


@pytest.mark.parametrize("route", ["graphs", "mesh", "nan_checks"])
def test_the_route_takes_the_graphs_only_without_a_mesh_or_nan_checks(route, monkeypatch):
    batch = _batch(3, 2, "cpu")
    mesh = Mesh(None, 1, 0, torch.device("cpu")) if route == "mesh" else None
    plain = _state(0.25, "cpu")
    plain_step = make_train_step(plain.model, PRI, PRI_XYXY, iou_thresh=0.4, mesh=mesh)
    _, m_plain = plain_step(plain, batch)

    real = step_mod._graphable
    monkeypatch.setattr(step_mod, "_graphable", lambda dev, mesh: real(torch.device("cuda"), mesh))
    monkeypatch.setattr(step_mod, "_StepGraph", _EagerGraph)
    monkeypatch.setattr(_EagerGraph, "calls", 0)
    state = _state(0.25, "cpu")
    step = make_train_step(state.model, PRI, PRI_XYXY, iou_thresh=0.4, mesh=mesh)
    if route == "nan_checks":
        debug.enable_nan_checks()
    try:
        m, counts = _counted_step(step, state, batch)
    finally:
        debug.disable_nan_checks()
    graphed = route == "graphs"
    assert counts == {"steps": 1, "replayed": int(graphed), "bn_layers": 20, "bn_fused": 0}
    assert _EagerGraph.calls == int(graphed)
    _assert_equal(_snapshot(state, m), _snapshot(plain, m_plain), route)


class _Recorder(step_mod._StepGraph):
    """``_StepGraph`` with its warm-up, eager steps, capture and replay
    recorded in ``events`` instead of run."""

    def __init__(self):
        super().__init__(lambda state, batch: self.events.append("eager"), torch.device("cpu"))
        self.events = []

    def _warm_up(self, state, batch):
        self.events.append("warm_up")

    def _capture(self, state, batch):
        self.events.append("capture")
        return "graph"

    def _replay(self, g, batch):
        self.events.append("replay")


def test_the_graph_warms_up_captures_replays_and_leaves_other_layouts_eager():
    model = torch.nn.Linear(3, 2)
    state = SimpleNamespace(model=model)
    layouts = {n: Batch(*(torch.zeros(n, k) for k in (3, 4, 1, 1))) for n in (4, 3)}
    g = _Recorder()

    def run(*names, state=state):
        g.events.clear()
        flags = [g(state, layouts[n])[1] for n in names]
        assert flags == [e == "replay" for e in g.events if e != "capture"]
        return list(g.events)

    assert run(4, 4, 4) == ["warm_up", "capture", "replay", "replay"]
    assert run(3, 4, 3, 4) == ["eager", "replay", "eager", "replay"]
    with torch.no_grad():
        model.weight.data = model.weight.data.clone()  # the tensors moved
    assert run(3, 4, 3, 3) == ["warm_up", "eager", "capture", "replay", "replay"]
    assert run(3, state=SimpleNamespace(model=torch.nn.Linear(3, 2))) == ["warm_up"]
    assert run(3, 3) == ["warm_up", "capture", "replay"]  # the first model is another again


def test_the_launch_counters_move_together(monkeypatch):
    from ssdx_torch.ops import pool, stem_train
    monkeypatch.setattr(stem_train, "launches", 5)
    monkeypatch.setattr(pool, "launches_fwd", 7)
    before = ops.launch_counts()
    assert before[("ssdx_torch.ops.stem_train", "launches")] == 5
    assert before[("ssdx_torch.ops.pool", "launches_fwd")] == 7
    assert ops.launches_since(before) == {}
    stem_train.launches += 2
    pool.launches_fwd += 1
    launched = ops.launches_since(before)
    assert launched == {("ssdx_torch.ops.stem_train", "launches"): 2,
                        ("ssdx_torch.ops.pool", "launches_fwd"): 1}
    ops.add_launches(launched, -1)  # a capture's, taken back
    assert ops.launch_counts() == before
    for _ in range(3):  # three replays
        ops.add_launches(launched)
    assert (stem_train.launches, pool.launches_fwd) == (11, 10)


def _trace():
    return Trace(window_s=0.1, busy_s=0.09, ops=[DeviceOp("k", "kernel", 10, 5)])


def _rec(i, **counts):
    return SpanRecord(STEP, i, 0, i, 1, 1000 * i, 1000 * i + 500, counts)


def test_the_replay_share_reads_the_step_span_counts(monkeypatch):
    assert METRIC in {m["name"] for m in core.load_cell("train_bs16", ROOT).per_layer}
    logs = {
        100.0: [_rec(i, steps=1, replayed=1) for i in range(1, 5)],
        50.0: [_rec(1, steps=1, replayed=1), _rec(2, steps=1, replayed=0),
               _rec(3, steps=1, replayed=1), _rec(4, steps=1, replayed=0)],
        None: [_rec(1), _rec(2)],  # the parent's spans: no counts
    }
    for want, log in logs.items():
        monkeypatch.setattr(profiling, "recent_spans", lambda log=log: list(log))
        ctx = core.Context(cell=core.load_cell("train_bs16", ROOT), trace=_trace(),
                           traced_iters=2)
        got = core.per_layer_metrics(ctx, ROOT).get(METRIC)
        if want is None:
            assert got is None
        else:
            assert got == {"value": pytest.approx(want), "unit": "%"}
    ctx = core.Context(cell=core.load_cell("train_bs16", ROOT), trace=None, traced_iters=2)
    assert core.reader(METRIC, ROOT)(ctx) is None  # no traced window: a run off the card


# ---- on the card ----

chip = pytest.mark.chip  # the benchmark's marker of tests that need a card


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _twins(cuda, width_mult):
    """A graph twin and an eager twin from one seed, bf16 on the card, and
    their steps (B3 on the full-width model)."""
    out = []
    for _ in range(2):
        state = _state(width_mult, cuda, torch.bfloat16, seed=7)
        out.append((state, make_train_step(state.model, PRI, PRI_XYXY, iou_thresh=0.4)))
    return out


def _eager_step(step, state, batch):
    debug.enable_nan_checks()  # keeps the eager route; the math is the same
    try:
        return _counted_step(step, state, batch)
    finally:
        debug.disable_nan_checks()


def _launching(run):
    """``run()``'s result and the kernel launches it counted."""
    before = ops.launch_counts()
    out = run()
    return out, ops.launches_since(before)


@chip
@pytest.mark.parametrize("width_mult", [1.0, 0.25])
def test_replayed_steps_equal_eager_steps_bit_for_bit(cuda, width_mult):
    (gs, gstep), (es, estep) = _twins(cuda, width_mult)
    batches = [_batch(10 + i, 4, cuda) for i in range(5)]
    stem_train_ops.launches = 0
    kept = None
    bn = {"bn_layers": 18, "bn_fused": 18} if width_mult == 1.0 else {"bn_layers": 20,
                                                                      "bn_fused": 20}
    for i, b in enumerate(batches):
        (m, counts), launched = _launching(lambda: _counted_step(gstep, gs, b))
        assert counts == {"steps": 1, "replayed": int(i > 0), **bn}, i
        (em, ecounts), elaunched = _launching(lambda: _eager_step(estep, es, b))
        assert ecounts == {"steps": 1, "replayed": 0, **bn}
        assert launched == elaunched, i
        if i == 1:
            kept = (m, {k: v.clone() for k, v in m.items()})
        if i == 3:
            _assert_equal(kept[0], kept[1], "losses kept from step 2")
        _assert_equal(_snapshot(gs, m), _snapshot(es, em), f"step {i + 1}")
    assert all(torch.isfinite(v) for v in m.values())
    assert stem_train_ops.launches == (10 if width_mult == 1.0 else 0)


@chip
def test_a_batch_of_another_shape_runs_eagerly(cuda):
    (gs, gstep), (es, estep) = _twins(cuda, 1.0)
    full = [_batch(20 + i, 4, cuda) for i in range(3)]
    other = _batch(30, 3, cuda)
    order = [full[0], full[1], other, full[2], other]
    stem_train_ops.launches = 0
    replayed = []
    for i, b in enumerate(order):
        m, counts = _counted_step(gstep, gs, b)
        replayed.append(counts["replayed"])
        em, _ = _eager_step(estep, es, b)
        _assert_equal(_snapshot(gs, m), _snapshot(es, em), f"step {i + 1}")
    assert replayed == [0, 1, 0, 1, 0]
    assert stem_train_ops.launches == 2 * len(order)
