"""The port's spans (``ssdx_torch.utils.profiling.span`` / ``recent_spans``)
on the CPU.

* With no profiler running, ``span`` is one shared object and the serving
  and training paths leave the log empty.
* Under a CPU ``torch.profiler.profile``, ``predict_batched`` +
  ``to_pylist`` and one train step (width 0.25) emit their spans with the
  right parents and roots, and each record's start and end lie within
  0.2 ms of the profiler's event of the same name (the records are on the
  profiler's clock).
* ``postprocess``'s ``nms_candidates`` count equals the number of stage-2
  scores above the threshold, computed here from the logits with numpy;
  ``nms_slots`` is B x K.
* The log keeps at most ``SPAN_LOG_SIZE`` records, the newest, and
  ``recent_spans`` empties it.
"""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from ssdx_torch import priors as P
from ssdx_torch.api import Detector
from ssdx_torch.model import SSD300, init_variables
from ssdx_torch.predict import to_pylist
from ssdx_torch.train.schedule import build_optimizer
from ssdx_torch.train.step import Batch, create_train_state, make_train_step
from ssdx_torch.utils import profiling

CLASSES = {"car": 0, "truck": 1, "bus": 2, "van": 3, "bike": 4}
SERVE = ("ssdx_torch.api.predict_batched", "ssdx_torch.api.input_copy",
         "ssdx_torch.api.network", "ssdx_torch.predict.postprocess")
READBACK = ("ssdx_torch.predict.to_pylist", "ssdx_torch.predict.to_pylist.wait",
            "ssdx_torch.predict.to_pylist.unpack")
TRAIN = ("ssdx_torch.train.step", "ssdx_torch.train.batch_copy", "ssdx_torch.train.forward",
         "ssdx_torch.train.targets_loss", "ssdx_torch.train.backward",
         "ssdx_torch.train.optimizer")
TOL_NS = 200_000


def _profile():
    return profile(activities=[ProfilerActivity.CPU])


@pytest.fixture(scope="module")
def detector():
    return Detector(CLASSES, width_mult=0.125, device="cpu")


@pytest.fixture(scope="module")
def images():
    return np.random.default_rng(0).normal(0, 1, (2, 300, 300, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def train():
    model = SSD300(6, width_mult=0.25)
    opt, sched = build_optimizer(model.parameters(), steps_per_epoch=10, max_epochs=2,
                                 warmup_epochs=0, base_lr=1e-3)
    state = create_train_state(model, opt, sched, init_variables(6, 0, 0.25))
    pri = P.create_priors()
    step = make_train_step(model, pri, P.priors_xyxy(pri), iou_thresh=0.4)
    rng = np.random.default_rng(1)
    lo = rng.uniform(0.1, 0.5, (2, 4, 2))
    boxes = np.concatenate([lo, lo + 0.3], -1).astype(np.float32)
    batch = Batch(rng.normal(0, 1, (2, 300, 300, 3)).astype(np.float32), boxes,
                  rng.integers(0, 5, (2, 4)).astype(np.int32), np.ones((2, 4), bool))
    return state, step, batch


@pytest.fixture(autouse=True)
def empty_log():
    """Each test starts with an empty log; the first span a process opens
    under a profiler pays a one-off set-up, taken here outside the test."""
    with _profile():
        with profiling.span("warm-up"):
            pass
    profiling.recent_spans()
    yield
    profiling.recent_spans()


def test_without_a_profiler_a_span_is_one_shared_object_and_logs_nothing(
        detector, images, train):
    a = profiling.span("a")
    b = profiling.span("b", n=torch.ones(3))
    assert a is b
    with a as handle:
        handle.count(n=1)
    state, step, batch = train
    to_pylist(detector.predict_batched(images))
    step(state, batch)
    assert profiling.recent_spans() == []


def _by_name(records):
    out = {}
    for r in records:
        out.setdefault(r.name, []).append(r)
    return out


def _check_tree(recs, root, children):
    (top,) = recs[root]
    assert top.parent == 0 and top.root == top.id
    for name in children:
        (r,) = recs[name]
        assert r.parent == top.id and r.root == top.id, name
        assert top.start_ns <= r.start_ns <= r.end_ns <= top.end_ns, name


def _check_clock(prof, records):
    """Each record beside the profiler's event of its name, in order."""
    events = {}
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith("ssdx_torch."):
            events.setdefault(e.name(), []).append(e)
    for name, recs in _by_name(records).items():
        evs = sorted(events[name], key=lambda e: e.start_ns())
        assert len(evs) == len(recs), name
        for r, e in zip(recs, evs):
            assert abs(r.start_ns - e.start_ns()) < TOL_NS, (name, r.start_ns - e.start_ns())
            assert abs(r.end_ns - e.end_ns()) < TOL_NS, (name, r.end_ns - e.end_ns())


def test_serving_spans_have_their_parents_and_the_profiler_clock(detector, images):
    with _profile() as prof:
        det = detector.predict_batched(images)
        out = to_pylist(det)
    assert len(out) == 2
    records = profiling.recent_spans()
    recs = _by_name(records)
    assert set(recs) == set(SERVE + READBACK)
    _check_tree(recs, SERVE[0], SERVE[1:])
    _check_tree(recs, READBACK[0], READBACK[1:])
    assert recs[SERVE[0]][0].root != recs[READBACK[0]][0].root
    (pp,) = recs["ssdx_torch.predict.postprocess"]
    assert pp.counts["nms_slots"] == 2 * 400
    assert isinstance(pp.counts["nms_candidates"], int)
    assert 0 <= pp.counts["nms_candidates"] <= 2 * 400
    _check_clock(prof, records)


def test_train_step_spans_have_their_parents_and_the_profiler_clock(train):
    state, step, batch = train
    with _profile() as prof:
        step(state, batch)
    records = profiling.recent_spans()
    recs = _by_name(records)
    assert set(recs) == set(TRAIN)
    _check_tree(recs, TRAIN[0], TRAIN[1:])
    phases = [recs[n][0] for n in TRAIN[1:]]
    assert all(a.end_ns <= b.start_ns for a, b in zip(phases, phases[1:]))
    _check_clock(prof, records)


def _candidates_apart(loc, conf, thresh, prior_top_k=200, k=400):
    """Stage-2 scores above ``thresh``, counted from the logits alone: the
    ``prior_top_k`` priors by best foreground log-probability, their
    foreground softmax scores, the best ``k`` of those."""
    n = 0
    for c in conf.astype(np.float64):
        logp = c - np.log(np.exp(c).sum(-1, keepdims=True))
        key = logp[:, 1:].max(-1)
        sel = np.argsort(-key, kind="stable")[:prior_top_k]
        scores = np.sort(np.exp(logp[sel, 1:]).ravel())[::-1][:k]
        n += int((scores > thresh).sum())
    return n


def test_nms_candidates_count_the_scores_above_the_threshold(detector):
    rng = np.random.default_rng(5)
    B, npri = 3, len(P.create_priors())
    conf = rng.normal(0, 1, (B, npri, 6)).astype(np.float32)
    conf[..., 0] += 3.0  # background everywhere but at the spikes
    hot = rng.integers(0, npri, (B, 150))
    for b in range(B):
        conf[b, hot[b], rng.integers(1, 6, 150)] += rng.uniform(2, 7, 150).astype(np.float32)
    loc = rng.normal(0, 0.5, (B, npri, 4)).astype(np.float32)
    with _profile():
        detector.predict_batched(pre_loc_all=loc, pre_conf_all=conf, score_thresh=0.3)
    (pp,) = [r for r in profiling.recent_spans() if r.name == "ssdx_torch.predict.postprocess"]
    want = _candidates_apart(loc, conf, 0.3)
    assert 0 < want < B * 400
    kept = pp.counts.pop("nms_kept")  # the candidates NMS keeps
    assert pp.counts == {"nms_candidates": want, "nms_slots": B * 400}
    assert 0 < kept < want


def test_the_log_keeps_the_newest_records_up_to_its_bound():
    assert profiling._LOG.maxlen == profiling.SPAN_LOG_SIZE
    n = profiling.SPAN_LOG_SIZE + 7
    with _profile():
        for i in range(n):
            with profiling.span("s", i=i):
                pass
    records = profiling.recent_spans()
    assert len(records) == profiling.SPAN_LOG_SIZE
    assert [r.counts["i"] for r in records[:2]] == [7, 8] and records[-1].counts["i"] == n - 1


def test_recent_spans_empties_the_log_and_reduces_tensor_counts():
    mask = torch.tensor([[True, False, True], [True, True, False]])
    with _profile():
        with profiling.span("outer", n=mask) as outer:
            outer.count(total=torch.tensor(2.5), plain=3)
            with profiling.span("inner"):
                pass
    first = profiling.recent_spans()
    assert [r.name for r in first] == ["inner", "outer"]
    inner, outer = first
    assert inner.parent == outer.id and inner.root == outer.id
    assert outer.counts == {"n": 4, "total": 2.5, "plain": 3}
    assert profiling.recent_spans() == []
