"""The input copy of ``Detector.forward`` staged through pinned host memory
(``ssdx_torch.api.Detector._stage``) and the reader of its counts.

On the CPU:
* the host's cast that staging makes (``Tensor.copy_`` from float32 into
  bfloat16) is bit for bit numpy's round to nearest even, on ties,
  subnormals, +-inf, +-0 and values near the bf16 maximum, and on whole
  batches of B = 1, 7, 32 and 33 images, which the copy splits over its
  intra-op threads;
* a CPU detector bypasses the staging: its span counts 0 staged bytes and
  its heads equal those of ``torch.as_tensor`` and the network;
* ``input_staged_share.*`` gives 100, 50 and None from span logs with all,
  half and none of the bytes staged.

On a CUDA card (``chip``; skipped without one), at full width, bf16 and
int8: the heads bit-identical to the pageable copy's at B = 1, 7, 32 and
33; back-to-back calls and two threads returning each batch's own result;
the span's counts equal; a CUDA tensor bypassing the staging.  Run there with
``python -m pytest --noconftest -p no:cacheprovider tests/test_torch_input_staging.py``.
This file imports neither JAX nor the JAX package.
"""
from __future__ import annotations

import threading
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from portbench import core
from portbench.trace import DeviceOp, Trace
from ssdx_torch.api import Detector
from ssdx_torch.utils import profiling
from ssdx_torch.utils.profiling import SpanRecord

ROOT = Path(__file__).resolve().parents[1]
CLASSES = {"car": 0, "truck": 1, "bus": 2, "van": 3, "bike": 4}
SPAN = "ssdx_torch.api.input_copy"


def _rne_bf16(x: np.ndarray) -> np.ndarray:
    """numpy's float32 -> bfloat16 bits, rounding to nearest even."""
    u = x.astype(np.float32).view(np.uint32).astype(np.uint64)
    return ((u + 0x7FFF + ((u >> 16) & 1)) >> 16).astype(np.uint16)


SPECIAL_BITS = [
    0x3F808000, 0x3F818000, 0xBF808000, 0x3F80C000, 0x3F807FFF, 0x3F808001,  # ties, near ties
    0x00000001, 0x00008000, 0x00018000, 0x00400000, 0x007FFFFF, 0x807FFFFF,  # subnormals
    0x7F800000, 0xFF800000, 0x00000000, 0x80000000,  # +-inf, +-0
    0x7F7F7FFF, 0x7F7F8000, 0x7F7FFFFF, 0xFF7F8000, 0x7F7EFFFF, 0x7F7E8000,  # near the max
]


def _cast_cases():
    rng = np.random.default_rng(3)
    normal = rng.standard_normal((5, 300, 300, 3), dtype=np.float32)
    ties = (rng.integers(0, 1 << 31, (5, 300, 300, 3), dtype=np.uint32) & ~np.uint32(0xFFFF)
            | np.uint32(0x8000)).view(np.float32)
    ties[~np.isfinite(ties)] = 1.0
    special = np.array(SPECIAL_BITS * 6, np.uint32).view(np.float32).reshape(-1, 4, 3)
    return {"normal": normal, "ties": ties, "special": special}


def _host_cast(x: np.ndarray) -> np.ndarray:
    """The bits of ``x`` cast to bfloat16 on the host as ``Detector._stage``
    casts it (into a pinned buffer on a CUDA machine, which the CPU build
    of PyTorch cannot allocate)."""
    got = torch.empty(x.shape, dtype=torch.bfloat16).copy_(torch.from_numpy(x))
    return got.view(torch.int16).numpy().view(np.uint16)


@pytest.mark.parametrize("case", ["normal", "ties", "special"])
def test_the_host_cast_into_a_slot_rounds_to_nearest_even(case):
    x = _cast_cases()[case]
    np.testing.assert_array_equal(_host_cast(x), _rne_bf16(x))


@pytest.mark.parametrize("batch", [1, 7, 32, 33])
def test_the_host_cast_of_a_batch_rounds_to_nearest_even(batch):
    rng = np.random.default_rng(batch)
    x = rng.standard_normal((batch, 300, 300, 3), dtype=np.float32)
    tie = rng.random(x.shape) < 0.25  # a quarter of the values exactly halfway
    x[tie] = (x[tie].view(np.uint32) & ~np.uint32(0xFFFF) | np.uint32(0x8000)).view(np.float32)
    np.testing.assert_array_equal(_host_cast(x), _rne_bf16(x))


@pytest.fixture(scope="module")
def cpu_detector():
    return Detector(CLASSES, width_mult=0.125, device="cpu")


@pytest.fixture(scope="module")
def images():
    return np.random.default_rng(0).normal(0, 1, (2, 300, 300, 3)).astype(np.float32)


def _forward_spans(det, images):
    profiling.recent_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        out = det.forward(images)
    return out, [r for r in profiling.recent_spans() if r.name == SPAN]


@pytest.mark.parametrize("as_tensor", [False, True])
def test_a_cpu_detector_bypasses_the_ring(cpu_detector, images, as_tensor):
    x = torch.from_numpy(images) if as_tensor else images
    (loc, conf), recs = _forward_spans(cpu_detector, x)
    assert [r.counts for r in recs] == [{"input_bytes": images.nbytes, "staged_bytes": 0}]
    with torch.inference_mode():
        want = cpu_detector._forward_local(torch.as_tensor(images, device="cpu"))
    assert torch.equal(loc, want[0]) and torch.equal(conf, want[1])


def _trace():
    return Trace(window_s=0.1, busy_s=0.05, ops=[DeviceOp("copy", "memcpy", 10, 5)])


def _rec(i, **counts):
    return SpanRecord(SPAN, i, 0, i, 1, 1000 * i, 1000 * i + 500, counts)


@pytest.mark.parametrize("cell,suffix", [("bf16_batch32", "serve"), ("int8_batch32", "int8")])
def test_the_staged_share_reads_the_span_counts(cell, suffix, monkeypatch):
    mb = 34_560_000
    logs = {
        100.0: [_rec(1, input_bytes=mb, staged_bytes=mb), _rec(2, input_bytes=mb, staged_bytes=mb)],
        50.0: [_rec(1, input_bytes=mb, staged_bytes=mb), _rec(2, input_bytes=mb, staged_bytes=0),
               _rec(3)],  # a record without the counts (the parent's) is left out
        None: [_rec(1), _rec(2)],
    }
    name = f"input_staged_share.{suffix}"
    assert name in {m["name"] for m in core.load_cell(cell, ROOT).per_layer}
    for want, log in logs.items():
        monkeypatch.setattr(profiling, "recent_spans", lambda log=log: list(log))
        ctx = core.Context(cell=core.load_cell(cell, ROOT), trace=_trace(), traced_iters=2)
        got = core.per_layer_metrics(ctx, ROOT).get(name)
        if want is None:
            assert got is None
        else:
            assert got == {"value": pytest.approx(want), "unit": "%"}
    ctx = core.Context(cell=core.load_cell(cell, ROOT), trace=None, traced_iters=2)
    assert core.reader(name, ROOT)(ctx) is None  # no traced window: a run off the card


# ---- on the card ----

chip = pytest.mark.chip  # the benchmark's marker of tests that need a card


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def detectors(cuda):
    """The serving detectors at full width, random weights: bf16 and int8."""
    kw = dict(fold_bn=True, stem_kernel=True, dtype=torch.bfloat16, device=cuda, rng_seed=5)
    bf16, int8 = Detector(CLASSES, **kw), Detector(CLASSES, **kw)
    int8.quantize_int8(np.random.default_rng(1).normal(0, 1, (16, 300, 300, 3)).astype(np.float32))
    return {"bf16": bf16, "int8": int8}


def _pageable(det, x):
    """The heads as the pageable copy made them before staging."""
    with torch.inference_mode():
        return det._forward_local(torch.as_tensor(x, device=det.device))


def _batch(b, seed):
    return np.random.default_rng(seed).normal(0, 1, (b, 300, 300, 3)).astype(np.float32)


def _equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


@chip
@pytest.mark.parametrize("kind", ["bf16", "int8"])
@pytest.mark.parametrize("batch", [1, 7, 32, 33])
def test_the_staged_heads_equal_the_pageable_copys(detectors, kind, batch):
    det = detectors[kind]
    x = _batch(batch, batch)
    got = det.forward(x)
    assert _equal(got, _pageable(det, x))
    assert _equal(det.forward(torch.from_numpy(x)), got)


@chip
def test_back_to_back_calls_return_each_batchs_own_result(detectors, cuda):
    det = detectors["bf16"]
    xs = [_batch(12, 100 + i) for i in range(6)]
    want = [_pageable(det, x) for x in xs]
    torch.cuda.synchronize(cuda)
    got = []
    for x in xs:
        got.append(det.forward(x))
        x[:] = 0.0  # the caller's array is free again once forward returns
    assert all(_equal(g, w) for g, w in zip(got, want))


@chip
def test_two_threads_get_what_two_calls_in_turn_get(detectors):
    det = detectors["bf16"]
    xs = {0: _batch(8, 200), 1: _batch(32, 201)}
    want = {k: det.predict(x) for k, x in xs.items()}
    got, errors = {}, []

    def work(k):
        try:
            for _ in range(5):
                got.setdefault(k, []).append(det.predict(xs[k]))
        except Exception as e:  # reported below, after the join
            errors.append(e)

    threads = [threading.Thread(target=work, args=(k,)) for k in xs]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errors and not any(t.is_alive() for t in threads)
    for k, runs in got.items():
        assert len(runs) == 5
        for run in runs:
            for a, b in zip(run, want[k]):
                assert all(np.array_equal(a[f], b[f]) for f in ("labels", "scores", "boxes"))


@chip
def test_the_span_counts_every_byte_staged(detectors, cuda):
    det = detectors["int8"]
    x = _batch(33, 300)
    _, recs = _forward_spans(det, x)
    assert [r.counts for r in recs] == [{"input_bytes": x.nbytes, "staged_bytes": x.nbytes}]
    (_, want), recs = _forward_spans(det, torch.from_numpy(x).to(cuda))
    assert [r.counts for r in recs] == [{"input_bytes": x.nbytes, "staged_bytes": 0}]
    assert torch.equal(want, _pageable(det, x)[1])
