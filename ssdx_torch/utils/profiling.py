"""Tracing and timing utilities, the port's counterpart of
``ssdx/utils/profiling.py``.

``trace`` captures a ``torch.profiler`` trace of the enclosed block (CPU
and, on a GPU, CUDA activities) and writes a Chrome trace that Perfetto or
``chrome://tracing`` opens.  ``StepTimer`` and ``time_fn`` time device work
properly: on a CUDA device with CUDA events (PyTorch returns before the
device finishes, so a bare host clock would measure the enqueue), and on the
CPU, where the caller asks for it, with the host clock.

``span`` marks a phase of the program's own paths (``predict_batched``, the
train step) while a ``torch.profiler.profile`` runs, and ``recent_spans``
hands the finished records out.  With no profiler running a span is one
shared object that does nothing.  With one running, it opens a profiler
event of its name (so it shows in ``trace``'s Chrome trace) and logs a
:class:`SpanRecord` whose times are on the clock of the profiler's events
(Unix-epoch nanoseconds), so a record can be set beside the device
operations of the same run, also in a profile that records the device
alone and not the host's calls.
"""
from __future__ import annotations

import collections
import contextlib
import itertools
import threading
import time
from pathlib import Path
from typing import Callable, NamedTuple

import torch
import torch.autograd.profiler as _autograd_profiler

from .. import resolve_device

__all__ = ["trace", "span", "recent_spans", "SpanRecord", "StepTimer", "time_fn"]


@contextlib.contextmanager
def trace(logdir: str = "ssdx_trace", device=None):
    """Profile the enclosed block; yields the ``torch.profiler.profile``
    object (``key_averages()`` gives the sums by kernel) and writes
    ``{logdir}/trace.json`` on exit."""
    dev = resolve_device(device)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    Path(logdir).mkdir(parents=True, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        try:
            yield prof
        finally:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
    prof.export_chrome_trace(str(Path(logdir) / "trace.json"))


class SpanRecord(NamedTuple):
    """One finished span: its name, its id, the id of the span that
    enclosed it on its thread (0 for none), the id of the outermost span
    it ran in (its own for an outermost one), the thread, its start and end
    in Unix-epoch ns (the profiler's clock) and its counts."""

    name: str
    id: int
    parent: int
    root: int
    thread: int
    start_ns: int
    end_ns: int
    counts: dict


# The profiler's event of a span: PyTorch's C++ RecordFunction context, which
# its compiled code marks regions with. Under a CPU profile it costs ~2 us a
# span against ~25 us for ``torch.profiler.record_function``, and it runs no
# Python between its timestamps and the record's, which enclose them.
_record_function = torch._C._profiler._RecordFunctionFast
SPAN_LOG_SIZE = 65_536  # records kept; a longer profile keeps the newest
_LOG: collections.deque = collections.deque(maxlen=SPAN_LOG_SIZE)
_ids = itertools.count(1)
_local = threading.local()


class _NullSpan:
    """What ``span`` returns while no profiler runs: enters, counts and
    exits doing nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def count(self, **counts) -> None:
        pass


_NULL_SPAN = _NullSpan()


class _Span:
    __slots__ = ("name", "counts", "id", "parent", "root", "_rf", "_start")

    def __init__(self, name: str, counts: dict):
        self.name, self.counts = name, counts

    def __enter__(self):
        if not hasattr(_local, "stack"):
            _local.stack = []
        stack = _local.stack
        self.id = next(_ids)
        outer = stack[-1] if stack else None
        self.parent, self.root = (outer.id, outer.root) if outer else (0, self.id)
        stack.append(self)
        self._rf = _record_function(self.name)
        self._start = time.time_ns()
        self._rf.__enter__()
        return self

    def __exit__(self, *exc):
        self._rf.__exit__(*exc)
        end = time.time_ns()
        _local.stack.pop()
        _LOG.append(SpanRecord(self.name, self.id, self.parent, self.root,
                               threading.get_ident(), self._start, end, self.counts))
        return False

    def count(self, **counts) -> None:
        """Add counts known only inside the span."""
        self.counts.update(counts)


def span(name: str, **counts):
    """A context manager around one phase, named ``ssdx_torch.<module>.<phase>``.

    ``counts`` (and ``count(**counts)`` on what ``with`` yields) are
    numbers or tensors; a tensor is kept as it is and reduced, to the sum
    of its elements (a mask counts its True entries), only by
    :func:`recent_spans`, so a span launches no kernel and waits for no
    device.  Without a running profiler this returns one shared object and
    reads no clock."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NULL_SPAN
    return _Span(name, counts)


def _number(v):
    return v.sum().item() if isinstance(v, torch.Tensor) else v


def recent_spans() -> list[SpanRecord]:
    """The spans finished since the last call, oldest first, with their
    counts as Python numbers (tensors reduced here, after any window that
    was timed); empties the log."""
    out = []
    while _LOG:
        r = _LOG.popleft()
        out.append(r._replace(counts={k: _number(v) for k, v in r.counts.items()}))
    return out


class StepTimer:
    """Accumulate the time of device steps, in seconds.

    >>> t = StepTimer(device="cpu")
    >>> with t:
    ...     pass
    >>> len(t.times)
    1
    """

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self.times: list[float] = []
        self._t0 = 0.0
        self._events = None

    def __enter__(self):
        if self.device.type == "cuda":
            self._events = (torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True))
            self._events[0].record(torch.cuda.current_stream(self.device))
        else:
            self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.device.type == "cuda":
            start, end = self._events
            end.record(torch.cuda.current_stream(self.device))
            end.synchronize()
            self.times.append(start.elapsed_time(end) * 1e-3)
        else:
            self.times.append(time.perf_counter() - self._t0)
        return False

    @property
    def mean(self) -> float:
        return sum(self.times) / max(len(self.times), 1)

    @property
    def total(self) -> float:
        return sum(self.times)


def time_fn(fn: Callable, *args, n_warmup: int = 2, n_iters: int = 20, device=None) -> float:
    """Mean seconds per call of ``fn(*args)`` after ``n_warmup`` calls."""
    dev = resolve_device(device)
    for _ in range(n_warmup):
        fn(*args)
    timer = StepTimer(dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    with timer:
        for _ in range(n_iters):
            fn(*args)
    return timer.total / n_iters
