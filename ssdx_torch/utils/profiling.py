"""Tracing and timing utilities, the port's counterpart of
``ssdx/utils/profiling.py``.

``trace`` captures a ``torch.profiler`` trace of the enclosed block (CPU
and, on a GPU, CUDA activities) and writes a Chrome trace that Perfetto or
``chrome://tracing`` opens.  ``StepTimer`` and ``time_fn`` time device work
properly: on a CUDA device with CUDA events (PyTorch returns before the
device finishes, so a bare host clock would measure the enqueue), and on the
CPU, where the caller asks for it, with the host clock.
"""
from __future__ import annotations

import contextlib
import time
from pathlib import Path
from typing import Callable

import torch

from .. import resolve_device

__all__ = ["trace", "StepTimer", "time_fn"]


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
