"""Pieces every driver uses: rendering scenes in the background, the traced
sub-window, and what a driver hands back to the harness."""
from __future__ import annotations

from dataclasses import dataclass, field

import torch

from ..trace import device_window, reduce


@dataclass
class Outcome:
    """A run as the harness reports it: the window's end-to-end metrics,
    its start on the host's monotonic clock, the answers attempted and
    failed, the numbers compared with the reference, the device's memory
    peak, and what the per-layer readers read."""

    end_to_end: dict
    start: float
    attempted: int
    failed: int
    numbers: dict
    memory_peak: int
    trace: object = None
    traced_iters: int = 0
    batch: int = 0
    window: dict = field(default_factory=dict)
    counters: dict = field(default_factory=dict)
    facts: dict = field(default_factory=dict)
    int8: bool = False


def profile_window(call, iters: int, device):
    """Trace ``iters`` calls of ``call(i)`` inside the span
    ``portbench.trace_window``, which ends once the device is done, with
    the host's calls recorded (to credit each device operation to the
    benchmark's spans and each idle gap to a host call); then ``iters``
    more, ``call(iters + i)``, with the device's activity alone, between two
    marker kernels, for the busy and idle time (recording the host's calls
    slows a host-bound loop).  The reduced ``Trace``, or None off the card."""
    from torch.profiler import ProfilerActivity, profile

    if device.type != "cuda":
        for i in range(iters):
            call(i)
        return None
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with torch.profiler.record_function("portbench.trace_window"):
            for i in range(iters):
                call(i)
            torch.cuda.synchronize()
    out = reduce(prof)
    marker = torch.zeros(1, device=device)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        marker.add_(1)
        for i in range(iters):
            call(iters + i)
        marker.add_(1)
        torch.cuda.synchronize()
    out.busy_s, out.window_s = device_window(prof)
    return out
