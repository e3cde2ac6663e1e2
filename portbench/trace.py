"""Reduction of a ``torch.profiler`` trace to what the per-layer metrics read.

The benchmark wraps the calls it makes into the program in spans of its
own (``torch.profiler.record_function`` named ``portbench.<layer>``).
Every device operation (kernel, copy, fill) is tied to the host call that
launched it through the profiler's correlation ids, and so to the
benchmark spans open on that thread at the launch: that is how a kernel is
credited to the forward, the postprocess or the train step without any
span inside the program.

``group`` and ``train_group`` sort kernels by name as the program's own
profiling tools do (``tools/profile_serving.py::group``,
``tools/profile_training.py::group``); frozen copies, so that a later
change to those tools leaves the yardstick where it is.  ``nvjet`` (the
names of cuBLAS's Hopper kernels) counts with the convolutions.
"""
from __future__ import annotations

import bisect
from collections import defaultdict
from dataclasses import dataclass, field

_CONV_KEYS = ("conv", "xmma", "cudnn", "implicit", "gemm", "sm90", "wgrad", "dgrad", "nvjet")
B3_KERNELS = ("conv1_stats_kernel", "stage2_kernel", "pool_kernel", "route_kernel",
              "dw2_kernel", "dw1_kernel", "colsum_kernel")


def group(name: str) -> str:
    """Serving groups: stem, nms, int8 conv, conv, sort, other."""
    n = name.lower()
    if "stem_kernel" in n:
        return "stem"
    if "nms_" in n:
        return "nms"
    if "::conv_kernel<" in n:  # before the cuDNN test: "conv" is in its name
        return "int8_conv"
    if any(k in n for k in _CONV_KEYS):
        return "conv"
    if "sort" in n or "radix" in n:
        return "sort"
    return "other"


def train_group(name: str) -> str:
    """Training groups: b3, conv, reduction, optimizer, sort, elementwise."""
    n = name.lower()
    if any(k in n for k in B3_KERNELS):
        return "b3"
    if any(k in n for k in _CONV_KEYS):
        return "conv"
    if "batch_norm" in n or "batchnorm" in n or "welford" in n or "reduce" in n:
        return "reduction"
    if "multi_tensor" in n or "foreach" in n:
        return "optimizer"
    if "sort" in n or "radix" in n or "scan" in n:
        return "sort"
    return "elementwise"


@dataclass
class DeviceOp:
    name: str
    kind: str  # kernel | memcpy | memset
    start_ns: int
    dur_ns: int
    spans: frozenset = frozenset()  # benchmark spans open at its launch


@dataclass
class Trace:
    """A traced window: ``window_s`` of host time from the window span's
    start to its end (which synchronizes), ``busy_s`` of it with an
    operation on the device, the operations, and the idle time by what the
    host was doing meanwhile.  ``profile_window`` replaces ``window_s`` and
    ``busy_s`` by those of a second window traced without the host."""

    window_s: float
    busy_s: float
    ops: list = field(default_factory=list)
    idle_by_host: dict = field(default_factory=dict)

    def select(self, span=None, kind=None, where=None) -> list:
        return [o for o in self.ops
                if (span is None or span in o.spans) and (kind is None or o.kind == kind)
                and (where is None or where(o))]

    def breakdown(self, top: int = 10) -> dict:
        by = defaultdict(float)
        for o in self.ops:
            by[o.name] += o.dur_ns * 1e-9
        ops = sorted(by.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.idle_by_host.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n, s] for n, s in ops], "idle_gaps": [[n, s] for n, s in gaps]}


def _kind(e) -> str | None:
    at = e.activity_type() if hasattr(e, "activity_type") else ""
    name = e.name()
    if at == "gpu_memcpy" or name.startswith("Memcpy"):
        return "memcpy"
    if at == "gpu_memset" or name.startswith("Memset"):
        return "memset"
    if at in ("kernel", "concurrent_kernel") or (not at and not name.startswith("portbench.")):
        return "kernel"
    return None


def reduce(prof, window: str = "portbench.trace_window") -> Trace:
    """The ``Trace`` of the span named ``window`` in a finished profile."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    events = prof.profiler.kineto_results.events()
    spans = defaultdict(list)  # thread -> [(start, end, name)]
    launches = {}  # correlation id -> (thread, start) of the host call
    host = defaultdict(list)  # thread -> [(start, end, name)] of host calls
    dev = []
    for e in events:
        if e.device_type() == cuda:
            k = _kind(e)
            if k is not None and e.duration_ns() > 0:
                dev.append((e, k))
            continue
        name = e.name()
        t = e.start_thread_id()
        if name.startswith("portbench."):
            spans[t].append((e.start_ns(), e.end_ns(), name))
        else:
            host[t].append((e.start_ns(), e.end_ns(), name))
            launches.setdefault(e.correlation_id(), (t, e.start_ns()))
    win = [s for ss in spans.values() for s in ss if s[2] == window]
    if not win:
        raise RuntimeError(f"the trace has no span {window!r}")
    w0, w1, _ = win[0]
    out = Trace(window_s=(w1 - w0) * 1e-9, busy_s=0.0)
    for e, k in dev:
        s, d = e.start_ns(), e.duration_ns()
        if s + d <= w0 or s >= w1:
            continue
        at = launches.get(e.correlation_id()) or launches.get(e.linked_correlation_id())
        names = frozenset()
        if at is not None:
            t, ts = at
            names = frozenset(n for a, b, n in spans.get(t, ()) if a <= ts <= b)
        out.ops.append(DeviceOp(e.name(), k, s, d, names))
    busy, gaps = _union([(max(o.start_ns, w0), min(o.start_ns + o.dur_ns, w1))
                         for o in out.ops], w0, w1)
    out.busy_s = busy * 1e-9
    # what the host was doing during each idle gap: the latest-started host
    # call or benchmark span still running at the gap's middle
    calls = sorted([c for cs in host.values() for c in cs]
                   + [s for ss in spans.values() for s in ss if s[2] != window])
    starts = [c[0] for c in calls]
    for a, b in gaps:
        if b - a < _SHORT_GAP_NS:
            name = "(gaps under 10 us between operations)"
        else:
            mid = (a + b) // 2
            name = "(no host call)"
            i = bisect.bisect_right(starts, mid) - 1
            for j in range(i, max(i - _LOOKBACK, -1), -1):
                if calls[j][1] >= mid:
                    name = calls[j][2]
                    break
        out.idle_by_host[name] = out.idle_by_host.get(name, 0.0) + (b - a) * 1e-9
    return out


def _union(intervals, w0: int, w1: int) -> tuple[int, list]:
    """(ns covered by the union of ``intervals`` inside [w0, w1], the gaps)."""
    busy, gaps, cur_s, cur_e = 0, [], None, w0
    for a, b in sorted(intervals):
        if cur_s is None or a > cur_e:
            if a > cur_e:
                gaps.append((cur_e, a))
            if cur_s is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = a, b
        else:
            cur_e = max(cur_e, b)
    if cur_s is not None:
        busy += cur_e - cur_s
    if w1 > cur_e:
        gaps.append((cur_e, w1))
    return busy, gaps


def device_window(prof) -> tuple[float, float]:
    """(busy_s, window_s) of a profile that records device activity alone,
    without the host calls whose recording slows the host: the window runs
    from the start of its first operation to the end of its last, which
    ``drivers.common.profile_window`` makes two marker kernels."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    iv = [(e.start_ns(), e.start_ns() + e.duration_ns())
          for e in prof.profiler.kineto_results.events()
          if e.device_type() == cuda and _kind(e) is not None and e.duration_ns() > 0]
    if not iv:
        raise RuntimeError("the device-only trace holds no operation")
    w0, w1 = min(a for a, _ in iv), max(b for _, b in iv)
    busy, _ = _union(iv, w0, w1)
    return busy * 1e-9, (w1 - w0) * 1e-9


_SHORT_GAP_NS = 10_000
_LOOKBACK = 20_000
