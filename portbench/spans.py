"""The program's own spans, as the per-layer readers see them.

``ssdx_torch.utils.profiling.span`` logs a record for each phase of
``predict_batched``, ``to_pylist`` and the train step while a profiler
runs; ``recent_spans()`` hands them out and empties the log.  A run reads
them once (``records``, cached against the run's ``Context``) and the
readers pick from them:

* host times from the device-only traced window alone, where recording the
  host's calls does not slow the host (``host_ms``): the records whose
  outermost span (one ``predict_batched``, ``to_pylist`` or train step)
  started after the last device operation of the host-recorded window
  (``Context.trace.ops``) ended.  Judging by the outermost span keeps the
  host-recorded window's last ``to_pylist.unpack`` out, though it starts
  within tens of microseconds of its own copies' end;
* counts from every traced batch (``count_share``).

A program without spans (no ``recent_spans``, or an empty log) gives
``None``, so its metrics are left out of the line.
"""
from __future__ import annotations

_cached: tuple = (None, None)  # (the Context read, its records)


def records(ctx) -> list | None:
    """Every span record of this run, read from the program once."""
    global _cached
    if _cached[0] is not ctx:
        try:
            from ssdx_torch.utils.profiling import recent_spans
        except ImportError:
            recs = None
        else:
            recs = recent_spans() or None
        _cached = (ctx, recs)
    return _cached[1]


def device_only(ctx) -> list | None:
    """The records of the device-only window: those whose outermost span
    started after the host-recorded window's last device operation ended."""
    recs, t = records(ctx), ctx.trace
    if not recs or t is None or not t.ops or not ctx.traced_iters:
        return None
    last = max(o.start_ns + o.dur_ns for o in t.ops)
    root_start = {r.id: r.start_ns for r in recs if r.root == r.id}
    return [r for r in recs if root_start.get(r.root, r.start_ns) > last]


def host_ms(ctx, name: str) -> float | None:
    """Host time an iteration of span ``name`` in the device-only window,
    in ms: the mean over the window's iterations, each of which opens the
    span once (another count means the window was not told apart, and
    gives None)."""
    recs = device_only(ctx)
    if recs is None:
        return None
    hits = [r for r in recs if r.name == name]
    if len(hits) != ctx.traced_iters:
        return None
    return sum(r.end_ns - r.start_ns for r in hits) * 1e-6 / ctx.traced_iters


def count_share(ctx, name: str, part: str, whole: str) -> float | None:
    """100 x the sum of count ``part`` over the sum of count ``whole``
    across every record of span ``name`` in the traced run."""
    recs = records(ctx)
    if not recs or ctx.trace is None:
        return None
    hits = [r.counts for r in recs if r.name == name and whole in r.counts and part in r.counts]
    total = sum(c[whole] for c in hits)
    return 100.0 * sum(c[part] for c in hits) / total if total else None
