"""Device time a batch of the forward's glue, in ms: the kernels launched
inside the benchmark's span around ``Detector.forward`` that are neither
the stem kernel, the int8 convs nor the library's convolutions (the
elementwise work, casts, gathers, pools and layout copies)."""
from portbench.trace import group


def read(ctx):
    t = ctx.trace
    if t is None or not ctx.traced_iters:
        return None
    ops = t.select(span="portbench.forward", kind="kernel", where=lambda o: group(o.name) == "other")
    return sum(o.dur_ns for o in ops) * 1e-6 / ctx.traced_iters if ops else None
