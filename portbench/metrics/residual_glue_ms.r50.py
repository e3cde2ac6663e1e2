"""Device time a batch of the trunk's glue, in ms: the kernels inside
``portbench.trunk`` that ``portbench.trace.group`` puts in "other" (the
residual adds, the ReLUs, the max pool, casts and layout copies), that is
the trunk's memory-bound work beside its convolutions."""
from portbench.trace import group


def read(ctx):
    t = ctx.trace
    if t is None or not ctx.traced_iters:
        return None
    ops = t.select(span="portbench.trunk", kind="kernel", where=lambda o: group(o.name) == "other")
    return sum(o.dur_ns for o in ops) * 1e-6 / ctx.traced_iters if ops else None
