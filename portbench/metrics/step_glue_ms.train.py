"""Device time a train step of its glue, in ms: the elementwise and
reduction kernels of the step (BatchNorm in float32, matching, the loss,
casts), grouped by name as ``portbench.trace.train_group`` does, that is
every kernel but the stem kernel B3, the library's convolutions, the
optimizer's fused updates and the sorts."""
from portbench.trace import train_group


def read(ctx):
    t = ctx.trace
    if t is None or not ctx.traced_iters:
        return None
    ops = t.select(kind="kernel",
                   where=lambda o: train_group(o.name) in ("elementwise", "reduction"))
    return sum(o.dur_ns for o in ops) * 1e-6 / ctx.traced_iters if ops else None
