"""Share of its roofline that the serving stem kernel B2 reaches, in
percent: the least time of conv1_1 + conv1_2 + pool at the batch's shape
(``portbench.flops.stem_bound_s``, by operations at the bf16 peak) over
the device time of the ``stem_kernel`` launches, per batch."""
from portbench.flops import stem_bound_s


def read(ctx):
    t = ctx.trace
    if t is None or not ctx.traced_iters:
        return None
    ops = t.select(kind="kernel", where=lambda o: "stem_kernel" in o.name)
    if not ops:
        return None
    per_batch = sum(o.dur_ns for o in ops) * 1e-9 / ctx.traced_iters
    return 100.0 * stem_bound_s(ctx.batch) / per_batch
