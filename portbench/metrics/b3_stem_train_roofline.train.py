"""Share of its roofline that the train stem kernel B3 reaches, in
percent: the least time of the stem's forward and backward at the step's
batch (``portbench.flops.stem_train_bound_s``, 0.3321 ms at 16 by
operations) over the device time of B3's launches, per step."""
from portbench.flops import stem_train_bound_s
from portbench.trace import train_group


def read(ctx):
    t = ctx.trace
    if t is None or not ctx.traced_iters:
        return None
    ops = t.select(kind="kernel", where=lambda o: train_group(o.name) == "b3")
    if not ops:
        return None
    per_step = sum(o.dur_ns for o in ops) * 1e-9 / ctx.traced_iters
    return 100.0 * stem_train_bound_s(ctx.batch) / per_step
