"""Share of their roofline that the network's convolutions reach, in
percent: the least time of every conv of the batch (``portbench.flops_r50.
conv_bound_s``: each the larger of its operations at the bf16 peak and its
bytes at the HBM rate) over the device time of the "conv" group
(``portbench.trace.group``) inside ``portbench.forward``, per batch."""
from portbench.flops_r50 import conv_bound_s
from portbench.trace import group


def read(ctx):
    t = ctx.trace
    if t is None or not ctx.traced_iters:
        return None
    ops = t.select(span="portbench.forward", kind="kernel", where=lambda o: group(o.name) == "conv")
    if not ops:
        return None
    per_batch = sum(o.dur_ns for o in ops) * 1e-9 / ctx.traced_iters
    return 100.0 * conv_bound_s(ctx.batch, ctx.cell.config["num_classes"]) / per_batch
