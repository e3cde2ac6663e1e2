"""Share of their roofline that the int8 conv kernels B4a/B4b reach over a
forward, in percent: the sum of the 21 post-stem layers' least times at
the batch's shape (each the larger of its operations at the int8 peak and
its bytes at the HBM rate; ``portbench.flops.int8_bound_s``) over the
device time of the ``conv_kernel`` launches, per batch."""
from portbench.flops import int8_bound_s, int8_layers


def read(ctx):
    t = ctx.trace
    if t is None or not ctx.traced_iters or not ctx.facts.get("int8"):
        return None
    ops = t.select(kind="kernel", where=lambda o: "::conv_kernel<" in o.name)
    if not ops:
        return None
    bound = sum(int8_bound_s(layer, ctx.batch) for layer in int8_layers())
    per_batch = sum(o.dur_ns for o in ops) * 1e-9 / ctx.traced_iters
    return 100.0 * bound / per_batch
