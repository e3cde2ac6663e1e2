"""Device time a batch of the 81-class heads, in ms: every kernel launched
inside the benchmark's span ``portbench.heads`` around the model's heads
(six fused 3x3 convs, the permutes, the concatenations and the float32
casts of loc and conf)."""


def read(ctx):
    t = ctx.trace
    if t is None or not ctx.traced_iters:
        return None
    ops = t.select(span="portbench.heads", kind="kernel")
    return sum(o.dur_ns for o in ops) * 1e-6 / ctx.traced_iters if ops else None
