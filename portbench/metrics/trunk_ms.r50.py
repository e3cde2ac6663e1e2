"""Device time a batch of the ResNet-50 trunk, in ms: every kernel launched
inside the benchmark's span ``portbench.trunk`` around the model's trunk
(conv1, the max pool, layer1-layer3: the convs, the residual adds and
ReLUs)."""


def read(ctx):
    t = ctx.trace
    if t is None or not ctx.traced_iters:
        return None
    ops = t.select(span="portbench.trunk", kind="kernel")
    return sum(o.dur_ns for o in ops) * 1e-6 / ctx.traced_iters if ops else None
