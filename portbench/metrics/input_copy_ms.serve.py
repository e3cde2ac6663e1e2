"""Device time of the host-to-device copies a batch, in ms: the float32
NHWC images the caller hands ``predict_batched`` go to the card here."""


def read(ctx):
    t = ctx.trace
    if t is None or not ctx.traced_iters:
        return None
    ops = t.select(kind="memcpy", where=lambda o: "HtoD" in o.name)
    return sum(o.dur_ns for o in ops) * 1e-6 / ctx.traced_iters if ops else None
