"""Device time a batch of the postprocess, in ms: every kernel launched
inside ``predict_batched`` but outside ``Detector.forward`` (ranking
sorts, softmax, decoding, gathers and the NMS kernel)."""


def read(ctx):
    t = ctx.trace
    if t is None or not ctx.traced_iters:
        return None
    ops = t.select(span="portbench.predict_batched", kind="kernel",
                   where=lambda o: "portbench.forward" not in o.spans)
    return sum(o.dur_ns for o in ops) * 1e-6 / ctx.traced_iters if ops else None
