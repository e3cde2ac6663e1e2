"""Share of its roofline that the NMS kernel B1 reaches, in percent: the
least time of the pairs these batches need (the candidates above the score
threshold among the 400, as the reference counts them, against every later
candidate; ``portbench.flops.nms_bound_s``) over the device time of the
``nms_`` launches, per batch."""
from portbench.flops import nms_bound_s


def read(ctx):
    t = ctx.trace
    cands = ctx.facts.get("nms_candidates")
    if t is None or not ctx.traced_iters or not cands:
        return None
    ops = t.select(kind="kernel", where=lambda o: "nms_" in o.name.lower())
    if not ops:
        return None
    nb = len(cands)
    bound = sum(nms_bound_s(cands[i % nb]) for i in range(ctx.traced_iters)) / ctx.traced_iters
    per_batch = sum(o.dur_ns for o in ops) * 1e-9 / ctx.traced_iters
    return 100.0 * bound / per_batch
