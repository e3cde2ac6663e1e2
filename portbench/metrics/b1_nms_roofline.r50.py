"""Share of its roofline that the NMS kernel B1 reaches in per-class
IoU-NMS, in percent: the least time of these batches' pairs (a label
compare for each pair of a candidate with a later one among the K sorted,
the IoU of the same-class ones, as the reference counts them;
``portbench.flops_r50.nms_iou_bound_s``) over the device time of the
``nms_`` launches, per batch."""
from portbench.flops_r50 import nms_iou_bound_s


def read(ctx):
    t = ctx.trace
    cands, same = ctx.facts.get("nms_candidates"), ctx.facts.get("same_class_pairs")
    if t is None or not ctx.traced_iters or not cands or not same:
        return None
    ops = t.select(kind="kernel", where=lambda o: "nms_" in o.name.lower())
    if not ops:
        return None
    nb, k = len(cands), ctx.facts["pair_top_k"]
    bound = sum(nms_iou_bound_s(cands[i % nb], same[i % nb], k)
                for i in range(ctx.traced_iters)) / ctx.traced_iters
    per_batch = sum(o.dur_ns for o in ops) * 1e-9 / ctx.traced_iters
    return 100.0 * bound / per_batch
