"""Share of the NMS kernel B1's candidate slots that hold a candidate, in
percent: the program's count ``nms_candidates`` (stage-2 scores above the
score threshold, the pairs B1 and the stage-2 sort do useful work on) over
``nms_slots`` (batch x K), summed over the postprocess spans
(``ssdx_torch.predict.postprocess``) of every traced batch."""
from portbench.spans import count_share


def read(ctx):
    return count_share(ctx, "ssdx_torch.predict.postprocess", "nms_candidates", "nms_slots")
