"""Share of the NMS's candidates that it keeps, in percent: the program's
count ``nms_kept`` (kept and valid pairs) over ``nms_candidates``, summed
over the postprocess spans (``ssdx_torch.predict.postprocess``) of every
traced batch.  A program that counts no ``nms_kept`` gives ``None``."""
from portbench.spans import count_share


def read(ctx):
    return count_share(ctx, "ssdx_torch.predict.postprocess", "nms_kept", "nms_candidates")
