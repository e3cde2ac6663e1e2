"""Share of the card's bf16 peak that whole batches reach over the
measured window, in percent: the images finished in the window times
40.3 GFLOP an image (``portbench.flops_r50``) at 989 TFLOP/s, over the
window's time."""
from portbench.flops_r50 import seconds_at_peak


def read(ctx):
    w = ctx.window
    if not w.get("seconds"):
        return None
    return 100.0 * w["images"] * seconds_at_peak(ctx.cell.config["num_classes"]) / w["seconds"]
