"""Share of the bf16 peak that whole train steps reach over the measured
window, in percent: three times the forward's 61.25 GFLOP an image
(forward and backward) for the images of the steps finished in the
window, at 989 TFLOP/s, over the window's time."""
from portbench.flops import seconds_at_peak


def read(ctx):
    w = ctx.window
    if not w.get("seconds"):
        return None
    return 100.0 * 3 * w["images"] * seconds_at_peak(ctx.cell.config["num_classes"]) / w["seconds"]
