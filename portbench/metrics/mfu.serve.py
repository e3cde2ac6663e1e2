"""Share of the card's peak that whole batches reach over the measured
window, in percent: the time the images finished in the window would take
at the peaks (61.25 GFLOP an image at the bf16 peak; in an int8
configuration the post-stem backbone at the int8 peak; ``portbench.flops``)
over the window's time."""
from portbench.flops import seconds_at_peak


def read(ctx):
    w = ctx.window
    if not w.get("seconds"):
        return None
    per_image = seconds_at_peak(ctx.cell.config["num_classes"],
                                int8_backbone=bool(ctx.facts.get("int8")))
    return 100.0 * w["images"] * per_image / w["seconds"]
