"""Host time a batch of the readback's unpacking, in ms, in the device-only
traced window: the span ``ssdx_torch.predict.to_pylist.unpack`` (the copies
after the first, which has waited for the batch, and the per-image numpy
split)."""
from portbench.spans import host_ms


def read(ctx):
    return host_ms(ctx, "ssdx_torch.predict.to_pylist.unpack")
