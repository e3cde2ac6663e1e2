"""Host time a train step of the forward, in ms, in the device-only traced
window: the span ``ssdx_torch.train.forward`` (stem kernel B3, the rest of
the model in train mode, the running statistics)."""
from portbench.spans import host_ms


def read(ctx):
    return host_ms(ctx, "ssdx_torch.train.forward")
