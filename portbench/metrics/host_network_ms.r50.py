"""Host time a batch of the network's enqueue, in ms, in the device-only
traced window: the program's span ``ssdx_torch.api.network`` (the trunk,
extras and heads launched, about 200 kernels a batch)."""
from portbench.spans import host_ms


def read(ctx):
    return host_ms(ctx, "ssdx_torch.api.network")
