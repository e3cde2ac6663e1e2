"""Host time a train step of the backward, in ms, in the device-only traced
window: the span ``ssdx_torch.train.backward`` around ``total.backward()``,
which returns once autograd has enqueued every gradient kernel."""
from portbench.spans import host_ms


def read(ctx):
    return host_ms(ctx, "ssdx_torch.train.backward")
