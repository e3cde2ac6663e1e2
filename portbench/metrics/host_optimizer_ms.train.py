"""Host time a train step of the update, in ms, in the device-only traced
window: the span ``ssdx_torch.train.optimizer`` (``optimizer.step()`` and
``scheduler.step()``)."""
from portbench.spans import host_ms


def read(ctx):
    return host_ms(ctx, "ssdx_torch.train.optimizer")
