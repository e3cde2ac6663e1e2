"""Host time a train step, in ms, in the device-only traced window: the
program's span ``ssdx_torch.train.step`` (the whole of ``train_step``:
batch copy, forward, targets and loss, backward, optimizer), read through
``portbench.spans``."""
from portbench.spans import host_ms


def read(ctx):
    return host_ms(ctx, "ssdx_torch.train.step")
