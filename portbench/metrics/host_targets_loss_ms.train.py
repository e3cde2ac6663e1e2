"""Host time a train step of matching and the loss, in ms, in the
device-only traced window: the span ``ssdx_torch.train.targets_loss``
(``build_targets`` and ``multibox_loss``)."""
from portbench.spans import host_ms


def read(ctx):
    return host_ms(ctx, "ssdx_torch.train.targets_loss")
