"""Host time a batch of the input copy, in ms, in the device-only traced
window: the span ``ssdx_torch.api.input_copy`` around
``torch.as_tensor(images, device=...)``, the pageable host-to-device copy
that holds the host until the batch is on the card."""
from portbench.spans import host_ms


def read(ctx):
    return host_ms(ctx, "ssdx_torch.api.input_copy")
