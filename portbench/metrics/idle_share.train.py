"""Share of the device-only traced window (recorded without the host's
calls, which slow the host) of the training cell with no kernel, copy
or fill on the card, in percent."""


def read(ctx):
    t = ctx.trace
    return None if t is None or t.window_s <= 0 else 100.0 * (1.0 - t.busy_s / t.window_s)
