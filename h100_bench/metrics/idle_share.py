"""``idle_share``: percent of the traced window's wall time in which no
kernel or copy ran on the device (the union of device intervals).
Layer: device."""


def read(ctx):
    t = ctx.trace
    return 100.0 * (1.0 - t.busy_s / t.window_s) if t.window_s > 0 else None
