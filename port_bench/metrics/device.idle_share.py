"""device.idle_share: 1 − (the union of the device's kernel, copy and set
intervals) / the traced slice's wall time, in percent."""


def read(ctx):
    t = ctx.trace
    return 100.0 * (1.0 - t.busy_s / t.window_s) if t.window_s > 0 else None
