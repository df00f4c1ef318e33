"""engine.window_ms: the median wall milliseconds of the engine's
harvested windows (Engine.window_log) that end inside the measured window."""
import statistics


def read(ctx):
    d = [h[1] for h in ctx.harvests_in(ctx.res.t_open, ctx.res.t_close)]
    return statistics.median(d) * 1e3 if d else None
