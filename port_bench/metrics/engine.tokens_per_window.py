"""engine.tokens_per_window: the mean tokens harvested per engine window
inside the measured window (slot occupancy times the harvest depth, less
what admission leaves empty)."""


def read(ctx):
    n = [h[2] for h in ctx.harvests_in(ctx.res.t_open, ctx.res.t_close)]
    return sum(n) / len(n) if n else None
