"""kernels.qmm_roofline: the least time of the quantized products of the
traced slice (port_bench/roofline.py's count) over the device time of the
port's quantized-product kernels in it. Decode steps in the slice come
from K2's launch counter (one launch per layer and forward) less the eager
prefills, their real rows from the tokens harvested in the slice; each
eager prefill counts its own real rows."""
from port_bench import roofline
from port_bench.run import clipped_tokens


def read(ctx):
    if ctx.res.k2_span is None or ctx.res.trace_span is None:
        return None
    t0, t1 = ctx.res.trace_span
    rows = ctx.prefill_rows(t0, t1)
    steps = (ctx.res.k2_span[1] - ctx.res.k2_span[0]) / ctx.n_layer - len(rows)
    dev = ctx.trace.time_in(lambda k: roofline.is_qmm_kernel(k.name))
    if steps <= 0 or dev <= 0:
        return None
    T = clipped_tokens(ctx.res.harvests, t0, t1) / steps
    least = steps * ctx.least_s(T) + sum(ctx.least_s(r) for r in rows)
    return 100.0 * least / dev
