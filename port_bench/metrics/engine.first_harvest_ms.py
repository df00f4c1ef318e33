"""engine.first_harvest_ms: the median, over the requests completed in the
measured window, of admission → the harvest of the request's first token
(its `request.prefill` span in the port's span recorder, utils/trace.py):
the flood's or last chunk's own device time and the window queued ahead of
it. None where the port records no request spans or its ring no longer
holds them."""
import statistics


def read(ctx):
    from ggml_gfx906_tpu_torch.utils import trace

    rec = getattr(trace, "RECORDER", None)
    done = ctx.completed()
    if rec is None or not done:
        return None
    req = rec.requests([d.rid for d in done], int(ctx.res.t_open * 1e9))
    if req is None:
        return None
    return statistics.median((s.t1 - s.t0) / 1e6
                             for s in (r["request.prefill"] for r in req.values()))
