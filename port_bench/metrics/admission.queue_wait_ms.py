"""admission.queue_wait_ms: the 95th percentile, over the requests completed
in the measured window, of each one's wait in the engine's queue: submit →
the start of the flood or first chunk that admitted it (its
`request.queued` span in the port's span recorder, utils/trace.py). None
where the port records no request spans or its ring no longer holds them."""
import statistics


def read(ctx):
    from ggml_gfx906_tpu_torch.utils import trace

    rec = getattr(trace, "RECORDER", None)
    done = ctx.completed()
    if rec is None or len(done) < 2:
        return None
    req = rec.requests([d.rid for d in done], int(ctx.res.t_open * 1e9))
    if req is None:
        return None
    wait = [(s.t1 - s.t0) / 1e6 for s in (r["request.queued"] for r in req.values())]
    return statistics.quantiles(wait, n=20)[18]
