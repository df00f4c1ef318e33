"""admission.flood_fill: the prompt tokens the engine's floods admitted over
the rows they computed (max_batch × s_pad each, pad rows included), in
percent, over the floods that start in the measured window: the counts on
their `engine.flood` spans in the port's span recorder (utils/trace.py).
None where the port records no spans, its ring no longer reaches back to
the window's opening, or no flood started in the window."""


def read(ctx):
    from ggml_gfx906_tpu_torch.utils import trace

    rec = getattr(trace, "RECORDER", None)
    t0, t1 = int(ctx.res.t_open * 1e9), int(ctx.res.t_close * 1e9)
    spans = rec.window(t0, t1) if rec is not None else None
    if spans is None:
        return None
    floods = [s for s in spans if s.name == "engine.flood" and t0 <= s.t0 <= t1]
    rows = sum(s.attrs["rows"] for s in floods)
    return 100.0 * sum(s.attrs["tokens"] for s in floods) / rows if rows else None
