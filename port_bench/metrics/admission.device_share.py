"""admission.device_share: the share of the traced slice's kernel time in
kernels launched one by one (the engine's eager floods and prefill chunks,
and what runs between windows) rather than by a CUDA graph replay (the
decode windows), by each kernel's launch in the profiler's runtime
correlation."""


def read(ctx):
    t = ctx.trace
    known = t.time_in(lambda k: k.graph is not None)
    if not t.launches_found or known <= 0:
        return None
    return 100.0 * t.time_in(lambda k: k.graph is False) / known
