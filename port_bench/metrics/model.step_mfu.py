"""model.step_mfu: the model FLOPs of the measured window over the window's
seconds times the H100's dense bf16 peak (989 TFLOP/s). FLOPs: 2 × the
active parameters (ref/<arch>.py::active_params: U of E experts) × (the
tokens generated in the window + the prompt tokens of the requests
completed in it), plus attention's 4·d·context per token and layer."""
from port_bench import roofline


def read(ctx):
    done = ctx.completed()
    if not done:
        return None
    from port_bench.run import clipped_tokens

    gen = clipped_tokens(ctx.res.harvests, ctx.res.t_open, ctx.res.t_close)
    prompt = sum(len(d.prompt) for d in done)
    d_attn = ctx.ref.sizes(ctx.hp)["D"]
    L = ctx.n_layer
    # attention context: each prompt token at its own position, each
    # generated token at the mean output position of the completed requests
    attn = sum(4.0 * d_attn * L * p * (p + 1) / 2 for p in (len(d.prompt) for d in done))
    mean_pos = sum(len(d.prompt) + len(d.out) / 2 for d in done) / len(done)
    attn += gen * 4.0 * d_attn * L * mean_pos
    flops = 2.0 * ctx.ref.active_params(ctx.hp) * (gen + prompt) + attn
    return 100.0 * flops / (ctx.window_s * roofline.PEAK["bf16"])
