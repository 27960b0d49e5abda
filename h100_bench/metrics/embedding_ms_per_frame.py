"""``embedding_ms_per_frame``: device ms a frame of the embedding stage group (eye alignment, K2 at 112 px, MobileFaceNet, the L2 norm)
inside the captured programs' replays: the differences of the program's
own stage stamps (the port's ``device.embedding`` timings, read back with
each call's results), over the traced units run once without the
profiler just before the traced window.  Layer: networks."""


def read(ctx):
    ms = ctx.timings.get("device.embedding", (0.0, 0))[0]
    frames = ctx.mix["trace_units"] * ctx.mix.get("batch", 1)
    return ms / frames if ms > 0 else None
