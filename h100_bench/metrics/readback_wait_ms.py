"""``readback_wait_ms``: the host's ms a unit blocked on the card, in the
port's ``compute_wait`` span (the wait for the readback's copy, which
follows the program's device work), over the traced units run once
without the profiler just before the traced window
(``FaceDetector.timings``).  Layer: entry."""


def read(ctx):
    ms = ctx.timings.get("compute_wait", (0.0, 0))[0]
    return ms / ctx.mix["trace_units"] if ms > 0 else None
