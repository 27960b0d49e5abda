"""``materialize_ms``: the host's ms a unit in the port's ``materialize``
span (the readback's rescale and the ``Face`` objects), over the traced
units run once without the profiler just before the traced window
(``FaceDetector.timings``).  Layer: entry."""


def read(ctx):
    ms = ctx.timings.get("materialize", (0.0, 0))[0]
    return ms / ctx.mix["trace_units"] if ms > 0 else None
