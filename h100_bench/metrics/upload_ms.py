"""``upload_ms``: the host's ms a unit in the port's ``upload`` span (the
frames' copy into the pinned ring and the queueing of its copy to the
card, or a call's cached upload and its batch of one), over the traced
units run once without the profiler just before the traced window
(``FaceDetector.timings``).  Layer: entry."""


def read(ctx):
    ms = ctx.timings.get("upload", (0.0, 0))[0]
    return ms / ctx.mix["trace_units"] if ms > 0 else None
