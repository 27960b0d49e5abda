"""``mask_materialize_ms``: the host's ms a unit building the mask objects
(``SegmentationMask`` and ``MulticlassSegmentationMask``), in the port's
``segment.materialize`` span, over the traced units run once without the
profiler just before the traced window (``FaceDetector.timings``).  None
where the program has no such span.  Layer: entry."""


def read(ctx):
    ms, n = ctx.timings.get("segment.materialize", (0.0, 0))
    return ms / ctx.mix["trace_units"] if n else None
