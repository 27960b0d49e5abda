"""``segmentation_ms_per_frame``: device ms a frame of the segmenter's
program (the letterbox to its input, the network, the softmax) inside
its captured program's replays: the difference of the program's own
stage stamps (the port's ``device.segmentation`` timings, read back with
each call's masks), over the traced units run once without the profiler
just before the traced window.  None where the program stamps no such
group.  Layer: networks."""


def read(ctx):
    ms = ctx.timings.get("device.segmentation", (0.0, 0))[0]
    frames = ctx.mix["trace_units"] * ctx.mix.get("batch", 1)
    return ms / frames if ms > 0 else None
