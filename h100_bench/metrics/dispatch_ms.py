"""``dispatch_ms``: the host's mean ms to queue one call's program (the
port's ``FaceDetector.timings`` stages ``dispatch*``), over the traced
units run once without the profiler just before the traced window.
Layer: entry."""


def read(ctx):
    stages = [v for k, v in ctx.timings.items() if k.startswith("dispatch")]
    calls = sum(n for _, n in stages)
    return sum(ms for ms, _ in stages) / calls if calls else None
