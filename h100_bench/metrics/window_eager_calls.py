"""``window_eager_calls``: calls that ran a program key's eager program in
place of its captured graph after the warm-up (the change of
``FaceDetector.memory_report()["eager_calls"]`` over the traced units'
two runs, without and with the profiler); 0 where the warm-up captured
every key the traffic reaches.  Layer: captured programs."""


def read(ctx):
    if "eager_calls" not in ctx.memory_after:
        return None
    return ctx.memory_after["eager_calls"] - ctx.memory_before["eager_calls"]
