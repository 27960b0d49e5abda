"""``conv_ms_per_frame``: device ms of the convolution kernels and their
layout transposes (``counts/kernels.py``) in the traced window, per frame.
Layer: networks."""

from h100_bench.counts import kernels


def read(ctx):
    s = ctx.trace.time_by(lambda n: kernels.kind(n) == "conv")
    return s * 1e3 / ctx.frames if s > 0 and ctx.frames else None
