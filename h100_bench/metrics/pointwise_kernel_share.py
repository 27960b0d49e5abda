"""``pointwise_kernel_share``: of the float32 1x1 convolutions (groups 1,
stride 1, no pad) that ran on the card over the traced units' two runs,
the share that ran in K6, the hand-written 1x1 convolution with its
epilogue, in percent: the change of
``FaceDetector.memory_report()["pointwise_kernel"]`` over that change
plus the change of ``["pointwise_library"]`` (those ``F.conv2d`` ran).
Replays count what their capture recorded.  None where the program keeps
no such count or none ran.  Layer: networks."""


def read(ctx):
    keys = ("pointwise_kernel", "pointwise_library")
    if any(k not in ctx.memory_after or k not in ctx.memory_before
           for k in keys):
        return None
    kernel, library = (ctx.memory_after[k] - ctx.memory_before[k]
                       for k in keys)
    total = kernel + library
    return 100.0 * kernel / total if total else None
