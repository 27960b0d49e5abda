"""``depthwise_kernel_share``: of the depthwise convolutions that ran on
the card over the traced units' two runs, the share that ran in K7, the
hand-written depthwise convolution with its bias and activation, in
percent: the change of ``FaceDetector.memory_report()["depthwise_kernel"]``
over that change plus the change of ``["depthwise_library"]`` (those
``F.conv2d`` ran).  Replays count what their capture recorded.  None
where the program keeps no such count or none ran.  Layer: networks."""

from h100_bench.counts.kernel_share import kernel_share


def read(ctx):
    return kernel_share(ctx, "depthwise_kernel", "depthwise_library")
