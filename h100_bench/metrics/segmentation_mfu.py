"""``segmentation_mfu``: the segmenter's FLOPs (``counts/macs/<name>.json``
of the configuration's ``segmentation`` network, 2 a multiply-add, one
run a frame) over its stamped device seconds (the port's
``device.segmentation`` timings, as ``segmentation_ms_per_frame``) times
the card's fp32 peak outside the tensor cores (``counts/peaks.json``),
in percent.  None where the program stamps no such group.  Layer:
networks."""

from h100_bench.counts import flops


def read(ctx):
    ms = ctx.timings.get("device.segmentation", (0.0, 0))[0]
    spec = ctx.config["networks"].get("segmentation")
    if ms <= 0 or not spec:
        return None
    frames = ctx.mix["trace_units"] * ctx.mix.get("batch", 1)
    work = 2.0 * flops.network_macs(spec["name"]) * frames
    peak = flops.load(flops.PEAKS)["fp32_flops_per_s"]
    return 100.0 * work / (ms * 1e-3 * peak)
