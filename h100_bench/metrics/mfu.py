"""``mfu``: the model's FLOPs in the traced window (``counts/flops.py``:
the detector a frame, the face networks a returned face) over the
window's wall seconds times the card's fp32 peak outside the tensor
cores (``counts/peaks.json``; the configurations are fp32 with TF32
off), in percent.  Layer: model step."""

from h100_bench.counts import flops


def read(ctx):
    work = sum(flops.per_frame_flops(ctx.config, n)
               for _, faces in ctx.traced_units for n in faces)
    peak = flops.load(flops.PEAKS)["fp32_flops_per_s"]
    if not work or ctx.trace.window_s <= 0:
        return None
    return 100.0 * work / (ctx.trace.window_s * peak)
