"""``embedding_mfu``: the embedding network's FLOPs over the traced
units' returned faces (``counts/macs/<name>.json`` of the
configuration's ``embedding`` network, 2 a multiply-add, one run a face)
over the stamped device seconds of the embedding stage group (the
port's ``device.embedding`` timings, as ``embedding_ms_per_frame``),
times the card's fp32 peak outside the tensor cores
(``counts/peaks.json``), in percent.  The group also holds the eye
alignment, K2 at 112 px and the L2 norm, and runs every slot of the
slab; the FLOPs count the faces alone.  None where the program stamps no
such group or the configuration embeds nothing.  Layer: networks."""

from h100_bench.counts import flops


def read(ctx):
    ms = ctx.timings.get("device.embedding", (0.0, 0))[0]
    spec = ctx.config["networks"].get("embedding")
    if ms <= 0 or not spec:
        return None
    faces = sum(n for _, counts in ctx.traced_units for n in counts)
    work = 2.0 * flops.network_macs(spec["name"]) * faces
    peak = flops.load(flops.PEAKS)["fp32_flops_per_s"]
    return 100.0 * work / (ms * 1e-3 * peak) if work else None
