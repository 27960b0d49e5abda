"""``k5_affine_roofline``: K5's affine instance's least time at the
card's HBM bandwidth (``counts/peaks.json``) for the bytes the traced
units' returned faces need at the embedding network's affine sites
(``counts/k5_affine_bytes.py``, one run a face), over the device time
of the kernels named ``residual_act_affine_kernel`` in the traced
window, in percent.  The kernel also runs the slab's empty slots, which
the bytes leave out.  None where no such kernel ran or the network has
no count.  Layer: kernels."""

from h100_bench.counts import flops, k5_affine_bytes

KERNEL = "residual_act_affine_kernel"


def read(ctx):
    seconds = ctx.trace.time_by(lambda n: KERNEL in n)
    spec = ctx.config["networks"].get("embedding")
    if seconds <= 0 or not spec:
        return None
    per_face = k5_affine_bytes.network_bytes(spec["name"])
    faces = sum(n for _, counts in ctx.traced_units for n in counts)
    if not per_face or not faces:
        return None
    bw = flops.load(flops.PEAKS)["hbm_bytes_per_s"]
    return 100.0 * per_face * faces / bw / seconds
