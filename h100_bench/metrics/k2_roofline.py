"""``k2_roofline``: K2's least time at the card's HBM bandwidth
(``counts/peaks.json``) for the bytes its inputs need
(``counts/k2_bytes.py``, from the reference's ROIs of each traced frame
at every site) over K2's device time in the traced window, in percent.
Layer: kernels."""

import numpy as np
import torch

from h100_bench.counts import flops, k2_bytes, kernels


def _frame_bytes(ctx, i):
    h, w = ctx.frame_hw
    total = 0.0
    faces = ctx.ref[i]["faces"]
    for out in sorted({size for f in faces for size in f["rois"]}):
        rois = [f["rois"][out] for f in faces if out in f["rois"]]
        if rois:
            r = torch.from_numpy(np.concatenate(rois)).to(ctx.device)
            total += float(k2_bytes.roi_bytes(h, w, r, out).sum())
    return total


def read(ctx):
    seconds = ctx.trace.time_by(lambda n: kernels.kind(n) == "k2")
    if seconds <= 0:
        return None
    per_frame = {}
    total = 0.0
    for idx, _ in ctx.traced_units:
        for i in idx:
            if i not in per_frame:
                per_frame[i] = _frame_bytes(ctx, i)
            total += per_frame[i]
    bw = flops.load(flops.PEAKS)["hbm_bytes_per_s"]
    return 100.0 * total / bw / seconds if total else None
