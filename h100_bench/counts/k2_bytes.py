"""K2's bytes (``csrc/warp.cu``, the ROI warp fused with the [-1, 1]
normalize): what its inputs need, each byte once.

Per ROI: every distinct source pixel its bilinear taps touch inside the
frame, 3 bytes each (uint8 RGB); 20 bytes of ROI parameters (centre,
size, cosine and sine); the float32 crop written once (``out^2 x 3 x
4``).  The taps follow the warp's geometry: the size rounded half up,
``scale = out / size``, the destination grid rotated by the ROI's angle
into the source, four taps a sample.
"""

from __future__ import annotations

import torch


def roi_bytes(h: int, w: int, rois: torch.Tensor, out: int,
              block: int = 16) -> torch.Tensor:
    """Bytes of each ROI ``rois [R, 4]`` (cx, cy, size, angle as the warp
    takes it) at crop size ``out`` on an ``h`` x ``w`` frame: ``[R]``
    float64."""
    dev = rois.device
    grid = torch.arange(out, dtype=torch.float32, device=dev)
    counts = []
    for i in range(0, rois.shape[0], block):
        r = rois[i:i + block].float()
        n = r.shape[0]
        size_int = torch.clamp_min(torch.floor(r[:, 2] + 0.5), 1.0)
        scale = torch.full_like(size_int, out) / size_int
        oc = out / 2.0 + 0.5 * (scale - 1.0)
        dx = (grid[None, None, :] - oc[:, None, None]) / scale[:, None, None]
        dy = (grid[None, :, None] - oc[:, None, None]) / scale[:, None, None]
        ct = torch.cos(r[:, 3])[:, None, None]
        st = torch.sin(r[:, 3])[:, None, None]
        sx = r[:, 0, None, None] + ct * dx + st * dy
        sy = r[:, 1, None, None] - st * dx + ct * dy
        x0 = torch.floor(sx).long()
        y0 = torch.floor(sy).long()
        ids = []
        for ox, oy in ((0, 0), (1, 0), (0, 1), (1, 1)):
            x, y = x0 + ox, y0 + oy
            inside = (x >= 0) & (x < w) & (y >= 0) & (y < h)
            roi = torch.arange(n, device=dev)[:, None, None].expand_as(x)
            ids.append((roi * (h * w) + y * w + x)[inside])
        uniq = torch.unique(torch.cat(ids))
        counts.append(torch.bincount(uniq // (h * w), minlength=n))
    if not counts:
        return torch.zeros(0, dtype=torch.float64)
    pixels = torch.cat(counts).double().cpu()
    return pixels * 3 + 20 + out * out * 3 * 4
