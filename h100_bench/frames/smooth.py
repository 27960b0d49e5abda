"""``smooth``: noise at ``1/cell`` of the size, upscaled bicubically and
clamped, so that neighbouring pixels agree as in a camera frame."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def make(spec: dict, gen, device) -> torch.Tensor:
    n, h, w, c = spec["count"], spec["height"], spec["width"], spec["cell"]
    small = torch.rand((n, 3, h // c + 3, w // c + 3), generator=gen,
                       device=device) * 255.0
    big = F.interpolate(small, scale_factor=c, mode="bicubic",
                        align_corners=False)
    x = big[:, :, :h, :w].clamp(0, 255).round().to(torch.uint8)
    return x.permute(0, 2, 3, 1).contiguous()
