"""``noise``: independent uniform bytes a pixel (the port's bench
frames)."""

from __future__ import annotations

import torch


def make(spec: dict, gen, device) -> torch.Tensor:
    return torch.randint(0, 256, (spec["count"], spec["height"],
                                  spec["width"], 3), generator=gen,
                         device=device, dtype=torch.uint8)
