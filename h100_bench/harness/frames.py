"""A traffic mix's pool of distinct seeded RGB frames.

The mix (``traffic/<mix>.json``) names the frames' ``kind``, size and
count; the generator of that kind (``h100_bench/frames/<kind>.py``) makes
them on the run's device from the seed, in one call a pool, and this
hands them to the host as one uint8 array.
"""

from __future__ import annotations

import numpy as np
import torch

from .manifest import plugin


def make_frames(spec: dict, seed: int, device) -> np.ndarray:
    """``[count, height, width, 3]`` uint8 frames of ``spec`` from
    ``seed``: the same seed gives the same frames."""
    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) * 8 + 7) % (1 << 63))
    return plugin("frames", spec["kind"]).make(spec, gen, device).cpu().numpy()
