"""FaceMesh: MediaPipe's Face Mesh model card and ``blazeface_landmark.py``
in zmurez/MediaPipePyTorch.

``input`` x ``input`` x 3 in, PReLU BlazeBlocks in each of
``stage_channels`` (``blocks_per_stage`` a stage, a stride-2 block
between stages), a landmark branch (a stride-2 stage, a 1x1 to
``head_channels``, a 3x3 VALID head of ``points`` x 3) and a presence
branch: ``[1, 1, 1, 3 * points]`` landmarks (crop px) and the
``[1, 1, 1, 1]`` presence logit.
"""

from __future__ import annotations

import numpy as np

from h100_bench.harness.netspec import PADDING_VALID, Builder, Graph

# Eye corners in 192-px crop units: where a trained mesh puts them (eyes
# 26 px wide, 26 px apart), so that eye ROIs are a third of the face.
EYE_CORNERS = {33: (57.0, 80.0), 133: (83.0, 80.0),
               362: (109.0, 80.0), 263: (135.0, 80.0)}


def build(draws, spec: dict) -> Graph:
    g = Builder(draws)
    size, chans, blocks = (spec["input"], spec["stage_channels"],
                           spec["blocks_per_stage"])
    inp = g.tensor((1, size, size, 3))
    x = g.pad(inp, [[0, 0], [0, 1], [0, 1], [0, 0]])
    x = g.prelu(g.conv(x, chans[0], 3, stride=2, padding=PADDING_VALID))
    for i, cout in enumerate(chans):
        if i:
            x = g.block(x, cout, stride=2, prelu=True)
        for _ in range(blocks):
            x = g.block(x, cout, prelu=True)
    feat, top = x, chans[-1]
    y = g.block(feat, top, stride=2, prelu=True)
    for _ in range(blocks):
        y = g.block(y, top, prelu=True)
    head = spec["head_channels"]
    y = g.prelu(g.conv(y, head, 1))
    y = g.block(y, head, prelu=True)
    points = spec["points"]
    lm_bias = np.zeros((points, 3), np.float32)
    lm_bias[:, :2] = g.r.uniform(40.0, 152.0, (points, 2))
    lm_bias[list(EYE_CORNERS), :2] = list(EYE_CORNERS.values())
    lm_bias[:, 2] = g.r.uniform(-10.0, 10.0, (points,))
    lm = g.conv(y, 3 * points, 3, padding=PADDING_VALID, gain=0.5,
                bias=lm_bias.reshape(-1))
    p = g.block(feat, top, stride=2, prelu=True)
    presence = g.conv(p, 1, 3, padding=PADDING_VALID, gain=0.05,
                      bias=np.asarray([3.0], np.float32))
    return g.graph([inp], [lm, presence], "FaceMesh")
