"""The BlazeFace back-camera detector: MediaPipe's BlazeFace model card
and ``blazeface.py`` with ``back_model=True`` in hollance/BlazeFace-PyTorch.

``input`` x ``input`` x 3 in, a 5x5/2 stem to the first stage's channels,
``blocks_per_stage`` BlazeBlocks in each of ``stage_channels`` (a stride-2
block between stages) down to 16x16, a stride-2 depthwise block to 8x8,
1x1 heads of 2 scores + 32 box values a 16x16 cell and 6 + 96 an 8x8
cell: ``[1, 896, 16]`` boxes and ``[1, 896, 1]`` score logits.
"""

from __future__ import annotations

import numpy as np

from h100_bench.harness.netspec import PADDING_VALID, Builder, Graph

# Box-head bias in 256-px detector-input units: (cx, cy, w, h) then the six
# keypoints (left eye, right eye, nose tip, mouth, left and right tragion).
BOX_BIAS = np.asarray([0, 0, 44, 44,
                       -9, -8, 9, -8, 0, 2, 0, 12, -20, -4, 20, -4],
                      np.float32)


def build(draws, spec: dict) -> Graph:
    g = Builder(draws)
    size, chans = spec["input"], spec["stage_channels"]
    inp = g.tensor((1, size, size, 3))
    x = g.pad(inp, [[0, 0], [1, 2], [1, 2], [0, 0]])
    x = g.conv(x, chans[0], 5, stride=2, padding=PADDING_VALID, act="RELU",
               weights="zero_sum")
    for i, cout in enumerate(chans):
        if i:
            x = g.block(x, cout, stride=2)
        for _ in range(spec["blocks_per_stage"]):
            x = g.block(x, cout)
    x16 = x
    _, h, w, c = g.shape(x16)
    x = g.pad(x16, [[0, 0], [0, 2], [0, 2], [0, 0]])
    x = g.op("DEPTHWISE_CONV_2D",
             [x, g.const(g.r.normal(1 / 3, (1, 3, 3, c))),
              g.const(np.zeros(c, np.float32))],
             (1, h // 2, w // 2, c), padding=PADDING_VALID, stride=2,
             activation=None)
    x8 = g.conv(x, c, 1, act="RELU")
    scores, boxes = [], []
    for feat, anchors in ((x16, 2), (x8, 6)):
        scores.append(g.head(feat, 1, 0.5, np.zeros(anchors, np.float32),
                             weights="positive"))
        boxes.append(g.head(feat, 16, 0.25, np.tile(BOX_BIAS, anchors)))
    n = spec["anchors"]
    box = g.op("CONCATENATION", boxes, (1, n, 16), axis=1)
    score = g.op("CONCATENATION", scores, (1, n, 1), axis=1)
    return g.graph([inp], [box, score], "BlazeFace back")
