"""The iris net: no published widths, so its widths are set to the
parameter count of the published ``iris_landmark.tflite`` (listed under
``assumed`` in the configuration files).

``input`` x ``input`` x 3 in, PReLU BlazeBlocks in each of
``stage_channels``, then two branches of two stride-2 stages and a 2x2
head: ``[1, 3 * contour_points]`` eye contour, then ``[1, 3 *
iris_points]`` iris, in crop pixels.
"""

from __future__ import annotations

import numpy as np

from h100_bench.harness.netspec import PADDING_VALID, Builder, Graph

#: The iris points around their centre (centre, then right, up, left,
#: down), in 64-px crop units.
IRIS_OFFSETS = [[0, 0], [5, 0], [0, -5], [-5, 0], [0, 5]]


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
    ctr = g.r.uniform(29.0, 35.0, (2,))
    n_iris = spec["iris_points"]
    iris_bias = np.zeros((n_iris, 3), np.float32)
    iris_bias[:, :2] = ctr + np.asarray(IRIS_OFFSETS[:n_iris], np.float32)
    iris_bias[:, 2] = g.r.uniform(-2.0, 2.0, (n_iris,))
    n_contour = spec["contour_points"]
    contour_bias = np.zeros((n_contour, 3), np.float32)
    contour_bias[:, :2] = g.r.uniform(12.0, 52.0, (n_contour, 2))
    contour_bias[:, 2] = g.r.uniform(-4.0, 4.0, (n_contour,))
    outs = []
    for bias in (contour_bias, iris_bias):
        y = feat
        for _ in range(2):
            y = g.block(y, top, stride=2, prelu=True)
            for _ in range(blocks):
                y = g.block(y, top, prelu=True)
        y = g.conv(y, bias.size, 2, padding=PADDING_VALID, gain=0.2,
                   bias=bias.reshape(-1))
        outs.append(g.op("RESHAPE", [y], (1, bias.size),
                         new_shape=[1, bias.size]))
    return g.graph([inp], outs, "iris landmark")
