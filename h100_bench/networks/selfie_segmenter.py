"""MediaPipe's selfie segmenters (the Selfie Segmentation and Image
Segmenter model cards): a MobileNetV3-style encoder and a decoder that
upsamples with squeeze-excite gates on the skips, every filter and bias
in float16 behind DEQUANTIZE, as the published files hold them.

The spec gives ``in_hw`` ([H, W]), ``classes``, ``stem`` (the 3x3/2
stem's width, hard-swish after it) and ``stages``: per encoder stage
``[expansion, width, kernel, stride, squeeze_excite, hard_swish,
blocks]``, MobileNetV3 bottlenecks whose first block takes the stride;
each stage's output is a skip.  The decoder, deepest skip first: a 1x1
convolution with ReLU to the skip's width, RESIZE_BILINEAR to its size
(half-pixel centres), the skip gated by the sigmoid of a 1x1
convolution of the upsampled map's global AVERAGE_POOL_2D, ADD, and a
bottleneck of twice the skip's width.  Then a 2x2 stride-2
``Convolution2DTransposeBias`` to ``classes`` planes at the input's
size, with a LOGISTIC for one class (the person probability); six
classes leave the logits to the program's softmax.  The general
(256x256, 1 class), landscape (144x256, 1 class) and multiclass
(256x256, 6 classes) segmenters differ only in these numbers.
"""

from __future__ import annotations

import math

import numpy as np

from h100_bench.harness.netspec import (PADDING_SAME, RES_GAIN, Builder,
                                        Graph)


class SegmenterBuilder(Builder):
    """The layers of the segmenters, float16 weights throughout."""

    def conv(self, x, cout, k, stride=1, act=None, gain=1.0):
        _, h, w, cin = self.shape(x)
        wt = self.r.normal(gain * math.sqrt(2.0 / (k * k * cin)),
                           (cout, k, k, cin))
        return self.op("CONV_2D", [x, self.half(wt),
                                   self.half(np.zeros(cout, np.float32))],
                       (1, -(-h // stride), -(-w // stride), cout),
                       padding=PADDING_SAME, stride=stride, activation=act)

    def depthwise(self, x, stride, k=3):
        """TF's SAME padding at every stride (no explicit pad)."""
        _, h, w, c = self.shape(x)
        wt = self.r.normal(math.sqrt(1.0 / (k * k)), (1, k, k, c))
        return self.op("DEPTHWISE_CONV_2D",
                       [x, self.half(wt), self.half(np.zeros(c, np.float32))],
                       (1, -(-h // stride), -(-w // stride), c),
                       padding=PADDING_SAME, stride=stride, activation=None)

    def scalar(self, v: float) -> int:
        return self.const(np.asarray([v], np.float32))

    def global_pool(self, x):
        _, h, w, c = self.shape(x)
        return self.op("AVERAGE_POOL_2D", [x], (1, 1, 1, c), padding=1,
                       filter=[h, w], stride=[h, w])

    def hard_sigmoid(self, x):
        """relu6(x + 3) / 6 as TFLite holds it: ADD with a fused RELU6,
        then MUL."""
        y = self.op("ADD", [x, self.scalar(3.0)], self.shape(x),
                    activation="RELU6")
        return self.op("MUL", [y, self.scalar(1.0 / 6.0)], self.shape(x),
                       activation=None)

    def squeeze_excite(self, x, squeeze):
        c = self.shape(x)[3]
        g = self.conv(self.global_pool(x), squeeze, 1, act="RELU")
        g = self.hard_sigmoid(self.conv(g, c, 1))
        return self.op("MUL", [x, g], self.shape(x), activation=None)

    def bneck(self, x, expand, cout, k=3, stride=1, se=False, hs=False):
        """1x1 expand (where the width changes) -> depthwise k x k ->
        (squeeze-excite) -> 1x1 project (+ residual where the shape
        stays); hard-swish or ReLU after the expand and the depthwise."""
        cin = self.shape(x)[3]

        def act(t):
            return self.op("HARD_SWISH" if hs else "RELU", [t],
                           self.shape(t))
        y = act(self.conv(x, expand, 1)) if expand != cin else x
        y = act(self.depthwise(y, stride, k))
        if se:
            y = self.squeeze_excite(y, max(8, expand // 4))
        keep = stride == 1 and cout == cin
        y = self.conv(y, cout, 1, gain=RES_GAIN if keep else 1.0)
        if keep:
            y = self.op("ADD", [x, y], self.shape(y), activation=None)
        return y

    def resize(self, x, hw):
        return self.op("RESIZE_BILINEAR", [x], (1, *hw, self.shape(x)[3]),
                       size=list(hw), align_corners=False,
                       half_pixel_centers=True)

    def transpose_conv(self, x, cout, k=2, stride=2, gain=0.5):
        """A k x k stride-s SAME ``Convolution2DTransposeBias``, filter
        ``[O, kh, kw, I]``."""
        _, h, w, cin = self.shape(x)
        wt = self.r.normal(gain * math.sqrt(2.0 * stride * stride /
                                            (k * k * cin)), (cout, k, k, cin))
        return self.op("CUSTOM:Convolution2DTransposeBias",
                       [x, self.half(wt),
                        self.half(np.zeros(cout, np.float32))],
                       (1, h * stride, w * stride, cout),
                       padding=PADDING_SAME, stride=stride)


def build(draws, spec: dict) -> Graph:
    g = SegmenterBuilder(draws)
    inp = g.tensor((1, *spec["in_hw"], 3))
    stem = g.conv(inp, spec["stem"], 3, stride=2)
    x = g.op("HARD_SWISH", [stem], g.shape(stem))
    skips = [x]
    for expand, cout, k, stride, se, hs, blocks in spec["stages"]:
        for b in range(blocks):
            x = g.bneck(x, expand, cout, k, stride if b == 0 else 1, se, hs)
        skips.append(x)
    d = skips.pop()
    for skip in reversed(skips):
        _, h, w, c = g.shape(skip)
        d = g.resize(g.conv(d, c, 1, act="RELU"), (h, w))
        gate = g.op("LOGISTIC", [g.conv(g.global_pool(d), c, 1)],
                    (1, 1, 1, c))
        d = g.op("ADD", [d, g.op("MUL", [skip, gate], g.shape(skip),
                                 activation=None)], g.shape(d),
                 activation=None)
        d = g.bneck(d, 2 * c, c)
    out = g.transpose_conv(d, spec["classes"])
    if spec["classes"] == 1:
        out = g.op("LOGISTIC", [out], g.shape(out))
    return g.graph([inp], [out], "selfie segmenter")
