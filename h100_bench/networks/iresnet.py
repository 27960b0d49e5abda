"""ArcFace's iResNet (InsightFace ``recognition/arcface_torch/backbones/
iresnet.py``; ``iresnet50`` is ``layers = [3, 4, 14, 3]``, trained as
``w600k_r50`` of the ``buffalo_l`` pack) in the TFLite form a converter
writes of it, with seeded weights and batch-norm statistics.

``input`` x ``input`` x 3 in [-1, 1]: the stem ``conv3x3(3 -> widths[0])
-> BN -> PReLU``, then ``layers[i]`` ``IBasicBlock``s at ``widths[i]``,
the first of each stage at stride 2 (``BN3(conv3x3_s(PReLU(BN2(
conv3x3_1(BN1(x)))))) + identity``, ``identity`` the input or
``BN(conv1x1_s(x))``, no activation after the add), then ``BN2d ->
flatten -> Linear -> BN1d`` to ``embedding_dim``; every BN's eps 1e-5.

The form: the BNs after a convolution (BN2, BN3, the stem's, each
downsample's) folded into its filter and bias, the BN1d into the
fully-connected layer (its scale fixed at 1, as InsightFace freezes it);
BN1, which a zero-padded convolution follows so that no fold is exact,
and the head's BN2d as a per-channel MUL and ADD; each stride-2 3x3
convolution as an explicit symmetric PAD of 1 then VALID (TF's SAME
would pad (0, 1)); the fully-connected rows in NHWC flatten order.  All
constants float32, the folds computed in float64.

The draws keep the activations O(1) through every block: filters normal
with variance 1 / fan_in; each BN's running variance the variance its
input has under these draws (times U(0.8, 1.25)), its running mean
N(0, 0.1) of that scale, its scale U(0.8, 1.2) and its shift N(0, 0.1);
each block's BN3 scale ``RES_GAIN`` times that, as trained residual
networks keep their branches small; PReLU slopes U(0.1, 0.3); the
fully-connected bias N(0, 0.1).
"""

from __future__ import annotations

import math

import numpy as np

from h100_bench.harness.netspec import (PADDING_SAME, PADDING_VALID,
                                        RES_GAIN, Builder, Graph)

EPS = 1e-5
#: The variance a unit normal keeps through a PReLU of slope about 0.2.
PRELU_GAIN = 0.52


def parameters(spec: dict) -> int:
    """The published network's parameters (filters, each BN's scale and
    shift, the PReLU slopes, the fully-connected weights and bias and
    the BN1d's scale and shift): 43,590,848 for iresnet50."""
    widths, c = spec["widths"], spec["widths"][0]
    side = spec["input"] // 16
    total = 27 * c + 3 * c                          # stem conv, BN, PReLU
    for w, n in zip(widths, spec["layers"]):
        total += 2 * c + 9 * c * w + 3 * w + 9 * w * w + 2 * w   # block 1
        total += w * c + 2 * w                      # its downsample
        total += (n - 1) * (2 * w + 9 * w * w + 3 * w + 9 * w * w + 2 * w)
        c = w
    d = spec["embedding_dim"]
    return total + 2 * c + c * side * side * d + d + 2 * d


class _Net:
    """Draws and folds the layers onto a graph under construction."""

    def __init__(self, draws):
        self.g = Builder(draws)
        self.r = draws

    def bn(self, c: int, var: float, gain: float = 1.0, scale: bool = True
           ) -> tuple[np.ndarray, np.ndarray]:
        """(scale, shift) in float64 of a seeded BN in eval over an input
        of variance about ``var``."""
        running_var = self.r.uniform(0.8, 1.25, (c,)).astype(
            np.float64) * var
        mean = self.r.normal(0.1 * math.sqrt(var), (c,)).astype(np.float64)
        gamma = (self.r.uniform(0.8, 1.2, (c,)).astype(np.float64) * gain
                 if scale else np.ones(c))
        beta = self.r.normal(0.1, (c,)).astype(np.float64)
        s = gamma / np.sqrt(running_var + EPS)
        return s, beta - mean * s

    def conv(self, x, cout: int, k: int, stride: int, var: float,
             gain: float = 1.0):
        """``BN(conv(x))`` with the BN folded (filter drawn first)."""
        g = self.g
        _, h, _, cin = g.shape(x)
        w = self.r.normal(math.sqrt(1.0 / (k * k * cin)), (cout, k, k, cin))
        s, t = self.bn(cout, var, gain)
        w = (w.astype(np.float64) * s[:, None, None, None]).astype(
            np.float32)
        padding = PADDING_SAME
        if stride == 2 and k == 3:
            x = g.pad(x, [[0, 0], [1, 1], [1, 1], [0, 0]])
            padding, h = PADDING_VALID, h + 2
        oh = ((h - k) // stride + 1 if padding == PADDING_VALID
              else -(-h // stride))
        return g.op("CONV_2D", [x, g.const(w), g.const(t.astype(np.float32))],
                    (1, oh, oh, cout), padding=padding, stride=stride,
                    activation=None)

    def prelu(self, x):
        c = self.g.shape(x)[3]
        return self.g.op("PRELU", [x, self.g.const(
            self.r.uniform(0.1, 0.3, (1, 1, c)))], self.g.shape(x))

    def affine(self, x, var: float):
        """A BN kept in the graph: MUL by its scale, ADD of its shift."""
        g = self.g
        s, t = self.bn(g.shape(x)[3], var)
        y = g.op("MUL", [x, g.const(s.astype(np.float32))], g.shape(x),
                 activation=None)
        return g.op("ADD", [y, g.const(t.astype(np.float32))], g.shape(x),
                    activation=None)


def build(draws, spec: dict) -> Graph:
    net = _Net(draws)
    g = net.g
    size, widths = spec["input"], spec["widths"]
    inp = g.tensor((1, size, size, 3))
    x = net.prelu(net.conv(inp, widths[0], 3, 1, 1.0 / 3.0))
    var = PRELU_GAIN
    for w, n in zip(widths, spec["layers"]):
        for j in range(n):
            stride = 2 if j == 0 else 1
            h = net.conv(net.affine(x, var), w, 3, 1, 1.0)
            h = net.conv(net.prelu(h), w, 3, stride, PRELU_GAIN,
                         gain=RES_GAIN)
            identity = x
            if j == 0:
                identity = net.conv(x, w, 1, stride, var)
                var = 1.0
            x = g.op("ADD", [h, identity], g.shape(h), activation=None)
            var += RES_GAIN ** 2
    x = net.affine(x, var)
    _, hh, ww, c = g.shape(x)
    flat = g.op("RESHAPE", [x], (1, hh * ww * c), new_shape=[1, hh * ww * c])
    d = spec["embedding_dim"]
    # The NCHW-ordered rows of the published layer, permuted to NHWC.
    fc_w = draws.normal(math.sqrt(1.0 / (c * hh * ww)), (d, c, hh, ww))
    fc_w = fc_w.transpose(0, 2, 3, 1).reshape(d, -1).astype(np.float64)
    fc_b = draws.normal(0.1, (d,)).astype(np.float64)
    s, t = net.bn(d, 1.0, scale=False)
    y = g.op("FULLY_CONNECTED", [flat, g.const(
        (fc_w * s[:, None]).astype(np.float32)), g.const(
        (fc_b * s + t).astype(np.float32))], (1, d), keep_num_dims=False)
    return g.graph([inp], [y], f"iresnet {spec['layers']} "
                               f"{spec['widths']} -> {d}")
