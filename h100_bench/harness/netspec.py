"""The benchmark's own frozen copy of the seeded networks: the graph
form and the layers they are made of.

The trained MediaPipe ``.tflite`` files are not in the repository, so the
benchmark builds the published topologies with weights drawn from the
run's seed.  Each network is a :class:`Graph` in TFLite's form (NHWC
tensors, OHWI filters, ``[1, kh, kw, C]`` depthwise filters, fp16 weights
behind DEQUANTIZE), made of the op mix the real files use.  The same
graph goes to the program (``system.py`` turns it into the port's IR) and
to the plain reference (``reference/interp.py``), so both compute one
function on one set of weights.

A configuration's ``networks`` maps each of the program's roles
(``detector``, ``mesh``, ``iris``, ``blendshapes``, ``embedding``) to a
spec whose ``builder`` names a module of ``h100_bench/networks/``; the
builder reads its widths and depths from the spec.  The port's
``models/random_init.py`` builds the same layouts; these are copies that
later changes to the port cannot move.

Weights are drawn on the run's device from a ``torch.Generator`` in a few
large calls (:class:`Draws`), then laid out on the host.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

PADDING_SAME = 0
PADDING_VALID = 1

# Residual-branch gain: keeps activations O(1) over ~30 residual blocks.
RES_GAIN = 0.35

@dataclasses.dataclass
class Tensor:
    shape: tuple
    data: Optional[np.ndarray] = None


@dataclasses.dataclass
class Op:
    name: str
    inputs: list
    outputs: list
    options: dict


@dataclasses.dataclass
class Graph:
    tensors: list
    ops: list
    inputs: list
    outputs: list
    description: str


class Draws:
    """Normal and uniform draws from one seed, generated on ``device`` in
    blocks of ``block`` values and served in order."""

    def __init__(self, seed: int, device, block: int = 1 << 21):
        self.gen = torch.Generator(device=device)
        self.gen.manual_seed(int(seed) % (1 << 63))
        self.device = device
        self.block = block
        self._pools = {"normal": np.zeros(0, np.float32),
                       "uniform": np.zeros(0, np.float32)}

    def _take(self, kind: str, n: int) -> np.ndarray:
        pool = self._pools[kind]
        if pool.size < n:
            size = max(self.block, n - pool.size)
            make = torch.randn if kind == "normal" else torch.rand
            fresh = make(size, generator=self.gen, device=self.device)
            pool = np.concatenate([pool, fresh.cpu().numpy()])
        self._pools[kind] = pool[n:]
        return pool[:n]

    def normal(self, std, shape) -> np.ndarray:
        n = int(np.prod(shape))
        return (self._take("normal", n) * np.float32(std)).reshape(shape)

    def uniform(self, lo, hi, shape) -> np.ndarray:
        n = int(np.prod(shape))
        u = self._take("uniform", n).reshape(shape)
        return (np.float32(lo) + u * np.float32(hi - lo)).astype(np.float32)


class Builder:
    """Appends tensors and ops to a graph under construction."""

    def __init__(self, draws: Draws):
        self.r = draws
        self.tensors: list[Tensor] = []
        self.ops: list[Op] = []

    def tensor(self, shape, data=None) -> int:
        self.tensors.append(Tensor(tuple(int(d) for d in shape), data))
        return len(self.tensors) - 1

    def const(self, arr) -> int:
        return self.tensor(np.shape(arr), np.asarray(arr))

    def shape(self, t: int) -> tuple:
        return self.tensors[t].shape

    def op(self, name, inputs, out_shape, **options) -> int:
        out = self.tensor(out_shape)
        self.ops.append(Op(name, list(inputs), [out], options))
        return out

    def graph(self, inputs, outputs, description) -> Graph:
        return Graph(self.tensors, self.ops, list(inputs), list(outputs),
                     description)

    def half(self, arr) -> int:
        """A constant stored as float16 behind DEQUANTIZE."""
        arr = np.asarray(arr, np.float32)
        return self.op("DEQUANTIZE", [self.const(arr.astype(np.float16))],
                       arr.shape)

    # -- layers ------------------------------------------------------------

    def conv(self, x, cout, k, stride=1, padding=PADDING_SAME, act=None,
             gain=1.0, bias=None, weights=None):
        _, h, w, cin = self.shape(x)
        wt = self.r.normal(gain * math.sqrt(2.0 / (k * k * cin)),
                           (cout, k, k, cin))
        if weights == "zero_sum":
            # A flat region (the letterbox padding) then maps to exactly 0.
            wt = wt - wt.mean(axis=(1, 2, 3), keepdims=True)
        elif weights == "positive":
            wt = np.abs(wt)
        b = np.zeros(cout, np.float32) if bias is None else bias
        if padding == PADDING_SAME:
            oh, ow = -(-h // stride), -(-w // stride)
        else:
            oh, ow = (h - k) // stride + 1, (w - k) // stride + 1
        return self.op("CONV_2D", [x, self.const(wt.astype(np.float32)),
                                   self.const(np.asarray(b, np.float32))],
                       (1, oh, ow, cout), padding=padding, stride=stride,
                       activation=act)

    def depthwise(self, x, stride, k=3):
        _, h, w, c = self.shape(x)
        if stride == 2:
            # Explicit (0, k - 1) spatial pad then VALID, as the files do.
            x = self.pad(x, [[0, 0], [0, k - 1], [0, k - 1], [0, 0]])
            h, w = h + k - 1, w + k - 1
            padding, oh, ow = (PADDING_VALID, (h - k) // 2 + 1,
                               (w - k) // 2 + 1)
        else:
            padding, oh, ow = PADDING_SAME, h, w
        wt = self.r.normal(math.sqrt(1.0 / (k * k)), (1, k, k, c))
        return self.op("DEPTHWISE_CONV_2D",
                       [x, self.const(wt), self.const(np.zeros(c, np.float32))],
                       (1, oh, ow, c), padding=padding, stride=stride,
                       activation=None)

    def pad(self, x, pads):
        shp = [d + a + b for d, (a, b) in zip(self.shape(x), pads)]
        return self.op("PAD", [x, self.const(np.asarray(pads, np.int32))], shp)

    def prelu(self, x):
        c = self.shape(x)[3]
        return self.op("PRELU", [x, self.const(self.r.uniform(0.1, 0.3,
                                                              (1, 1, c)))],
                       self.shape(x))

    def block(self, x, cout, stride=1, prelu=False):
        """BlazeBlock: dw 3x3 -> pw 1x1 (+ residual) -> ReLU / PReLU."""
        _, h, w, cin = self.shape(x)
        y = self.conv(self.depthwise(x, stride), cout, 1, gain=RES_GAIN)
        res = x
        if stride == 2:
            res = self.op("MAX_POOL_2D", [res], (1, h // 2, w // 2, cin),
                          stride=2, filter=2)
        if cout > cin:
            res = self.pad(res, [[0, 0], [0, 0], [0, 0], [0, cout - cin]])
        out = self.op("ADD", [y, res], self.shape(y),
                      activation=None if prelu else "RELU")
        return self.prelu(out) if prelu else out

    def head(self, x, per_anchor, gain, bias, weights=None):
        """1x1 head flattened to [1, cells * anchors, per_anchor]."""
        _, h, w, _ = self.shape(x)
        y = self.conv(x, bias.size, 1, gain=gain, bias=bias, weights=weights)
        shp = (1, h * w * bias.size // per_anchor, per_anchor)
        return self.op("RESHAPE", [y], shp, new_shape=list(shp))

    def fc(self, x, cout, gain=1.0, bias_std=0.0):
        """FULLY_CONNECTED over the last axis, fp16 weights [cout, cin]."""
        cin = self.shape(x)[-1]
        w = self.r.normal(gain / math.sqrt(cin), (cout, cin))
        b = self.r.normal(bias_std, (cout,))
        return self.op("FULLY_CONNECTED", [x, self.half(w), self.half(b)],
                       self.shape(x)[:-1] + (cout,), keep_num_dims=True)

    def mean(self, x, axes, keep_dims=True):
        shp = tuple(1 if i in axes else d for i, d in enumerate(self.shape(x)))
        if not keep_dims:
            shp = tuple(d for i, d in enumerate(self.shape(x))
                        if i not in axes)
        return self.op("MEAN", [x], shp, axes=list(axes), keep_dims=keep_dims)

    def layer_norm(self, x, eps=1e-6):
        """Layer norm over the last axis in TensorFlow's op sequence."""
        c = self.shape(x)[-1]
        last = len(self.shape(x)) - 1
        m = self.mean(x, [last])
        var = self.mean(self.op("SQUARED_DIFFERENCE", [x, m], self.shape(x)),
                        [last])
        r = self.op("RSQRT", [self.op(
            "ADD", [var, self.const(np.asarray(eps, np.float32))],
            self.shape(var), activation=None)], self.shape(var))
        gamma = self.half(1.0 + self.r.normal(0.1, (1, 1, c)))
        beta = self.half(self.r.normal(0.1, (1, 1, c)))
        s = self.op("MUL", [r, gamma], self.shape(x))
        shift = self.op("ADD", [self.op(
            "MUL", [self.op("NEG", [m], self.shape(m)), s], self.shape(x)),
            beta], self.shape(x), activation=None)
        return self.op("ADD", [self.op("MUL", [x, s], self.shape(x)), shift],
                       self.shape(x), activation=None)

    def transpose(self, x, perm):
        return self.op("TRANSPOSE", [x], tuple(self.shape(x)[p] for p in perm),
                       perm=list(perm))

    def mlp(self, x, hidden):
        y = self.fc(x, hidden, bias_std=0.1)
        y = self.op("GELU", [y], self.shape(y))
        return self.fc(y, self.shape(x)[-1], gain=RES_GAIN, bias_std=0.1)


def score_bias_tensors(graph: Graph) -> list[int]:
    """Tensor indices of the detector's score-head biases."""
    producer = {op.outputs[0]: op for op in graph.ops}
    out = producer[graph.outputs[1]]
    reshapes = ([producer[t] for t in out.inputs]
                if out.name == "CONCATENATION" else [out])
    return [producer[r.inputs[0]].inputs[2] for r in reshapes]


def calibrate_score_bias(graph: Graph, logits: np.ndarray,
                         per_image: float) -> float:
    """Shifts the score-head biases in place so that about ``per_image``
    anchors a frame pass logit 0 on the frames that gave ``logits``
    ([B, A]).  The cut sits midway across the widest gap between
    neighbouring pooled logits within an eighth of the target count, so
    that no anchor of these frames lies near the threshold.  Returns the
    shift."""
    pooled = np.sort(np.asarray(logits, np.float64).reshape(-1))[::-1]
    m = max(1, int(round(per_image * logits.shape[0])))
    lo, hi = max(1, m - m // 8), min(pooled.size - 1, m + m // 8)
    gaps = pooled[lo - 1:hi] - pooled[lo:hi + 1]
    j = lo + int(np.argmax(gaps))
    shift = -0.5 * (pooled[j - 1] + pooled[j])
    for t in score_bias_tensors(graph):
        tt = graph.tensors[t]
        tt.data = (tt.data + shift).astype(np.float32)
    return float(shift)


def build_networks(config: dict, seed: int, device) -> dict:
    """Every network of ``config`` with weights from ``seed`` (the
    detector's score heads not yet calibrated), keyed by role: a graph,
    or a parameter dict where the port loads the network from a
    checkpoint.  The ``i``-th role of ``networks`` (in the file's order,
    empty roles counted) draws from the stream ``seed * 8 + i``."""
    from .manifest import plugin
    out = {}
    for i, (role, spec) in enumerate(config["networks"].items()):
        if spec:
            out[role] = plugin("networks", spec["builder"]).build(
                Draws(seed * 8 + i, device), spec)
    return out
