"""ArcFace's iResNet in plain PyTorch, and the TFLite form a converter
makes of it.

:class:`IResNet` follows InsightFace's
``recognition/arcface_torch/backbones/iresnet.py`` (``iresnet50``:
``layers = [3, 4, 14, 3]``, trained as ``w600k_r50`` of the ``buffalo_l``
pack; Deng et al., "ArcFace", arXiv 1801.07698), in NCHW with
``nn.Conv2d``, ``nn.BatchNorm2d`` in eval on its running statistics,
``nn.PReLU``, an NCHW flatten, ``nn.Linear`` and ``nn.BatchNorm1d``:

* stem: ``conv3x3(3 -> w0, stride 1, pad 1, no bias) -> BN -> PReLU``;
* four stages of ``IBasicBlock`` at ``widths``, the first block of each
  at stride 2:
  ``BN3(conv3x3_s(PReLU(BN2(conv3x3_1(BN1(x)))))) + identity``, the
  stride on the second convolution, ``identity`` = ``x`` or
  ``BN(conv1x1_s(x))`` where the stride or the width changes, no
  activation after the add; every BN's eps 1e-5;
* head: ``BN2d -> dropout(p=0) -> flatten (NCHW) -> Linear -> BN1d``,
  the BN1d's scale fixed at 1 as InsightFace freezes it.

Departures from the published code: no ``fp16`` autocast branch and no
``dilation`` or ``groups`` options (``iresnet50`` uses neither); the
flattened size comes from ``input_size`` (InsightFace fixes 7 x 7, which
is ``input_size`` 112); the seeded weights of :func:`seeded` stand in for
the trained file, which is not in the repository.

:func:`tflite_form` is the graph a converter writes of it (NHWC tensors,
OHWI filters, TFLite's op names and the port's option names): BN2, BN3,
the stem's BN and each downsample's BN folded into their convolutions as
scale and bias, BN1d folded into the fully-connected layer; BN1 (before
a zero-padded convolution, so no fold is exact) and the head's BN2d as a
per-channel MUL and ADD; each stride-2 3x3 convolution as an explicit
symmetric PAD of 1 then VALID, since TF's SAME pads (0, 1) there; the
fully-connected rows permuted to the NHWC flatten order.

Imports only ``torch`` and ``numpy``: no kernel, cache or batching of
the port.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
from torch import nn

PADDING_SAME = 0
PADDING_VALID = 1
EPS = 1e-5

#: iresnet50's stages and widths.
LAYERS_50 = (3, 4, 14, 3)
WIDTHS = (64, 128, 256, 512)


def conv3x3(cin: int, cout: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 3, stride, 1, bias=False)


def conv1x1(cin: int, cout: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 1, stride, bias=False)


class IBasicBlock(nn.Module):
    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: nn.Module | None = None):
        super().__init__()
        self.bn1 = nn.BatchNorm2d(inplanes, eps=EPS)
        self.conv1 = conv3x3(inplanes, planes)
        self.bn2 = nn.BatchNorm2d(planes, eps=EPS)
        self.prelu = nn.PReLU(planes)
        self.conv2 = conv3x3(planes, planes, stride)
        self.bn3 = nn.BatchNorm2d(planes, eps=EPS)
        self.downsample = downsample
        self.stride = stride

    def forward(self, x):
        identity = x
        out = self.bn3(self.conv2(self.prelu(self.bn2(self.conv1(
            self.bn1(x))))))
        if self.downsample is not None:
            identity = self.downsample(x)
        return out + identity


class IResNet(nn.Module):
    """``forward(x [N, 3, S, S])`` (RGB in [-1, 1]) -> ``[N,
    num_features]``, not normalised.  Sets TF32 off for cuBLAS and cuDNN
    when built: the reference is float32."""

    def __init__(self, layers=LAYERS_50, widths=WIDTHS,
                 num_features: int = 512, input_size: int = 112):
        super().__init__()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.inplanes = widths[0]
        self.conv1 = conv3x3(3, widths[0])
        self.bn1 = nn.BatchNorm2d(widths[0], eps=EPS)
        self.prelu = nn.PReLU(widths[0])
        self.layers = nn.ModuleList(
            self._make_layer(w, n, 2) for w, n in zip(widths, layers))
        self.bn2 = nn.BatchNorm2d(widths[-1], eps=EPS)
        self.dropout = nn.Dropout(p=0.0)
        side = input_size // 16
        self.fc = nn.Linear(widths[-1] * side * side, num_features)
        self.features = nn.BatchNorm1d(num_features, eps=EPS)
        nn.init.constant_(self.features.weight, 1.0)
        self.features.weight.requires_grad = False

    def _make_layer(self, planes: int, blocks: int, stride: int):
        downsample = None
        if stride != 1 or self.inplanes != planes:
            downsample = nn.Sequential(
                conv1x1(self.inplanes, planes, stride),
                nn.BatchNorm2d(planes, eps=EPS))
        out = [IBasicBlock(self.inplanes, planes, stride, downsample)]
        self.inplanes = planes
        out += [IBasicBlock(planes, planes) for _ in range(1, blocks)]
        return nn.Sequential(*out)

    def forward(self, x):
        x = self.prelu(self.bn1(self.conv1(x)))
        for layer in self.layers:
            x = layer(x)
        x = self.dropout(self.bn2(x))
        return self.features(self.fc(torch.flatten(x, 1)))


def _batch_norms(model: IResNet):
    return [m for m in model.modules()
            if isinstance(m, (nn.BatchNorm2d, nn.BatchNorm1d))]


def seeded(model: IResNet, seed: int, res_gain: float = 0.35) -> IResNet:
    """``model`` with seeded weights and batch-norm statistics under which
    the activations stay O(1) over every block, in eval mode.  Filters
    are normal with variance 1 / fan_in; each BN's running variance is
    the variance its input has under these draws (times U(0.8, 1.25)),
    its running mean N(0, 0.1) of that scale, its scale U(0.8, 1.2) and
    its shift N(0, 0.1), so that it normalises; each block's BN3 scale is
    ``res_gain`` times that, as trained residual networks keep their
    branches small; the PReLU slopes U(0.1, 0.3); the fully-connected
    layer's bias N(0, 0.1); the BN1d's scale stays 1."""
    rng = np.random.default_rng(seed)

    def normal(std, shape):
        return torch.from_numpy(rng.normal(0.0, std, shape).astype(
            np.float32))

    def uniform(lo, hi, shape):
        return torch.from_numpy(rng.uniform(lo, hi, shape).astype(
            np.float32))

    def conv(m: nn.Conv2d):
        fan_in = m.in_channels * m.kernel_size[0] * m.kernel_size[1]
        m.weight.data = normal(math.sqrt(1.0 / fan_in), m.weight.shape)

    def bn(m, var, gain=1.0, scale=True):
        c = m.num_features
        m.running_var = uniform(0.8, 1.25, (c,)) * var
        m.running_mean = normal(0.1 * math.sqrt(var), (c,))
        if scale:
            m.weight.data = uniform(0.8, 1.2, (c,)) * gain
        m.bias.data = normal(0.1, (c,))

    def prelu(m: nn.PReLU):
        m.weight.data = uniform(0.1, 0.3, m.weight.shape)

    prelu_gain = 0.52          # the variance a unit normal keeps in PReLU
    conv(model.conv1)
    bn(model.bn1, 1.0 / 3.0)   # a [-1, 1] crop's variance, about
    prelu(model.prelu)
    var = prelu_gain
    for layer in model.layers:
        for block in layer:
            bn(block.bn1, var)
            conv(block.conv1)
            bn(block.bn2, 1.0)
            prelu(block.prelu)
            conv(block.conv2)
            bn(block.bn3, prelu_gain, gain=res_gain)
            if block.downsample is not None:
                conv(block.downsample[0])
                bn(block.downsample[1], var)
                var = 1.0
            var += res_gain ** 2
    bn(model.bn2, var)
    model.fc.weight.data = normal(math.sqrt(1.0 / model.fc.in_features),
                                  model.fc.weight.shape)
    model.fc.bias.data = normal(0.1, model.fc.bias.shape)
    bn(model.features, 1.0, scale=False)
    return model.eval()


def bn_affine(m) -> tuple[np.ndarray, np.ndarray]:
    """(scale, shift) of a batch norm in eval: ``y = x * scale + shift``,
    computed in float64."""
    var = m.running_var.double().numpy()
    mean = m.running_mean.double().numpy()
    gamma = m.weight.detach().double().numpy()
    beta = m.bias.detach().double().numpy()
    s = gamma / np.sqrt(var + m.eps)
    return s, beta - mean * s


@dataclasses.dataclass
class Tensor:
    shape: tuple
    data: np.ndarray | None = None


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


def tflite_form(model: IResNet, input_size: int = 112) -> Graph:
    """The TFLite-form graph of ``model`` (see the module's docstring):
    input ``[1, S, S, 3]``, output ``[1, num_features]``."""
    tensors: list[Tensor] = []
    ops: list[Op] = []

    def tensor(shape, data=None) -> int:
        tensors.append(Tensor(tuple(int(d) for d in shape), data))
        return len(tensors) - 1

    def const(arr) -> int:
        arr = np.asarray(arr)
        return tensor(arr.shape, arr)

    def op(name, inputs, shape, **options) -> int:
        out = tensor(shape)
        ops.append(Op(name, list(inputs), [out], options))
        return out

    def shape(t):
        return tensors[t].shape

    def conv(x, m: nn.Conv2d, norm, stride=1):
        """``norm(m(x))`` with the BN folded into the filter and bias."""
        s, t = bn_affine(norm)
        w = m.weight.detach().double().numpy() * s[:, None, None, None]
        w = w.transpose(0, 2, 3, 1).astype(np.float32)          # OHWI
        k = w.shape[1]
        _, h, _, _ = shape(x)
        padding = PADDING_SAME
        if stride == 2 and k == 3:
            x = op("PAD", [x, const(np.asarray(
                [[0, 0], [1, 1], [1, 1], [0, 0]], np.int32))],
                (1, h + 2, h + 2, shape(x)[3]))
            padding, h = PADDING_VALID, h + 2
        oh = ((h - k) // stride + 1 if padding == PADDING_VALID
              else -(-h // stride))
        return op("CONV_2D", [x, const(w), const(t.astype(np.float32))],
                  (1, oh, oh, w.shape[0]), padding=padding, stride_w=stride,
                  stride_h=stride, dilation_w=1, dilation_h=1,
                  activation=None)

    def prelu(x, m: nn.PReLU):
        a = m.weight.detach().numpy().astype(np.float32).reshape(1, 1, -1)
        return op("PRELU", [x, const(a)], shape(x))

    def affine(x, norm):
        s, t = bn_affine(norm)
        y = op("MUL", [x, const(s.astype(np.float32))], shape(x),
               activation=None)
        return op("ADD", [y, const(t.astype(np.float32))], shape(x),
                  activation=None)

    x0 = tensor((1, input_size, input_size, 3))
    x = prelu(conv(x0, model.conv1, model.bn1), model.prelu)
    for layer in model.layers:
        for block in layer:
            out = conv(affine(x, block.bn1), block.conv1, block.bn2)
            out = conv(prelu(out, block.prelu), block.conv2, block.bn3,
                       block.stride)
            identity = x
            if block.downsample is not None:
                identity = conv(x, block.downsample[0], block.downsample[1],
                                block.stride)
            x = op("ADD", [out, identity], shape(out), activation=None)
    x = affine(x, model.bn2)
    _, h, w, c = shape(x)
    flat = op("RESHAPE", [x, const(np.asarray([1, h * w * c], np.int32))],
              (1, h * w * c), new_shape=[1, h * w * c])
    s, t = bn_affine(model.features)
    fc_w = model.fc.weight.detach().double().numpy()
    fc_w = fc_w.reshape(-1, c, h, w).transpose(0, 2, 3, 1).reshape(
        fc_w.shape[0], -1)                          # NHWC flatten order
    fc_b = model.fc.bias.detach().double().numpy()
    y = op("FULLY_CONNECTED", [flat, const((fc_w * s[:, None]).astype(
        np.float32)), const((fc_b * s + t).astype(np.float32))],
        (1, fc_w.shape[0]), activation=None, keep_num_dims=False)
    return Graph(tensors, ops, [x0], [y])
