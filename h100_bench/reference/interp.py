"""A plain PyTorch interpreter of the benchmark's network graphs.

It follows TFLite's semantics op by op (NHWC tensors, OHWI filters, TF's
SAME padding, fused activations) with nothing of the program under test:
no kernel, no capture, no cache.  ``operands`` is applied to the operands
of every convolution and fully-connected layer; the control passes a
rounding to TF32 there (:func:`round_tf32`), the reference passes nothing.
Batches run in blocks of ``block`` rows.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

PADDING_SAME = 0


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to TF32's 10-bit mantissa, to nearest even,
    as the tensor cores round their operands."""
    bits = x.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    bits = (bits + 0x0FFF + lsb) & ~0x1FFF
    return bits.view(torch.float32)


def _same_pads(n: int, stride: int, k: int) -> tuple[int, int]:
    out = -(-n // stride)
    total = max((out - 1) * stride + k - n, 0)
    return total // 2, total - total // 2


def _act(x, name):
    if name == "RELU":
        return torch.relu(x)
    if name is None:
        return x
    raise ValueError(f"activation {name!r}")


def _conv(x, w, b, opts, depthwise: bool, operands):
    """NHWC ``x``; ``w`` OHWI (or [1, kh, kw, C] depthwise)."""
    x = x.permute(0, 3, 1, 2)
    if depthwise:
        w = w.permute(3, 0, 1, 2)          # [C, 1, kh, kw]
        groups = x.shape[1]
    else:
        w = w.permute(0, 3, 1, 2)          # OIHW
        groups = 1
    s = opts["stride"]
    if opts["padding"] == PADDING_SAME:
        pt, pb = _same_pads(x.shape[2], s, w.shape[2])
        pl, pr = _same_pads(x.shape[3], s, w.shape[3])
        x = F.pad(x, (pl, pr, pt, pb))
    if operands is not None:
        x, w = operands(x), operands(w)
    y = F.conv2d(x.contiguous(), w.contiguous(), b, stride=s, groups=groups)
    return _act(y, opts.get("activation")).permute(0, 2, 3, 1)


def _binary(fn):
    def run(v, opts, _ops):
        return _act(fn(v[0], v[1]), opts.get("activation"))
    return run


def _reshape(v, opts, _ops):
    shape = list(opts["new_shape"])
    shape[0] = v[0].shape[0]
    return v[0].reshape(shape)


def _fc(v, opts, operands):
    x, w, b = v
    if not opts.get("keep_num_dims"):
        x = x.reshape(x.shape[0], -1)
    if operands is not None:
        x, w = operands(x), operands(w)
    return torch.matmul(x, w.t()) + b


_OPS = {
    "PAD": lambda v, o, _: F.pad(v[0], [int(p) for pair in reversed(
        v[1].tolist()) for p in pair]),
    "CONV_2D": lambda v, o, ops: _conv(v[0], v[1], v[2], o, False, ops),
    "DEPTHWISE_CONV_2D": lambda v, o, ops: _conv(v[0], v[1], v[2], o, True,
                                                 ops),
    "MAX_POOL_2D": lambda v, o, _: F.max_pool2d(
        v[0].permute(0, 3, 1, 2), o["filter"], o["stride"]).permute(
            0, 2, 3, 1),
    "ADD": _binary(torch.add),
    "SUB": _binary(torch.sub),
    "MUL": _binary(torch.mul),
    "SQUARED_DIFFERENCE": lambda v, o, _: (v[0] - v[1]) ** 2,
    "PRELU": lambda v, o, _: torch.where(v[0] >= 0, v[0], v[0] * v[1]),
    "RESHAPE": _reshape,
    "CONCATENATION": lambda v, o, _: torch.cat(v, dim=o["axis"]),
    "FULLY_CONNECTED": _fc,
    "MEAN": lambda v, o, _: torch.mean(v[0], dim=o["axes"],
                                       keepdim=o["keep_dims"]),
    "RSQRT": lambda v, o, _: torch.rsqrt(v[0]),
    "NEG": lambda v, o, _: -v[0],
    "GELU": lambda v, o, _: 0.5 * v[0] * (1.0 + torch.erf(
        v[0] / math.sqrt(2.0))),
    "LOGISTIC": lambda v, o, _: torch.sigmoid(v[0]),
    "DEQUANTIZE": lambda v, o, _: v[0].float(),
    "TRANSPOSE": lambda v, o, _: v[0].permute(*o["perm"]),
}


class Network:
    """A graph ready to run on ``device``: its constants uploaded once."""

    def __init__(self, graph, device):
        self.graph = graph
        self.consts = {}
        for i, t in enumerate(graph.tensors):
            if t.data is not None:
                self.consts[i] = torch.as_tensor(t.data).to(device)

    def _run(self, x: torch.Tensor, operands) -> list[torch.Tensor]:
        g = self.graph
        vals = dict(self.consts)
        vals[g.inputs[0]] = x
        for op in g.ops:
            vals[op.outputs[0]] = _OPS[op.name](
                [vals[i] for i in op.inputs], op.options, operands)
        return [vals[o] for o in g.outputs]

    def __call__(self, x: torch.Tensor, operands=None, block: int = 256
                 ) -> list[torch.Tensor]:
        """The graph's outputs for ``x`` ([N, ...]), in blocks of rows."""
        if x.shape[0] == 0:
            return [torch.zeros((0,) + tuple(self.graph.tensors[o].shape[1:]),
                                device=x.device)
                    for o in self.graph.outputs]
        parts = [self._run(x[i:i + block], operands)
                 for i in range(0, x.shape[0], block)]
        return [torch.cat(p) for p in zip(*parts)]
