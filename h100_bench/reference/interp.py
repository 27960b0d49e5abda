"""A plain PyTorch interpreter of the benchmark's network graphs.

It follows TFLite's semantics op by op (NHWC tensors, OHWI filters, TF's
SAME padding, fused activations) with nothing of the program under test:
no kernel, no capture, no cache.  ``operands`` is applied to the operands
of every convolution (transposed ones too) and fully-connected layer;
the control passes a rounding to TF32 there (:func:`round_tf32`), the
reference passes nothing.
Batches run in blocks of ``block`` rows.
"""

from __future__ import annotations

import math

import numpy as np
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
    if name == "RELU6":
        return torch.clamp(x, 0.0, 6.0)
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


def _transpose_conv(x, w, b, opts, operands, out_hw=None):
    """TFLite's transposed convolution of NHWC ``x`` by ``w`` ``[O, kh, kw,
    I]``: every input pixel scatters ``w`` at ``stride`` into the output.
    The output is ``out_hw`` where the op states it (TRANSPOSE_CONV), else
    ``in * stride`` (SAME) or ``(in - 1) * stride + k`` (VALID), and SAME
    starts it at the forward convolution's leading pad over the output;
    where the scatter is shorter the output is zero."""
    s = opts["stride"]
    k = w.shape[1:3]
    same = opts["padding"] == PADDING_SAME
    if out_hw is None:
        out_hw = [n * s if same else (n - 1) * s + kk
                  for n, kk in zip(x.shape[1:3], k)]
    x, w = x.permute(0, 3, 1, 2), w.permute(3, 0, 1, 2)    # [I, O, kh, kw]
    if operands is not None:
        x, w = operands(x), operands(w)
    y = F.conv_transpose2d(x.contiguous(), w.contiguous(), stride=s)
    start = [_same_pads(n, s, kk)[0] if same else 0
             for n, kk in zip(out_hw, k)]
    y = y[:, :, start[0]:start[0] + out_hw[0], start[1]:start[1] + out_hw[1]]
    y = F.pad(y, (0, out_hw[1] - y.shape[3], 0, out_hw[0] - y.shape[2]))
    if b is not None:
        y = y + b[:, None, None]
    return _act(y, opts.get("activation")).permute(0, 2, 3, 1)


def _average_pool(v, opts, _ops):
    """AVERAGE_POOL_2D: under SAME padding TFLite divides each window's sum
    by the count of real pixels in it."""
    (fh, fw), (sh, sw) = opts["filter"], opts["stride"]
    x = v[0].permute(0, 3, 1, 2)
    pads = (0, 0, 0, 0)
    if opts["padding"] == PADDING_SAME:
        pt, pb = _same_pads(x.shape[2], sh, fh)
        pl, pr = _same_pads(x.shape[3], sw, fw)
        pads = (pl, pr, pt, pb)
    total = F.avg_pool2d(F.pad(x, pads), (fh, fw), (sh, sw),
                         divisor_override=1)
    count = F.avg_pool2d(F.pad(torch.ones_like(x[:1, :1]), pads), (fh, fw),
                         (sh, sw), divisor_override=1)
    return _act(total / count, opts.get("activation")).permute(0, 2, 3, 1)


def _resize_taps(n_in: int, n_out: int, align_corners: bool,
                 half_pixel: bool, device):
    """TFLite's RESIZE_BILINEAR along one axis, in float32 as its kernel
    computes it: the scale ``in / out`` (``(in - 1) / (out - 1)`` with
    ``align_corners``), the source ``(i + 0.5) * scale - 0.5`` with
    half-pixel centres (else ``i * scale``), the lower tap ``max(floor,
    0)``, the upper ``min(ceil, in - 1)``, the upper's weight the source
    less the lower tap."""
    scale = np.float32((n_in - 1) / (n_out - 1) if align_corners
                       and n_out > 1 else n_in / n_out)
    i = np.arange(n_out, dtype=np.float32)
    src = ((i + np.float32(0.5)) * scale - np.float32(0.5) if half_pixel
           else i * scale)
    lo = np.maximum(np.floor(src), 0).astype(np.int64)
    hi = np.minimum(np.ceil(src), n_in - 1).astype(np.int64)
    frac = (src - lo.astype(np.float32)).astype(np.float32)
    return (torch.from_numpy(lo).to(device), torch.from_numpy(hi).to(device),
            torch.from_numpy(frac).to(device))


def _resize_bilinear(v, opts, _ops):
    x = v[0]
    for axis, n_out in ((1, opts["size"][0]), (2, opts["size"][1])):
        lo, hi, f = _resize_taps(x.shape[axis], n_out, opts["align_corners"],
                                 opts["half_pixel_centers"], x.device)
        shape = [1, 1, 1, 1]
        shape[axis] = -1
        f = f.view(shape)
        x = (x.index_select(axis, lo) * (1.0 - f)
             + x.index_select(axis, hi) * f)
    return x


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
    "RELU": lambda v, o, _: torch.relu(v[0]),
    "HARD_SWISH": lambda v, o, _: v[0] * torch.clamp(v[0] + 3.0, 0.0,
                                                      6.0) / 6.0,
    "SOFTMAX": lambda v, o, _: torch.softmax(v[0] * o.get("beta", 1.0),
                                             dim=-1),
    "AVERAGE_POOL_2D": _average_pool,
    "RESIZE_BILINEAR": _resize_bilinear,
    # MediaPipe's custom op: (x, filter, bias).
    "CUSTOM:Convolution2DTransposeBias": lambda v, o, ops: _transpose_conv(
        v[0], v[1], v[2], o, ops),
    # The builtin, as the benchmark's graphs hold it: (filter, x, bias),
    # its output shape an option.
    "TRANSPOSE_CONV": lambda v, o, ops: _transpose_conv(
        v[1], v[0], v[2] if len(v) > 2 else None, o, ops,
        o["output_shape"][1:3]),
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
