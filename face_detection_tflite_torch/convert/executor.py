"""ModelIR -> ``torch.nn.Module``.

Port of the JAX package's ``convert/executor.py::convert_model``: every op
that executor lowers, its precision tiers and its fake-quant emulation of
quantized graphs.  Each ``.tflite`` graph is converted once into a module
whose weights are buffers; the module runs eagerly on the device its
buffers live on.

Precision tiers (the JAX executor's ``precision``): a tier names the
operand precision of the convolutions, transposed convolutions,
FULLY_CONNECTED and BATCH_MATMUL ops.  ``"highest"`` runs them in fp32
with TF32 off; ``"default"`` (one bf16 pass on the TPU) feeds them bf16
operands, a bf16 copy of each weight made once when the module is built,
with fp32 accumulation, and casts the result back to fp32, so the bias
and the ops after it run in fp32; ``"high"`` (three bf16 passes on the
TPU) has no cuDNN counterpart and runs as ``"highest"``.  ``"mixed"``
resolves through :func:`mixed_precision`, and a callable
``(op_index, op_name) -> tier`` is called per op of the pruned op list.
Each module holds its per-op tiers (:attr:`ConvertedModel.tiers`);
:meth:`ConvertedModel.with_precision` re-resolves them over the same op
list, sharing the fp32 weights.  No tier sets a process-wide flag around
a forward.

Quantized graphs run as the JAX executor runs them: constants dequantize
to fp32 exactly, and every activation with a per-tensor int8, uint8 or
int16 grid is snapped to it after the op that writes it (``_fake_quant``),
as is a quantized graph input, which takes the integer dtype (dequantized)
or a float (snapped).  QUANTIZE is a cast whose snap is that output hook.

Differences from the JAX executor, all deliberate:

* the leading batch dimension may be any ``N >= 1`` where the graph says 1
  (the JAX function checks the exact shape and is vmapped instead);
  a RESHAPE whose target starts with the graph's batch of 1 takes ``N``
  there; a FULLY_CONNECTED without ``keep_num_dims`` on more than one row
  a sample flattens to ``[N * rows, in]``, and then only RESHAPEs may
  consume it; an op that would mix the batch raises when ``N > 1``:
  a reshape, pad, concatenation, pack, split, unpack, slice, tile or
  gather across axis 0, a transpose that moves it, a reduction, squeeze
  or arg-max over it, an expand-dims before it;
* tensors stay NHWC at the graph boundary and between ops; each conv runs
  as ``F.conv2d`` (a transposed conv as ``F.conv_transpose2d``) on
  ``x.permute(0, 3, 1, 2)``, which is a channels_last view, so cuDNN
  takes it without a copy;
* RESIZE_BILINEAR runs as two gathers and a lerp per axis with the
  weights of the JAX executor's interpolation matrices, not as two
  matrix products; the JAX ``rs{i}_h``/``rs{i}_w`` matrices are recomputed
  on export (:meth:`ConvertedModel.jax_params`) and ignored on import;
* a bf16 tier's convolution or product rounds its output to bf16 before
  the cast back to fp32 (cuDNN and cuBLAS write the operands' dtype),
  one rounding (2^-9 relative) that the TPU's fp32 output does not have;
* ``"high"`` runs fp32 operands, not three bf16 passes;
* a quantized int64 constant (a 16x8 graph's bias) is dequantized like
  the other quantized constants; the JAX executor keeps its raw integers;
* RESIZE_BILINEAR gathers its taps in fp32 at every tier, where the JAX
  executor's two matrix products take the op's tier.

Conversion-time passes (numpy, no device work) are those of the JAX
executor: constant fp16 ``DEQUANTIZE`` and ``DENSIFY`` fold into fp32
weights, and static shape arithmetic folds into constants.
"""

from __future__ import annotations

import re
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .tflite import ModelIR, OpIR, PADDING_SAME, densify, parse_tflite

__all__ = ["ConvertedModel", "SUPPORTED_OPS", "convert_model", "convert_file",
           "fp32_on_the_card", "mixed_precision", "params_from_jax",
           "resolve_device"]

#: Ops this executor runs: those the JAX executor lowers.  DEQUANTIZE of a
#: constant and DENSIFY fold away at conversion; a DEQUANTIZE or QUANTIZE
#: of an activation runs as a cast (the QUANTIZE's snap to its grid is the
#: output hook of every op, :func:`_fake_quant`).
SUPPORTED_OPS = frozenset({
    "CONV_2D", "DEPTHWISE_CONV_2D", "TRANSPOSE_CONV",
    "CUSTOM:Convolution2DTransposeBias", "ADD", "MUL", "SUB", "DIV",
    "PAD", "PADV2", "MIRROR_PAD", "MAX_POOL_2D", "AVERAGE_POOL_2D",
    "PRELU", "RELU", "RELU6", "LEAKY_RELU", "ELU", "TANH", "LOGISTIC",
    "GELU", "HARD_SWISH", "SOFTMAX", "RESHAPE", "SQUEEZE", "EXPAND_DIMS",
    "CONCATENATION", "FULLY_CONNECTED", "BATCH_MATMUL", "NEG",
    "SQUARED_DIFFERENCE", "RSQRT", "SQRT", "SQUARE", "EXP", "LOG", "ABS",
    "FLOOR", "POW", "MAXIMUM", "MINIMUM", "TRANSPOSE", "MEAN", "SUM",
    "REDUCE_MAX", "REDUCE_MIN", "ARG_MAX", "L2_NORMALIZATION", "CAST",
    "SLICE", "STRIDED_SLICE", "SPLIT", "UNPACK", "PACK", "TILE", "GATHER",
    "DEPTH_TO_SPACE", "SPACE_TO_DEPTH", "RESIZE_BILINEAR",
    "RESIZE_NEAREST_NEIGHBOR", "DEQUANTIZE", "QUANTIZE"})

#: Ops whose operand precision a tier sets (the JAX executor passes
#: ``precision=`` to these; its RESIZE_BILINEAR products too, which this
#: executor gathers in fp32).
_TIERED = frozenset({"CONV_2D", "DEPTHWISE_CONV_2D", "TRANSPOSE_CONV",
                     "CUSTOM:Convolution2DTransposeBias", "FULLY_CONNECTED",
                     "BATCH_MATMUL"})

#: The operand positions of a tiered op's inputs where they are not (0, 1).
_OPERANDS = {"TRANSPOSE_CONV": (1, 2)}

#: The names ``jax.lax.Precision`` takes -> the tier they name.
_TIER_NAMES = {"highest": "highest", "float32": "highest",
               "high": "high", "tensorfloat32": "high",
               "default": "default", "bfloat16": "default",
               "fastest": "default"}

#: A tier -> the operand dtype of its ops on this executor.
_TIER_DTYPE = {"highest": torch.float32, "high": torch.float32,
               "default": torch.bfloat16}

# Ops whose listed inputs at these positions are static (shape-like)
# values: the JAX executor's table, so both executors hold the same params.
_STATIC_INPUTS = {
    "RESHAPE": {1}, "PAD": {1}, "PADV2": {1, 2}, "TRANSPOSE": {1},
    "MEAN": {1}, "SUM": {1}, "REDUCE_MAX": {1}, "REDUCE_MIN": {1},
    "STRIDED_SLICE": {1, 2, 3}, "RESIZE_BILINEAR": {1},
    "RESIZE_NEAREST_NEIGHBOR": {1}, "SPLIT": {0}, "ARG_MAX": {1},
    "EXPAND_DIMS": {1}, "TILE": {1}, "SLICE": {1, 2},
    "TRANSPOSE_CONV": {0}, "MIRROR_PAD": {1}}

# Elementwise ops of one and of two operands (a fused activation, where
# the op has one, follows).
_UNARY = {
    "RELU": torch.relu, "RELU6": lambda x: torch.clamp(x, 0.0, 6.0),
    "TANH": torch.tanh, "LOGISTIC": torch.sigmoid, "NEG": torch.neg,
    "RSQRT": torch.rsqrt, "SQRT": torch.sqrt, "EXP": torch.exp,
    "LOG": torch.log, "ABS": torch.abs, "FLOOR": torch.floor, "ELU": F.elu,
    "SQUARE": lambda x: x * x,
    "HARD_SWISH": lambda x: x * torch.clamp(x + 3.0, 0.0, 6.0) / 6.0,
    "DEQUANTIZE": lambda x: x.float(), "QUANTIZE": lambda x: x.float()}
_BINARY = {
    "ADD": torch.add, "SUB": torch.sub, "MUL": torch.mul, "DIV": torch.div,
    "MAXIMUM": torch.maximum, "MINIMUM": torch.minimum, "POW": torch.pow,
    "SQUARED_DIFFERENCE": lambda a, b: (a - b) * (a - b)}
_REDUCE = {"MEAN": torch.mean, "SUM": torch.sum, "REDUCE_MAX": torch.amax,
           "REDUCE_MIN": torch.amin}

_QUANTIZED = (np.int8, np.uint8, np.int16)

#: The integer range of each quantized activation dtype.
_QRANGE = {np.dtype(np.int8): (-128.0, 127.0),
           np.dtype(np.uint8): (0.0, 255.0),
           np.dtype(np.int16): (-32768.0, 32767.0)}


def _act(x, name):
    if name is None:
        return x
    if name == "RELU":
        return torch.relu(x)
    if name == "RELU6":
        return torch.clamp(x, 0.0, 6.0)
    if name == "RELU_N1_TO_1":
        return torch.clamp(x, -1.0, 1.0)
    if name == "TANH":
        return torch.tanh(x)
    raise NotImplementedError(f"activation {name}")


def _same_pads(in_size: int, stride: int, eff_k: int) -> tuple[int, int]:
    """TF/TFLite SAME padding: total = max((ceil(in/s)-1)*s + k_eff - in, 0)."""
    out = -(-in_size // stride)
    total = max((out - 1) * stride + eff_k - in_size, 0)
    lo = total // 2
    return lo, total - lo


def _conv_padding(opts, h, w, kh, kw) -> list[tuple[int, int]]:
    if opts["padding"] == PADDING_SAME:
        eff_kh = (kh - 1) * opts.get("dilation_h", 1) + 1
        eff_kw = (kw - 1) * opts.get("dilation_w", 1) + 1
        return [
            _same_pads(h, opts["stride_h"], eff_kh),
            _same_pads(w, opts["stride_w"], eff_kw),
        ]
    return [(0, 0), (0, 0)]


def _dequantize_const(t, data: np.ndarray) -> np.ndarray:
    """Exact dequantization of a quantized constant (per-tensor or
    per-channel along ``quant['dim']``)."""
    q = t.quant
    scale, zp = q["scale"], q["zero_point"]
    if scale.size == 1:
        return ((data.astype(np.float32) - np.float32(zp[0]))
                * np.float32(scale[0]))
    shape = [1] * data.ndim
    shape[q["dim"]] = scale.size
    return ((data.astype(np.float32) - zp.reshape(shape).astype(np.float32))
            * scale.reshape(shape).astype(np.float32))


def _fold(ir: ModelIR) -> tuple[dict[int, np.ndarray], list[OpIR]]:
    """Pass 1 of the JAX executor: constants (densified, dequantized) and
    the live op list after folding constant DEQUANTIZE / DENSIFY and
    static shape arithmetic."""
    const: dict[int, np.ndarray] = {}
    for t in ir.tensors:
        if t.data is not None:
            const[t.index] = densify(t) if t.sparsity is not None else t.data
    for t in ir.tensors:
        if t.dtype in _QUANTIZED and t.data is not None and t.quant is None:
            raise NotImplementedError(
                f"tensor {t.name!r} is {np.dtype(t.dtype).name} with no "
                "quantization parameters; cannot convert")
    # Every quantized integer constant dequantizes, the int64 biases of
    # 16x8 graphs too (the JAX executor leaves int64 constants as raw
    # integers, which adds a 16x8 graph's biases unscaled).
    for t in ir.tensors:
        if t.index in const and t.quant is not None and \
                np.issubdtype(np.dtype(t.dtype), np.integer):
            const[t.index] = _dequantize_const(t, const[t.index])

    def fold_static(op) -> bool:
        nm = op.name
        if nm == "SHAPE":
            shp = ir.tensors[op.inputs[0]].shape
            if shp and all(d > 0 for d in shp):
                const[op.outputs[0]] = np.asarray(shp, np.int32)
                return True
            return False
        ins = [i for i in op.inputs if i >= 0]
        if not ins or not all(i in const for i in ins):
            return False
        vals = [const[i] for i in ins]
        o = op.options
        if nm == "PACK" and o.get("activation") is None:
            const[op.outputs[0]] = np.stack(vals, axis=o.get("axis", 0))
        elif nm == "CONCATENATION" and o.get("activation") is None:
            const[op.outputs[0]] = np.concatenate(vals,
                                                  axis=o.get("axis", 0))
        elif nm == "STRIDED_SLICE" and vals[0].ndim == 1 and \
                not (o["ellipsis_mask"] or o["new_axis_mask"]):
            x = vals[0]
            b = 0 if (o["begin_mask"] & 1) else int(vals[1][0])
            e = x.shape[0] if (o["end_mask"] & 1) else int(vals[2][0])
            out = x[b:e:int(vals[3][0])]
            if o["shrink_axis_mask"] & 1:
                out = out[0]
            const[op.outputs[0]] = np.asarray(out)
        elif nm in ("MUL", "ADD", "SUB") and o.get("activation") is None:
            f = {"MUL": np.multiply, "ADD": np.add,
                 "SUB": np.subtract}[nm]
            const[op.outputs[0]] = f(vals[0], vals[1])
        elif nm == "CAST":
            const[op.outputs[0]] = vals[0].astype(
                ir.tensors[op.outputs[0]].dtype)
        elif nm == "EXPAND_DIMS":
            const[op.outputs[0]] = np.expand_dims(
                vals[0], int(np.atleast_1d(vals[1])[0]))
        else:
            return False
        return True

    ops: list[OpIR] = []
    for op in ir.ops:
        if op.name == "DEQUANTIZE" and op.inputs[0] in const:
            const[op.outputs[0]] = const[op.inputs[0]].astype(np.float32)
            continue
        if op.name == "DENSIFY":
            const[op.outputs[0]] = const[op.inputs[0]]
            continue
        if fold_static(op):
            continue
        if op.name not in SUPPORTED_OPS:
            raise NotImplementedError(
                f"op {op.name} not implemented in the PyTorch executor")
        ops.append(op)
    return const, ops


def _act_quant(ir: ModelIR) -> dict[int, tuple[float, float, float, float]]:
    """Tensor index -> (scale, zero point, qmin, qmax) of every activation
    on a per-tensor quantization grid (the JAX executor's ``act_quant``)."""
    out = {}
    for t in ir.tensors:
        rng = _QRANGE.get(np.dtype(t.dtype))
        if t.data is None and t.quant is not None and rng is not None \
                and t.quant["scale"].size == 1:
            out[t.index] = (float(t.quant["scale"][0]),
                            float(t.quant["zero_point"][0])) + rng
    return out


def _fake_quant(x: torch.Tensor, divisor: torch.Tensor, scale: float,
                zero_point: float, qmin: float, qmax: float) -> torch.Tensor:
    """Snaps a float activation onto its integer grid:
    dequantize(quantize(x)), rounding half to even as ``jnp.round`` does.
    ``divisor`` is ``scale`` as a 0-dim float32 tensor on ``x``'s device,
    so that ``x / divisor`` is a true division there too (a Python float
    divisor is multiplied by its reciprocal on CUDA, which moves the
    ties)."""
    q = torch.clamp(torch.round(x / divisor) + zero_point, qmin, qmax)
    return (q - zero_point) * scale


def _tier(p) -> str:
    """The canonical name of tier ``p``; a falsy tier is the JAX
    executor's ``precision=None``, the backend's default (one bf16 pass
    on the TPU)."""
    if not p:
        return "default"
    name = _TIER_NAMES.get(str(p).lower())
    if name is None:
        raise ValueError(f"unknown precision {p!r}: expected 'highest', "
                         f"'high', 'default', 'mixed' or a per-op callable")
    return name


def _resolve_tiers(ops: list[OpIR], precision) -> tuple:
    """Each op's tier (None for the ops no tier reaches): a string applies
    to every op, ``"mixed"`` resolves through :func:`mixed_precision` over
    ``ops``, and a callable ``(op_index, op_name) -> tier`` is called for
    every op of ``ops`` in order, as the JAX executor calls it."""
    if isinstance(precision, str) and precision == "mixed":
        precision = mixed_precision(ops)
    if callable(precision):
        given = [precision(i, op.name) for i, op in enumerate(ops)]
    else:
        given = [_tier(precision)] * len(ops)
    return tuple(_tier(p) if op.name in _TIERED else None
                 for op, p in zip(ops, given))


def mixed_precision(ops, frac: float = 0.5, low: str = "default",
                    high: str = "high"):
    """Per-op tier callable: the earliest ``frac`` of the conv ops run
    ``low``, the rest, the regression heads included, ``high``; the other
    products stay ``high``.  ``ops`` is the pruned executable op list, the
    index space the converter calls a tier callable with (the ``"mixed"``
    string resolves against it).  Where ``frac`` covers no conv it
    returns ``high`` itself.  The JAX package's function."""
    conv_ids = [i for i, op in enumerate(ops) if "CONV" in op.name]
    n_low = int(len(conv_ids) * frac)
    if n_low <= 0:
        return high
    cutoff = conv_ids[n_low - 1]

    def spec(oi, nm):
        if "CONV" in nm and oi <= cutoff:
            return low
        return high
    return spec


def _refresh_low(module, incompatible_keys=None) -> None:
    """Load-state-dict post hook: re-derives the bf16 weight copies from
    the fp32 weights just loaded."""
    module._make_low()


def _weight_kinds(ops: list[OpIR]) -> dict[int, str]:
    """Tensor index -> "conv" (OHWI), "dw" ([1, kh, kw, C*m]) or "tconv"
    (a transposed conv's [O, kh, kw, I]) for the filter inputs whose
    layout this executor changes."""
    kinds: dict[int, str] = {}
    for op in ops:
        if op.name == "CONV_2D":
            kinds[op.inputs[1]] = "conv"
        elif op.name == "DEPTHWISE_CONV_2D":
            kinds[op.inputs[1]] = "dw"
        elif op.name in ("TRANSPOSE_CONV", "CUSTOM:Convolution2DTransposeBias"):
            kinds[op.inputs[1]] = "tconv"
    return kinds


#: The permutation from this executor's filter layouts back to TFLite's.
_TO_TFLITE = {"conv": (0, 2, 3, 1), "dw": (1, 2, 3, 0), "tconv": (1, 2, 3, 0)}


def _port_tensor(kind: str | None, arr: np.ndarray) -> torch.Tensor:
    """A TFLite-layout constant as the tensor this executor computes with:
    OHWI conv filters become OIHW in channels_last memory (the same bytes
    as OHWI), depthwise filters [1, kh, kw, C*m] become [C*m, 1, kh, kw],
    transposed-conv filters [O, kh, kw, I] become ``F.conv_transpose2d``'s
    [I, O, kh, kw]."""
    arr = np.asarray(arr)
    if arr.dtype == np.float16:
        arr = arr.astype(np.float32)
    if kind == "conv":
        t = torch.from_numpy(np.array(arr.transpose(0, 3, 1, 2), order="C"))
        return t.contiguous(memory_format=torch.channels_last)
    if kind in ("dw", "tconv"):
        return torch.from_numpy(np.array(arr.transpose(3, 0, 1, 2), order="C"))
    return torch.from_numpy(np.array(arr))


def _resize_matrix(in_size: int, out_size: int, align_corners: bool,
                   half_pixel: bool) -> np.ndarray:
    """Dense [out, in] bilinear interpolation matrix with TFLite semantics
    (the JAX executor's ``rs{i}_h``/``rs{i}_w`` params)."""
    m = np.zeros((out_size, in_size), np.float32)
    if out_size == 1:
        src = np.array([0.0]) if align_corners else np.array(
            [0.5 * in_size / out_size - 0.5 if half_pixel else 0.0])
    elif align_corners:
        src = np.arange(out_size) * (in_size - 1) / (out_size - 1)
    else:
        scale = in_size / out_size
        if half_pixel:
            src = (np.arange(out_size) + 0.5) * scale - 0.5
        else:
            src = np.arange(out_size) * scale
    src = np.clip(src, 0.0, in_size - 1)
    lo = np.floor(src).astype(np.int64)
    hi = np.minimum(lo + 1, in_size - 1)
    frac = (src - lo).astype(np.float32)
    for o in range(out_size):
        m[o, lo[o]] += 1.0 - frac[o]
        m[o, hi[o]] += frac[o]
    return m


def _resize_taps(m: np.ndarray) -> list[np.ndarray]:
    """The two taps of each row of :func:`_resize_matrix`: (lo, hi, weight
    of lo, weight of hi), the weights read from the matrix itself (where
    lo == hi the row's one weight is lo's and hi's is 0)."""
    lo = np.argmax(m != 0, axis=1)
    hi = np.minimum(lo + 1, m.shape[1] - 1)
    rows = np.arange(m.shape[0])
    w_lo = m[rows, lo]
    w_hi = np.where(hi != lo, m[rows, hi], 0.0).astype(np.float32)
    return [lo, hi, w_lo, w_hi]


def _nearest_index(in_s: int, out_s: int, align_corners: bool,
                   half_pixel: bool) -> np.ndarray:
    """TFLite's nearest-neighbour source index: floor(i * scale), with
    half-pixel centres floor((i + 0.5) * scale), with aligned corners
    round(i * (in - 1) / (out - 1))."""
    i = np.arange(out_s)
    if align_corners and out_s > 1:
        idx = np.round(i * (in_s - 1) / (out_s - 1))
    elif half_pixel:
        idx = np.floor((i + 0.5) * in_s / out_s)
    else:
        idx = np.floor(i * in_s / out_s)
    return np.clip(idx, 0, in_s - 1).astype(np.int64)


def _pool_pads(o, h: int, w: int) -> tuple[tuple[int, int], tuple[int, int]]:
    if o["padding"] != PADDING_SAME:
        return (0, 0), (0, 0)
    return (_same_pads(h, o["stride_h"], o["filter_h"]),
            _same_pads(w, o["stride_w"], o["filter_w"]))


def _pool_count(o, h: int, w: int) -> np.ndarray:
    """[1, 1, OH, OW] count of the real pixels under each window of a SAME
    AVERAGE_POOL_2D: TFLite divides by it, not by the window's size."""
    (pt, pb), (pl, pr) = _pool_pads(o, h, w)
    ones = np.pad(np.ones((h, w), np.float32), ((pt, pb), (pl, pr)))
    fh, fw, sh, sw = o["filter_h"], o["filter_w"], o["stride_h"], o["stride_w"]
    oh = (ones.shape[0] - fh) // sh + 1
    ow = (ones.shape[1] - fw) // sw + 1
    cnt = np.asarray([[ones[y * sh:y * sh + fh, x * sw:x * sw + fw].sum()
                       for x in range(ow)] for y in range(oh)], np.float32)
    return cnt[None, None]


def _static_tables(ops: list[OpIR], const: dict[int, np.ndarray],
                   shapes: dict[int, tuple]) -> dict[str, np.ndarray]:
    """Index and weight tables that ops compute from static shapes, as
    non-persistent buffers: a RESIZE_BILINEAR's taps (``rs{i}_*``), a
    RESIZE_NEAREST_NEIGHBOR's source rows and columns (``rn{i}_*``), a
    padded AVERAGE_POOL_2D's counts (``ap{i}``) and a MIRROR_PAD's source
    index per padded axis (``mp{i}_{axis}``); ``i`` indexes ``ops``."""
    tables: dict[str, np.ndarray] = {}
    for i, op in enumerate(ops):
        o = op.options
        shp = shapes.get(op.inputs[0])
        if op.name in ("RESIZE_BILINEAR", "RESIZE_NEAREST_NEIGHBOR"):
            out_hw = [int(v) for v in const[op.inputs[1]]]
            for axis, n_in, n_out in (("h", shp[1], out_hw[0]),
                                      ("w", shp[2], out_hw[1])):
                if op.name == "RESIZE_BILINEAR":
                    for part, arr in zip(("lo", "hi", "wlo", "whi"),
                                         _resize_taps(_resize_matrix(
                                             n_in, n_out, o["align_corners"],
                                             o["half_pixel_centers"]))):
                        tables[f"rs{i}_{axis}_{part}"] = arr
                else:
                    tables[f"rn{i}_{axis}"] = _nearest_index(
                        n_in, n_out, bool(o.get("align_corners")),
                        bool(o.get("half_pixel_centers")))
        elif op.name == "AVERAGE_POOL_2D" and \
                _pool_pads(o, shp[1], shp[2]) != ((0, 0), (0, 0)):
            tables[f"ap{i}"] = _pool_count(o, shp[1], shp[2])
        elif op.name == "MIRROR_PAD":
            mode = "reflect" if o.get("mode", 0) == 0 else "symmetric"
            for axis, (a, b) in enumerate(const[op.inputs[1]].reshape(-1, 2)):
                if a or b:
                    tables[f"mp{i}_{axis}"] = np.pad(
                        np.arange(shp[axis]), (int(a), int(b)), mode=mode)
    return tables


def resolve_device(device=None) -> torch.device:
    """``device`` as given (``cuda`` resolved to ``cuda:N``), else
    ``cuda``; raises when CUDA is absent and the caller did not ask for
    the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to run on "
                               "the CPU")
        device = "cuda"
    return torch.empty(0, device=device).device


def fp32_on_the_card(device: torch.device) -> None:
    """Turns cuDNN's TF32 off for the process where ``device`` is a GPU
    (cuDNN runs fp32 convolutions in TF32 by default), and cuBLAS's
    reduced-precision reductions of bf16 products (the bf16 tier
    accumulates in fp32).  Called where a card model is built
    (``PipelineModels``, ``FaceEmbedding``); a forward only checks
    (:func:`_check_fp32`), since a flag set and restored around a forward
    is process-wide and would switch TF32 back on under another thread's
    convolutions."""
    if device.type == "cuda":
        torch.backends.cudnn.enabled = True
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            False


def _check_fp32(device: torch.device, bf16: bool = False) -> None:
    """Raises where a forward on ``device`` would run its fp32 ops in TF32
    or, with ``bf16``, reduce its bf16 products in reduced precision."""
    if device.type != "cuda":
        return
    flags = [("cuda.matmul.allow_tf32", torch.backends.cuda.matmul.allow_tf32),
             ("cudnn.allow_tf32", torch.backends.cudnn.allow_tf32)]
    if bf16:
        flags.append((
            "cuda.matmul.allow_bf16_reduced_precision_reduction",
            torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction))
    for name, on in flags:
        if on:
            raise RuntimeError(
                f"the executor's tiers need torch.backends.{name} = False "
                f"(convert.executor.fp32_on_the_card sets it)")


class ConvertedModel(nn.Module):
    """A converted TFLite graph as a module.

    ``forward(*inputs)`` takes NHWC float tensors whose shapes equal the
    graph's ``input_shapes`` except for the leading batch dimension, and
    returns the graph outputs as a tuple.  Weights are buffers named
    ``t{tensor index}``, the keys of the JAX ``ConvertedModel.params``;
    the tables of :func:`_static_tables`, the bf16 copies of the weights
    that bf16-tier ops read (``_bf_t{index}``) and the quantization grids'
    scales (``_qscale``) are non-persistent buffers, so they follow the
    module to its device but stay out of its state dict; loading a state
    dict re-derives the bf16 copies.  ``precision`` is the JAX executor's
    (a tier name, ``"mixed"`` or a per-op callable); :attr:`tiers` holds
    its resolution per op.
    """

    def __init__(self, ops: list[OpIR], params: dict[str, torch.Tensor],
                 param_key: dict[int, str], statics: dict[int, np.ndarray],
                 input_ixs: tuple, output_ixs: tuple, input_names: list[str],
                 const_outputs: dict[int, np.ndarray],
                 input_shapes: list[tuple], output_shapes: list[tuple],
                 name: str = "", *, tables: dict[str, Any],
                 shapes: dict[int, tuple], dtypes: dict[int, Any],
                 act_quant: dict[int, tuple] | None = None,
                 precision="highest", tiers: tuple | None = None):
        super().__init__()
        for key, t in params.items():
            self.register_buffer(key, t)
        for key, arr in tables.items():
            self.register_buffer(f"_{key}", torch.as_tensor(arr),
                                 persistent=False)
        self._tables = tuple(tables)
        self._act_quant = dict(act_quant or {})
        #: Graph tensor -> its position in ``_qscale``.
        self._qslot = {t: j for j, t in enumerate(self._act_quant)}
        self.register_buffer("_qscale", torch.tensor(
            [q[0] for q in self._act_quant.values()], dtype=torch.float32),
            persistent=False)
        self._ops = ops
        self._param_key = param_key
        self._statics = statics
        self._input_ixs = input_ixs
        self._output_ixs = output_ixs
        self._input_names = input_names
        self._const_outputs = const_outputs
        self._shapes = shapes
        self._dtypes = dtypes
        self.input_shapes = input_shapes
        self.output_shapes = output_shapes
        self.name = name
        # Outputs that a FULLY_CONNECTED may flatten to [N * rows, out]:
        # those read only by RESHAPEs, which put N back in front.
        readers: dict[int, set[str]] = {}
        for op in ops:
            for t in op.inputs:
                readers.setdefault(t, set()).add(op.name)
        self._row_flat_ok = frozenset(
            op.outputs[0] for op in ops if op.name == "FULLY_CONNECTED"
            and readers.get(op.outputs[0]) == {"RESHAPE"}
            and op.outputs[0] not in output_ixs)
        self.precision = precision
        #: Each op's tier ("highest", "high" or "default"; None for the
        #: ops no tier reaches), indexed as the pruned op list.
        self.tiers = (_resolve_tiers(ops, precision) if tiers is None
                      else tiers)
        # Weight tensor -> the key of its bf16 copy, for the weights that
        # bf16-tier ops take as an operand (not as a bias).
        self._low_key = {
            op.inputs[j]: f"_bf_{param_key[op.inputs[j]]}"
            for op, tier in zip(ops, self.tiers)
            if tier is not None and _TIER_DTYPE[tier] is torch.bfloat16
            for j in _OPERANDS.get(op.name, (0, 1))
            if op.inputs[j] in param_key}
        self._bf16 = any(t is not None and _TIER_DTYPE[t] is torch.bfloat16
                         for t in self.tiers)
        self._make_low()
        self.register_load_state_dict_post_hook(_refresh_low)

    def _make_low(self) -> None:
        """(Re)makes the bf16 copies of the weights bf16-tier ops read."""
        for tix, key in self._low_key.items():
            w = getattr(self, self._param_key[tix])
            self.register_buffer(
                key, w.to(torch.bfloat16, memory_format=torch.preserve_format),
                persistent=False)

    def with_precision(self, precision) -> "ConvertedModel":
        """This graph at ``precision``, its tiers re-resolved over the same
        op list (``"mixed"`` and a callable index it as here); the fp32
        weights and tables are shared with this module, not copied.
        Returns this module where the tiers do not change."""
        tiers = _resolve_tiers(self._ops, precision)
        if tiers == self.tiers:
            return self
        return ConvertedModel(
            self._ops, {k: getattr(self, k) for k in self._param_key.values()},
            self._param_key, self._statics, self._input_ixs,
            self._output_ixs, self._input_names, self._const_outputs,
            self.input_shapes, self.output_shapes, self.name,
            tables={k: getattr(self, f"_{k}") for k in self._tables},
            shapes=self._shapes, dtypes=self._dtypes,
            act_quant=self._act_quant, precision=precision, tiers=tiers
        ).to(self._qscale.device).train(self.training)

    @property
    def num_params(self) -> int:
        return sum(getattr(self, k).numel() for k in self._param_key.values())

    def jax_params(self) -> dict[str, np.ndarray]:
        """The weights as the JAX ``ConvertedModel.params`` of the same
        graph (keys ``t{index}``, OHWI and [1, kh, kw, C] filters, and the
        ``rs{i}_h``/``rs{i}_w`` interpolation matrices)."""
        kinds = _weight_kinds(self._ops)
        out = {}
        for tix, key in self._param_key.items():
            t = getattr(self, key)
            kind = kinds.get(tix)
            out[key] = np.ascontiguousarray(
                (t.permute(_TO_TFLITE[kind]) if kind else t).cpu().numpy())
        for i, op in enumerate(self._ops):
            if op.name == "RESIZE_BILINEAR":
                shp = self._shapes[op.inputs[0]]
                out_hw = [int(v) for v in self._statics[op.inputs[1]]]
                for axis, n_in, n_out in (("h", shp[1], out_hw[0]),
                                          ("w", shp[2], out_hw[1])):
                    out[f"rs{i}_{axis}"] = _resize_matrix(
                        n_in, n_out, op.options["align_corners"],
                        op.options["half_pixel_centers"])
        return out

    def load_jax_params(self, params: dict[str, np.ndarray]
                        ) -> "ConvertedModel":
        """Loads the JAX ``ConvertedModel.params`` of the same graph."""
        self.load_state_dict(_port_params(self._ops, params))
        return self

    def forward(self, *inputs):
        if len(inputs) != len(self._input_ixs):
            raise ValueError(f"expected {len(self._input_ixs)} inputs, got "
                             f"{len(inputs)}")
        n = inputs[0].shape[0]
        env: dict[int, Any] = {tix: getattr(self, key)
                               for tix, key in self._param_key.items()}
        for tix, x, want, in_name in zip(self._input_ixs, inputs,
                                         self.input_shapes,
                                         self._input_names):
            if tuple(x.shape[1:]) != tuple(want[1:]) or want[0] != 1 \
                    or x.shape[0] != n or n < 1:
                raise ValueError(
                    f"input tensor {in_name!r} expects shape "
                    f"(N, {', '.join(map(str, want[1:]))}) with N >= 1, got "
                    f"{tuple(x.shape)}")
            if tix in self._act_quant:
                # A quantized graph input: the model's integer dtype is
                # dequantized, a float is snapped to the input's grid.
                s, zp, lo, hi = self._act_quant[tix]
                if x.dtype.is_floating_point:
                    x = _fake_quant(x.float(), self._qscale[self._qslot[tix]],
                                    s, zp, lo, hi)
                else:
                    x = (x.float() - zp) * s
            env[tix] = x
        device = inputs[0].device
        _check_fp32(device, bf16=self._bf16)
        for i, op in enumerate(self._ops):
            self._run_op(i, op, env, n)
            for t in op.outputs:
                if t in self._act_quant and t in env:
                    env[t] = _fake_quant(env[t], self._qscale[self._qslot[t]],
                                         *self._act_quant[t])
        return tuple(
            env[t] if t in env else
            torch.as_tensor(self._const_outputs[t], device=device)
            for t in self._output_ixs)

    def _static(self, tix: int) -> np.ndarray:
        return self._statics[tix]

    def _operand(self, env: dict, tix: int, dtype: torch.dtype):
        """Input ``tix`` of a tiered op in the tier's operand ``dtype``: a
        weight's bf16 copy, else the activation cast."""
        if dtype is torch.bfloat16 and tix in self._low_key:
            return getattr(self, self._low_key[tix])
        return env[tix].to(dtype)

    def _axis(self, op: OpIR, axis: int, rank: int, n: int) -> int:
        """``axis`` in [0, rank); raises where it is the batch axis at
        N > 1."""
        axis = int(axis) % rank
        if n > 1 and axis == 0:
            raise ValueError(f"{op.name} along the batch dimension with "
                             f"N = {n}")
        return axis

    @staticmethod
    def _batched(xs: list, n: int) -> list:
        """Operands of a concatenation or pack with a constant's batch of
        1 broadcast to N, as the vmapped JAX function sees them."""
        if n == 1:
            return xs
        return [x.expand((n,) + x.shape[1:]) if x.dim() and x.shape[0] == 1
                else x for x in xs]

    def _run_op(self, i: int, op: OpIR, env: dict, n: int) -> None:
        o = op.options
        nm = op.name
        get = env.__getitem__
        out = op.outputs[0]
        if nm in _BINARY:
            env[out] = _act(_BINARY[nm](get(op.inputs[0]), get(op.inputs[1])),
                            o.get("activation"))
        elif nm in _UNARY:
            env[out] = _UNARY[nm](get(op.inputs[0]))
        elif nm in ("CONV_2D", "DEPTHWISE_CONV_2D"):
            dtype = _TIER_DTYPE[self.tiers[i]]
            x = self._operand(env, op.inputs[0], dtype)
            w = self._operand(env, op.inputs[1], dtype)  # OIHW / [C*m, 1, kh, kw]
            (pt, pb), (pl, pr) = _conv_padding(o, x.shape[1], x.shape[2],
                                               w.shape[2], w.shape[3])
            xc = x.permute(0, 3, 1, 2)
            if pt == pb and pl == pr:
                pad = (pt, pl)
            else:
                xc = F.pad(xc, (pl, pr, pt, pb))
                pad = (0, 0)
            bias = get(op.inputs[2]) if len(op.inputs) > 2 and \
                op.inputs[2] >= 0 else None
            low = dtype is not torch.float32
            y = F.conv2d(xc, w, None if low else bias,
                         stride=(o["stride_h"], o["stride_w"]), padding=pad,
                         dilation=(o["dilation_h"], o["dilation_w"]),
                         groups=x.shape[3] if nm == "DEPTHWISE_CONV_2D" else 1)
            y = y.permute(0, 2, 3, 1)
            if low:
                # The epilogue runs in fp32, as after the TPU's conv with
                # preferred_element_type=float32.
                y = y.float() if bias is None else y.float() + bias
            env[out] = _act(y, o["activation"])
        elif nm in ("TRANSPOSE_CONV", "CUSTOM:Convolution2DTransposeBias"):
            # Builtin inputs: (output_shape, filter, x[, bias]); MediaPipe's
            # custom op: (x, filter, bias).
            xi, wi, bi = (2, 1, 3) if nm == "TRANSPOSE_CONV" else (0, 1, 2)
            dtype = _TIER_DTYPE[self.tiers[i]]
            x = self._operand(env, op.inputs[xi], dtype)
            w = self._operand(env, op.inputs[wi], dtype)  # [I, O, kh, kw]
            bias = get(op.inputs[bi]) if len(op.inputs) > bi and \
                op.inputs[bi] >= 0 else None
            sh, sw = o["stride_h"], o["stride_w"]
            kh, kw = w.shape[2], w.shape[3]
            # The graph's declared output fixes the size; TFLite's SAME
            # padding of a transposed conv is the forward conv's, so the
            # output is the full transposed conv, (in - 1) * s + k long,
            # from the forward conv's leading pad on, zero-extended where
            # it is short (k < s).
            out_h, out_w = self._shapes[out][1:3]
            (pt, _), (pl, _) = ((_same_pads(out_h, sh, kh),
                                 _same_pads(out_w, sw, kw))
                                if o["padding"] == PADDING_SAME
                                else ((0, 0), (0, 0)))
            y = F.conv_transpose2d(x.permute(0, 3, 1, 2), w,
                                   stride=(sh, sw)).float()
            y = y[:, :, pt:pt + out_h, pl:pl + out_w]
            if y.shape[2:] != (out_h, out_w):
                y = F.pad(y, (0, out_w - y.shape[3], 0, out_h - y.shape[2]))
            y = y.permute(0, 2, 3, 1)
            if bias is not None:
                y = y + bias
            env[out] = _act(y, o.get("activation"))
        elif nm in ("MAX_POOL_2D", "AVERAGE_POOL_2D"):
            x = get(op.inputs[0])
            xc = x.permute(0, 3, 1, 2)
            (pt, pb), (pl, pr) = _pool_pads(o, x.shape[1], x.shape[2])
            padded = (pt, pb, pl, pr) != (0, 0, 0, 0)
            k, s = (o["filter_h"], o["filter_w"]), (o["stride_h"], o["stride_w"])
            if nm == "MAX_POOL_2D":
                if padded:
                    xc = F.pad(xc, (pl, pr, pt, pb), value=float("-inf"))
                y = F.max_pool2d(xc, k, s)
            elif padded:
                # TFLite divides by the count of real pixels a window holds.
                y = F.avg_pool2d(F.pad(xc, (pl, pr, pt, pb)), k, s,
                                 divisor_override=1) / getattr(self, f"_ap{i}")
            else:
                y = F.avg_pool2d(xc, k, s)
            env[out] = _act(y.permute(0, 2, 3, 1), o["activation"])
        elif nm == "PRELU":
            x = get(op.inputs[0])
            env[out] = torch.where(x >= 0, x, x * get(op.inputs[1]))
        elif nm == "LEAKY_RELU":
            x = get(op.inputs[0])
            env[out] = torch.where(x >= 0, x, x * o["alpha"])
        elif nm == "GELU":
            env[out] = F.gelu(
                get(op.inputs[0]),
                approximate="tanh" if o.get("approximate") else "none")
        elif nm == "SOFTMAX":
            x = get(op.inputs[0])
            self._axis(op, -1, x.dim(), n)
            env[out] = torch.softmax(x * o.get("beta", 1.0), dim=-1)
        elif nm == "L2_NORMALIZATION":
            x = get(op.inputs[0])
            self._axis(op, -1, x.dim(), n)
            env[out] = _act(x * torch.rsqrt(
                torch.sum(x * x, dim=-1, keepdim=True) + 1e-12),
                o.get("activation"))
        elif nm in ("PAD", "PADV2"):
            x = get(op.inputs[0])
            padv = self._static(op.inputs[1]).reshape(-1, 2)
            if n > 1 and tuple(padv[0]) != (0, 0):
                raise ValueError(f"{nm} across the batch dimension with "
                                 f"N > 1")
            value = 0.0
            if nm == "PADV2" and len(op.inputs) > 2:
                value = float(self._static(op.inputs[2]).reshape(()))
            flat: list[int] = []
            for a, b in padv[::-1]:
                flat += [int(a), int(b)]
            env[out] = F.pad(x, flat, value=value)
        elif nm == "MIRROR_PAD":
            x = get(op.inputs[0])
            padv = self._static(op.inputs[1]).reshape(-1, 2)
            if n > 1 and tuple(padv[0]) != (0, 0):
                raise ValueError("MIRROR_PAD across the batch dimension with "
                                 "N > 1")
            for axis in range(x.dim()):
                if f"_mp{i}_{axis}" in self._buffers:
                    x = x.index_select(axis, getattr(self, f"_mp{i}_{axis}"))
            env[out] = x
        elif nm == "RESHAPE":
            x = get(op.inputs[0])
            if len(op.inputs) > 1 and op.inputs[1] >= 0 and \
                    op.inputs[1] in self._statics:
                shp = [int(v) for v in self._static(op.inputs[1])]
            else:
                shp = list(o["new_shape"])
            if n > 1:
                per_sample = x[0].numel()
                if shp and shp[0] == 1:
                    shp[0] = n
                elif not (shp and shp[0] == -1 and
                          int(np.prod(shp[1:])) == per_sample):
                    raise ValueError(
                        f"RESHAPE to {shp} crosses the batch dimension "
                        f"with N = {n}")
            env[out] = torch.reshape(x, shp)
        elif nm == "SQUEEZE":
            shp = self._shapes[op.inputs[0]]
            dims = o["squeeze_dims"] or [d for d, s in enumerate(shp)
                                         if s == 1]
            dims = tuple(self._axis(op, d, len(shp), n) for d in dims)
            env[out] = torch.squeeze(get(op.inputs[0]), dim=dims)
        elif nm == "EXPAND_DIMS":
            x = get(op.inputs[0])
            axis = int(self._static(op.inputs[1]).reshape(()))
            env[out] = torch.unsqueeze(
                x, self._axis(op, axis, x.dim() + 1, n))
        elif nm == "CONCATENATION":
            xs = self._batched([get(t) for t in op.inputs], n)
            axis = self._axis(op, o["axis"], xs[0].dim(), n)
            env[out] = _act(torch.cat(xs, dim=axis), o["activation"])
        elif nm == "PACK":
            xs = self._batched([get(t) for t in op.inputs], n)
            axis = self._axis(op, o["axis"], xs[0].dim() + 1, n)
            env[out] = torch.stack(xs, dim=axis)
        elif nm == "UNPACK":
            x = get(op.inputs[0])
            parts = torch.unbind(x, dim=self._axis(op, o["axis"], x.dim(), n))
            for t, part in zip(op.outputs, parts):
                env[t] = part
        elif nm == "SPLIT":
            x = get(op.inputs[1])
            axis = self._axis(op, int(self._static(op.inputs[0]).reshape(())),
                              x.dim(), n)
            parts = torch.split(x, x.shape[axis] // len(op.outputs), dim=axis)
            for t, part in zip(op.outputs, parts):
                env[t] = part
        elif nm == "TILE":
            reps = [int(v) for v in np.atleast_1d(self._static(op.inputs[1]))]
            if n > 1 and reps[0] != 1:
                raise ValueError(f"TILE {reps} repeats the batch dimension "
                                 f"with N = {n}")
            env[out] = torch.tile(get(op.inputs[0]), reps)
        elif nm == "GATHER":
            x = get(op.inputs[0])
            if o.get("batch_dims", 0):
                raise ValueError(
                    "GATHER with batch_dims != 0 is not supported")
            if n > 1 and op.inputs[1] not in self._param_key:
                raise ValueError(f"GATHER with computed indices takes them "
                                 f"across the batch with N = {n}")
            idx = get(op.inputs[1])
            axis = self._axis(op, o.get("axis", 0), x.dim(), n)
            y = torch.index_select(x, axis, idx.reshape(-1).long())
            env[out] = y.reshape(x.shape[:axis] + idx.shape +
                                 x.shape[axis + 1:])
        elif nm == "SLICE":
            x = get(op.inputs[0])
            begin = [int(v) for v in self._static(op.inputs[1])]
            size = [int(v) for v in self._static(op.inputs[2])]
            idx = []
            for d, (b, s) in enumerate(zip(begin, size)):
                if d == 0 and n > 1:
                    if b != 0 or s not in (-1, 1):
                        raise ValueError(f"SLICE of the batch dimension with "
                                         f"N = {n}")
                    idx.append(slice(None))
                else:
                    idx.append(slice(b, None if s == -1 else b + s))
            env[out] = x[tuple(idx)]
        elif nm == "STRIDED_SLICE":
            if o["ellipsis_mask"] or o["new_axis_mask"]:
                raise NotImplementedError(
                    "STRIDED_SLICE ellipsis_mask/new_axis_mask not supported")
            x = get(op.inputs[0])
            begin, end, strides = (self._static(t).astype(np.int64)
                                   for t in op.inputs[1:4])
            idx, flips = [], []
            for d in range(len(begin)):
                b = None if o["begin_mask"] & (1 << d) else int(begin[d])
                e = None if o["end_mask"] & (1 << d) else int(end[d])
                st = int(strides[d])
                shrink = o["shrink_axis_mask"] & (1 << d)
                if d == 0 and n > 1:
                    # The graph's batch of 1 must pass whole: it then
                    # takes all N.
                    if shrink or range(1)[slice(b, e, int(strides[0]))] != \
                            range(1):
                        raise ValueError(f"STRIDED_SLICE of the batch "
                                         f"dimension with N = {n}")
                    idx.append(slice(None))
                elif shrink:
                    idx.append(b if b is not None else 0)
                elif st < 0:
                    # torch slices step forward only: the same elements,
                    # counted from the end of the flipped axis.
                    r = range(x.shape[d])[slice(b, e, st)]
                    first = x.shape[d] - 1 - r.start if len(r) else 0
                    flips.append(d)
                    idx.append(slice(first, first + len(r) * -st, -st))
                else:
                    idx.append(slice(b, e, st))
            if flips:
                x = x.flip(flips)
            env[out] = x[tuple(idx)]
        elif nm == "TRANSPOSE":
            perm = [int(v) for v in self._static(op.inputs[1])]
            if n > 1 and perm[0] != 0:
                raise ValueError(f"TRANSPOSE {perm} moves the batch "
                                 f"dimension with N = {n}")
            env[out] = get(op.inputs[0]).permute(perm)
        elif nm in _REDUCE:
            x = get(op.inputs[0])
            axes = sorted({self._axis(op, v, x.dim(), n) for v in
                           np.atleast_1d(self._static(op.inputs[1]))})
            env[out] = _REDUCE[nm](x, dim=axes, keepdim=bool(o["keep_dims"]))
        elif nm == "ARG_MAX":
            x = get(op.inputs[0])
            axis = self._axis(op, int(self._static(op.inputs[1]).reshape(())),
                              x.dim(), n)
            env[out] = torch.argmax(x, dim=axis).to(_torch_dtype(
                self._dtypes[out]))
        elif nm == "CAST":
            env[out] = get(op.inputs[0]).to(_torch_dtype(self._dtypes[out]))
        elif nm == "FULLY_CONNECTED":
            dtype = _TIER_DTYPE[self.tiers[i]]
            x = self._operand(env, op.inputs[0], dtype)
            w = self._operand(env, op.inputs[1], dtype)  # [out, in]
            if not o.get("keep_num_dims") and x.dim() > 2:
                # TFLite flattens all but the feature dim into rows.
                if n > 1 and out not in self._row_flat_ok:
                    raise ValueError(
                        "FULLY_CONNECTED flattens the batch dimension into "
                        f"rows with N = {n} and no RESHAPE restores it")
                x = x.reshape(-1, w.shape[1])
            bias = get(op.inputs[2]) if len(op.inputs) > 2 and \
                op.inputs[2] >= 0 else None
            if dtype is torch.float32:
                y = F.linear(x, w, bias)
            else:
                y = F.linear(x, w).float()
                y = y if bias is None else y + bias
            env[out] = _act(y, o["activation"])
        elif nm == "BATCH_MATMUL":
            dtype = _TIER_DTYPE[self.tiers[i]]
            a = self._operand(env, op.inputs[0], dtype)
            b = self._operand(env, op.inputs[1], dtype)
            for t, x, moved in ((op.inputs[0], a, o.get("adj_x")),
                                (op.inputs[1], b, True)):
                # A rank-2 activation holds the batch in its rows: it may
                # only be the left operand, untransposed.
                if n > 1 and x.dim() == 2 and moved and \
                        t not in self._param_key:
                    raise ValueError(f"BATCH_MATMUL of a rank-2 activation "
                                     f"moves the batch with N = {n}")
            if o.get("adj_x"):
                a = a.transpose(-1, -2)
            if o.get("adj_y"):
                b = b.transpose(-1, -2)
            env[out] = torch.matmul(a, b).float()
        elif nm == "DEPTH_TO_SPACE":
            x = get(op.inputs[0])
            bs = o["block_size"]
            nb, h, w, c = x.shape
            y = x.reshape(nb, h, w, bs, bs, c // (bs * bs))
            env[out] = y.permute(0, 1, 3, 2, 4, 5).reshape(
                nb, h * bs, w * bs, c // (bs * bs))
        elif nm == "SPACE_TO_DEPTH":
            x = get(op.inputs[0])
            bs = o["block_size"]
            nb, h, w, c = x.shape
            y = x.reshape(nb, h // bs, bs, w // bs, bs, c)
            env[out] = y.permute(0, 1, 3, 2, 4, 5).reshape(
                nb, h // bs, w // bs, bs * bs * c)
        elif nm == "RESIZE_BILINEAR":
            y = get(op.inputs[0])
            for axis, name in ((1, "h"), (2, "w")):
                lo, hi, w_lo, w_hi = (getattr(self, f"_rs{i}_{name}_{p}")
                                      for p in ("lo", "hi", "wlo", "whi"))
                shape = [1] * y.dim()
                shape[axis] = -1
                y = (y.index_select(axis, lo) * w_lo.view(shape)
                     + y.index_select(axis, hi) * w_hi.view(shape))
            env[out] = y
        elif nm == "RESIZE_NEAREST_NEIGHBOR":
            y = get(op.inputs[0]).index_select(1, getattr(self, f"_rn{i}_h"))
            env[out] = y.index_select(2, getattr(self, f"_rn{i}_w"))
        else:  # _fold admits only SUPPORTED_OPS
            raise NotImplementedError(f"op {nm} not implemented")


def _torch_dtype(dtype) -> torch.dtype:
    return torch.from_numpy(np.zeros(0, dtype)).dtype


def convert_model(ir: ModelIR, name: str = "",
                  precision="highest") -> ConvertedModel:
    """Builds a :class:`ConvertedModel` (on the CPU) from a ModelIR.

    ``precision`` is the JAX executor's: ``"highest"`` (fp32, TF32 off),
    ``"high"``, ``"default"`` (bf16 operands), ``"mixed"``
    (:func:`mixed_precision`) or a callable ``(op_index, op_name) ->
    tier`` over the pruned op list (constant DEQUANTIZE, DENSIFY and
    static shape ops removed first, so an fp16 graph's indices are not
    ``ir.ops``'s).  ``ir`` is not changed, so one parsed IR converts at
    several tiers.
    """
    const, ops = _fold(ir)
    kinds = _weight_kinds(ops)

    traced: set[int] = set()
    static_needed: set[int] = set()
    for op in ops:
        statics = _STATIC_INPUTS.get(op.name, set())
        for pos, tix in enumerate(op.inputs):
            if tix >= 0 and tix in const:
                (static_needed if pos in statics else traced).add(tix)

    params: dict[str, torch.Tensor] = {}
    param_key: dict[int, str] = {}
    for tix in sorted(traced):
        key = f"t{tix}"
        params[key] = _port_tensor(kinds.get(tix), const[tix])
        param_key[tix] = key

    tensor_shape = {t.index: t.shape for t in ir.tensors}
    return ConvertedModel(
        ops, params, param_key,
        statics={tix: np.array(const[tix]) for tix in static_needed},
        input_ixs=tuple(ir.inputs), output_ixs=tuple(ir.outputs),
        input_names=[ir.tensors[t].name for t in ir.inputs],
        const_outputs={t: np.array(const[t]) for t in ir.outputs
                       if t in const},
        input_shapes=[tensor_shape[t] for t in ir.inputs],
        output_shapes=[tensor_shape[t] for t in ir.outputs],
        name=name, tables=_static_tables(ops, const, tensor_shape),
        shapes={t: tensor_shape[t] for op in ops
                for t in (*op.inputs, *op.outputs) if t >= 0},
        dtypes={t: ir.tensors[t].dtype for op in ops for t in op.outputs},
        act_quant=_act_quant(ir), precision=precision)


def params_from_jax(ir: ModelIR, jax_params: dict[str, np.ndarray]
                    ) -> dict[str, torch.Tensor]:
    """The JAX ``ConvertedModel.params`` of ``ir`` (keys ``t{index}``, OHWI
    and [1, kh, kw, C] filter layouts) as a state dict of this executor's
    :class:`ConvertedModel` for the same IR: load it with
    ``model.load_state_dict(params_from_jax(ir, params))``.  The JAX
    executor's interpolation matrices (``rs{i}_h``, ``rs{i}_w``) have no
    counterpart in the state dict: this executor computes its resize taps
    from the graph."""
    return _port_params(_fold(ir)[1], jax_params)


def _port_params(ops: list[OpIR], jax_params: dict[str, np.ndarray]
                 ) -> dict[str, torch.Tensor]:
    kinds = _weight_kinds(ops)
    out: dict[str, torch.Tensor] = {}
    for key, arr in jax_params.items():
        if re.fullmatch(r"rs\d+_[hw]", key):
            continue
        if not (key.startswith("t") and key[1:].isdigit()):
            raise ValueError(f"parameter {key!r} has no counterpart in the "
                             "PyTorch executor")
        out[key] = _port_tensor(kinds.get(int(key[1:])), np.asarray(arr))
    return out


def convert_file(path: str, name: str = "",
                 precision="highest") -> ConvertedModel:
    with open(path, "rb") as f:
        buf = f.read()
    return convert_model(parse_tflite(buf), name=name or path,
                         precision=precision)
