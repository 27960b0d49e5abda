"""ModelIR -> ``torch.nn.Module``.

Port of the JAX package's ``convert/executor.py::convert_model`` for the ops
the BlazeFace, FaceMesh, iris and blendshape graphs use.  Each ``.tflite`` graph is converted
once into a module whose weights are buffers; the module runs eagerly on the
device its buffers live on.

Differences from the JAX executor, all deliberate:

* the leading batch dimension may be any ``N >= 1`` where the graph says 1
  (the JAX function checks the exact shape and is vmapped instead);
  a RESHAPE whose target starts with the graph's batch of 1 takes ``N``
  there; a FULLY_CONNECTED without ``keep_num_dims`` on more than one row
  a sample flattens to ``[N * rows, in]``, and then only RESHAPEs may
  consume it; a graph that reshapes, pads, concatenates, transposes or
  averages across the batch raises when ``N > 1``;
* tensors stay NHWC at the graph boundary and between ops; each conv runs
  as ``F.conv2d`` on ``x.permute(0, 3, 1, 2)``, which is a channels_last
  view, so cuDNN takes it without a copy;
* only ``precision="highest"`` is supported: convolutions and matrix
  products run with TF32 off.

Conversion-time passes (numpy, no device work) are those of the JAX
executor: constant fp16 ``DEQUANTIZE`` and ``DENSIFY`` fold into fp32
weights, and static shape arithmetic folds into constants.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .tflite import ModelIR, OpIR, PADDING_SAME, densify, parse_tflite

__all__ = ["ConvertedModel", "SUPPORTED_OPS", "convert_model", "convert_file",
           "fp32_on_the_card", "params_from_jax", "resolve_device"]

#: Ops this executor runs: the op mix of the BlazeFace, FaceMesh and iris
#: graphs (convolutional) and of the blendshape MLP-Mixer (fully connected
#: layers, transposes and the layer norms TensorFlow emits as MEAN, NEG,
#: SQUARED_DIFFERENCE, RSQRT, MUL and ADD).
SUPPORTED_OPS = frozenset({
    "CONV_2D", "DEPTHWISE_CONV_2D", "ADD", "MUL", "PAD", "MAX_POOL_2D",
    "PRELU", "RELU", "RESHAPE", "CONCATENATION",
    "FULLY_CONNECTED", "SUB", "NEG", "SQUARED_DIFFERENCE", "RSQRT",
    "LOGISTIC", "GELU", "TRANSPOSE", "MEAN"})

# Ops whose listed inputs at these positions are static (shape-like) values.
_STATIC_INPUTS = {"RESHAPE": {1}, "PAD": {1}, "TRANSPOSE": {1}, "MEAN": {1}}

_QUANTIZED = (np.int8, np.uint8, np.int16)


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
        if t.data is None and t.quant is not None and t.dtype in _QUANTIZED:
            raise NotImplementedError(
                f"tensor {t.name!r} is a quantized activation: fake-quant "
                "emulation is not ported yet (ROADMAP §1 item 2)")
    for t in ir.tensors:
        if t.index in const and t.quant is not None and \
                np.issubdtype(np.dtype(t.dtype), np.integer) and \
                t.dtype != np.int64:
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
                f"op {op.name} not implemented in the PyTorch executor "
                "(ROADMAP §1 item 2)")
        ops.append(op)
    return const, ops


def _weight_kinds(ops: list[OpIR]) -> dict[int, str]:
    """Tensor index -> "conv" (OHWI) or "dw" ([1, kh, kw, C*m]) for the
    filter inputs whose layout this executor changes."""
    kinds: dict[int, str] = {}
    for op in ops:
        if op.name == "CONV_2D":
            kinds[op.inputs[1]] = "conv"
        elif op.name == "DEPTHWISE_CONV_2D":
            kinds[op.inputs[1]] = "dw"
    return kinds


def _port_tensor(kind: str | None, arr: np.ndarray) -> torch.Tensor:
    """A TFLite-layout constant as the tensor this executor computes with:
    OHWI conv filters become OIHW in channels_last memory (the same bytes
    as OHWI), depthwise filters [1, kh, kw, C*m] become [C*m, 1, kh, kw]."""
    arr = np.asarray(arr)
    if arr.dtype == np.float16:
        arr = arr.astype(np.float32)
    if kind == "conv":
        t = torch.from_numpy(np.array(arr.transpose(0, 3, 1, 2), order="C"))
        return t.contiguous(memory_format=torch.channels_last)
    if kind == "dw":
        return torch.from_numpy(np.array(arr.transpose(3, 0, 1, 2), order="C"))
    return torch.from_numpy(np.array(arr))


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
    """Turns cuDNN's TF32 off for the process where ``device`` is a GPU:
    cuDNN runs fp32 convolutions in TF32 by default.  Called where a card
    model is built (``PipelineModels``, ``FaceEmbedding``); a forward only
    checks (:func:`_check_fp32`), since a flag set and restored around a
    forward is process-wide and would switch TF32 back on under another
    thread's convolutions."""
    if device.type == "cuda":
        torch.backends.cudnn.enabled = True
        torch.backends.cudnn.allow_tf32 = False


def _check_fp32(device: torch.device) -> None:
    """Raises where a forward on ``device`` would run in TF32."""
    if device.type != "cuda":
        return
    for name, on in (("cuda.matmul", torch.backends.cuda.matmul.allow_tf32),
                     ("cudnn", torch.backends.cudnn.allow_tf32)):
        if on:
            raise RuntimeError(
                f"precision='highest' needs torch.backends.{name}.allow_tf32 "
                f"= False (convert.executor.fp32_on_the_card sets cuDNN's)")


class ConvertedModel(nn.Module):
    """A converted TFLite graph as a module.

    ``forward(*inputs)`` takes NHWC float tensors whose shapes equal the
    graph's ``input_shapes`` except for the leading batch dimension, and
    returns the graph outputs as a tuple.  Weights are buffers named
    ``t{tensor index}``, the keys of the JAX ``ConvertedModel.params``.
    """

    def __init__(self, ops: list[OpIR], params: dict[str, torch.Tensor],
                 param_key: dict[int, str], statics: dict[int, np.ndarray],
                 input_ixs: tuple, output_ixs: tuple, input_names: list[str],
                 const_outputs: dict[int, np.ndarray],
                 input_shapes: list[tuple], output_shapes: list[tuple],
                 name: str = ""):
        super().__init__()
        for key, t in params.items():
            self.register_buffer(key, t)
        self._ops = ops
        self._param_key = param_key
        self._statics = statics
        self._input_ixs = input_ixs
        self._output_ixs = output_ixs
        self._input_names = input_names
        self._const_outputs = const_outputs
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

    @property
    def num_params(self) -> int:
        return sum(b.numel() for b in self.buffers())

    def jax_params(self) -> dict[str, np.ndarray]:
        """The weights as the JAX ``ConvertedModel.params`` of the same
        graph (keys ``t{index}``, OHWI and [1, kh, kw, C] filters)."""
        kinds = _weight_kinds(self._ops)
        perm = {"conv": (0, 2, 3, 1), "dw": (1, 2, 3, 0)}
        out = {}
        for tix, key in self._param_key.items():
            t = getattr(self, key)
            kind = kinds.get(tix)
            out[key] = np.ascontiguousarray(
                (t.permute(perm[kind]) if kind else t).cpu().numpy())
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
            env[tix] = x
        device = inputs[0].device
        _check_fp32(device)
        for op in self._ops:
            self._run_op(op, env, n)
        return tuple(
            env[t] if t in env else
            torch.as_tensor(self._const_outputs[t], device=device)
            for t in self._output_ixs)

    def _run_op(self, op: OpIR, env: dict, n: int) -> None:
        o = op.options
        nm = op.name
        get = env.__getitem__
        if nm in ("CONV_2D", "DEPTHWISE_CONV_2D"):
            x = get(op.inputs[0])
            w = get(op.inputs[1])  # OIHW / [C*m, 1, kh, kw]
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
            y = F.conv2d(xc, w, bias, stride=(o["stride_h"], o["stride_w"]),
                         padding=pad,
                         dilation=(o["dilation_h"], o["dilation_w"]),
                         groups=x.shape[3] if nm == "DEPTHWISE_CONV_2D" else 1)
            env[op.outputs[0]] = _act(y.permute(0, 2, 3, 1), o["activation"])
        elif nm == "MAX_POOL_2D":
            x = get(op.inputs[0])
            xc = x.permute(0, 3, 1, 2)
            if o["padding"] == PADDING_SAME:
                pt, pb = _same_pads(x.shape[1], o["stride_h"], o["filter_h"])
                pl, pr = _same_pads(x.shape[2], o["stride_w"], o["filter_w"])
                if pt or pb or pl or pr:
                    xc = F.pad(xc, (pl, pr, pt, pb), value=float("-inf"))
            y = F.max_pool2d(xc, (o["filter_h"], o["filter_w"]),
                             (o["stride_h"], o["stride_w"]))
            env[op.outputs[0]] = _act(y.permute(0, 2, 3, 1), o["activation"])
        elif nm == "ADD":
            env[op.outputs[0]] = _act(
                get(op.inputs[0]) + get(op.inputs[1]), o["activation"])
        elif nm == "MUL":
            env[op.outputs[0]] = _act(
                get(op.inputs[0]) * get(op.inputs[1]), o["activation"])
        elif nm == "RELU":
            env[op.outputs[0]] = torch.relu(get(op.inputs[0]))
        elif nm == "PRELU":
            x = get(op.inputs[0])
            env[op.outputs[0]] = torch.where(x >= 0, x,
                                             x * get(op.inputs[1]))
        elif nm == "PAD":
            x = get(op.inputs[0])
            padv = self._statics[op.inputs[1]].reshape(-1, 2)
            if n > 1 and tuple(padv[0]) != (0, 0):
                raise ValueError("PAD across the batch dimension with N > 1")
            flat: list[int] = []
            for a, b in padv[::-1]:
                flat += [int(a), int(b)]
            env[op.outputs[0]] = F.pad(x, flat)
        elif nm == "RESHAPE":
            x = get(op.inputs[0])
            if len(op.inputs) > 1 and op.inputs[1] >= 0 and \
                    op.inputs[1] in self._statics:
                shp = [int(v) for v in self._statics[op.inputs[1]]]
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
            env[op.outputs[0]] = torch.reshape(x, shp)
        elif nm == "CONCATENATION":
            xs = [get(i) for i in op.inputs]
            axis = o["axis"] % xs[0].dim()
            if n > 1 and axis == 0:
                raise ValueError("CONCATENATION across the batch dimension "
                                 "with N > 1")
            env[op.outputs[0]] = _act(torch.cat(xs, dim=axis),
                                      o["activation"])
        elif nm == "FULLY_CONNECTED":
            x = get(op.inputs[0])
            w = get(op.inputs[1])  # [out, in]
            if not o.get("keep_num_dims") and x.dim() > 2:
                # TFLite flattens all but the feature dim into rows.
                if n > 1 and op.outputs[0] not in self._row_flat_ok:
                    raise ValueError(
                        "FULLY_CONNECTED flattens the batch dimension into "
                        f"rows with N = {n} and no RESHAPE restores it")
                x = x.reshape(-1, w.shape[1])
            bias = get(op.inputs[2]) if len(op.inputs) > 2 and \
                op.inputs[2] >= 0 else None
            env[op.outputs[0]] = _act(F.linear(x, w, bias), o["activation"])
        elif nm == "SUB":
            env[op.outputs[0]] = _act(
                get(op.inputs[0]) - get(op.inputs[1]), o["activation"])
        elif nm == "NEG":
            env[op.outputs[0]] = -get(op.inputs[0])
        elif nm == "SQUARED_DIFFERENCE":
            d = get(op.inputs[0]) - get(op.inputs[1])
            env[op.outputs[0]] = d * d
        elif nm == "RSQRT":
            env[op.outputs[0]] = torch.rsqrt(get(op.inputs[0]))
        elif nm == "LOGISTIC":
            env[op.outputs[0]] = torch.sigmoid(get(op.inputs[0]))
        elif nm == "GELU":
            env[op.outputs[0]] = F.gelu(
                get(op.inputs[0]),
                approximate="tanh" if o.get("approximate") else "none")
        elif nm == "TRANSPOSE":
            perm = [int(v) for v in self._statics[op.inputs[1]]]
            if n > 1 and perm[0] != 0:
                raise ValueError(f"TRANSPOSE {perm} moves the batch "
                                 f"dimension with N = {n}")
            env[op.outputs[0]] = get(op.inputs[0]).permute(perm)
        elif nm == "MEAN":
            x = get(op.inputs[0])
            axes = sorted({int(v) % x.dim() for v in
                           np.atleast_1d(self._statics[op.inputs[1]])})
            if n > 1 and 0 in axes:
                raise ValueError(f"MEAN over the batch dimension with N = "
                                 f"{n}")
            env[op.outputs[0]] = torch.mean(x, dim=axes,
                                            keepdim=bool(o["keep_dims"]))
        else:  # _fold admits only SUPPORTED_OPS
            raise NotImplementedError(f"op {nm} not implemented")


def convert_model(ir: ModelIR, name: str = "",
                  precision: str = "highest") -> ConvertedModel:
    """Builds a :class:`ConvertedModel` (on the CPU) from a ModelIR.

    Only ``precision="highest"`` (fp32, TF32 off) is supported; the other
    tiers of the JAX executor ("high", "mixed", "serving", "default", or a
    per-op callable) raise ``NotImplementedError``.
    """
    if precision != "highest":
        raise NotImplementedError(
            f"precision {precision!r}: only 'highest' is ported; the lower "
            "tiers wait for the precision callables (ROADMAP §1 item 2)")
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
        name=name)


def params_from_jax(ir: ModelIR, jax_params: dict[str, np.ndarray]
                    ) -> dict[str, torch.Tensor]:
    """The JAX ``ConvertedModel.params`` of ``ir`` (keys ``t{index}``, OHWI
    and [1, kh, kw, C] filter layouts) as a state dict of this executor's
    :class:`ConvertedModel` for the same IR: load it with
    ``model.load_state_dict(params_from_jax(ir, params))``."""
    return _port_params(_fold(ir)[1], jax_params)


def _port_params(ops: list[OpIR], jax_params: dict[str, np.ndarray]
                 ) -> dict[str, torch.Tensor]:
    kinds = _weight_kinds(ops)
    out: dict[str, torch.Tensor] = {}
    for key, arr in jax_params.items():
        if not (key.startswith("t") and key[1:].isdigit()):
            raise ValueError(f"parameter {key!r} has no counterpart in the "
                             "PyTorch executor")
        out[key] = _port_tensor(kinds.get(int(key[1:])), np.asarray(arr))
    return out


def convert_file(path: str, name: str = "",
                 precision: str = "highest") -> ConvertedModel:
    with open(path, "rb") as f:
        buf = f.read()
    return convert_model(parse_tflite(buf), name=name or path,
                         precision=precision)
