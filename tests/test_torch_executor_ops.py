"""The executor ops the segmenters, the full-range detector and other
graphs need, each on a one-op graph, against the JAX executor on the same
``ModelIR``.

Tolerances: data-movement ops (slices, gathers, pads, resizes by nearest
neighbour, casts, reductions by max/min/arg-max, floor) are equal; the
arithmetic ones are within 2e-6 of the reference's largest magnitude (the
executor's budget, ``docs/PARITY.md`` row 1).  Every op runs at the
graph's batch of 1 against JAX and at N = 3 against three N = 1 runs of
the port (the same tolerances); an op that would mix the batch raises at
N = 3 instead.  The transposed convolutions are held against
``tf.nn.conv2d_transpose`` plus the bias where TensorFlow is installed."""

import numpy as np
import pytest
import torch

from face_detection_tflite_torch.convert.executor import (SUPPORTED_OPS,
                                                          convert_model)
from face_detection_tflite_torch.convert.tflite import (PADDING_SAME,
                                                        PADDING_VALID,
                                                        ModelIR, OpIR,
                                                        TensorIR)

from .torch_parity import both_models, rel_err

_rng = np.random.default_rng(99)


def _graph(op_name, options, tensors, inputs, outputs):
    """A one-op ModelIR.  ``tensors``: (shape, data or None, dtype); the
    graph's input is the first tensor without data."""
    ts = [TensorIR(i, f"t{i}", tuple(shape),
                   dtype if data is None else data.dtype.type, data)
          for i, (shape, data, dtype) in enumerate(tensors)]
    graph_in = [i for i in inputs if i >= 0 and ts[i].data is None][:1]
    return ModelIR(ts, [OpIR(op_name, list(inputs), list(outputs), options)],
                   graph_in, list(outputs), op_name)


def _x(shape, dtype=np.float32):
    return (shape, None, dtype)


def _c(arr):
    arr = np.asarray(arr)
    return (arr.shape, arr, arr.dtype.type)


def _w(*shape, scale=0.5):
    return _rng.normal(0, scale, shape).astype(np.float32)


def _unary(name, shape=(1, 5, 6, 4), out=None, options=None, **kw):
    return lambda: _graph(name, options or {}, [_x(shape), _x(out or shape)],
                          [0], [1])


def _binary(name, shape=(1, 5, 6, 4), const_shape=(1, 1, 4), options=None,
            positive=False):
    def build():
        c = _w(*const_shape)
        if positive:
            c = np.abs(c) + 0.5
        return _graph(name, options or {}, [_x(shape), _c(c), _x(shape)],
                      [0, 1], [2])
    return build


def _tconv(builtin, cin, cout, k, s, in_hw, out_hw, padding, bias=True):
    """A TRANSPOSE_CONV ([output_shape, filter, x, bias]) or MediaPipe's
    ``Convolution2DTransposeBias`` ([x, filter, bias]) with a TFLite
    [O, kh, kw, I] filter."""
    def build():
        x_shape = (1, *in_hw, cin)
        y_shape = (1, *out_hw, cout)
        w = _w(cout, k, k, cin)
        b = _w(cout)
        opts = {"padding": padding, "stride_w": s, "stride_h": s}
        if builtin:
            opts["activation"] = None
            tensors = [_c(np.asarray(y_shape, np.int32)), _c(w), _x(x_shape),
                       _c(b), _x(y_shape)]
            ins = [0, 1, 2, 3 if bias else -1]
            return _graph("TRANSPOSE_CONV", opts, tensors, ins, [4])
        tensors = [_x(x_shape), _c(w), _c(b), _x(y_shape)]
        return _graph("CUSTOM:Convolution2DTransposeBias", opts, tensors,
                      [0, 1, 2], [3])
    return build


def _pool(name, k, s, padding, shape=(1, 7, 9, 3)):
    def out(n):
        return -(-n // s) if padding == PADDING_SAME else (n - k) // s + 1
    return _unary(name, shape, (1, out(shape[1]), out(shape[2]), shape[3]),
                  dict(padding=padding, stride_w=s, stride_h=s, filter_w=k,
                       filter_h=k, activation=None))


def _resize(name, in_hw, out_hw, align=False, half=False):
    def build():
        return _graph(name, {"align_corners": align,
                             "half_pixel_centers": half},
                      [_x((1, *in_hw, 3)), _c(np.asarray(out_hw, np.int32)),
                       _x((1, *out_hw, 3))], [0, 1], [2])
    return build


def _static(name, shape, static, out, options=None, static_pos=1):
    """An op with one activation and one static input."""
    def build():
        tensors = [_x(shape), _c(np.asarray(static, np.int32)), _x(out)]
        ins = [0, 1] if static_pos == 1 else [1, 0]
        return _graph(name, options or {}, tensors, ins, [2])
    return build


def _multi(name, shape, outs, options, static=None):
    """SPLIT (static axis first) or UNPACK: one input, several outputs."""
    def build():
        tensors = [_x(shape)] + [_x(o) for o in outs]
        ins = [0]
        if static is not None:
            tensors.append(_c(np.asarray(static, np.int32)))
            ins = [len(tensors) - 1, 0]
        return _graph(name, options, tensors, ins,
                      list(range(1, len(outs) + 1)))
    return build


def _strided(shape, begin, end, strides, out, **masks):
    opts = {"begin_mask": 0, "end_mask": 0, "ellipsis_mask": 0,
            "new_axis_mask": 0, "shrink_axis_mask": 0, **masks}

    def build():
        return _graph("STRIDED_SLICE", opts,
                      [_x(shape)] + [_c(np.asarray(v, np.int32))
                                     for v in (begin, end, strides)]
                      + [_x(out)], [0, 1, 2, 3], [4])
    return build


def _two_inputs(name, shape, out, options):
    """PACK of the input and a constant of the same shape."""
    def build():
        return _graph(name, options, [_x(shape), _c(_w(*shape)), _x(out)],
                      [0, 1], [2])
    return build


_SAME, _VALID = PADDING_SAME, PADDING_VALID

#: name -> (function making the graph, input range, exact).
OPS = {
    "transpose_conv_same_s2_even": (
        _tconv(True, 4, 3, 3, 2, (8, 8), (16, 16), _SAME), (-1, 1), False),
    "transpose_conv_same_s2_odd_out": (
        _tconv(True, 4, 3, 3, 2, (7, 5), (13, 9), _SAME), (-1, 1), False),
    "transpose_conv_same_k1_s2": (
        _tconv(True, 3, 2, 1, 2, (5, 6), (10, 12), _SAME), (-1, 1), False),
    "transpose_conv_valid_s2": (
        _tconv(True, 4, 3, 3, 2, (5, 7), (11, 15), _VALID), (-1, 1), False),
    "transpose_conv_no_bias": (
        _tconv(True, 4, 3, 4, 2, (6, 6), (12, 12), _SAME, bias=False),
        (-1, 1), False),
    "conv2d_transpose_bias_same_even": (
        _tconv(False, 8, 4, 2, 2, (8, 8), (16, 16), _SAME), (-1, 1), False),
    "conv2d_transpose_bias_same_odd": (
        _tconv(False, 6, 6, 3, 2, (9, 5), (18, 10), _SAME), (-1, 1), False),
    "average_pool_same_s2": (_pool("AVERAGE_POOL_2D", 3, 2, _SAME),
                             (-2, 2), False),
    "average_pool_same_s1": (_pool("AVERAGE_POOL_2D", 3, 1, _SAME),
                             (-2, 2), False),
    "average_pool_valid": (_pool("AVERAGE_POOL_2D", 2, 2, _VALID),
                           (-2, 2), False),
    "average_pool_global": (_pool("AVERAGE_POOL_2D", 8, 8, _VALID,
                                  (1, 8, 8, 5)), (-2, 2), False),
    "resize_bilinear_half_pixel_up": (
        _resize("RESIZE_BILINEAR", (5, 8), (9, 16), half=True), (-3, 3),
        False),
    "resize_bilinear_align_corners": (
        _resize("RESIZE_BILINEAR", (5, 8), (10, 16), align=True), (-3, 3),
        False),
    "resize_bilinear_default_down": (
        _resize("RESIZE_BILINEAR", (9, 12), (4, 5)), (-3, 3), False),
    "resize_nearest_default": (
        _resize("RESIZE_NEAREST_NEIGHBOR", (5, 8), (9, 16)), (-3, 3), True),
    "resize_nearest_half_pixel": (
        _resize("RESIZE_NEAREST_NEIGHBOR", (5, 8), (10, 13), half=True),
        (-3, 3), True),
    "resize_nearest_align_corners": (
        _resize("RESIZE_NEAREST_NEIGHBOR", (5, 8), (9, 16), align=True),
        (-3, 3), True),
    "hard_swish": (_unary("HARD_SWISH"), (-5, 5), False),
    "softmax_beta": (_unary("SOFTMAX", options={"beta": 2.0}), (-3, 3),
                     False),
    "relu6": (_unary("RELU6"), (-3, 9), True),
    "tanh": (_unary("TANH"), (-3, 3), False),
    "leaky_relu": (_unary("LEAKY_RELU", options={"alpha": 0.2}), (-3, 3),
                   False),
    "elu": (_unary("ELU"), (-3, 3), False),
    "exp": (_unary("EXP"), (-3, 3), False),
    "log": (_unary("LOG"), (0.1, 5), False),
    "sqrt": (_unary("SQRT"), (0.1, 5), False),
    "abs": (_unary("ABS"), (-3, 3), True),
    "square": (_unary("SQUARE"), (-3, 3), False),
    "floor": (_unary("FLOOR"), (-3, 3), True),
    "dequantize_fp16": (
        lambda: _graph("DEQUANTIZE", {}, [_x((1, 5, 6, 4), np.float16),
                                          _x((1, 5, 6, 4))], [0], [1]),
        (-3, 3), True),
    "cast_to_int32": (
        lambda: _graph("CAST", {}, [_x((1, 5, 6, 4)),
                                    _x((1, 5, 6, 4), np.int32)], [0], [1]),
        (-9, 9), True),
    "div_relu": (_binary("DIV", options={"activation": "RELU"},
                         positive=True), (-3, 3), False),
    "maximum": (_binary("MAXIMUM"), (-1, 1), True),
    "minimum": (_binary("MINIMUM"), (-1, 1), True),
    "pow": (_binary("POW", positive=True), (0.2, 3), False),
    "sum": (_static("SUM", (1, 5, 6, 4), [1, 2], (1, 1, 1, 4),
                    {"keep_dims": True}), (-2, 2), False),
    "reduce_max": (_static("REDUCE_MAX", (1, 5, 6, 4), [3], (1, 5, 6),
                           {"keep_dims": False}), (-2, 2), True),
    "reduce_min": (_static("REDUCE_MIN", (1, 5, 6, 4), [-1, 2], (1, 5, 1, 1),
                           {"keep_dims": True}), (-2, 2), True),
    "arg_max": (lambda: _graph(
        "ARG_MAX", {}, [_x((1, 5, 6, 4)), _c(np.asarray(3, np.int32)),
                        _x((1, 5, 6), np.int32)], [0, 1], [2]),
        (-2, 2), True),
    "l2_normalization": (_unary("L2_NORMALIZATION",
                                options={"activation": None}), (-2, 2),
                         False),
    "squeeze": (_unary("SQUEEZE", (1, 5, 1, 4), (1, 5, 4),
                       {"squeeze_dims": [2]}), (-2, 2), True),
    "expand_dims": (_static("EXPAND_DIMS", (1, 5, 4), 2, (1, 5, 1, 4)),
                    (-2, 2), True),
    "expand_dims_negative": (_static("EXPAND_DIMS", (1, 5, 4), -1,
                                     (1, 5, 4, 1)), (-2, 2), True),
    "slice": (lambda: _graph(
        "SLICE", {}, [_x((1, 6, 7, 4)), _c(np.asarray([0, 1, 2, 0], np.int32)),
                      _c(np.asarray([1, 3, -1, 2], np.int32)),
                      _x((1, 3, 5, 2))], [0, 1, 2], [3]), (-2, 2), True),
    "strided_slice_masks": (_strided(
        (1, 6, 7, 4), [0, 1, 5, 1], [1, 5, 0, 4], [1, 2, -2, 1],
        (1, 2, 3, 3), begin_mask=0b0001, end_mask=0b0100), (-2, 2), True),
    "strided_slice_shrink": (_strided(
        (1, 6, 7, 4), [0, 2, 0, 0], [1, 3, 7, 4], [1, 1, 1, 1], (1, 7, 4),
        shrink_axis_mask=0b0010), (-2, 2), True),
    "split": (_multi("SPLIT", (1, 4, 6, 6), [(1, 4, 6, 2)] * 3,
                     {"num_splits": 3}, static=3), (-2, 2), True),
    "unpack": (_multi("UNPACK", (1, 3, 5, 4), [(1, 5, 4)] * 3,
                      {"num": 3, "axis": 1}), (-2, 2), True),
    "pack": (_two_inputs("PACK", (1, 5, 4), (1, 5, 2, 4), {"axis": 2,
                                                            "values_count": 2}),
             (-2, 2), True),
    "tile": (_static("TILE", (1, 3, 4, 2), [1, 2, 1, 3], (1, 6, 4, 6)),
             (-2, 2), True),
    "gather": (lambda: _graph(
        "GATHER", {"axis": 2, "batch_dims": 0},
        [_x((1, 4, 6, 3)), _c(np.asarray([[5, 0], [2, 2]], np.int32)),
         _x((1, 4, 2, 2, 3))], [0, 1], [2]), (-2, 2), True),
    "mirror_pad_reflect": (_static(
        "MIRROR_PAD", (1, 5, 6, 3), [[0, 0], [2, 1], [1, 3], [0, 0]],
        (1, 8, 10, 3), {"mode": 0}), (-2, 2), True),
    "mirror_pad_symmetric": (_static(
        "MIRROR_PAD", (1, 5, 6, 3), [[0, 0], [1, 2], [3, 0], [0, 1]],
        (1, 8, 9, 4), {"mode": 1}), (-2, 2), True),
    "padv2": (lambda: _graph(
        "PADV2", {}, [_x((1, 4, 5, 3)),
                      _c(np.asarray([[0, 0], [1, 2], [0, 1], [0, 0]],
                                    np.int32)),
                      _c(np.asarray(0.75, np.float32)), _x((1, 7, 6, 3))],
        [0, 1, 2], [3]), (-2, 2), True),
    "depth_to_space": (_unary("DEPTH_TO_SPACE", (1, 3, 4, 8), (1, 6, 8, 2),
                              {"block_size": 2}), (-2, 2), True),
    "space_to_depth": (_unary("SPACE_TO_DEPTH", (1, 6, 8, 2), (1, 3, 4, 8),
                              {"block_size": 2}), (-2, 2), True),
    "batch_matmul_adj_y": (lambda: _graph(
        "BATCH_MATMUL", {"adj_x": False, "adj_y": True},
        [_x((1, 5, 6)), _c(_w(1, 3, 6)), _x((1, 5, 3))], [0, 1], [2]),
        (-2, 2), False),
    "batch_matmul_rows": (lambda: _graph(
        "BATCH_MATMUL", {"adj_x": False, "adj_y": False},
        [_x((1, 6)), _c(_w(6, 4)), _x((1, 4))], [0, 1], [2]), (-2, 2),
        False),
}

#: The ops this file ports, by TFLite name: each has a case above.
NEW_OPS = {
    "TRANSPOSE_CONV", "CUSTOM:Convolution2DTransposeBias", "AVERAGE_POOL_2D",
    "RESIZE_BILINEAR", "RESIZE_NEAREST_NEIGHBOR", "HARD_SWISH", "SOFTMAX",
    "RELU6", "TANH", "LEAKY_RELU", "ELU", "DIV", "MAXIMUM", "MINIMUM", "POW",
    "ABS", "EXP", "LOG", "SQRT", "SQUARE", "FLOOR", "SUM", "REDUCE_MAX",
    "REDUCE_MIN", "ARG_MAX", "L2_NORMALIZATION", "SQUEEZE", "EXPAND_DIMS",
    "CAST", "SLICE", "STRIDED_SLICE", "SPLIT", "UNPACK", "PACK", "TILE",
    "GATHER", "MIRROR_PAD", "PADV2", "DEPTH_TO_SPACE", "SPACE_TO_DEPTH",
    "BATCH_MATMUL", "DEQUANTIZE"}


def _input(ir, lo, hi, n):
    t = ir.tensors[ir.inputs[0]]
    x = _rng.uniform(lo, hi, (n,) + tuple(t.shape[1:]))
    return x.astype(t.dtype)


def _check(got, ref, exact):
    got = np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    if exact:
        np.testing.assert_array_equal(got, ref)
    else:
        assert rel_err(got, ref) <= 2e-6


def test_every_new_op_has_a_case():
    names = {OPS[k][0]().ops[0].name for k in OPS}
    assert NEW_OPS <= names
    assert NEW_OPS <= SUPPORTED_OPS
    assert "QUANTIZE" not in SUPPORTED_OPS


@pytest.mark.parametrize("name", sorted(OPS))
def test_op_matches_jax(name):
    build, (lo, hi), exact = OPS[name]
    ir = build()
    jm, tm = both_models(ir)
    x = _input(ir, lo, hi, 1)
    refs = jm.fn(jm.params, x)
    with torch.inference_mode():
        gots = tm(torch.from_numpy(x))
    assert len(gots) == len(refs)
    for g, r in zip(gots, refs):
        _check(g, r, exact)


@pytest.mark.parametrize("name", sorted(OPS))
def test_op_batch_of_three_matches_three_single_runs(name):
    build, (lo, hi), exact = OPS[name]
    tm = convert_model(build())
    x = torch.from_numpy(_input(build(), lo, hi, 3))
    with torch.inference_mode():
        batched = tm(x)
        singles = [tm(x[i:i + 1]) for i in range(3)]
    for k, out in enumerate(batched):
        _check(out, torch.cat([s[k] for s in singles]), exact)


#: name -> a graph whose op would mix the batch at N > 1.
BATCH_MIXERS = {
    "squeeze_all_unit_dims": _unary("SQUEEZE", (1, 5, 1, 4), (5, 4),
                                    {"squeeze_dims": []}),
    "expand_dims_before_batch": _static("EXPAND_DIMS", (1, 5, 4), 0,
                                        (1, 1, 5, 4)),
    "pack_on_axis_0": _two_inputs("PACK", (1, 5, 4), (2, 1, 5, 4),
                                  {"axis": 0, "values_count": 2}),
    "unpack_axis_0": _multi("UNPACK", (1, 3, 4), [(3, 4)],
                            {"num": 1, "axis": 0}),
    "split_axis_0": _multi("SPLIT", (1, 4, 6), [(1, 4, 6)],
                           {"num_splits": 1}, static=0),
    "tile_batch": _static("TILE", (1, 3, 4), [2, 1, 1], (2, 3, 4)),
    "gather_axis_0": lambda: _graph(
        "GATHER", {"axis": 0, "batch_dims": 0},
        [_x((1, 4, 3)), _c(np.asarray([0, 0], np.int32)), _x((2, 4, 3))],
        [0, 1], [2]),
    "mirror_pad_batch": _static("MIRROR_PAD", (1, 5, 3),
                                [[1, 0], [1, 1], [0, 0]], (2, 7, 3),
                                {"mode": 1}),
    "padv2_batch": lambda: _graph(
        "PADV2", {}, [_x((1, 4, 3)),
                      _c(np.asarray([[1, 0], [0, 0], [0, 0]], np.int32)),
                      _c(np.asarray(0.5, np.float32)), _x((2, 4, 3))],
        [0, 1, 2], [3]),
    "sum_over_batch": _static("SUM", (1, 5, 4), [0, 1], (4,),
                              {"keep_dims": False}),
    "arg_max_over_batch": lambda: _graph(
        "ARG_MAX", {}, [_x((1, 5)), _c(np.asarray(0, np.int32)),
                        _x((5,), np.int32)], [0, 1], [2]),
    "strided_slice_shrinks_batch": _strided(
        (1, 6, 4), [0, 0, 0], [1, 6, 4], [1, 1, 1], (6, 4),
        shrink_axis_mask=0b001),
    "slice_of_batch": lambda: _graph(
        "SLICE", {}, [_x((1, 6, 4)), _c(np.asarray([0, 0, 0], np.int32)),
                      _c(np.asarray([0, 6, 4], np.int32)), _x((0, 6, 4))],
        [0, 1, 2], [3]),
    "batch_matmul_rows_on_the_right": lambda: _graph(
        "BATCH_MATMUL", {"adj_x": False, "adj_y": False},
        [_x((1, 6)), _c(_w(4, 1)), _x((4, 6))], [1, 0], [2]),
    "softmax_over_batch": _unary("SOFTMAX", (1,), (1,), {"beta": 1.0}),
}


@pytest.mark.parametrize("name", sorted(BATCH_MIXERS))
def test_ops_refuse_to_mix_the_batch(name):
    ir = BATCH_MIXERS[name]()
    tm = convert_model(ir)
    shape = ir.tensors[ir.inputs[0]].shape
    with torch.inference_mode():
        tm(torch.zeros((1,) + tuple(shape[1:])))
        with pytest.raises(ValueError, match="batch"):
            tm(torch.zeros((3,) + tuple(shape[1:])))


@pytest.mark.parametrize("builtin", [True, False])
@pytest.mark.parametrize("k,in_hw,out_hw", [
    (2, (8, 8), (16, 16)), (3, (7, 5), (14, 10)), (3, (7, 5), (13, 9)),
    (4, (5, 6), (10, 12))])
def test_transposed_convs_match_tensorflow(builtin, k, in_hw, out_hw):
    """TRANSPOSE_CONV and ``Convolution2DTransposeBias`` with SAME padding
    at stride 2, odd and even sizes, against ``tf.nn.conv2d_transpose``
    plus the bias (TensorFlow's filter is [kh, kw, out, in])."""
    tf = pytest.importorskip("tensorflow")
    ir = _tconv(builtin, 5, 3, k, 2, in_hw, out_hw, _SAME)()
    tm = convert_model(ir)
    w_ix, b_ix = (1, 3) if builtin else (1, 2)
    w = ir.tensors[w_ix].data
    b = ir.tensors[b_ix].data
    x = _input(ir, -1, 1, 2)
    ref = tf.nn.conv2d_transpose(
        x, np.transpose(w, (1, 2, 0, 3)), output_shape=(2, *out_hw, 3),
        strides=2, padding="SAME").numpy() + b
    with torch.inference_mode():
        (got,) = tm(torch.from_numpy(x))
    assert rel_err(got, ref) <= 2e-6
