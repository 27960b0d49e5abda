"""The PyTorch executor against the JAX executor on the same ModelIR.

Single-op graphs hold each ported op to the ≤2e-6 relative budget of
``docs/PARITY.md`` row 1; the seeded full-width BlazeFace-back and FaceMesh
graphs (reduced depth) hold the composed networks to 2e-6 of the output's
largest magnitude: sums run in another order over ~40 convs, and the error
measured over three seeds was at most 6.5e-7."""

import numpy as np
import pytest
import torch

from face_detection_tflite_torch.convert.executor import (convert_model,
                                                          params_from_jax)
from face_detection_tflite_torch.convert.tflite import (
    PADDING_SAME, PADDING_VALID, ModelIR, OpIR, TensorIR, parse_tflite)
from face_detection_tflite_torch.models import random_init

from .torch_parity import both_models, jax_ir, rel_err

_rng = np.random.default_rng(1234)


def _conv_opts(padding, stride, act=None, **extra):
    return dict(padding=padding, stride_w=stride, stride_h=stride,
                activation=act, dilation_w=1, dilation_h=1, **extra)


def _ir(op_name, in_shape, out_shape, options, consts=(), inputs2=()):
    """One op over input tensor 0 (plus constant inputs) -> tensor 1."""
    tensors = [TensorIR(0, "x", tuple(in_shape), np.float32, None),
               TensorIR(1, "y", tuple(out_shape), np.float32, None)]
    ins = [0]
    for i, c in enumerate(consts, start=2):
        tensors.append(TensorIR(i, f"c{i}", c.shape, c.dtype.type, c))
        ins.append(i)
    return ModelIR(tensors, [OpIR(op_name, ins + list(inputs2), [1],
                                  options)], [0], [1], "single-op")


def _w(*shape, scale=0.5):
    return _rng.normal(0, scale, shape).astype(np.float32)


SINGLE_OPS = {
    "conv_same_s1_relu": lambda: _ir(
        "CONV_2D", (1, 9, 9, 4), (1, 9, 9, 6),
        _conv_opts(PADDING_SAME, 1, "RELU"), [_w(6, 3, 3, 4), _w(6)]),
    "conv_same_s2_asym": lambda: _ir(
        "CONV_2D", (1, 10, 10, 3), (1, 5, 5, 5),
        _conv_opts(PADDING_SAME, 2), [_w(5, 3, 3, 3), _w(5)]),
    "conv_valid_s2_relu6": lambda: _ir(
        "CONV_2D", (1, 11, 11, 3), (1, 4, 4, 8),
        _conv_opts(PADDING_VALID, 2, "RELU6"), [_w(8, 5, 5, 3), _w(8)]),
    "depthwise_same_s1": lambda: _ir(
        "DEPTHWISE_CONV_2D", (1, 8, 8, 6), (1, 8, 8, 6),
        _conv_opts(PADDING_SAME, 1, depth_multiplier=1),
        [_w(1, 3, 3, 6), _w(6)]),
    "depthwise_valid_s2_relu": lambda: _ir(
        "DEPTHWISE_CONV_2D", (1, 10, 10, 4), (1, 4, 4, 4),
        _conv_opts(PADDING_VALID, 2, "RELU", depth_multiplier=1),
        [_w(1, 3, 3, 4), _w(4)]),
    "depthwise_multiplier2": lambda: _ir(
        "DEPTHWISE_CONV_2D", (1, 7, 7, 3), (1, 7, 7, 6),
        _conv_opts(PADDING_SAME, 1, depth_multiplier=2),
        [_w(1, 3, 3, 6), _w(6)]),
    "add_broadcast_relu": lambda: _ir(
        "ADD", (1, 5, 5, 4), (1, 5, 5, 4), {"activation": "RELU"},
        [_w(1, 1, 4)]),
    "mul_tanh": lambda: _ir(
        "MUL", (1, 5, 5, 4), (1, 5, 5, 4), {"activation": "TANH"},
        [_w(1, 5, 5, 4)]),
    "pad": lambda: _ir(
        "PAD", (1, 5, 6, 3), (1, 8, 8, 7), {},
        [np.asarray([[0, 0], [1, 2], [0, 2], [0, 4]], np.int32)]),
    "max_pool_valid": lambda: _ir(
        "MAX_POOL_2D", (1, 8, 8, 3), (1, 4, 4, 3),
        dict(padding=PADDING_VALID, stride_w=2, stride_h=2, filter_w=2,
             filter_h=2, activation=None)),
    "max_pool_same_relu": lambda: _ir(
        "MAX_POOL_2D", (1, 7, 7, 3), (1, 4, 4, 3),
        dict(padding=PADDING_SAME, stride_w=2, stride_h=2, filter_w=3,
             filter_h=3, activation="RELU")),
    "prelu": lambda: _ir("PRELU", (1, 5, 5, 4), (1, 5, 5, 4), {},
                         [_w(1, 1, 4)]),
    "relu": lambda: _ir("RELU", (1, 5, 5, 4), (1, 5, 5, 4), {}),
    "reshape": lambda: _ir(
        "RESHAPE", (1, 4, 4, 6), (1, 48, 2), {"new_shape": [1, 48, 2]},
        [np.asarray([1, 48, 2], np.int32)]),
}


@pytest.mark.parametrize("name", sorted(SINGLE_OPS))
def test_single_op_matches_jax(name):
    ir = SINGLE_OPS[name]()
    jm, tm = both_models(ir)
    x = _rng.uniform(-2, 2, ir.tensors[0].shape).astype(np.float32)
    (ref,) = jm.fn(jm.params, x)
    (got,) = tm(torch.from_numpy(x))
    assert got.shape == ref.shape
    assert rel_err(got, ref) <= 2e-6


@pytest.mark.parametrize("axis", [1, -1])
def test_concatenation_matches_jax(axis):
    tensors = [TensorIR(0, "a", (1, 3, 4), np.float32, None),
               TensorIR(1, "b", (1, 3, 4), np.float32, None),
               TensorIR(2, "y", (1, 6, 4) if axis == 1 else (1, 3, 8),
                        np.float32, None)]
    ir = ModelIR(tensors, [OpIR("CONCATENATION", [0, 1], [2],
                                {"axis": axis, "activation": "RELU"})],
                 [0, 1], [2], "concat")
    jm, tm = both_models(ir)
    a, b = (_rng.normal(size=(1, 3, 4)).astype(np.float32) for _ in range(2))
    (ref,) = jm.fn(jm.params, a, b)
    (got,) = tm(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_fp16_dequantize_folds():
    """fp16 weights behind a DEQUANTIZE op (the real detector files' form)
    fold into fp32 buffers, as in the JAX executor's pass 1."""
    w16 = _w(4, 1, 1, 3).astype(np.float16)
    tensors = [TensorIR(0, "x", (1, 5, 5, 3), np.float32, None),
               TensorIR(1, "y", (1, 5, 5, 4), np.float32, None),
               TensorIR(2, "w16", w16.shape, np.float16, w16),
               TensorIR(3, "w", w16.shape, np.float32, None)]
    ir = ModelIR(tensors, [
        OpIR("DEQUANTIZE", [2], [3], {}),
        OpIR("CONV_2D", [0, 3, -1], [1], _conv_opts(PADDING_SAME, 1))],
        [0], [1], "fp16")
    jm, tm = both_models(ir)
    x = _rng.normal(size=(1, 5, 5, 3)).astype(np.float32)
    assert rel_err(tm(torch.from_numpy(x))[0], jm.fn(jm.params, x)[0]) <= 2e-6
    assert tm.t3.dtype == torch.float32


def test_unsupported_op_and_precision_raise():
    ir = _ir("HASHTABLE_LOOKUP", (1, 4), (1, 4), {})
    with pytest.raises(NotImplementedError, match="HASHTABLE_LOOKUP"):
        convert_model(ir)
    # Every tier of the JAX executor is ported; a name that is not one is
    # refused (jax.lax.Precision refuses it too).
    with pytest.raises(ValueError, match="precision"):
        convert_model(SINGLE_OPS["relu"](), precision="bf16x3")
    with pytest.raises(ValueError):
        params_from_jax(SINGLE_OPS["relu"](), {"w0": np.zeros(2)})
    # The JAX executor's interpolation matrices have no counterpart: the
    # port computes its resize taps from the graph.
    assert params_from_jax(SINGLE_OPS["relu"](), {"rs0_h": np.zeros(2)}) == {}


def test_reshape_across_batch_raises():
    ir = _ir("RESHAPE", (1, 4, 4, 6), (96,), {"new_shape": [96]},
             [np.asarray([96], np.int32)])
    tm = convert_model(ir)
    assert tm(torch.zeros(1, 4, 4, 6))[0].shape == (96,)
    with pytest.raises(ValueError, match="batch"):
        tm(torch.zeros(2, 4, 4, 6))
    with pytest.raises(ValueError, match="expects shape"):
        tm(torch.zeros(1, 4, 5, 6))


@pytest.mark.parametrize("which", ["blazeface", "mesh"])
def test_random_models_match_jax(which):
    """Full widths, one block per stage: both executors on one IR."""
    if which == "blazeface":
        ir = random_init.blazeface_back_ir(3, blocks_per_stage=1)
        x = _rng.uniform(-1, 1, (1, 256, 256, 3)).astype(np.float32)
    else:
        ir = random_init.face_mesh_ir(4, blocks_per_stage=1)
        x = _rng.uniform(-1, 1, (1, 192, 192, 3)).astype(np.float32)
    jm, tm = both_models(ir)
    refs = jm.fn(jm.params, x)
    with torch.inference_mode():
        gots = tm(torch.from_numpy(x))
    assert [tuple(g.shape) for g in gots] == [tuple(r.shape) for r in refs]
    assert [tuple(s) for s in tm.output_shapes] == \
        [tuple(s) for s in jm.output_shapes]
    for g, r in zip(gots, refs):
        assert np.isfinite(g.numpy()).all()
        assert rel_err(g, r) <= 2e-6


def test_batch_equals_single_runs():
    ir = random_init.face_mesh_ir(5, blocks_per_stage=1)
    tm = convert_model(ir)
    x = torch.from_numpy(
        _rng.uniform(-1, 1, (3, 192, 192, 3)).astype(np.float32))
    with torch.inference_mode():
        batched = tm(x)
        singles = [tm(x[i:i + 1]) for i in range(3)]
    for j, out in enumerate(batched):
        one = torch.cat([s[j] for s in singles])
        assert rel_err(out, one) <= 1e-6


def test_parse_tflite_matches_jax_parser():
    """The port's parser on a TensorFlow-built graph gives the JAX
    package's IR, and both executors agree on it."""
    tf = pytest.importorskip("tensorflow")
    from face_detection_tflite_tpu.convert.tflite import \
        parse_tflite as j_parse
    inp = tf.keras.Input((16, 16, 3), batch_size=1)
    x = tf.keras.layers.Conv2D(8, 3, strides=2, padding="same")(inp)
    x = tf.keras.layers.PReLU(shared_axes=[1, 2])(x)
    y = tf.keras.layers.DepthwiseConv2D(3, padding="same")(x)
    x = tf.keras.layers.ReLU()(tf.keras.layers.Add()([x, y]))
    x = tf.keras.layers.MaxPooling2D(2)(x)
    out = tf.keras.layers.Reshape((16, 8))(x)
    blob = tf.lite.TFLiteConverter.from_keras_model(
        tf.keras.Model(inp, out)).convert()
    mine, ref = parse_tflite(blob), j_parse(blob)
    assert (mine.inputs, mine.outputs) == (ref.inputs, ref.outputs)
    assert [(o.name, o.inputs, o.outputs, o.options) for o in mine.ops] == \
        [(o.name, o.inputs, o.outputs, o.options) for o in ref.ops]
    for a, b in zip(mine.tensors, ref.tensors):
        assert (a.index, a.name, a.shape, a.dtype) == \
            (b.index, b.name, b.shape, b.dtype)
        if b.data is None:
            assert a.data is None
        else:
            np.testing.assert_array_equal(a.data, b.data)
    jm, tm = both_models(mine)
    xin = _rng.uniform(-1, 1, (1, 16, 16, 3)).astype(np.float32)
    assert rel_err(tm(torch.from_numpy(xin))[0], jm.fn(jm.params, xin)[0]) \
        <= 2e-6
    assert jax_ir(mine).description == mine.description


def _fc_ir(in_shape, cout, keep, act=None, bias=True, reshape_to=None):
    """FULLY_CONNECTED over the last axis, optionally followed by a
    RESHAPE (the form TFLite gives a flattening FULLY_CONNECTED)."""
    cin = in_shape[-1]
    rows = int(np.prod(in_shape[:-1]))
    out_shape = tuple(in_shape[:-1]) + (cout,) if keep else (rows, cout)
    tensors = [TensorIR(0, "x", tuple(in_shape), np.float32, None),
               TensorIR(1, "fc", out_shape, np.float32, None),
               TensorIR(2, "w", (cout, cin), np.float32, _w(cout, cin)),
               TensorIR(3, "b", (cout,), np.float32, _w(cout))]
    ops = [OpIR("FULLY_CONNECTED", [0, 2, 3 if bias else -1], [1],
                {"activation": act, "keep_num_dims": keep})]
    out = 1
    if reshape_to is not None:
        shp = np.asarray(reshape_to, np.int32)
        tensors += [TensorIR(4, "shape", shp.shape, np.int32, shp),
                    TensorIR(5, "y", tuple(reshape_to), np.float32, None)]
        ops.append(OpIR("RESHAPE", [1, 4], [5],
                        {"new_shape": list(reshape_to)}))
        out = 5
    return ModelIR(tensors, ops, [0], [out], "fully connected")


#: The ops of the iris and blendshape graphs that the BlazeFace and
#: FaceMesh graphs lack: name -> (IR builder, input range).
MIXER_OPS = {
    "fc_keep_num_dims": (lambda: _fc_ir((1, 7, 8), 5, True), (-2, 2)),
    "fc_2d_relu": (lambda: _fc_ir((1, 12), 5, False, "RELU"), (-2, 2)),
    "fc_no_bias": (lambda: _fc_ir((1, 3, 12), 4, True, bias=False),
                   (-2, 2)),
    "fc_rows_then_reshape": (
        lambda: _fc_ir((1, 6, 8), 5, False, reshape_to=(1, 6, 5)), (-2, 2)),
    "sub_relu": (lambda: _ir("SUB", (1, 5, 4), (1, 5, 4),
                             {"activation": "RELU"}, [_w(1, 1, 4)]), (-2, 2)),
    "neg": (lambda: _ir("NEG", (1, 5, 4), (1, 5, 4), {}), (-2, 2)),
    "squared_difference": (lambda: _ir("SQUARED_DIFFERENCE", (1, 6, 4),
                                       (1, 6, 4), {}, [_w(1, 6, 1)]),
                           (-2, 2)),
    "rsqrt": (lambda: _ir("RSQRT", (1, 5, 4), (1, 5, 4), {}), (0.05, 3)),
    "logistic": (lambda: _ir("LOGISTIC", (1, 5, 4), (1, 5, 4), {}), (-8, 8)),
    "gelu": (lambda: _ir("GELU", (1, 5, 4), (1, 5, 4),
                         {"approximate": False}), (-4, 4)),
    "gelu_tanh": (lambda: _ir("GELU", (1, 5, 4), (1, 5, 4),
                              {"approximate": True}), (-4, 4)),
    "transpose_3d": (lambda: _ir("TRANSPOSE", (1, 4, 6), (1, 6, 4), {},
                                 [np.asarray([0, 2, 1], np.int32)]), (-2, 2)),
    "transpose_4d": (lambda: _ir("TRANSPOSE", (1, 3, 4, 5), (1, 5, 3, 4), {},
                                 [np.asarray([0, 3, 1, 2], np.int32)]),
                     (-2, 2)),
    "mean_keep": (lambda: _ir("MEAN", (1, 7, 4), (1, 1, 4),
                              {"keep_dims": True},
                              [np.asarray([1], np.int32)]), (-2, 2)),
    "mean_two_axes": (lambda: _ir("MEAN", (1, 3, 4, 5), (1, 5),
                                  {"keep_dims": False},
                                  [np.asarray([1, 2], np.int32)]), (-2, 2)),
    "mean_scalar_last_axis": (lambda: _ir("MEAN", (1, 7, 4), (1, 7),
                                          {"keep_dims": False},
                                          [np.asarray(-1, np.int32)]),
                              (-2, 2)),
}


def _jax_batched(jm, x):
    """The JAX function (one sample of the graph's batch 1) vmapped over
    the leading axis of ``x``."""
    import jax
    return jax.vmap(lambda xi: jm.fn(jm.params, xi[None]))(x)


@pytest.mark.parametrize("n", [1, 3])
@pytest.mark.parametrize("name", sorted(MIXER_OPS))
def test_mixer_op_matches_jax(name, n):
    """Each op against the JAX executor, at the graph's batch of 1 and at
    N = 3 against the JAX function vmapped (an op that mixes the samples
    gives wrong rows only at N > 1)."""
    build, (lo, hi) = MIXER_OPS[name]
    ir = build()
    jm, tm = both_models(ir)
    x = _rng.uniform(lo, hi, (n,) + ir.tensors[0].shape[1:]).astype(
        np.float32)
    (ref,) = _jax_batched(jm, x)
    (got,) = tm(torch.from_numpy(x))
    ref = np.asarray(ref)
    assert got.shape[0] == (n * ref.shape[1] if got.dim() == 2 and
                            ref.shape[1] != 1 else n)
    assert got.numel() == ref.size
    assert rel_err(got.reshape(ref.shape), ref) <= 2e-6


def test_mixer_ops_refuse_to_mix_the_batch():
    """An op that would move or reduce the batch dimension raises at N > 1
    and runs at N = 1."""
    cases = [
        _ir("TRANSPOSE", (1, 4, 6), (4, 1, 6), {},
            [np.asarray([1, 0, 2], np.int32)]),
        _ir("MEAN", (1, 4, 6), (4, 6), {"keep_dims": False},
            [np.asarray([0], np.int32)]),
        # A flattening FULLY_CONNECTED whose rows nothing puts back.
        _fc_ir((1, 6, 8), 5, False),
    ]
    for ir in cases:
        tm = convert_model(ir)
        tm(torch.zeros((1,) + ir.tensors[0].shape[1:]))
        with pytest.raises(ValueError, match="batch"):
            tm(torch.zeros((2,) + ir.tensors[0].shape[1:]))


def _tf_mixer_blob(tf):
    """A tiny Keras MLP-Mixer on [1, 146, 2], converted by TensorFlow with
    random (non-zero) weights: FULLY_CONNECTED, TRANSPOSE, GELU, the layer
    norms' MEAN / NEG / SQUARED_DIFFERENCE / RSQRT, LOGISTIC."""
    keras = tf.keras
    inp = keras.Input((146, 2), batch_size=1)
    x = keras.layers.Dense(16)(inp)
    y = keras.layers.LayerNormalization(epsilon=1e-6)(x)
    y = keras.layers.Permute((2, 1))(y)
    y = keras.layers.Dense(32, activation="gelu")(y)
    y = keras.layers.Permute((2, 1))(keras.layers.Dense(146)(y))
    x = keras.layers.Add()([x, y])
    y = keras.layers.LayerNormalization(epsilon=1e-6)(x)
    y = keras.layers.Dense(16)(keras.layers.Dense(24, activation="gelu")(y))
    x = keras.layers.GlobalAveragePooling1D()(keras.layers.Add()([x, y]))
    model = keras.Model(inp, keras.layers.Dense(52, activation="sigmoid")(x))
    rng = np.random.default_rng(5)
    model.set_weights([rng.normal(0, 0.3, w.shape).astype(np.float32) +
                       (1.0 if w.ndim == 1 and i % 2 == 0 else 0.0)
                       for i, w in enumerate(model.get_weights())])
    return tf.lite.TFLiteConverter.from_keras_model(model).convert()


def test_tf_mixer_matches_jax():
    """A TensorFlow-built MLP-Mixer ``.tflite`` through both executors, at
    N = 1 and N = 3 (the JAX function vmapped)."""
    tf = pytest.importorskip("tensorflow")
    ir = parse_tflite(_tf_mixer_blob(tf))
    names = {op.name for op in ir.ops}
    assert {"FULLY_CONNECTED", "TRANSPOSE", "GELU", "MEAN", "RSQRT",
            "SQUARED_DIFFERENCE", "LOGISTIC"} <= names
    jm, tm = both_models(ir)
    for n in (1, 3):
        x = _rng.uniform(-3, 3, (n, 146, 2)).astype(np.float32)
        (ref,) = _jax_batched(jm, x)
        with torch.inference_mode():
            (got,) = tm(torch.from_numpy(x))
        assert got.shape == (n, 52)
        assert rel_err(got, np.asarray(ref).reshape(n, 52)) <= 2e-6


@pytest.mark.parametrize("which", ["iris", "blendshapes"])
def test_random_full_models_match_jax(which):
    """The seeded iris and blendshape nets at full width and depth, at
    N = 1 and N = 2 (the JAX function vmapped)."""
    if which == "iris":
        ir = random_init.iris_landmark_ir(6)
        x = _rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    else:
        ir = random_init.face_blendshapes_ir(7)
        x = _rng.uniform(0, 1280, (2, 146, 2)).astype(np.float32)
    jm, tm = both_models(ir)
    for n in (1, 2):
        refs = _jax_batched(jm, x[:n])
        with torch.inference_mode():
            gots = tm(torch.from_numpy(x[:n]))
        assert len(gots) == len(refs) == (2 if which == "iris" else 1)
        for g, r in zip(gots, refs):
            r = np.asarray(r).reshape(g.shape)
            assert np.isfinite(g.numpy()).all()
            assert rel_err(g, r) <= 2e-6
