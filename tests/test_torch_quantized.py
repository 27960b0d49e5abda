"""Quantized graphs on the port: the fake-quant emulation and QUANTIZE.

The port runs a quantized graph as the JAX executor does (``_fake_quant``:
fp32 compute, constants dequantized exactly, every activation snapped to
its per-tensor grid).  On the JAX package's TF-built toy graphs
(``tests/test_quantized.py``: post-training int8, a Keras Flatten graph
with and without int8, and the 16x8 scheme) the port is held to
``tf.lite.Interpreter`` within the JAX test's bounds (one output grid step;
two for the flatten graph; 1e-4 for 16x8; 1e-5 for the float graph) and
to the JAX executor within one output step.  The seeded int8 BlazeFace
(``random_init.quantized_ir``) runs through both executors within two
output steps, and equal on all but 5% of the outputs: the two executors'
fp32 convolutions differ in their last bits, which can move an
intermediate value across a grid tie (1.6% of the back detector's scores
moved one step on these seeds).
"""

import numpy as np
import pytest
import torch

from face_detection_tflite_torch import FaceDetector
from face_detection_tflite_torch.convert.executor import (SUPPORTED_OPS,
                                                          convert_model)
from face_detection_tflite_torch.convert.tflite import (ModelIR, OpIR,
                                                        TensorIR, parse_tflite)
from face_detection_tflite_torch.models import random_init
from face_detection_tflite_torch.pipeline.programs import PipelineModels
from face_detection_tflite_tpu.convert import executor as j_exec
from face_detection_tflite_tpu.convert import tflite as j_tflite

from .torch_parity import H, MAX_FACES, W, jax_ir

_FRAMES = np.random.default_rng(21).integers(0, 256, (4, H, W, 3),
                                             dtype=np.uint8)


def _tf():
    return pytest.importorskip("tensorflow")


def _interpreter(blob):
    tf = _tf()
    interp = tf.lite.Interpreter(
        model_content=blob,
        experimental_op_resolver_type=tf.lite.experimental
        .OpResolverType.BUILTIN_WITHOUT_DEFAULT_DELEGATES)
    interp.allocate_tensors()
    return (interp, interp.get_input_details()[0],
            interp.get_output_details()[0])


def _int8_converter(model, rep, int16=False):
    tf = _tf()
    conv = tf.lite.TFLiteConverter.from_keras_model(model)
    conv.optimizations = [tf.lite.Optimize.DEFAULT]
    conv.representative_dataset = rep
    if int16:
        conv.target_spec.supported_ops = [
            tf.lite.OpsSet
            .EXPERIMENTAL_TFLITE_BUILTINS_ACTIVATIONS_INT16_WEIGHTS_INT8]
    else:
        conv.target_spec.supported_ops = [tf.lite.OpsSet.TFLITE_BUILTINS_INT8]
        conv.inference_input_type = tf.int8
        conv.inference_output_type = tf.int8
    return conv.convert()


@pytest.fixture(scope="module")
def int8_model():
    """The JAX test's toy: conv/2 + ReLU, depthwise + ReLU, global pool,
    dense, softmax, int8 in and out (same seeds)."""
    tf = _tf()
    tf.keras.utils.set_random_seed(0)
    rng = np.random.default_rng(0)
    inp = tf.keras.Input((16, 16, 3))
    x = tf.keras.layers.Conv2D(8, 3, strides=2, padding="same",
                               activation="relu")(inp)
    x = tf.keras.layers.DepthwiseConv2D(3, padding="same",
                                        activation="relu")(x)
    x = tf.keras.layers.GlobalAveragePooling2D()(x)
    x = tf.keras.layers.Dense(10)(x)
    out = tf.keras.layers.Softmax()(x)
    model = tf.keras.Model(inp, out)

    def rep():
        for _ in range(50):
            yield [rng.uniform(-1, 1, (1, 16, 16, 3)).astype(np.float32)]
    return _int8_converter(model, rep)


@pytest.mark.parametrize("given", ["int8", "float"])
def test_int8_matches_interpreter_and_jax(int8_model, given):
    """An int8 input is dequantized, a float one snapped to the input
    grid; both within one output step of the interpreter and of the JAX
    executor."""
    interp, idet, odet = _interpreter(int8_model)
    iscale, izp = idet["quantization"]
    oscale, ozp = odet["quantization"]
    ir = parse_tflite(int8_model)
    tm = convert_model(ir, name="toy-int8")
    jm = j_exec.convert_model(j_tflite.parse_tflite(int8_model))
    rng = np.random.default_rng(7)
    worst_tf = worst_jax = 0.0
    for _ in range(4):
        xf = rng.uniform(-1, 1, (1, 16, 16, 3)).astype(np.float32)
        xi = np.clip(np.round(xf / iscale) + izp, -128, 127).astype(np.int8)
        interp.set_tensor(idet["index"], xi)
        interp.invoke()
        ref = (interp.get_tensor(odet["index"]).astype(np.float32)
               - ozp) * oscale
        x = xi if given == "int8" else xf
        with torch.inference_mode():
            (got,) = tm(torch.from_numpy(x))
        (jgot,) = jm.fn(jm.params, x)
        worst_tf = max(worst_tf, float(np.abs(got.numpy() - ref).max()))
        worst_jax = max(worst_jax, float(np.abs(got.numpy() - jgot).max()))
    assert worst_tf <= oscale, f"drifted {worst_tf} (> {oscale})"
    assert worst_jax <= oscale


def test_int8_batch_matches_single_runs(int8_model):
    """The fake-quant hook and QUANTIZE are elementwise: N = 3 equals
    three N = 1 runs."""
    tm = convert_model(parse_tflite(int8_model))
    x = torch.from_numpy(np.random.default_rng(8).uniform(
        -1, 1, (3, 16, 16, 3)).astype(np.float32))
    with torch.inference_mode():
        (batched,) = tm(x)
        singles = torch.cat([tm(x[i:i + 1])[0] for i in range(3)])
    assert torch.equal(batched, singles)


def test_per_channel_weights_dequantized(int8_model):
    """Per-channel int8 filters dequantize exactly, to the JAX params."""
    ir = parse_tflite(int8_model)
    per_channel = [t for t in ir.tensors
                   if t.quant is not None and t.quant["scale"].size > 1]
    assert per_channel
    tm = convert_model(ir)
    jm = j_exec.convert_model(j_tflite.parse_tflite(int8_model))
    got = tm.jax_params()
    for key, ref in jm.params.items():
        if key in got:
            np.testing.assert_array_equal(got[key], np.asarray(ref))


def test_quantized_constant_without_params_rejected():
    ir = ModelIR(
        tensors=[TensorIR(0, "in", (1, 4), np.float32, None),
                 TensorIR(1, "w", (4, 4), np.int8, np.zeros((4, 4), np.int8)),
                 TensorIR(2, "out", (1, 4), np.float32, None)],
        ops=[OpIR("FULLY_CONNECTED", [0, 1, -1], [2],
                  {"activation": None, "keep_num_dims": False})],
        inputs=[0], outputs=[2], description="")
    with pytest.raises(NotImplementedError, match="no.*quantization"):
        convert_model(ir)
    assert "QUANTIZE" in SUPPORTED_OPS


def _flatten_model(quantize):
    tf = _tf()
    tf.keras.utils.set_random_seed(2)
    rng = np.random.default_rng(2)
    inp = tf.keras.Input((8, 8, 3))
    x = tf.keras.layers.Conv2D(4, 3, padding="same", activation="relu")(inp)
    x = tf.keras.layers.Flatten()(x)
    model = tf.keras.Model(inp, tf.keras.layers.Dense(5)(x))
    if not quantize:
        return tf.lite.TFLiteConverter.from_keras_model(model).convert()
    return _int8_converter(model, lambda: (
        [rng.uniform(-1, 1, (1, 8, 8, 3)).astype(np.float32)]
        for _ in range(20)))


@pytest.mark.parametrize("quantize", [False, True])
def test_flatten_model_matches_interpreter(quantize):
    """Keras Flatten's SHAPE -> STRIDED_SLICE -> PACK -> RESHAPE chain
    folds; the int8 form within two output steps of the interpreter (its
    integer kernels break rounding ties their own way) and one of the JAX
    executor, the float form within 1e-5."""
    blob = _flatten_model(quantize)
    ir = parse_tflite(blob)
    assert any(op.name == "SHAPE" for op in ir.ops)
    tm = convert_model(ir, name="flatten")
    jm = j_exec.convert_model(j_tflite.parse_tflite(blob))
    interp, idet, odet = _interpreter(blob)
    xf = np.random.default_rng(3).uniform(-1, 1, (1, 8, 8, 3)).astype(
        np.float32)
    if quantize:
        isc, izp = idet["quantization"]
        osc, ozp = odet["quantization"]
        xi = np.clip(np.round(xf / isc) + izp, -128, 127).astype(np.int8)
        interp.set_tensor(idet["index"], xi)
        interp.invoke()
        ref = (interp.get_tensor(odet["index"]).astype(np.float32)
               - ozp) * osc
        with torch.inference_mode():
            (got,) = tm(torch.from_numpy(xi))
        assert np.abs(got.numpy() - ref).max() <= 2 * osc
        assert np.abs(got.numpy() - np.asarray(jm.fn(jm.params, xi)[0])
                      ).max() <= osc
    else:
        interp.set_tensor(idet["index"], xf)
        interp.invoke()
        with torch.inference_mode():
            (got,) = tm(torch.from_numpy(xf))
        assert np.abs(got.numpy() - interp.get_tensor(odet["index"])
                      ).max() < 1e-5


@pytest.mark.parametrize("bias", ["zeros", "random_normal"])
def test_16x8_quantization_matches_interpreter(bias):
    """int16 activations and int8 weights (16x8): the int16 grid tracks
    the interpreter within 1e-4.  The scheme stores the biases as int64 on
    the grid of input scale x weight scale; with the JAX test's untrained
    (zero) biases both executors agree, with nonzero ones the JAX executor,
    which leaves int64 constants as raw integers, adds them unscaled
    (up to millions) while the port dequantizes them."""
    tf = _tf()
    tf.keras.utils.set_random_seed(5)
    rng = np.random.default_rng(5)
    inp = tf.keras.Input((16, 16, 3))
    x = tf.keras.layers.Conv2D(8, 3, strides=2, padding="same",
                               activation="relu", bias_initializer=bias)(inp)
    x = tf.keras.layers.GlobalAveragePooling2D()(x)
    model = tf.keras.Model(inp, tf.keras.layers.Dense(
        6, bias_initializer=bias)(x))
    blob = _int8_converter(model, lambda: (
        [rng.uniform(-1, 1, (1, 16, 16, 3)).astype(np.float32)]
        for _ in range(20)), int16=True)
    ir = parse_tflite(blob)
    assert any(np.dtype(t.dtype) == np.int16 for t in ir.tensors
               if t.quant is not None)
    tm = convert_model(ir, name="toy-16x8")
    interp, idet, odet = _interpreter(blob)
    xf = rng.uniform(-1, 1, (1, 16, 16, 3)).astype(np.float32)
    interp.set_tensor(idet["index"], xf)
    interp.invoke()
    ref = interp.get_tensor(odet["index"])
    with torch.inference_mode():
        (got,) = tm(torch.from_numpy(xf))
    assert np.abs(got.numpy() - ref).max() < 1e-4
    jm = j_exec.convert_model(j_tflite.parse_tflite(blob))
    jerr = float(np.abs(np.asarray(jm.fn(jm.params, xf)[0]) - ref).max())
    if bias == "zeros":
        assert jerr < 1e-4
    else:
        # 0.32 on this seed, clipped by the ReLU and the int16 grids.
        assert jerr > 1e-2, "the JAX executor's int64 biases are unscaled"


_QIRS: dict = {}


def _qir(net):
    """(float IR, its int8 form) of a small seeded network, calibrated on
    the test frames."""
    if net not in _QIRS:
        frames = torch.from_numpy(_FRAMES)
        ir = (random_init.calibrated_detector_ir("back", frames, 11, blocks=1,
                                                 per_image=12)
              if net == "back" else random_init.face_mesh_ir(12, 1))
        _QIRS[net] = ir, random_init.quantized_ir(ir, frames, seed=3)
    return _QIRS[net]


@pytest.mark.parametrize("net", ["back", "mesh"])
def test_quantized_ir_structure(net):
    """TFLite's full-int8 form with a float interface: QUANTIZE first, a
    DEQUANTIZE per output, int8 activations on per-tensor grids, int8
    filters per output channel, int32 biases on the input-times-weight
    grid; the float IR is left as it was."""
    ir, qir = _qir(net)
    assert qir.ops[0].name == "QUANTIZE"
    assert [qir.ops[-k].name for k in range(1, len(ir.outputs) + 1)] == \
        ["DEQUANTIZE"] * len(ir.outputs)
    assert all(qir.tensors[t].dtype == np.float32
               for t in (*qir.inputs, *qir.outputs))
    for op in qir.ops:
        if op.name in ("CONV_2D", "DEPTHWISE_CONV_2D"):
            w, b = qir.tensors[op.inputs[1]], qir.tensors[op.inputs[2]]
            x = qir.tensors[op.inputs[0]]
            assert w.dtype == np.int8 and w.quant["scale"].size == \
                w.shape[0 if op.name == "CONV_2D" else 3]
            assert b.dtype == np.int32
            np.testing.assert_array_equal(
                b.quant["scale"],
                (x.quant["scale"][0] * w.quant["scale"]).astype(np.float32))
            assert qir.tensors[op.outputs[0]].dtype == np.int8
    assert all(t.dtype == np.float32 for t in ir.tensors if t.data is not None
               and np.issubdtype(t.dtype, np.floating))
    again = random_init.quantized_ir(ir, torch.from_numpy(_FRAMES), seed=3)
    for a, b in zip(qir.tensors, again.tensors):
        assert (a.quant is None) == (b.quant is None)
        if a.quant is not None:
            np.testing.assert_array_equal(a.quant["scale"], b.quant["scale"])


@pytest.mark.parametrize("net", ["back", "mesh"])
def test_quantized_ir_matches_jax(net):
    """The int8 graph through both executors: every output within two of
    its grid steps, and all but 5% of the values equal; the outputs lie
    on their grids."""
    _, qir = _qir(net)
    tm = convert_model(qir)
    jm = j_exec.convert_model(jax_ir(qir))
    size = tm.input_shapes[0][1]
    x = np.random.default_rng(4).uniform(-1, 1, (2, size, size, 3)).astype(
        np.float32)
    with torch.inference_mode():
        gots = tm(torch.from_numpy(x))
    for i in range(2):
        for k, (got, ref) in enumerate(zip(gots, jm.fn(jm.params,
                                                       x[i:i + 1]))):
            out = qir.ops[len(qir.ops) - len(gots) + k].inputs[0]
            q = qir.tensors[out].quant
            step = float(q["scale"][0])
            diff = np.abs(got[i:i + 1].numpy() - np.asarray(ref))
            assert diff.max() <= 2 * step * (1 + 1e-6)
            assert (diff > 0).mean() <= 0.05
            grid = got[i].numpy() / step + float(q["zero_point"][0])
            assert np.abs(grid - np.round(grid)).max() <= 1e-2


def test_quantized_detector_runs_the_pipeline():
    """The int8 BlazeFace in place of the float one: the FULL pipeline
    runs, and its faces come from raw outputs on the output grids."""
    ir, qir = _qir("back")
    frames = torch.from_numpy(_FRAMES)
    models, *_ = random_init.random_pipeline_models(
        frames, seed=11, detector_blocks=1, mesh_blocks=1, per_image=12,
        iris_blocks=1, mixer_blocks=1)
    qmodels = PipelineModels(convert_model(qir), "back", mesh=models.mesh,
                             device="cpu", iris=models.iris,
                             blendshapes=models.blendshapes)
    det = FaceDetector(models=qmodels, device="cpu", max_faces=MAX_FACES)
    faces = det.detect_faces_batch(_FRAMES)
    assert len(faces) == len(_FRAMES) and sum(map(len, faces)) > 0
    for face in (f for per in faces for f in per):
        assert np.isfinite(face.mesh.points).all()
    det.dispose()
