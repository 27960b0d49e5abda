"""The port's tools beside the JAX package's.

``tools/export_weights_torch.py`` on TF-built toy ``.tflite`` graphs (a
float graph with a bilinear resize, a post-training int8 graph) writes the
same parameter keys and arrays as ``tools/export_weights.py`` on the same
files, its meta shapes without object arrays, and each package's file
loads in both packages' ``load_params_npz``.  ``trace_capture_torch.py``,
``warm_torch.py`` and ``export_weights_torch.py`` exit 1 with their
messages where the assets or the card are absent.
"""

from __future__ import annotations

import importlib.util
import os
import sys

import numpy as np
import pytest
import torch

from face_detection_tflite_torch.convert import checkpoint as t_ckpt
from face_detection_tflite_torch.pipeline import detector as t_detector
from face_detection_tflite_tpu.convert import checkpoint as j_ckpt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tool(name: str):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _tf():
    return pytest.importorskip("tensorflow")


def _float_graph() -> bytes:
    """Conv, depthwise conv, a bilinear upsample (RESIZE_BILINEAR) and a
    dense head, float32."""
    tf = _tf()
    tf.keras.utils.set_random_seed(1)
    inp = tf.keras.Input((16, 16, 3))
    x = tf.keras.layers.Conv2D(8, 3, strides=2, padding="same",
                               activation="relu")(inp)
    x = tf.keras.layers.DepthwiseConv2D(3, padding="same")(x)
    x = tf.keras.layers.UpSampling2D(interpolation="bilinear")(x)
    x = tf.keras.layers.GlobalAveragePooling2D()(x)
    out = tf.keras.layers.Dense(5)(x)
    model = tf.keras.Model(inp, out)
    return tf.lite.TFLiteConverter.from_keras_model(model).convert()


def _int8_graph() -> bytes:
    """The JAX quantization test's toy, post-training int8 in and out."""
    tf = _tf()
    tf.keras.utils.set_random_seed(0)
    rng = np.random.default_rng(0)
    inp = tf.keras.Input((16, 16, 3))
    x = tf.keras.layers.Conv2D(8, 3, strides=2, padding="same",
                               activation="relu")(inp)
    x = tf.keras.layers.DepthwiseConv2D(3, padding="same",
                                        activation="relu")(x)
    x = tf.keras.layers.GlobalAveragePooling2D()(x)
    out = tf.keras.layers.Dense(4, activation="softmax")(x)
    model = tf.keras.Model(inp, out)
    conv = tf.lite.TFLiteConverter.from_keras_model(model)
    conv.optimizations = [tf.lite.Optimize.DEFAULT]
    conv.representative_dataset = lambda: (
        [rng.uniform(-1, 1, (1, 16, 16, 3)).astype(np.float32)]
        for _ in range(16))
    conv.target_spec.supported_ops = [tf.lite.OpsSet.TFLITE_BUILTINS_INT8]
    conv.inference_input_type = tf.int8
    conv.inference_output_type = tf.int8
    return conv.convert()


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """(source dir, JAX tool's dir, port tool's dir) after both tools ran
    on the same two toy graphs."""
    root = tmp_path_factory.mktemp("export")
    src = root / "models"
    src.mkdir()
    (src / "toy_float.tflite").write_bytes(_float_graph())
    (src / "toy_int8.tflite").write_bytes(_int8_graph())
    jax_dst, port_dst = root / "jax", root / "port"
    argv = sys.argv
    try:
        sys.argv = ["export_weights.py", "--src", str(src), "--dst",
                    str(jax_dst)]
        _tool("export_weights").main()
    finally:
        sys.argv = argv
    assert _tool("export_weights_torch").main(
        ["--src", str(src), "--dst", str(port_dst)]) == 0
    return src, jax_dst, port_dst


@pytest.mark.parametrize("name", ["toy_float", "toy_int8"])
def test_export_writes_the_jax_tools_keys_and_arrays(exported, name):
    _, jax_dst, port_dst = exported
    with np.load(jax_dst / f"{name}.npz", allow_pickle=True) as z:
        jax_file = {k: z[k] for k in z.files}
    with np.load(port_dst / f"{name}.npz") as z:   # no pickle needed
        port_file = {k: z[k] for k in z.files}
    assert set(port_file) == set(jax_file)
    params = [k for k in jax_file if not k.startswith("__meta")]
    assert params and any(k.startswith("rs") for k in params) == (
        name == "toy_float")
    for k in params:
        assert port_file[k].dtype == jax_file[k].dtype, k
        np.testing.assert_array_equal(port_file[k], jax_file[k], k)
    np.testing.assert_array_equal(port_file["__meta_input_shapes__"],
                                  jax_file["__meta_input_shapes__"])
    out = port_file["__meta_output_shapes__"]
    assert out.dtype == np.int64
    want = [list(s) for s in jax_file["__meta_output_shapes__"]]
    assert [[d for d in row if d >= 0] for row in out.tolist()] == want


@pytest.mark.parametrize("name", ["toy_float", "toy_int8"])
def test_each_file_loads_in_both_packages(exported, name):
    _, jax_dst, port_dst = exported
    files = [str(jax_dst / f"{name}.npz"), str(port_dst / f"{name}.npz")]
    loaded = [load(f) for f in files
              for load in (j_ckpt.load_params_npz, t_ckpt.load_params_npz)]
    keys = set(loaded[0])
    for params in loaded[1:]:
        assert set(params) == keys
        for k in keys:
            np.testing.assert_array_equal(np.asarray(params[k]),
                                          np.asarray(loaded[0][k]))


def test_export_without_sources_exits_1(tmp_path, capsys):
    tool = _tool("export_weights_torch")
    assert tool.main(["--src", str(tmp_path / "none")]) == 1
    assert str(tmp_path / "none") in capsys.readouterr().err
    assert tool.main(["--src", str(tmp_path)]) == 1
    assert "no .tflite file" in capsys.readouterr().err


def test_trace_capture_without_assets_exits_1(tmp_path, monkeypatch,
                                              capsys):
    """No model directory: exit 1 naming the directories looked in; a
    model directory without the sample image: exit 1 naming its
    directory."""
    missing = str(tmp_path / "nowhere" / "models")
    monkeypatch.setenv("FDT_TPU_MODEL_DIR", missing)
    monkeypatch.setattr(t_detector, "_DEFAULT_MODEL_DIR",
                        str(tmp_path / "default" / "models"))
    tool = _tool("trace_capture_torch")
    assert tool.main([]) == 1
    assert missing in capsys.readouterr().err
    models = tmp_path / "assets" / "models"
    models.mkdir(parents=True)
    monkeypatch.setenv("FDT_TPU_MODEL_DIR", str(models))
    assert tool.main([]) == 1
    err = capsys.readouterr().err
    assert "landmark-ex1.jpg" in err and str(tmp_path / "assets") in err


def test_trace_capture_without_a_card_exits_1(tmp_path, monkeypatch,
                                              capsys):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    models = tmp_path / "assets" / "models"
    samples = tmp_path / "assets" / "samples"
    models.mkdir(parents=True)
    samples.mkdir()
    (samples / "landmark-ex1.jpg").write_bytes(b"\xff\xd8\xff")
    monkeypatch.setenv("FDT_TPU_MODEL_DIR", str(models))
    monkeypatch.delenv("FDT_FORCE_CPU", raising=False)
    assert _tool("trace_capture_torch").main([]) == 1
    assert "CUDA start-up failed" in capsys.readouterr().err


def test_warm_without_a_card_exits_1(monkeypatch, capsys):
    """No CPU fallback: ``FDT_FORCE_CPU`` refuses on any host, and a host
    without CUDA fails its start-up."""
    tool = _tool("warm_torch")
    monkeypatch.setenv("FDT_FORCE_CPU", "1")
    assert tool.main([]) == 1
    assert "nothing to warm on the CPU" in capsys.readouterr().err
    if torch.cuda.is_available():
        return
    monkeypatch.delenv("FDT_FORCE_CPU")
    assert tool.main([]) == 1
    assert "CUDA start-up failed" in capsys.readouterr().err


class _WarmupRecorder:
    def __init__(self):
        self.calls = []

    def warmup(self, image_shape, batch_size=1, modes=None):
        self.calls.append((tuple(image_shape), batch_size,
                           None if modes is None else list(modes)))


def test_warm_builds_then_warms_each_program_key(monkeypatch):
    """``warm`` builds the kernels, then runs ``FaceDetector.warmup`` for
    every mode at the batch size and for STANDARD at each smaller size of
    the ladder; on a real detector (on the CPU, with the build replaced)
    it runs through."""
    from face_detection_tflite_torch import FaceDetectionMode, FaceDetector
    from face_detection_tflite_torch.kernels import build

    from .torch_parity import H, MAX_FACES, W, small_pipeline

    tool = _tool("warm_torch")
    built = []
    monkeypatch.setattr(build, "build", lambda: built.append(1))
    rec = _WarmupRecorder()
    steps = tool.warm(rec, 4)
    standard = [FaceDetectionMode.STANDARD]
    assert built == [1]
    assert rec.calls == [(tool.BENCH_SHAPE, 4, None),
                         (tool.BENCH_SHAPE, 1, standard),
                         (tool.BENCH_SHAPE, 2, standard)]
    assert [label for label, _ in steps] == [
        "kernels build", "bench fast, standard, full b=4",
        "bucket standard b=1", "bucket standard b=2"]
    _, models, _ = small_pipeline()
    det = FaceDetector(models=models, device="cpu", max_faces=MAX_FACES)
    assert len(tool.warm(det, 2, (H, W, 3))) == 3
    assert built == [1, 1]
