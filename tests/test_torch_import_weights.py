"""The port's MobileFaceNet weight import against the JAX package's.

``face_detection_tflite_torch/convert/import_weights.py`` is a copy of the
JAX module that validates against the port's own template.  On the JAX
tests' synthetic checkpoints (the paper layout with per-channel and
scalar PReLU slopes, and the InsightFace_Pytorch layout with its 2-D
Linear + BatchNorm1d tail) the port's import equals the JAX import array
for array; the ``.pth`` and ``.npz`` paths, the rejections, and
``FaceEmbedding.load`` of the result (embeddings within 1e-5 of the JAX
package's on the same crops) are held too.
"""

import numpy as np
import pytest
import torch

from face_detection_tflite_torch.convert import import_weights as t_iw
from face_detection_tflite_torch.models.embedding import (FaceEmbedding,
                                                          build_mobilefacenet)
from face_detection_tflite_tpu.convert import import_weights as j_iw
from face_detection_tflite_tpu.models import embedding as j_embedding

from .test_import_weights import (_insightface_state_dict,
                                  _synthetic_state_dict)

_CHECKPOINTS = {
    "paper": lambda: _synthetic_state_dict(),
    "paper_scalar_prelu": lambda: _synthetic_state_dict(1, prelu_scalar=True),
    "insightface": lambda: _insightface_state_dict(),
}


def _assert_same(a: dict, b: dict):
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("layout", sorted(_CHECKPOINTS))
def test_state_dict_import_equals_jax(layout):
    sd = _CHECKPOINTS[layout]()
    _assert_same(t_iw.import_mobilefacenet_state_dict(sd),
                 j_iw.import_mobilefacenet_state_dict(sd))


def test_template_and_constants_equal_jax():
    assert t_iw.BN_EPS == j_iw.BN_EPS
    assert t_iw._conv_order() == j_iw._conv_order()
    _assert_same(t_iw._template(),
                 {k: np.asarray(v) for k, v in j_iw._template().items()})


def test_fold_bn_equals_jax():
    rng = np.random.default_rng(1)
    args = (rng.normal(size=(8, 4, 3, 3)), rng.uniform(0.5, 1.5, 8),
            rng.normal(size=8), rng.normal(size=8), rng.uniform(0.5, 2.0, 8))
    for got, want in zip(t_iw.fold_bn(*args), j_iw.fold_bn(*args)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("wrap", ["state_dict", "nested"])
def test_torch_file_import_equals_jax(tmp_path, wrap):
    """A ``.pth`` file, as saved (a plain state dict, or under a
    ``"state_dict"`` key), through ``torch.load(weights_only=True)``."""
    sd = _insightface_state_dict()
    tensors = {k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}
    path = tmp_path / "model_mobilefacenet.pth"
    torch.save(tensors if wrap == "state_dict" else {"state_dict": tensors},
               path)
    _assert_same(t_iw.import_mobilefacenet(str(path)),
                 j_iw.import_mobilefacenet(str(path)))


def test_npz_round_trip_and_face_embedding(tmp_path):
    """The import saved as ``.npz`` reloads equal through both packages,
    loads as a trained ``FaceEmbedding`` (no warning), and embeds within
    1e-5 of the JAX package's ``FaceEmbedding`` on the same crops."""
    import warnings
    params = t_iw.import_mobilefacenet_state_dict(_synthetic_state_dict())
    path = str(tmp_path / "mobilefacenet.npz")
    np.savez_compressed(path, **params)
    _assert_same(t_iw.import_mobilefacenet(path), params)
    _assert_same(j_iw.import_mobilefacenet_npz(path), params)
    emb = FaceEmbedding.load(path, device="cpu")
    assert emb.is_pretrained
    jemb = j_embedding.FaceEmbedding.load(path)
    x = np.random.default_rng(2).uniform(-1, 1, (3, 112, 112, 3)).astype(
        np.float32)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        with torch.inference_mode():
            (got,) = emb.model(torch.from_numpy(x))
    want = np.stack([np.asarray(jemb.model.fn(jemb.model.params,
                                              x[i:i + 1])[0][0])
                     for i in range(3)])
    got = got.numpy()
    got /= np.linalg.norm(got, axis=1, keepdims=True)
    want /= np.linalg.norm(want, axis=1, keepdims=True)
    assert np.abs(got - want).max() <= 1e-5
    # The import is the JAX package's params: the port's network carries
    # it unchanged.
    _assert_same(emb.model.jax_params(), params)


_BREAKS = {
    "conv_count": (lambda sd: sd.pop("layer0.conv.weight"), "conv layers"),
    "prelu_count": (lambda sd: sd.pop("layer0.prelu.weight"), "PReLU"),
    "bad_shape": (lambda sd: sd.__setitem__(
        "layer0.conv.weight", sd["layer0.conv.weight"][:, :, :2, :2]),
        "folds to"),
    "bn_count": (lambda sd: [sd.pop(f"layer1.bn.{s}") for s in (
        "weight", "bias", "running_mean", "running_var")], "BatchNorm"),
}


@pytest.mark.parametrize("case", sorted(_BREAKS))
def test_broken_state_dicts_rejected_as_by_jax(case):
    sd = _synthetic_state_dict()
    brk, match = _BREAKS[case]
    brk(sd)
    for mod in (t_iw, j_iw):
        with pytest.raises(ValueError, match=match):
            mod.import_mobilefacenet_state_dict(sd)


def test_bad_files_rejected(tmp_path):
    bad = str(tmp_path / "bad.npz")
    np.savez_compressed(bad, stem_w=np.zeros((3, 3, 3, 64), np.float32))
    with pytest.raises(ValueError, match="mismatch"):
        t_iw.import_mobilefacenet_npz(bad)
    shape = dict(build_mobilefacenet().jax_params())
    shape["stem_b"] = np.zeros(3, np.float32)
    wrong = str(tmp_path / "wrong.npz")
    np.savez_compressed(wrong, **shape)
    with pytest.raises(ValueError, match="shape mismatch"):
        t_iw.import_mobilefacenet_npz(wrong)
    with pytest.raises(ValueError, match="unsupported"):
        t_iw.import_mobilefacenet(str(tmp_path / "weights.onnx"))
