"""The port's public surface against the JAX package's.

``__all__`` equals the JAX one, ``ReplicaPool`` included, plus the
port's ``ServerOverloaded`` and ``params_from_jax``; every name exists and the names both packages
export are the same kind of object.  The functions this surface added
(``resize_matrix``, ``transform_mesh_flat_to_absolute``,
``extract_aligned_square``, ``split_meshes_if_concatenated``) equal the
JAX ones on the same seeded inputs: the first two exactly, the warp
within 1e-5 (at angles whose sine and cosine the two libraries round
alike) with ``flip_x`` both ways and a non-zero fill."""

import inspect

import numpy as np
import pytest
import torch

import face_detection_tflite_torch as pkg
import face_detection_tflite_tpu as jpkg
from face_detection_tflite_torch.ops import letterbox as t_letterbox
from face_detection_tflite_torch.ops import warp as t_warp
from face_detection_tflite_torch.pipeline import geometry as t_geometry
from face_detection_tflite_tpu.ops import letterbox as j_letterbox
from face_detection_tflite_tpu.ops import warp as j_warp
from face_detection_tflite_tpu.pipeline import geometry as j_geometry

PORT_ONLY = {"ServerOverloaded", "params_from_jax"}
NOT_PORTED: set = set()


def test_all_equals_jax_minus_replica_pool():
    """The JAX surface with nothing left out (``NOT_PORTED`` is empty)."""
    assert not NOT_PORTED and "ReplicaPool" in pkg.__all__
    assert len(pkg.__all__) == len(set(pkg.__all__))
    assert set(pkg.__all__) == (set(jpkg.__all__) - NOT_PORTED) | PORT_ONLY
    missing = [n for n in pkg.__all__ if not hasattr(pkg, n)]
    assert not missing, missing
    assert isinstance(pkg.__version__, str)
    assert pkg.__version__ == jpkg.__version__


def _plain(v):
    """Enum keys by name, so that the two packages' tables compare."""
    if isinstance(v, dict):
        return {getattr(k, "name", k): _plain(x) for k, x in v.items()}
    return v


@pytest.mark.parametrize("name", sorted(set(jpkg.__all__) - NOT_PORTED))
def test_export_is_the_same_kind(name):
    """Classes by name, functions as the port's own, tables equal."""
    got, want = getattr(pkg, name), getattr(jpkg, name)
    if inspect.isclass(want):
        assert inspect.isclass(got) and got.__name__ == want.__name__
    elif callable(want):
        assert callable(got)
        assert got.__module__.startswith("face_detection_tflite_torch.")
    else:
        assert _plain(got) == _plain(want)


@pytest.mark.parametrize("sizes", [(256, 192), (192, 256), (7, 7), (853, 256),
                                   (3, 17)])
def test_resize_matrix_equals_jax(sizes):
    got = t_letterbox.resize_matrix(*sizes)
    want = j_letterbox.resize_matrix(*sizes)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_transform_mesh_flat_equals_jax():
    import jax.numpy as jnp
    rng = np.random.default_rng(0)
    flat = rng.uniform(0, 1, (2, 3, 468 * 3)).astype(np.float32)
    cx, cy = (rng.uniform(50, 500, (2, 3)).astype(np.float32)
              for _ in range(2))
    size = rng.uniform(40, 300, (2, 3)).astype(np.float32)
    theta = rng.uniform(-np.pi, np.pi, (2, 3)).astype(np.float32)
    got = t_geometry.transform_mesh_flat_to_absolute(
        *(torch.from_numpy(a) for a in (flat, cx, cy, size, theta))).numpy()
    want = np.asarray(j_geometry.transform_mesh_flat_to_absolute(
        *(jnp.asarray(a) for a in (flat, cx, cy, size, theta))))
    assert got.shape == want.shape == flat.shape
    np.testing.assert_array_equal(got, want)
    # The flat layout is the point layout's reshape.
    np.testing.assert_array_equal(
        got.reshape(2, 3, 468, 3),
        t_geometry.transform_mesh_to_absolute(
            torch.from_numpy(flat.reshape(2, 3, 468, 3)),
            *(torch.from_numpy(a) for a in (cx, cy, size, theta))).numpy())


#: Angles whose float32 sine and cosine torch and XLA round alike; at
#: others one ulp of a coordinate moves a tap of a noise image by up to
#: 8e-4 (checked below, so that the choice stays explicit).
ANGLES = (0.0, 0.3, -0.7, 2.5)


@pytest.mark.parametrize("flip_x", [False, True])
@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_extract_aligned_square_equals_jax(flip_x, dtype):
    import jax.numpy as jnp
    rng = np.random.default_rng(4)
    img = rng.integers(0, 256, (50, 70, 4)).astype(dtype)
    filled = 0
    for theta in ANGLES:
        t32 = np.float32(theta)
        assert np.float32(np.asarray(jnp.sin(t32))) == \
            torch.sin(torch.tensor(t32)).item()
        assert np.float32(np.asarray(jnp.cos(t32))) == \
            torch.cos(torch.tensor(t32)).item()
        for cx, cy, size in ((30.3, 20.7, 41.2), (2.0, 48.5, 60.0),
                             (35.0, 25.0, 10.5)):
            got = t_warp.extract_aligned_square(
                img, cx, cy, size, theta, out_size=24, flip_x=flip_x,
                fill_value=-3.0)
            want = np.asarray(j_warp.extract_aligned_square(
                jnp.asarray(img), cx, cy, size, theta, out_size=24,
                flip_x=flip_x, fill_value=-3.0))
            assert got.dtype == torch.float32 and got.shape == (24, 24, 4)
            assert np.abs(got.numpy() - want).max() <= 1e-5
            filled += int((want == -3.0).all(-1).sum())
    assert filled > 0  # the border cases sampled outside the image


@pytest.mark.parametrize("flip_x", [False, True])
def test_extract_aligned_square_general_angles(flip_x):
    """At seeded random angles and ROIs, within 1e-5 of the image's
    range: torch and XLA may round a sine or cosine one ulp apart, which
    moves a tap by rounding noise only."""
    import jax.numpy as jnp
    rng = np.random.default_rng(5)
    img = rng.integers(0, 256, (50, 70, 3)).astype(np.float32)
    tol = 1e-5 * np.abs(img).max()
    for theta, cx, cy, size in zip(rng.uniform(-np.pi, np.pi, 24),
                                   rng.uniform(-5, 75, 24),
                                   rng.uniform(-5, 55, 24),
                                   rng.uniform(8, 80, 24)):
        args = (float(cx), float(cy), float(size), float(theta))
        got = t_warp.extract_aligned_square(img, *args, out_size=24,
                                            flip_x=flip_x, fill_value=7.0)
        want = np.asarray(j_warp.extract_aligned_square(
            jnp.asarray(img), *args, out_size=24, flip_x=flip_x,
            fill_value=7.0))
        assert np.abs(got.numpy() - want).max() <= tol, args


def test_split_meshes_equals_jax():
    rng = np.random.default_rng(1)
    for n in (0, 468, 468 * 3, 500):
        pts = rng.uniform(0, 100, (n, 3))
        got = pkg.FaceDetector.split_meshes_if_concatenated(pts)
        want = jpkg.FaceDetector.split_meshes_if_concatenated(pts)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        assert [a.shape for a in pkg.split_meshes_if_concatenated(pts)] == \
            [a.shape for a in want]
