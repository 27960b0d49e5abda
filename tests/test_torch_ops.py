"""The port's main-path ops against the JAX package's on the same numpy
inputs.  Budgets (``docs/PARITY.md``): letterbox ≤1e-4, warp ≤1e-5,
decode and letterbox removal exact (scores within two ulp: the two
sigmoid implementations differ); geometry and gates on the cases of
``tests/test_shared.py``."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from face_detection_tflite_torch.ops import letterbox as t_lb
from face_detection_tflite_torch.ops import warp as t_warp
from face_detection_tflite_torch.ops.anchors import SSD_BACK, generate_anchors
from face_detection_tflite_torch.ops.detections import (decode_detections,
                                                        remove_letterbox)
from face_detection_tflite_torch.pipeline import gates as t_gates
from face_detection_tflite_torch.pipeline import geometry as t_geo
from face_detection_tflite_tpu.ops import anchors as j_anchors
from face_detection_tflite_tpu.ops import detections as j_det
from face_detection_tflite_tpu.ops import letterbox as j_lb
from face_detection_tflite_tpu.ops import warp as j_warp
from face_detection_tflite_tpu.pipeline import gates as j_gates
from face_detection_tflite_tpu.pipeline import geometry as j_geo

_rng = np.random.default_rng(77)


@pytest.mark.parametrize("src", [(170, 512), (853, 1280), (300, 200),
                                 (256, 256)])
def test_letterbox_matches_jax(src):
    h, w = src
    p, jp = t_lb.letterbox_params(h, w, 128, 128), \
        j_lb.letterbox_params(h, w, 128, 128)
    assert dataclass_tuple(p) == dataclass_tuple(jp)
    imgs = _rng.integers(0, 256, (2, h, w, 3), dtype=np.uint8)
    got = t_lb.letterbox_image(torch.from_numpy(imgs), p).numpy()
    ref = np.stack([np.asarray(j_lb.letterbox_image(jnp.asarray(i), jp))
                    for i in imgs])
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= 1e-4


def test_letterbox_uploads_its_tap_tables_once():
    """A second letterbox of the same geometry on the same device builds
    no new tap tables (each upload would wait for the stream) and gives
    the same result."""
    p = t_lb.letterbox_params(53, 80, 64, 64)
    imgs = torch.from_numpy(_rng.integers(0, 256, (2, 53, 80, 3),
                                          dtype=np.uint8))
    first = t_lb.letterbox_image(imgs, p)
    built = t_lb._device_taps.cache_info().misses
    second = t_lb.letterbox_image(imgs, p)
    assert t_lb._device_taps.cache_info().misses == built
    assert torch.equal(first, second)


def dataclass_tuple(p):
    return (p.new_h, p.new_w, p.pad_top, p.pad_bottom, p.pad_left,
            p.pad_right, p.padding)


def test_letterbox_dart_rounding():
    """170x512 -> 128 is an exact .5 product (42.5): Dart rounds up."""
    assert t_lb.letterbox_params(170, 512, 128, 128).new_h == 43


def test_anchors_match_jax():
    np.testing.assert_array_equal(
        generate_anchors(SSD_BACK), j_anchors.generate_anchors(
            j_anchors.SSD_BACK))


def test_decode_and_remove_letterbox_exact():
    anchors = generate_anchors(SSD_BACK)
    raw_boxes = _rng.normal(0, 20, (2, 896, 16)).astype(np.float32)
    raw_scores = _rng.normal(0, 3, (2, 896, 1)).astype(np.float32)
    raw_scores[0, :4, 0] = [150.0, -150.0, 0.0, 1e-3]
    got = decode_detections(torch.from_numpy(raw_boxes),
                            torch.from_numpy(raw_scores),
                            torch.from_numpy(anchors), 256.0)
    ref = jax.vmap(lambda b, s: j_det.decode_detections(
        b, s, jnp.asarray(anchors), 256.0))(jnp.asarray(raw_boxes),
                                            jnp.asarray(raw_scores))
    for name, g, r in zip(("boxes", "kp", "scores", "valid"), got, ref):
        if name == "scores":
            # torch.sigmoid and XLA's logistic differ by up to two ulp.
            np.testing.assert_array_max_ulp(g.numpy(), np.asarray(r),
                                            maxulp=2)
        else:
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    pad = (0.1, 0.12, 0.0, 0.0)
    gb, gk = remove_letterbox(got[0], got[1], pad)
    rb, rk = j_det.remove_letterbox(ref[0], ref[1], pad)
    np.testing.assert_array_equal(gb.numpy(), np.asarray(rb))
    np.testing.assert_array_equal(gk.numpy(), np.asarray(rk))


def _rois(b, f, h, w, rng=_rng):
    cx = rng.uniform(-20, w + 20, (b, f)).astype(np.float32)
    cy = rng.uniform(-20, h + 20, (b, f)).astype(np.float32)
    size = rng.uniform(10, 1.5 * max(h, w), (b, f)).astype(np.float32)
    size[0, 0] = 40.5  # exact .5: Dart rounding
    theta = rng.uniform(-math.pi, math.pi, (b, f)).astype(np.float32)
    return cx, cy, size, theta


# The 24-px cases keep their names and draw from the module's generator;
# the iris (64) and embedding (112) crop sizes draw from their own.
@pytest.mark.parametrize("s,flip", [
    pytest.param(24, False, id="False"), pytest.param(24, True, id="True"),
    pytest.param(64, False, id="64-False"),
    pytest.param(64, True, id="64-True"),
    pytest.param(112, False, id="112-False"),
    pytest.param(112, True, id="112-True")])
def test_warp_plain_matches_jax(s, flip):
    b, f, h, w = 2, 5, 60, 80
    rng = _rng if s == 24 else np.random.default_rng(s + flip)
    frames = rng.integers(0, 256, (b, h, w, 3), dtype=np.uint8)
    cx, cy, size, theta = _rois(b, f, h, w, rng)
    flips = rng.uniform(size=(b, f)) < 0.5 if flip else None
    t = torch.from_numpy
    # cos/sin as XLA computes them inside extract_rois: the comparison then
    # measures the warp (measured exact), not the libraries' trigonometry.
    ct = np.array(jnp.cos(jnp.asarray(theta)))
    st = np.array(jnp.sin(jnp.asarray(theta)))
    got = t_warp.warp_normalize(
        t(frames), t(cx), t(cy), t(size), t(ct), t(st), out_size=s,
        flip=None if flips is None else t(flips)).numpy()
    assert got.shape == (b, f, s, s, 3)
    for i in range(b):
        ref = j_warp.extract_rois(
            jnp.asarray(frames[i]), jnp.asarray(cx[i]), jnp.asarray(cy[i]),
            jnp.asarray(size[i]), jnp.asarray(theta[i]), out_size=s,
            flip_x=None if flips is None else jnp.asarray(flips[i]))
        ref = np.asarray(j_lb.normalize_image(ref))
        assert np.abs(got[i] - ref).max() <= 1e-5


def test_warp_float_frames_match_uint8():
    frames = _rng.integers(0, 256, (1, 30, 40, 3), dtype=np.uint8)
    cx, cy, size, theta = (torch.from_numpy(a) for a in _rois(1, 3, 30, 40))
    a = t_warp.extract_rois_normalized(torch.from_numpy(frames), cx, cy,
                                       size, theta, out_size=16)
    b = t_warp.extract_rois_normalized(torch.from_numpy(frames).float(), cx,
                                       cy, size, theta, out_size=16)
    assert torch.equal(a, b)


def _kp(le, re, mouth):
    kp = np.zeros((1, 6, 2), np.float32)
    kp[0, 0], kp[0, 1], kp[0, 3] = le, re, mouth
    return kp


@pytest.mark.parametrize("kp", [
    _kp((0.4, 0.4), (0.6, 0.4), (0.5, 0.6)),
    _kp((0.4, 0.5), (0.5, 0.6), (0.5, 0.7)),
    _rng.uniform(0, 1, (4, 6, 2)).astype(np.float32)])
def test_alignment_matches_jax(kp):
    got = t_geo.compute_face_alignment(torch.from_numpy(kp), 100.0, 80.0)
    ref = j_geo.compute_face_alignment(jnp.asarray(kp), 100.0, 80.0)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-6,
                                   atol=1e-6)


def test_alignment_level_eyes_values():
    theta, cx, cy, size = t_geo.compute_face_alignment(
        torch.from_numpy(_kp((0.4, 0.4), (0.6, 0.4), (0.5, 0.6))), 100, 100)
    assert float(theta[0]) == pytest.approx(0.0)
    assert float(size[0]) == pytest.approx(80.0)
    assert (float(cx[0]), float(cy[0])) == pytest.approx((50.0, 42.0))


def test_mesh_transform_matches_jax():
    lm = _rng.uniform(0, 1, (2, 3, 468, 3)).astype(np.float32)
    cx, cy, size, theta = (_rng.uniform(lo, hi, (2, 3)).astype(np.float32)
                           for lo, hi in ((0, 100), (0, 100), (10, 90),
                                          (-3, 3)))
    t = torch.from_numpy
    got = t_geo.transform_mesh_to_absolute(t(lm), t(cx), t(cy), t(size),
                                           t(theta)).numpy()
    ref = np.asarray(j_geo.transform_mesh_to_absolute(
        jnp.asarray(lm), jnp.asarray(cx), jnp.asarray(cy),
        jnp.asarray(size), jnp.asarray(theta)))
    assert np.abs(got - ref).max() <= 1e-4
    out = t_geo.transform_mesh_to_absolute(
        torch.tensor([[[0.5, 0.5, 0.0], [1.0, 0.5, 0.1]]]),
        torch.tensor([10.0]), torch.tensor([20.0]), torch.tensor([100.0]),
        torch.tensor([0.0]))[0].numpy()
    np.testing.assert_allclose(out, [[10, 20, 0], [60, 20, 10]], atol=1e-5)


def test_gates_match_jax():
    for args in ((-0.1, 0.0), (0.0, 1.5), (float("nan"), 0.0)):
        with pytest.raises(ValueError):
            t_gates.validate_face_gates(*args)
    t_gates.validate_face_gates(0.0, 0.0, 1.0)
    for box in ([-0.25, 0.0, 0.25, 1.0], [1.2, 0.0, 1.5, 1.0]):
        assert float(t_gates.box_visible_width_fraction(
            torch.tensor(box), 100.0)) == float(
                j_gates.box_visible_width_fraction(jnp.asarray(box), 100.0))
    valid = np.asarray([True, True, True])
    scores = np.asarray([0.9, 0.4, 0.6], np.float32)
    boxes = np.asarray([[0.1, 0.1, 0.5, 0.5], [0.1, 0.1, 0.9, 0.9],
                        [0.1, 0.1, 0.12, 0.5]], np.float32)
    got = t_gates.apply_detection_gates_mask(
        torch.from_numpy(valid), torch.from_numpy(scores),
        torch.from_numpy(boxes), min_score=0.5, min_face_size=0.1,
        image_width=100.0)
    ref = j_gates.apply_detection_gates_mask(
        jnp.asarray(valid), jnp.asarray(scores), jnp.asarray(boxes),
        min_score=0.5, min_face_size=0.1, image_width=100.0)
    assert got.tolist() == np.asarray(ref).tolist() == [True, False, False]
    v = torch.tensor([True, False])
    assert t_gates.apply_detection_gates_mask(
        v, torch.tensor([0.1, 0.9]), torch.zeros(2, 4), min_score=0.0,
        min_face_size=0.0, image_width=100.0) is v

