"""The port's ``utils/render.py`` against the JAX package's.

Each package's ``Face`` and mask objects are built from the same numpy
arrays (seeded detections, meshes, irises, blendshapes; single-plane and
multiclass masks with letterbox padding), and every public function of
the module must give the same image byte for byte (and the same values
for the geometry and text helpers).  The faces cover a mesh-less face,
one that crosses the image border, and a face whose lips are two
ellipses (an open mouth), so that the lipstick rings and their even-odd
fill have real geometry."""

import numpy as np
import pytest

from face_detection_tflite_torch.models import segmentation as t_seg
from face_detection_tflite_torch.pipeline import types as t_types
from face_detection_tflite_torch.utils import render as t_render
from face_detection_tflite_tpu.models import segmentation as j_seg
from face_detection_tflite_tpu.pipeline import types as j_types
from face_detection_tflite_tpu.utils import render as j_render

H, W = 96, 128
LIPS = t_types.FaceContourType


def _lip_mesh(rng, cx, cy, a, b, inner):
    """A seeded 468-point mesh around (cx, cy) whose outer lip arcs lie on
    an ellipse of half-axes (a, b) and inner arcs on one scaled by
    ``inner``."""
    mesh = np.column_stack([rng.uniform(cx - 30, cx + 30, 468),
                            rng.uniform(cy - 40, cy + 20, 468),
                            rng.uniform(-5, 5, 468)])
    arcs = {LIPS.UPPER_LIP_TOP: (1.0, -1), LIPS.LOWER_LIP_BOTTOM: (1.0, 1),
            LIPS.UPPER_LIP_BOTTOM: (inner, -1), LIPS.LOWER_LIP_TOP: (inner, 1)}
    for ctype, (scale, side) in arcs.items():
        idx = t_types.FACE_CONTOUR_MESH_INDICES[ctype]
        t = np.linspace(np.pi, 0.0, len(idx))
        mesh[idx, 0] = cx + a * np.cos(t)
        mesh[idx, 1] = cy + side * scale * b * np.sin(t)
    return mesh


def _arrays(seed=5):
    """Per-face arrays: (box, score, keypoints, mesh or None, mesh score,
    iris [152, 3] or empty, blendshapes or None, tracking id)."""
    rng = np.random.default_rng(seed)
    kp = np.asarray([[0.3, 0.3], [0.6, 0.3], [0.45, 0.45], [0.45, 0.6],
                     [0.2, 0.35], [0.7, 0.35]])
    faces = []
    mesh = _lip_mesh(rng, 60.0, 60.0, 14.0, 7.0, 0.5)
    iris = np.concatenate([rng.uniform(40, 80, (76, 3)) for _ in range(2)])
    faces.append(((0.25, 0.2, 0.75, 0.85), 0.93, kp, mesh, 0.98, iris,
                  rng.uniform(0, 1, 52), 3))
    faces.append(((-0.1, 0.6, 0.3, 1.2), 0.71, kp * 0.5 + 0.4,
                  rng.uniform(-20, 140, (468, 3)), 0.61,
                  np.zeros((0, 3)), None, None))
    faces.append(((0.6, 0.05, 0.95, 0.4), 0.55, kp * 0.3 + 0.6, None, None,
                  np.zeros((0, 3)), None, 7))
    return faces


def _build(types, arrays, size=(W, H)):
    out = []
    for box, score, kp, mesh, mscore, iris, bs, tid in arrays:
        det = types.Detection(types.RectF(*box), score, np.asarray(kp))
        m = None if mesh is None else types.FaceMesh(mesh, mscore)
        out.append(types.Face(det, m, iris, size, blendshape_scores=bs,
                              tracking_id=tid))
    return out


def _image(seed=9):
    return np.random.default_rng(seed).integers(0, 256, (H, W, 3),
                                                dtype=np.uint8)


def _mask_data(seed=3):
    rng = np.random.default_rng(seed)
    data = rng.uniform(0, 1, (32, 32)).astype(np.float32)
    cls = rng.uniform(0, 1, (32, 32, 6)).astype(np.float32)
    cls /= cls.sum(-1, keepdims=True)
    cls[8:24, 8:24, 3] += 2.0  # one class that wins a block, labelled
    return data, cls, (0.125, 0.125, 0.0, 0.0)


def _masks(seg, multiclass=False):
    data, cls, pad = _mask_data()
    if multiclass:
        return seg.MulticlassSegmentationMask(data, W, H, pad, class_data=cls)
    return seg.SegmentationMask(data, W, H, pad)


FACES = {"port": lambda: _build(t_types, _arrays()),
         "jax": lambda: _build(j_types, _arrays())}


def _both(fn_name, img, masks=None, **kw):
    """Calls ``fn_name(img, faces[, mask])`` of both modules, each on its
    own package's faces (and mask, ``masks`` saying which kind)."""
    out = []
    for mod, types, seg in ((t_render, t_types, t_seg),
                            (j_render, j_types, j_seg)):
        args = [img, _build(types, _arrays())]
        if masks is not None:
            args.append(_masks(seg, masks))
        out.append(getattr(mod, fn_name)(*args, **kw))
    return out


def _assert_equal_images(got, want):
    assert got.dtype == want.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


#: Keywords of every face painter's cases (the name before a suffix).
FACE_CASES = {
    "draw_detections": {},
    "draw_detections_labels": {"show_landmark_labels": True},
    "draw_mesh": {},
    "draw_contours": {},
    "draw_iris": {},
    "draw_face_info": {},
    "draw_face_info_classification": {"show_classification": True},
    "annotate": {},
    "draw_lipstick": {},
    "draw_lipstick_hard": {"feather_pixels": 0.0, "strength": 1.0,
                           "dilate_pixels": 0.0, "smoothing": 0.0},
}


@pytest.mark.parametrize("case", sorted(FACE_CASES))
def test_face_painters_equal_jax(case):
    kw = FACE_CASES[case]
    name = case.replace("_labels", "").replace("_classification", "") \
        .replace("_hard", "")
    img = _image()
    got, want = _both(name, img, **kw)
    _assert_equal_images(got, want)
    assert (got != img).any(), "the painter drew nothing"


@pytest.mark.parametrize("multiclass", [False, True])
def test_annotate_with_mask_equals_jax(multiclass):
    got, want = _both("annotate", _image(), masks=multiclass)
    _assert_equal_images(got, want)


MASK_CASES = {
    "draw_segmentation": {},
    "draw_mask": {},
    "draw_mask_binary_mirrored": {"binary": True,
                                  "mirror_horizontally": True},
    "draw_mask_class": {"class_index": 3, "multiclass": True},
    "draw_multiclass_segmentation": {"multiclass": True},
    "draw_multiclass_segmentation_binary_mirrored": {
        "multiclass": True, "binary": True, "mirror_horizontally": True},
    "draw_virtual_background": {},
    "draw_virtual_background_mirrored": {"mirror_horizontally": True},
}


@pytest.mark.parametrize("case", sorted(MASK_CASES))
def test_mask_painters_equal_jax(case):
    kw = dict(MASK_CASES[case])
    multiclass = kw.pop("multiclass", False)
    name = next(n for n in ("draw_multiclass_segmentation",
                            "draw_virtual_background", "draw_segmentation",
                            "draw_mask") if case.startswith(n))
    img = _image()
    if name == "draw_virtual_background":
        bg = _image(seed=4)[:40, :70]
        got, want = (mod.draw_virtual_background(img, _masks(seg), bg, **kw)
                     for mod, seg in ((t_render, t_seg), (j_render, j_seg)))
    else:
        got, want = (getattr(mod, name)(img, _masks(seg, multiclass), **kw)
                     for mod, seg in ((t_render, t_seg), (j_render, j_seg)))
    _assert_equal_images(got, want)
    assert (got != img).any()


@pytest.mark.parametrize("layers", ["faces", "tint", "classes", "background",
                                    "mirrored"])
def test_compose_camera_overlay_equals_jax(layers):
    """Every layer of the camera overlay, the badge included."""
    kw = {"detect_ms": 37.0, "show_pose_and_scores": True,
          "show_classification": True}
    multiclass = layers == "classes"
    if layers in ("tint", "classes", "mirrored"):
        kw.update(show_segmentation=True, show_all_classes=multiclass)
    if layers == "background":
        kw["virtual_background"] = _image(seed=4)[:50, :60]
    if layers == "mirrored":
        kw["mirror_horizontally"] = True
    out = []
    for mod, types, seg in ((t_render, t_types, t_seg),
                            (j_render, j_types, j_seg)):
        mask = None if layers == "faces" else _masks(seg, multiclass)
        out.append(mod.compose_camera_overlay(
            _image(), _build(types, _arrays()), mask=mask, **kw))
    _assert_equal_images(*out)


def test_mirror_face_equals_jax():
    got = [t_render.mirror_face(f, W) for f in FACES["port"]()]
    want = [j_render.mirror_face(f, W) for f in FACES["jax"]()]
    for g, w in zip(got, want):
        assert g.to_dict(include_mesh=True, include_iris=True) == \
            w.to_dict(include_mesh=True, include_iris=True)


def test_text_and_geometry_helpers_equal_jax():
    for g, w in zip(FACES["port"](), FACES["jax"]()):
        for cls in (False, True):
            assert t_render.face_info_label_text(g, cls) == \
                j_render.face_info_label_text(w, cls)
        got, want = (t_render.build_lip_rings(g, 1.5),
                     j_render.build_lip_rings(w, 1.5))
        assert (got is None) == (want is None)
        if got is not None:
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, b)
    port_face = FACES["port"]()[0]
    assert t_render.build_lip_rings(port_face)[1] is not None  # open mouth
    for ms in (12.0, 200.0, 499.0, 999.0, 4000.0):
        assert t_render.performance_level(ms) == j_render.performance_level(ms)
    for args in ((640, 480, 300, 600), (100, 100, 100, 100), (7, 3, 5, 9)):
        assert t_render.cover_fit_transform(*args) == \
            j_render.cover_fit_transform(*args)
    with pytest.raises(ValueError):
        t_render.cover_fit_transform(0, 1, 1, 1)
    assert t_render.mask_valid_region(_masks(t_seg)) == \
        j_render.mask_valid_region(_masks(j_seg))
    for name in ("SEGMENTATION_CLASS_LABELS", "SEGMENTATION_CLASS_COLORS",
                 "LANDMARK_LABEL_NAMES", "LIPSTICK_COLOR", "__all__"):
        assert getattr(t_render, name) == getattr(j_render, name), name


def test_lip_primitives_equal_jax():
    rng = np.random.default_rng(2)
    top, bottom = rng.uniform(0, 50, (11, 3)), rng.uniform(0, 50, (11, 3))
    for shared in (True, False):
        np.testing.assert_array_equal(
            t_render.lip_ring(top, bottom, shared),
            j_render.lip_ring(top, bottom, shared))
    ring = t_render.lip_ring(top, bottom)
    assert t_render.ring_signed_area(ring) == j_render.ring_signed_area(ring)
    for px in (0.0, 2.5, -1.0):
        for r in (ring, ring[::-1]):
            np.testing.assert_array_equal(t_render.dilate_ring(r, px),
                                          j_render.dilate_ring(r, px))
    faces = (FACES["port"](), FACES["jax"]())
    for kw in ({}, {"dilate_pixels": 2.0, "smoothing": 0.0},
               {"min_open_fraction": 0.9}):
        got = t_render.lipstick_mask(faces[0], (H, W), **kw)
        np.testing.assert_array_equal(
            got, j_render.lipstick_mask(faces[1], (H, W), **kw))
        assert got.any()
    np.testing.assert_array_equal(
        t_render.lipstick_mask(faces[0][0], (H, W)),
        j_render.lipstick_mask(faces[1][0], (H, W)))
