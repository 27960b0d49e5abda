"""Result rendering: boxes, keypoints, mesh, contours, iris, masks.

Host-side analog of the reference's Flutter overlay painters
(`lib/src/ui/overlay_painters.dart`: DetectionsPainter, mesh/contour/iris
painters, segmentation mask rendering).  Draws onto numpy RGB images so
demos, notebooks, and golden-image tests share one implementation.

A copy of the JAX package's ``utils/render.py`` (numpy and PIL) on the
port's own ``Face`` (``pipeline/types.py``), masks
(``models/segmentation.py``) and ``ops/letterbox.resize_matrix``: the
images are byte-equal to the JAX module's on the same faces and masks.
"""

from __future__ import annotations

import numpy as np

from ..pipeline.types import (EYE_LANDMARK_CONNECTIONS,
                              FACE_CONTOUR_MESH_INDICES, Face,
                              FaceContourType)

__all__ = ["draw_detections", "draw_mesh", "draw_contours", "draw_iris",
           "draw_segmentation", "annotate", "cover_fit_transform",
           "face_info_label_text", "draw_face_info", "draw_mask",
           "draw_multiclass_segmentation", "draw_virtual_background",
           "compose_camera_overlay", "performance_level",
           "mask_valid_region", "SEGMENTATION_CLASS_LABELS",
           "SEGMENTATION_CLASS_COLORS", "LANDMARK_LABEL_NAMES",
           "lip_ring", "ring_signed_area", "dilate_ring", "build_lip_rings",
           "lipstick_mask", "draw_lipstick", "LIPSTICK_COLOR"]

BOX_COLOR = (0, 255, 0)
KP_COLOR = (255, 64, 64)
MESH_COLOR = (64, 160, 255)
CONTOUR_COLOR = (255, 220, 0)
IRIS_COLOR = (255, 0, 255)

#: Semantic labels for the 6 multiclass-segmentation classes
#: (`overlay_painters.dart:5-12`).
SEGMENTATION_CLASS_LABELS = ("BG", "Hair", "Body", "Face", "Clothes",
                             "Other")

#: Per-class RGBA overlay colors, index-aligned with
#: :data:`SEGMENTATION_CLASS_LABELS` (`overlay_painters.dart:18-25`,
#: ARGB hex converted to RGBA tuples; alpha preserved for compositing).
SEGMENTATION_CLASS_COLORS = (
    (160, 160, 160, 153),   # 0x99A0A0A0 BG
    (205, 133, 63, 153),    # 0x99CD853F Hair
    (255, 165, 0, 136),     # 0x88FFA500 Body skin
    (255, 105, 180, 136),   # 0x88FF69B4 Face skin
    (0, 191, 255, 153),     # 0x9900BFFF Clothes
    (64, 224, 208, 153),    # 0x9940E0D0 Other
)

#: Display names for the 6 detector keypoints
#: (`overlay_painters.dart:313-320`).
LANDMARK_LABEL_NAMES = ("Left Eye", "Right Eye", "Nose Tip", "Mouth",
                        "L Tragion", "R Tragion")


def _clip(v, lo, hi):
    return int(min(max(v, lo), hi))


def _draw_line(img, x0, y0, x1, y1, color):
    h, w = img.shape[:2]
    n = int(max(abs(x1 - x0), abs(y1 - y0), 1))
    xs = np.linspace(x0, x1, n + 1)
    ys = np.linspace(y0, y1, n + 1)
    xi = xs.round().astype(int)
    yi = ys.round().astype(int)
    # Clip (drop out-of-image samples) rather than clamping to the border,
    # which would smear off-screen geometry along the edges.
    inside = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
    img[yi[inside], xi[inside]] = color


def _draw_rect(img, x0, y0, x1, y1, color):
    _draw_line(img, x0, y0, x1, y0, color)
    _draw_line(img, x1, y0, x1, y1, color)
    _draw_line(img, x1, y1, x0, y1, color)
    _draw_line(img, x0, y1, x0, y0, color)


def _draw_dot(img, x, y, color, r=2):
    h, w = img.shape[:2]
    x0, x1 = _clip(x - r, 0, w - 1), _clip(x + r, 0, w - 1)
    y0, y1 = _clip(y - r, 0, h - 1), _clip(y + r, 0, h - 1)
    img[y0:y1 + 1, x0:x1 + 1] = color


def _text_painter(text: str, color=(255, 255, 255)):
    """Rasterizes ``text`` to an RGBA numpy patch via PIL's built-in bitmap
    font (the host analog of Flutter's TextPainter)."""
    from PIL import Image, ImageDraw

    probe = ImageDraw.Draw(Image.new("RGBA", (1, 1)))
    bbox = probe.multiline_textbbox((0, 0), text, spacing=2)
    w, h = max(bbox[2] - bbox[0], 1), max(bbox[3] - bbox[1], 1)
    im = Image.new("RGBA", (w + 2, h + 2), (0, 0, 0, 0))
    ImageDraw.Draw(im).multiline_text((1 - bbox[0], 1 - bbox[1]), text,
                                      fill=tuple(color) + (255,), spacing=2)
    return np.asarray(im)


def _blit_rgba(img: np.ndarray, patch: np.ndarray, x: int, y: int) -> None:
    """Alpha-composites an RGBA patch onto an RGB image in place (clipped)."""
    h, w = img.shape[:2]
    ph, pw = patch.shape[:2]
    x0, y0 = max(x, 0), max(y, 0)
    x1, y1 = min(x + pw, w), min(y + ph, h)
    if x1 <= x0 or y1 <= y0:
        return
    sub = patch[y0 - y:y1 - y, x0 - x:x1 - x].astype(np.float32)
    a = sub[..., 3:4] / 255.0
    region = img[y0:y1, x0:x1].astype(np.float32)
    img[y0:y1, x0:x1] = (region * (1 - a) + sub[..., :3] * a).astype(np.uint8)


def _fill_rect_alpha(img: np.ndarray, x0, y0, x1, y1, color,
                     alpha: float) -> None:
    h, w = img.shape[:2]
    x0, x1 = _clip(x0, 0, w), _clip(x1, 0, w)
    y0, y1 = _clip(y0, 0, h), _clip(y1, 0, h)
    if x1 <= x0 or y1 <= y0:
        return
    region = img[y0:y1, x0:x1].astype(np.float32)
    img[y0:y1, x0:x1] = (region * (1 - alpha)
                         + np.asarray(color, np.float32) * alpha
                         ).astype(np.uint8)


def face_info_label_text(face: Face, show_classification: bool = False
                         ) -> str:
    """Compact per-face info text — detection/mesh confidence, head-pose
    Euler angles, and (opt-in) smile / eye-open probabilities.  Verbatim
    semantics of `overlay_painters.dart:116-146` (``faceInfoLabelText``):
    pitch/yaw only when a mesh exists, roll always when angles exist."""
    parts = [f"score {face.score:.2f}"]
    if face.mesh_score is not None:
        parts.append(f"  mesh {face.mesh_score:.2f}")
    angles = face.head_euler_angles
    if angles is not None:
        parts.append("\n")
        if face.mesh is not None:
            parts.append(f"P {angles.x:.0f}°  Y {angles.y:.0f}°  "
                         f"R {angles.z:.0f}°")
        else:
            parts.append(f"R {angles.z:.0f}°")
    if show_classification and face.smiling_probability is not None:
        parts.append(f"\nsmile {face.smiling_probability:.2f}  "
                     f"eyeL {face.left_eye_open_probability:.2f}  "
                     f"eyeR {face.right_eye_open_probability:.2f}")
    return "".join(parts)


def draw_face_info(img: np.ndarray, faces: list[Face],
                   show_classification: bool = False,
                   copy: bool = True) -> np.ndarray:
    """Per-face translucent info cards anchored just above each bounding
    box, falling back inside its top edge when there is no room, clamped
    to the image (``drawFaceInfoLabel``, `overlay_painters.dart:151-195`)."""
    out = np.array(img, copy=True) if copy else img
    h, w = out.shape[:2]
    pad_h, pad_v, gap = 6, 4, 4
    for f in faces:
        patch = _text_painter(
            face_info_label_text(f, show_classification=show_classification))
        box_w = patch.shape[1] + pad_h * 2
        box_h = patch.shape[0] + pad_v * 2
        fx0, fy0, _, _ = f.bounding_box_pixels
        left, top = fx0, fy0 - gap - box_h
        if top < 0:
            top = fy0 + gap
        if left + box_w > w:
            left = w - box_w
        left = max(left, 0)
        if top + box_h > h:
            top = max(0, h - box_h)
        left, top = int(round(left)), int(round(top))
        # 0xB3000000 card: black at alpha 179/255 (`overlay_painters.dart:190`)
        _fill_rect_alpha(out, left, top, left + box_w, top + box_h,
                         (0, 0, 0), 179 / 255.0)
        _blit_rgba(out, patch, left + pad_h, top + pad_v)
    return out


def draw_detections(img: np.ndarray, faces: list[Face],
                    color=BOX_COLOR, kp_color=KP_COLOR,
                    show_landmark_labels: bool = False,
                    copy: bool = True) -> np.ndarray:
    """Boxes + the 6 detector keypoints (DetectionsPainter analog);
    ``show_landmark_labels`` names each keypoint like
    `overlay_painters.dart:313-343`."""
    out = np.array(img, copy=True) if copy else img
    h, w = out.shape[:2]
    for f in faces:
        x0, y0, x1, y1 = f.bounding_box_pixels
        _draw_rect(out, x0, y0, x1, y1, color)
        for t, p in f.landmarks.items():  # evaluate the lazy property once
            if p is not None:
                _draw_dot(out, p[0], p[1], kp_color)
                if show_landmark_labels:
                    _blit_rgba(out, _text_painter(LANDMARK_LABEL_NAMES[t]),
                               int(p[0]) + 4, int(p[1]) - 10)
    return out


def draw_mesh(img: np.ndarray, faces: list[Face],
              color=MESH_COLOR) -> np.ndarray:
    """All 468 mesh points as dots."""
    out = np.array(img, copy=True)
    for f in faces:
        if f.mesh is None:
            continue
        for x, y, _ in f.mesh.points:
            _draw_dot(out, x, y, color, r=1)
    return out


def draw_contours(img: np.ndarray, faces: list[Face],
                  color=CONTOUR_COLOR, copy: bool = True) -> np.ndarray:
    """Polyline contours (face oval, eyes, brows, lips, nose)."""
    out = np.array(img, copy=True) if copy else img
    for f in faces:
        if f.mesh is None:
            continue
        for ctype in FACE_CONTOUR_MESH_INDICES:
            pts = f.mesh.contour(ctype)
            for a, b in zip(pts[:-1], pts[1:]):
                _draw_line(out, a[0], a[1], b[0], b[1], color)
            if ctype == FaceContourType.FACE and len(pts) > 2:
                _draw_line(out, pts[-1][0], pts[-1][1],
                           pts[0][0], pts[0][1], color)
    return out


def draw_iris(img: np.ndarray, faces: list[Face],
              color=IRIS_COLOR, copy: bool = True) -> np.ndarray:
    """Iris centers/contours and eyelid rings (iris painter analog)."""
    out = np.array(img, copy=True) if copy else img
    for f in faces:
        eyes = f.eyes
        if eyes is None:
            continue
        for eye in (eyes.left_eye, eyes.right_eye):
            if eye is None:
                continue
            _draw_dot(out, eye.iris_center[0], eye.iris_center[1], color)
            for p in eye.iris_contour:
                _draw_dot(out, p[0], p[1], color, r=1)
            ring = eye.contour
            for a, b in EYE_LANDMARK_CONNECTIONS:
                if a < len(ring) and b < len(ring):
                    _draw_line(out, ring[a][0], ring[a][1],
                               ring[b][0], ring[b][1], color)
    return out


def draw_segmentation(img: np.ndarray, mask, color=(0, 128, 255),
                      alpha: float = 0.5, threshold: float = 0.5
                      ) -> np.ndarray:
    """Blends the person mask over the image (LiveSegmentationPainter
    analog).  ``mask`` is a SegmentationMask; it is upsampled to the image
    size first."""
    out = np.array(img, copy=True).astype(np.float32)
    up = mask.upsample(target_width=img.shape[1], target_height=img.shape[0],
                       max_size=0)
    m = (up.data >= threshold)[..., None] * alpha
    out = out * (1 - m) + np.asarray(color, np.float32) * m
    return out.astype(np.uint8)


def mask_valid_region(mask) -> tuple[int, int, int, int]:
    """(x0, y0, x1, y1) of the non-letterbox-padding region of a
    SegmentationMask in mask pixels (``maskValidRegion``,
    `overlay_painters.dart:41-53`).  Delegates to the single crop-rounding
    source shared with ``SegmentationMask.upsample``."""
    from ..models.segmentation import mask_valid_region as _valid

    return _valid(mask.width, mask.height, mask.padding)


def _upsampled_valid(mask, data: np.ndarray, out_w: int, out_h: int
                     ) -> np.ndarray:
    """Crops ``data`` (mask-resolution plane) to the valid region and
    bilinearly resizes it onto the output canvas, like the painters'
    per-pixel (x - x0) * scale mapping."""
    from ..models.segmentation import crop_valid_and_resize

    return crop_valid_and_resize(data, mask.width, mask.height,
                                 mask.padding, out_w, out_h)


def draw_mask(img: np.ndarray, mask, color=(0, 255, 0, 136),
              threshold: float = 0.5, binary: bool = False,
              class_index: int | None = None,
              mirror_horizontally: bool = False) -> np.ndarray:
    """Single-color mask tint (SegmentationMaskPainter's single-class path,
    `overlay_painters.dart:981-1016`): per-pixel alpha = probability x the
    color's alpha (or hard alpha at ``threshold`` when ``binary``);
    ``class_index`` isolates one multiclass plane.  ``mirror_horizontally``
    flips the mask onto a mirrored preview canvas (LiveSegmentationPainter
    renderX, `overlay_painters.dart:721`)."""
    out = np.array(img, copy=True)
    h, w = out.shape[:2]
    plane = mask.class_mask(class_index) if class_index is not None \
        else mask.data
    prob = np.clip(_upsampled_valid(mask, np.asarray(plane, np.float32),
                                    w, h), 0.0, 1.0)
    if mirror_horizontally:
        prob = prob[:, ::-1]
    base_a = (color[3] if len(color) > 3 else 255) / 255.0
    a = np.where(prob >= threshold, base_a, 0.0) if binary else prob * base_a
    a = np.where(a > 0.01, a, 0.0)[..., None]
    blended = (out.astype(np.float32) * (1 - a)
               + np.asarray(color[:3], np.float32) * a)
    return blended.astype(np.uint8)


def draw_multiclass_segmentation(img: np.ndarray, mask,
                                 threshold: float = 0.5,
                                 binary: bool = False,
                                 show_labels: bool = True,
                                 class_colors=SEGMENTATION_CLASS_COLORS,
                                 mirror_horizontally: bool = False
                                 ) -> np.ndarray:
    """All-classes multiclass overlay (`overlay_painters.dart:935-980`):
    each pixel is tinted with its argmax class color when that class's
    probability >= ``threshold`` (alpha scaled by the probability unless
    ``binary``), plus class-name labels at class centroids for classes
    covering > 100 mask pixels (`overlay_painters.dart:58-92`);
    ``mirror_horizontally`` flips onto a mirrored preview
    (`overlay_painters.dart:763`)."""
    out = np.array(img, copy=True)
    h, w = out.shape[:2]
    planes = np.stack([_upsampled_valid(
        mask, np.asarray(mask.class_mask(c), np.float32), w, h)
        for c in range(6)], axis=-1)
    if mirror_horizontally:
        planes = planes[:, ::-1]
    winner = planes.argmax(axis=-1)
    max_prob = np.clip(planes.max(axis=-1), 0.0, 1.0)
    colors = np.asarray([c[:3] for c in class_colors], np.float32)[winner]
    base_a = np.asarray([(c[3] if len(c) > 3 else 255) / 255.0
                         for c in class_colors], np.float32)[winner]
    a = np.where(max_prob >= threshold,
                 base_a if binary else max_prob * base_a, 0.0)[..., None]
    out = (out.astype(np.float32) * (1 - a) + colors * a).astype(np.uint8)

    if show_labels:
        # Label threshold is >100 *mask-resolution* pixels in the painter;
        # scale it to canvas pixels since we composited after upsampling.
        x0, y0, x1, y1 = mask_valid_region(mask)
        scale = (w * h) / max((x1 - x0) * (y1 - y0), 1)
        drawn = max_prob >= threshold
        for c in range(6):
            sel = drawn & (winner == c)
            count = int(sel.sum())
            if count > 100 * scale:
                ys, xs = np.nonzero(sel)
                patch = _text_painter(SEGMENTATION_CLASS_LABELS[c])
                _blit_rgba(out, patch,
                           int(xs.mean()) - patch.shape[1] // 2,
                           int(ys.mean()) - patch.shape[0] // 2)
    return out


def draw_virtual_background(img: np.ndarray, mask,
                            background: np.ndarray,
                            mirror_horizontally: bool = False
                            ) -> np.ndarray:
    """Replaces non-person areas with ``background`` using soft alpha at
    the edges (VirtualBackgroundOverlayPainter,
    `overlay_painters.dart:813-881`): per pixel, the background is drawn
    with alpha = 1 - person probability; the background image is stretched
    to the canvas."""
    out = np.array(img, copy=True)
    h, w = out.shape[:2]
    prob = np.clip(_upsampled_valid(mask, np.asarray(mask.data, np.float32),
                                    w, h), 0.0, 1.0)
    if mirror_horizontally:
        prob = prob[:, ::-1]
    bg_a = 1.0 - prob
    bg_a = np.where(bg_a < 0.01, 0.0, bg_a)[..., None]
    from ..ops.letterbox import resize_matrix
    bg = np.asarray(background, np.float32)
    bg = np.einsum("Hh,hwc,Ww->HWc", resize_matrix(bg.shape[0], h), bg,
                   resize_matrix(bg.shape[1], w))
    return (out.astype(np.float32) * (1 - bg_a) + bg * bg_a).astype(np.uint8)


def mirror_face(face: Face, width: float) -> Face:
    """Horizontally mirrored copy of a Face (pixel x -> width - x,
    normalized x -> 1 - x) — how the reference's painters map camera-space
    results onto a mirrored front-camera preview (CameraDetectionPainter's
    ``renderX = size.width - x``, `overlay_painters.dart:553`).  For
    painting only: anatomical left/right semantics flip with the image."""
    import dataclasses

    from ..pipeline.types import Face as _Face
    from ..pipeline.types import FaceMesh, RectF
    det = face.detection_data
    bb = det.bounding_box
    kp = np.array(det.keypoints_xy, np.float64)
    kp[:, 0] = 1.0 - kp[:, 0]
    mdet = dataclasses.replace(
        det, bounding_box=RectF(1.0 - bb.xmax, bb.ymin, 1.0 - bb.xmin,
                                bb.ymax),
        keypoints_xy=kp)
    mesh = None
    if face.mesh is not None:
        pts = np.array(face.mesh.points, np.float64)
        pts[:, 0] = width - pts[:, 0]
        mesh = FaceMesh(pts, face.mesh.score)
    iris = np.array(face.iris_points, np.float64)
    if iris.size:
        iris[:, 0] = width - iris[:, 0]
    return _Face(mdet, mesh, iris, face.original_size,
                 face._blendshape_scores, face.tracking_id,
                 embedding=face.embedding)


def compose_camera_overlay(frame: np.ndarray, faces: list[Face],
                           mask=None, virtual_background=None,
                           show_segmentation: bool = False,
                           show_all_classes: bool = False,
                           show_pose_and_scores: bool = False,
                           show_classification: bool = False,
                           mirror_horizontally: bool = False,
                           detect_ms: float | None = None) -> np.ndarray:
    """One annotated frame from a live stream — the host analog of the
    FaceDetectionCameraOverlay widget's layer stack
    (`overlay_painters.dart:1045+`): virtual background (or segmentation
    tint), then detections/contours/irises, then per-face info cards, then
    a performance badge when ``detect_ms`` is given."""
    # Copy the frame ONCE, then let the box/contour/iris/info painters
    # draw in place — per-layer copies cost ~16 MB of churn per composed
    # 1280x853 frame in a live stream.  The mask/background layers build
    # new arrays inherently (they blend), so they count as the copy.
    out = frame
    owned = False
    if mirror_horizontally:
        # Every layer mirrors, exactly like the reference widget passes
        # mirrorHorizontally to ALL its painters (segmentation tint, face
        # overlays, info cards — overlay_painters.dart:1156-1190), not
        # just the virtual background.
        faces = [mirror_face(f, frame.shape[1]) for f in faces]
    if mask is not None and virtual_background is not None:
        out = draw_virtual_background(out, mask, virtual_background,
                                      mirror_horizontally)
        owned = True
    elif mask is not None and show_segmentation:
        if show_all_classes and hasattr(mask, "class_mask"):
            out = draw_multiclass_segmentation(
                out, mask, mirror_horizontally=mirror_horizontally)
        else:
            out = draw_mask(out, mask,
                            mirror_horizontally=mirror_horizontally)
        owned = True
    out = draw_detections(out, faces, copy=not owned)
    owned = True
    out = draw_contours(out, faces, copy=False)
    out = draw_iris(out, faces, copy=False)
    if show_pose_and_scores or show_classification:
        out = draw_face_info(out, faces,
                             show_classification=show_classification,
                             copy=False)
    if detect_ms is not None:
        label, color = performance_level(detect_ms)
        patch = _text_painter(f"{detect_ms:.0f} ms  {label}", color=color)
        _fill_rect_alpha(out, 4, 4, 16 + patch.shape[1], 12 + patch.shape[0],
                         (0, 0, 0), 0.6)
        _blit_rgba(out, patch, 10, 8)
    return out


def performance_level(ms: float) -> tuple[str, tuple[int, int, int]]:
    """Buckets a detection time into a display label + RGB color
    (``performanceLevel``, `overlay_painters.dart:29-39`; Material color
    values)."""
    if ms < 200:
        return "Excellent", (76, 175, 80)
    if ms < 500:
        return "Good", (139, 195, 74)
    if ms < 1000:
        return "Fair", (255, 152, 0)
    return "Slow", (244, 67, 54)


#: Default lipstick shade — the reference demo's desaturated berry
#: (0xFF8C3A4A, `example/lib/lipstick_painter.dart:32`).
LIPSTICK_COLOR = (140, 58, 74)


def lip_ring(top: np.ndarray, bottom: np.ndarray,
             shared_endpoints: bool = True) -> np.ndarray:
    """Joins two lip arcs into one closed ring ([N, 2], first != last).

    The four lip contours pair into two rings sharing their endpoints
    (mesh 61/291 outer, 78/308 inner), so the second arc is appended
    reversed with its duplicated first/last vertices dropped
    (`lipstick_painter.dart:40-50`)."""
    top = np.asarray(top, np.float64)[:, :2]
    rev = np.asarray(bottom, np.float64)[::-1, :2]
    return np.concatenate([top, rev[1:-1] if shared_endpoints else rev])


def ring_signed_area(ring: np.ndarray) -> float:
    """Shoelace signed area; the sign encodes winding
    (`lipstick_painter.dart:53-62`)."""
    ring = np.asarray(ring, np.float64)
    x, y = ring[:, 0], ring[:, 1]
    xn, yn = np.roll(x, -1), np.roll(y, -1)
    return float(np.sum(x * yn - xn * y) / 2)


def dilate_ring(ring: np.ndarray, pixels: float) -> np.ndarray:
    """Pushes every vertex outward by ``pixels`` along its vertex normal.

    Outward depends on the ring's winding — which is NOT stable between
    faces (a near-closed mouth inverts the inner ring) — so it is derived
    from the signed area, not assumed (`lipstick_painter.dart:64-93`)."""
    ring = np.asarray(ring, np.float64)
    if pixels == 0 or len(ring) < 3:
        return ring
    orient = 1.0 if ring_signed_area(ring) >= 0 else -1.0

    def unit(v):
        n = np.linalg.norm(v, axis=-1, keepdims=True)
        return np.where(n == 0, 0.0, v / np.where(n == 0, 1.0, n))

    d1 = unit(ring - np.roll(ring, 1, axis=0))    # from prev to cur
    d2 = unit(np.roll(ring, -1, axis=0) - ring)   # from cur to next
    avg = d1 + d2
    normal = unit(np.stack([avg[:, 1], -avg[:, 0]], axis=1) * orient)
    return ring + normal * pixels


def _catmull_rom_ring(ring: np.ndarray, tension: float = 1.0,
                      samples: int = 8) -> np.ndarray:
    """Densifies a closed ring as a Catmull-Rom spline (the painter's
    `addSmoothRing`, `lipstick_painter.dart:106-132`).  tension 0 gives
    the raw polygon."""
    ring = np.asarray(ring, np.float64)
    n = len(ring)
    if n < 3 or tension == 0 or samples <= 1:
        return ring
    p0 = np.roll(ring, 1, axis=0)
    p1 = ring
    p2 = np.roll(ring, -1, axis=0)
    p3 = np.roll(ring, -2, axis=0)
    c1 = p1 + (p2 - p0) * (tension / 6.0)
    c2 = p2 - (p3 - p1) * (tension / 6.0)
    t = (np.arange(samples) / samples)[None, :, None]
    seg = ((1 - t) ** 3 * p1[:, None] + 3 * (1 - t) ** 2 * t * c1[:, None]
           + 3 * (1 - t) * t ** 2 * c2[:, None] + t ** 3 * p2[:, None])
    return seg.reshape(-1, 2)


def build_lip_rings(face: Face, dilate_pixels: float = 0.0,
                    min_open_fraction: float = 0.06):
    """(outer, inner|None) lip rings for a face, or None without a mesh.

    The mouth opening (inner ring) is cut out only when its area is a
    meaningful fraction of the mouth's — on a closed mouth the collapsed
    inner ring can self-intersect and would speckle an even-odd fill
    (`lipstick_painter.dart:134-180`; the gate is geometric because the
    lip landmarks feeding `jawOpen` are unrefined coarse mesh)."""
    if face.mesh is None:
        return None
    outer = dilate_ring(
        lip_ring(face.mesh.contour(FaceContourType.UPPER_LIP_TOP),
                 face.mesh.contour(FaceContourType.LOWER_LIP_BOTTOM)),
        dilate_pixels)
    inner = lip_ring(face.mesh.contour(FaceContourType.UPPER_LIP_BOTTOM),
                     face.mesh.contour(FaceContourType.LOWER_LIP_TOP))
    outer_area = abs(ring_signed_area(outer))
    if outer_area <= 0:
        return None
    if abs(ring_signed_area(inner)) / outer_area < min_open_fraction:
        inner = None
    return outer, inner


def _fill_even_odd(rings, shape) -> np.ndarray:
    """Even-odd rasterization of closed rings -> bool [H, W] (the
    painter's `PathFillType.evenOdd` — mandatory because the inner ring's
    winding flips between faces)."""
    h, w = shape[:2]
    mask = np.zeros((h, w), bool)
    pts = np.concatenate([np.asarray(r, np.float64) for r in rings])
    x0 = max(int(np.floor(pts[:, 0].min())), 0)
    x1 = min(int(np.ceil(pts[:, 0].max())) + 1, w)
    y0 = max(int(np.floor(pts[:, 1].min())), 0)
    y1 = min(int(np.ceil(pts[:, 1].max())) + 1, h)
    if x0 >= x1 or y0 >= y1:
        return mask
    ys = np.arange(y0, y1, dtype=np.float64)[:, None] + 0.5
    xs = np.arange(x0, x1, dtype=np.float64)[None, :] + 0.5
    crossings = np.zeros((y1 - y0, x1 - x0), np.int32)
    for ring in rings:
        ring = np.asarray(ring, np.float64)
        for (ax, ay), (bx, by) in zip(ring, np.roll(ring, -1, axis=0)):
            if ay == by:
                continue
            spans = (ay <= ys) != (by <= ys)           # [rows, 1]
            xi = ax + (ys - ay) / (by - ay) * (bx - ax)  # [rows, 1]
            crossings += (spans & (xs < xi)).astype(np.int32)
    mask[y0:y1, x0:x1] = (crossings % 2) == 1
    return mask


def lipstick_mask(faces, image_shape, dilate_pixels: float = 0.0,
                  smoothing: float = 1.0,
                  min_open_fraction: float = 0.06) -> np.ndarray:
    """Bool [H, W] lip-region mask for all faces (even-odd union — lip
    regions never overlap between faces, `lipstick_painter.dart:182-201`)."""
    if isinstance(faces, Face):
        faces = [faces]
    mask = np.zeros(image_shape[:2], bool)
    for face in faces:
        built = build_lip_rings(face, dilate_pixels, min_open_fraction)
        if built is None:
            continue
        outer, inner = built
        rings = [_catmull_rom_ring(outer, smoothing)]
        if inner is not None:
            rings.append(_catmull_rom_ring(inner, smoothing))
        mask |= _fill_even_odd(rings, image_shape)
    return mask


def _blend_color_mode(dst: np.ndarray, color) -> np.ndarray:
    """Skia `BlendMode.color`: hue+saturation of the paint, luminosity of
    the image (the PDF SetLum/ClipColor construction Flutter uses)."""
    dst = dst.astype(np.float32) / 255.0
    src = np.asarray(color, np.float32) / 255.0
    lum_w = np.array([0.3, 0.59, 0.11], np.float32)
    out = src[None, :] + (dst @ lum_w - float(src @ lum_w))[:, None]
    # ClipColor: pull out-of-gamut channels back toward the luminosity.
    lum = (out @ lum_w)[:, None]
    mn = out.min(axis=1, keepdims=True)
    mx = out.max(axis=1, keepdims=True)
    with np.errstate(divide="ignore", invalid="ignore"):
        low = np.where(mn < 0, lum + (out - lum) * lum / (lum - mn), out)
        out = np.where(mx > 1, lum + (low - lum) * (1 - lum) / (mx - lum),
                       low)
    return (np.clip(out, 0, 1) * 255 + 0.5).astype(np.uint8)


def _gaussian_blur_2d(a: np.ndarray, sigma: float) -> np.ndarray:
    """Separable Gaussian blur of a float array (no cv2 dependency)."""
    r = max(1, int(np.ceil(3 * sigma)))
    x = np.arange(-r, r + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    k /= k.sum()
    pad = np.pad(a, ((r, r), (0, 0)), mode="edge")
    a = sum(k[i] * pad[i:i + a.shape[0]] for i in range(2 * r + 1))
    pad = np.pad(a, ((0, 0), (r, r)), mode="edge")
    return sum(k[i] * pad[:, i:i + a.shape[1]] for i in range(2 * r + 1))


def draw_lipstick(img: np.ndarray, faces, color=LIPSTICK_COLOR,
                  strength: float = 0.85, feather_pixels: float = 1.5,
                  dilate_pixels: float = 1.0, smoothing: float = 1.0,
                  min_open_fraction: float = 0.06,
                  copy: bool = True) -> np.ndarray:
    """AR lipstick overlay from the named lip contours — the reference
    demo's `LipstickPainter` (`example/lib/lipstick_painter.dart:213-233`,
    geometry pinned by `lipstick_overlay_test.dart`) rendered on numpy
    images with the same even-odd/dilation/open-fraction semantics.

    ``strength`` scales the paint's alpha (0.85 default) and
    ``feather_pixels`` Gaussian-softens the mask edge — the coarse mesh
    does not land exactly on the vermillion border, so a hard
    full-strength fill exposes every landmark error."""
    out = np.array(img, copy=True) if copy else img
    strength = float(np.clip(strength, 0.0, 1.0))
    if strength <= 0:
        return out
    region = lipstick_mask(faces, out.shape, dilate_pixels, smoothing,
                           min_open_fraction)
    if not region.any():
        return out
    ys, xs = np.nonzero(region)
    r = max(1, int(np.ceil(3 * feather_pixels))) if feather_pixels > 0 else 0
    y0 = max(ys.min() - r, 0)
    y1 = min(ys.max() + r + 1, out.shape[0])
    x0 = max(xs.min() - r, 0)
    x1 = min(xs.max() + r + 1, out.shape[1])
    alpha = region[y0:y1, x0:x1].astype(np.float64)
    if feather_pixels > 0:
        alpha = _gaussian_blur_2d(alpha, feather_pixels)
    alpha = (alpha * strength)[..., None]
    box = out[y0:y1, x0:x1]
    tinted = _blend_color_mode(box.reshape(-1, 3), color).reshape(box.shape)
    out[y0:y1, x0:x1] = (box * (1 - alpha) + tinted * alpha
                         + 0.5).astype(np.uint8)
    return out


def annotate(img: np.ndarray, faces: list[Face], mask=None) -> np.ndarray:
    """Everything at once — the demo-app overlay."""
    # Copy once, then draw in place (compose_camera_overlay's pattern:
    # per-layer copies are ~3.3 MB each on a 1280x853 frame).
    out = img
    owned = False
    if mask is not None:
        out = draw_segmentation(out, mask)
        owned = True
    out = draw_detections(out, faces, copy=not owned)
    out = draw_contours(out, faces, copy=False)
    out = draw_iris(out, faces, copy=False)
    return out


def cover_fit_transform(src_w: int, src_h: int, dst_w: int, dst_h: int
                        ) -> tuple[float, float, float]:
    """(scale, dx, dy) mapping source-image pixels onto a cover-fit viewport.

    The reference's camera-overlay painters map detection coordinates onto
    a preview that fills the widget BoxFit.cover-style
    (`overlay_painters.dart:196` et al.): uniform scale = max(dstW/srcW,
    dstH/srcH), centered, edges cropped.  dst = src * scale + (dx, dy).
    """
    if min(src_w, src_h, dst_w, dst_h) <= 0:
        raise ValueError("cover_fit_transform requires positive dimensions")
    scale = max(dst_w / src_w, dst_h / src_h)
    dx = (dst_w - src_w * scale) * 0.5
    dy = (dst_h - src_h * scale) * 0.5
    return scale, dx, dy
