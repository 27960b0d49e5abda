"""Public result types: Face, Detection, Eye, contours, head pose.

Python port of the data surface of `lib/src/shared/face_types.dart` — the
objects a user of the reference package works with, preserved so switching
to this framework is a drop-in for result handling.  Points are numpy
arrays ([..., 3] = x, y, z in absolute pixels unless noted).  A numpy copy
of the JAX package's module.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import NamedTuple, Optional, Sequence

import numpy as np

from .blendshape_input import BLENDSHAPE_NAMES
from .geometry import (MESH_CHIN_BOTTOM, MESH_FOREHEAD_TOP, MESH_LEFT_CHEEK,
                       MESH_RIGHT_CHEEK)

__all__ = [
    "FaceLandmarkType", "FaceContourType", "Blendshape", "RectF",
    "AlignedRoi",
    "Detection", "FaceMesh", "Eye", "EyePair", "FaceLandmarks",
    "HeadEulerAngles", "FaceBlendshapes", "Face",
    "FACE_CONTOUR_MESH_INDICES", "EYE_LANDMARK_CONNECTIONS",
    "MESH_POINTS", "MAX_EYE_LANDMARK", "split_meshes_if_concatenated",
    "BLENDSHAPE_NAMES",
]

MESH_POINTS = 468

MAX_EYE_LANDMARK = 15


def _np_head_euler(mesh_points: np.ndarray):
    """Host (numpy) head-pose solve — same math as the JAX package's
    `geometry.head_euler_angles_from_mesh`.  Returns (pitch, yaw, roll)
    degrees or None for degenerate meshes (face_geometry.dart:215-229)."""
    f = mesh_points[MESH_FOREHEAD_TOP].astype(np.float64)
    c = mesh_points[MESH_CHIN_BOTTOM].astype(np.float64)
    l = mesh_points[MESH_LEFT_CHEEK].astype(np.float64)
    r = mesh_points[MESH_RIGHT_CHEEK].astype(np.float64)
    right = r - l
    down = c - f
    rlen = np.linalg.norm(right)
    dlen = np.linalg.norm(down)
    if rlen < 1e-6 or dlen < 1e-6:
        return None
    right /= rlen
    down /= dlen
    down = down - np.dot(down, right) * right
    dlen2 = np.linalg.norm(down)
    if dlen2 < 1e-6:
        return None
    down /= dlen2
    bz = right[0] * down[1] - right[1] * down[0]
    pitch = np.arctan2(down[2], bz)
    yaw = np.arcsin(np.clip(-right[2], -1.0, 1.0))
    roll = np.arctan2(right[1], right[0])
    return (float(np.degrees(-pitch)), float(np.degrees(-yaw)),
            float(np.degrees(-roll)))


class FaceLandmarkType(enum.IntEnum):
    """Detector keypoint order (`face_types.dart:19`)."""

    LEFT_EYE = 0
    RIGHT_EYE = 1
    NOSE_TIP = 2
    MOUTH = 3
    LEFT_EYE_TRAGION = 4
    RIGHT_EYE_TRAGION = 5


class FaceContourType(enum.Enum):
    FACE = "face"
    LEFT_EYEBROW_TOP = "leftEyebrowTop"
    LEFT_EYEBROW_BOTTOM = "leftEyebrowBottom"
    RIGHT_EYEBROW_TOP = "rightEyebrowTop"
    RIGHT_EYEBROW_BOTTOM = "rightEyebrowBottom"
    LEFT_EYE = "leftEye"
    RIGHT_EYE = "rightEye"
    UPPER_LIP_TOP = "upperLipTop"
    UPPER_LIP_BOTTOM = "upperLipBottom"
    LOWER_LIP_TOP = "lowerLipTop"
    LOWER_LIP_BOTTOM = "lowerLipBottom"
    NOSE_BRIDGE = "noseBridge"
    NOSE_BOTTOM = "noseBottom"
    LEFT_CHEEK = "leftCheek"
    RIGHT_CHEEK = "rightCheek"


Blendshape = enum.Enum(  # type: ignore[misc]
    "Blendshape",
    {("NEUTRAL" if n == "_neutral" else n): i
     for i, n in enumerate(BLENDSHAPE_NAMES)},
)

# MediaPipe canonical FACEMESH_* sets chained into ordered polylines
# (`face_types.dart:661-743`).
FACE_CONTOUR_MESH_INDICES: dict[FaceContourType, list[int]] = {
    FaceContourType.FACE: [
        10, 338, 297, 332, 284, 251, 389, 356, 454, 323, 361, 288,
        397, 365, 379, 378, 400, 377, 152, 148, 176, 149, 150, 136,
        172, 58, 132, 93, 234, 127, 162, 21, 54, 103, 67, 109],
    FaceContourType.LEFT_EYEBROW_TOP: [300, 293, 334, 296, 336],
    FaceContourType.LEFT_EYEBROW_BOTTOM: [276, 283, 282, 295, 285],
    FaceContourType.RIGHT_EYEBROW_TOP: [70, 63, 105, 66, 107],
    FaceContourType.RIGHT_EYEBROW_BOTTOM: [46, 53, 52, 65, 55],
    FaceContourType.LEFT_EYE: [
        263, 466, 388, 387, 386, 385, 384, 398,
        362, 382, 381, 380, 374, 373, 390, 249],
    FaceContourType.RIGHT_EYE: [
        33, 246, 161, 160, 159, 158, 157, 173,
        133, 155, 154, 153, 145, 144, 163, 7],
    FaceContourType.UPPER_LIP_TOP: [
        61, 185, 40, 39, 37, 0, 267, 269, 270, 409, 291],
    FaceContourType.UPPER_LIP_BOTTOM: [
        78, 191, 80, 81, 82, 13, 312, 311, 310, 415, 308],
    FaceContourType.LOWER_LIP_TOP: [
        78, 95, 88, 178, 87, 14, 317, 402, 318, 324, 308],
    FaceContourType.LOWER_LIP_BOTTOM: [
        61, 146, 91, 181, 84, 17, 314, 405, 321, 375, 291],
    FaceContourType.NOSE_BRIDGE: [168, 6, 197, 195, 5, 4],
    FaceContourType.NOSE_BOTTOM: [98, 97, 2, 326, 327],
    FaceContourType.LEFT_CHEEK: [280],
    FaceContourType.RIGHT_CHEEK: [50],
}

# Eyeball outline connections (`face_types.dart:635-651`).
EYE_LANDMARK_CONNECTIONS = [
    (0, 1), (1, 2), (2, 3), (3, 4), (4, 5), (5, 6), (6, 7), (7, 8),
    (9, 10), (10, 11), (11, 12), (12, 13), (13, 14), (0, 9), (8, 14),
]


@dataclasses.dataclass(frozen=True)
class RectF:
    """Normalized rectangle (`face_types.dart:1439`)."""

    xmin: float
    ymin: float
    xmax: float
    ymax: float

    @property
    def w(self) -> float:
        return self.xmax - self.xmin

    @property
    def h(self) -> float:
        return self.ymax - self.ymin

    def expand(self, fraction: float) -> "RectF":
        dw = self.w * fraction * 0.5
        dh = self.h * fraction * 0.5
        return RectF(self.xmin - dw, self.ymin - dh,
                     self.xmax + dw, self.ymax + dh)

    def scaled(self, w: float, h: float) -> tuple[float, float, float, float]:
        return (self.xmin * w, self.ymin * h, self.xmax * w, self.ymax * h)


class AlignedRoi(NamedTuple):
    """Rotated square ROI in pixels (`face_types.dart:1561`).

    Tuple-compatible with `geometry.eye_rois_from_mesh`'s
    (cx, cy, size, theta) order.  NOTE: `geometry.compute_face_alignment`
    returns (theta, cx, cy, size) — splatting THAT into this type would
    silently scramble all four fields; reorder explicitly.
    """

    cx: float
    cy: float
    size: float
    theta: float


@dataclasses.dataclass(frozen=True)
class Detection:
    """One detector result: normalized box + 6 keypoints + score."""

    bounding_box: RectF
    score: float
    keypoints_xy: np.ndarray  # [6, 2] normalized

    def keypoint(self, t: FaceLandmarkType) -> tuple[float, float]:
        return (float(self.keypoints_xy[t, 0]), float(self.keypoints_xy[t, 1]))


@dataclasses.dataclass(frozen=True)
class HeadEulerAngles:
    """Pitch/yaw/roll degrees, ML Kit sign convention
    (`face_types.dart:1009`)."""

    x: float  # pitch (positive = face up)
    y: float  # yaw   (positive = toward image right)
    z: float  # roll  (positive = counter-clockwise)


class FaceMesh:
    """468-point mesh in absolute pixels with optional presence score."""

    def __init__(self, points: np.ndarray, score: Optional[float] = None):
        self.points = np.asarray(points)  # [468, 3]
        self.score = score

    def __len__(self) -> int:
        return len(self.points)

    def contour(self, contour_type: FaceContourType) -> np.ndarray:
        """Ordered polyline for one contour group ([K, 3] pixels)."""
        idx = FACE_CONTOUR_MESH_INDICES[contour_type]
        return self.points[idx]

    @property
    def contours(self) -> dict[FaceContourType, np.ndarray]:
        return {t: self.contour(t) for t in FACE_CONTOUR_MESH_INDICES}


class Eye:
    """Iris center + iris contour + 71-point eye mesh
    (`face_types.dart:834`)."""

    def __init__(self, iris_center: np.ndarray, iris_contour: np.ndarray,
                 mesh: Optional[np.ndarray] = None):
        self.iris_center = iris_center
        self.iris_contour = iris_contour
        self.mesh = mesh if mesh is not None else np.zeros((0, 3))

    @property
    def contour(self) -> np.ndarray:
        """Visible eyelid ring: first 15 mesh points."""
        return self.mesh[:MAX_EYE_LANDMARK]

    @classmethod
    def from_points(cls, points: np.ndarray) -> Optional["Eye"]:
        """Splits a 76-point per-eye stream (71 contour + 5 iris);
        iris center = point nearest the 5-point centroid
        (`face_types.dart:1148-1171`)."""
        points = np.asarray(points)
        if len(points) < 5:
            return None
        if len(points) > 5:
            iris_start = len(points) - 5
            eye_mesh = points[:iris_start]
            iris = points[iris_start:]
        else:
            eye_mesh = np.zeros((0, 3))
            iris = points
        centroid = iris[:, :2].mean(axis=0)
        d = ((iris[:, :2] - centroid) ** 2).sum(axis=1)
        best = int(np.argmin(d))
        contour = np.delete(iris, best, axis=0)
        return cls(iris_center=iris[best], iris_contour=contour,
                   mesh=eye_mesh)


@dataclasses.dataclass(frozen=True)
class EyePair:
    left_eye: Optional[Eye]
    right_eye: Optional[Eye]


class FaceLandmarks:
    """Named access to the 6 detector keypoints in absolute pixels."""

    def __init__(self, points: dict[FaceLandmarkType, np.ndarray]):
        self._points = points

    def __getitem__(self, t: FaceLandmarkType) -> Optional[np.ndarray]:
        return self._points.get(t)

    def items(self):
        """(FaceLandmarkType, point) pairs — public iteration for painters
        (the reference exposes the underlying map directly)."""
        return self._points.items()

    @property
    def left_eye(self):
        return self._points.get(FaceLandmarkType.LEFT_EYE)

    @property
    def right_eye(self):
        return self._points.get(FaceLandmarkType.RIGHT_EYE)

    @property
    def nose_tip(self):
        return self._points.get(FaceLandmarkType.NOSE_TIP)

    @property
    def mouth(self):
        return self._points.get(FaceLandmarkType.MOUTH)

    @property
    def left_eye_tragion(self):
        return self._points.get(FaceLandmarkType.LEFT_EYE_TRAGION)

    @property
    def right_eye_tragion(self):
        return self._points.get(FaceLandmarkType.RIGHT_EYE_TRAGION)


class FaceBlendshapes:
    """The 52 Blendshape V2 coefficients with named access."""

    def __init__(self, scores: Sequence[float]):
        self.scores = np.asarray(scores, np.float32)
        assert self.scores.shape == (52,)

    def __getitem__(self, b) -> float:
        if isinstance(b, Blendshape):
            return float(self.scores[b.value])
        if isinstance(b, str):
            return self.by_name(b)
        return float(self.scores[b])

    def by_name(self, name: str) -> float:
        return float(self.scores[BLENDSHAPE_NAMES.index(name)])

    def as_dict(self) -> dict[str, float]:
        return {n: float(s) for n, s in zip(BLENDSHAPE_NAMES, self.scores)}


class Face:
    """One detected face — the reference's `Face` (`face_types.dart:1070`).

    Lazily derives eyes, head angles, and blendshape getters exactly like
    the reference (cached on first access).
    """

    def __init__(self, detection: Detection, mesh: Optional[FaceMesh],
                 irises: np.ndarray, original_size: tuple[float, float],
                 blendshape_scores: Optional[np.ndarray] = None,
                 tracking_id: Optional[int] = None,
                 embedding: Optional[np.ndarray] = None,
                 head_angles: Optional[np.ndarray] = None):
        self.detection_data = detection
        self.mesh = mesh
        self.iris_points = np.asarray(irises).reshape(-1, 3) \
            if irises is not None and len(irises) else np.zeros((0, 3))
        self.original_size = original_size  # (width, height)
        self._blendshape_scores = blendshape_scores
        self.tracking_id = tracking_id
        #: 192-dim L2-normalized embedding, present when the detector ran
        #: with embed_in_full (fused MobileFaceNet stage; the reference
        #: computes embeddings via separate getFaceEmbedding calls,
        #: face_detector.dart:685).
        self.embedding = embedding
        self._eyes: Optional[EyePair] = None
        #: FULL-mode programs already compute the head pose on device
        #: (pinned equal to the host solve); seeding the cache here saves
        #: re-deriving it from the mesh in numpy per access.
        self._angles: Optional[HeadEulerAngles] = (
            HeadEulerAngles(*(float(v) for v in head_angles))
            if head_angles is not None else None)
        self._bs: Optional[FaceBlendshapes] = None

    def with_tracking_id(self, tracking_id: int) -> "Face":
        f = Face(self.detection_data, self.mesh, self.iris_points,
                 self.original_size, self._blendshape_scores, tracking_id,
                 embedding=self.embedding)
        f._angles = self._angles  # carry the (device-computed) pose cache
        return f

    # -- detection-level -----------------------------------------------------

    @property
    def bounding_box(self) -> RectF:
        return self.detection_data.bounding_box

    @property
    def bounding_box_pixels(self) -> tuple[float, float, float, float]:
        w, h = self.original_size
        return self.detection_data.bounding_box.scaled(w, h)

    @property
    def score(self) -> float:
        return self.detection_data.score

    @property
    def mesh_score(self) -> Optional[float]:
        return self.mesh.score if self.mesh is not None else None

    @property
    def width_fraction(self) -> float:
        """Visible face width / image width (`face_types.dart:1196`).
        Pure numpy (a tensor op here would cost a device sync per
        access)."""
        b = self.detection_data.bounding_box
        iw = float(self.original_size[0])
        if iw <= 0:
            return 0.0
        visible = min(b.xmax * iw, iw) - max(b.xmin * iw, 0.0)
        return visible / iw if visible > 0 else 0.0

    @property
    def landmarks(self) -> FaceLandmarks:
        """The 6 detector keypoints in absolute pixels.  In full mode the
        eye entries are the iris centers including their z
        (`face_types.dart:1317-1321`)."""
        w, h = self.original_size
        pts = {}
        for t in FaceLandmarkType:
            if t < len(self.detection_data.keypoints_xy):
                kp = self.detection_data.keypoints_xy[t]
                pts[t] = np.asarray([kp[0] * w, kp[1] * h, 0.0])
        eyes = self.eyes
        if eyes is not None:
            if eyes.left_eye is not None:
                pts[FaceLandmarkType.LEFT_EYE] = np.asarray(
                    eyes.left_eye.iris_center, np.float64)
            if eyes.right_eye is not None:
                pts[FaceLandmarkType.RIGHT_EYE] = np.asarray(
                    eyes.right_eye.iris_center, np.float64)
        return FaceLandmarks(pts)

    # -- derived (lazy, as in the reference) ----------------------------------

    @property
    def eyes(self) -> Optional[EyePair]:
        """Per-eye iris data; stream-splitting rules follow
        `face_types.dart:1289-1307` IN ORDER: 152 -> two 76-point eyes,
        76 -> ONE full (left) eye (the documented per-eye stream — it must
        NOT fall into the even-split rule, which would fabricate two
        38-point half-eyes), 10 -> two 5-point iris sets, any other even
        length > 10 -> split in half, and any stream of >= 5 points parses
        as a single (left) eye."""
        if self._eyes is None and len(self.iris_points):
            n = len(self.iris_points)
            if n == 152:
                self._eyes = EyePair(Eye.from_points(self.iris_points[:76]),
                                     Eye.from_points(self.iris_points[76:]))
            elif n == 76:
                self._eyes = EyePair(Eye.from_points(self.iris_points), None)
            elif n == 10:
                self._eyes = EyePair(Eye.from_points(self.iris_points[:5]),
                                     Eye.from_points(self.iris_points[5:]))
            elif n > 10 and n % 2 == 0:
                half = n // 2
                self._eyes = EyePair(
                    Eye.from_points(self.iris_points[:half]),
                    Eye.from_points(self.iris_points[half:]))
            elif n >= 5:
                self._eyes = EyePair(Eye.from_points(self.iris_points), None)
        return self._eyes

    @property
    def head_euler_angles(self) -> Optional[HeadEulerAngles]:
        if self._angles is None:
            # The reference accepts any mesh long enough to index its 4
            # canonical points (`face_geometry.dart:191`: length must
            # exceed kMeshRightCheek=454) — requiring the full 468 here
            # silently degraded 455..467-point meshes to roll-only.
            if self.mesh is not None and len(self.mesh) > MESH_RIGHT_CHEEK:
                a = _np_head_euler(self.mesh.points)
                if a is not None:
                    self._angles = HeadEulerAngles(*a)
            if self._angles is None:
                # Fast-mode fallback: roll only (`face_types.dart:1271-1287`).
                kp = self.detection_data.keypoints_xy
                if len(kp) >= 2:
                    w, h = self.original_size
                    dx = (kp[1][0] - kp[0][0]) * w
                    dy = (kp[1][1] - kp[0][1]) * h
                    roll = float(np.degrees(-np.arctan2(dy, dx)))
                    self._angles = HeadEulerAngles(0.0, 0.0, roll)
        return self._angles

    @property
    def blendshapes(self) -> Optional[FaceBlendshapes]:
        if self._bs is None and self._blendshape_scores is not None:
            s = np.asarray(self._blendshape_scores)
            if s.shape == (52,):
                self._bs = FaceBlendshapes(s)
        return self._bs

    @property
    def smiling_probability(self) -> Optional[float]:
        b = self.blendshapes
        if b is None:
            return None
        v = (b[Blendshape.mouthSmileLeft] + b[Blendshape.mouthSmileRight]) / 2
        return min(max(v, 0.0), 1.0)

    @property
    def left_eye_open_probability(self) -> Optional[float]:
        """Subject-relative left eye; 1 - eyeBlinkLeft (ML Kit semantics)."""
        b = self.blendshapes
        if b is None:
            return None
        return min(max(1.0 - b[Blendshape.eyeBlinkLeft], 0.0), 1.0)

    @property
    def right_eye_open_probability(self) -> Optional[float]:
        b = self.blendshapes
        if b is None:
            return None
        return min(max(1.0 - b[Blendshape.eyeBlinkRight], 0.0), 1.0)

    def to_dict(self, include_mesh: bool = False,
                include_contours: bool = False,
                include_iris: bool = False,
                include_embedding: bool = True) -> dict:
        """JSON-safe dict of this face — the HTTP-serving analog of the
        reference's isolate-RPC payload `_faceToFastMap`
        (`face_detector.dart:1160-1181`).

        The heavyweight arrays (468-pt mesh, per-contour point lists,
        iris contours, 192-dim embedding) are opt-in so a detection
        response stays small by default.  All values are plain Python
        floats/ints/lists — ``json.dumps`` works directly.
        """
        b = self.bounding_box
        out: dict = {
            "bounding_box": {"xmin": float(b.xmin), "ymin": float(b.ymin),
                             "xmax": float(b.xmax), "ymax": float(b.ymax)},
            "score": float(self.score),
            "width_fraction": float(self.width_fraction),
            "tracking_id": self.tracking_id,
            "landmarks": {t.name.lower(): [float(v) for v in p]
                          for t, p in self.landmarks.items()},
        }
        if self.mesh_score is not None:
            out["mesh_score"] = float(self.mesh_score)
        angles = self.head_euler_angles
        if angles is not None:
            out["head_euler_angles"] = {"x": float(angles.x),
                                        "y": float(angles.y),
                                        "z": float(angles.z)}
        bs = self.blendshapes
        if bs is not None:
            out["blendshapes"] = bs.as_dict()
            out["smiling_probability"] = self.smiling_probability
            out["left_eye_open_probability"] = self.left_eye_open_probability
            out["right_eye_open_probability"] = \
                self.right_eye_open_probability
        eyes = self.eyes
        if eyes is not None:
            eye_d = {}
            for name, eye in (("left_eye", eyes.left_eye),
                              ("right_eye", eyes.right_eye)):
                if eye is None:
                    continue
                d = {"iris_center": [float(v) for v in eye.iris_center]}
                if include_iris:
                    d["iris_contour"] = eye.iris_contour.astype(
                        float).tolist()
                    d["eye_contour"] = eye.mesh.astype(float).tolist()
                eye_d[name] = d
            if eye_d:
                out["eyes"] = eye_d
        if include_mesh and self.mesh is not None and len(self.mesh):
            out["mesh"] = self.mesh.points.astype(float).tolist()
        if include_contours and self.mesh is not None and len(self.mesh):
            out["contours"] = {
                ct.name: pts.astype(float).tolist()
                for ct, pts in self.mesh.contours.items()}
        if include_embedding and self.embedding is not None:
            out["embedding"] = [float(v) for v in self.embedding]
        return out

    def __repr__(self) -> str:
        return (f"Face(score={self.score:.3f}, box={self.bounding_box}, "
                f"mesh={'yes' if self.mesh is not None else 'no'}, "
                f"tracking_id={self.tracking_id})")


def split_meshes_if_concatenated(mesh_points: np.ndarray
                                 ) -> list[np.ndarray]:
    """Splits a [k*468, 3] point array into per-face [468, 3] meshes.

    `splitMeshesIfConcatenated` (face_detector.dart:1047): empty input
    yields []; lengths that are not a multiple of 468 are returned whole
    as a single entry.
    """
    pts = np.asarray(mesh_points)
    if pts.size == 0:
        return []
    if len(pts) % MESH_POINTS != 0:
        return [pts]
    return [pts[i * MESH_POINTS:(i + 1) * MESH_POINTS]
            for i in range(len(pts) // MESH_POINTS)]
