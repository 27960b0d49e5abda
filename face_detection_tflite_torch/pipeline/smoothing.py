"""Temporal landmark smoothing for video streams.

Analog of the reference example app's `FaceSmoother`
(`example/lib/main.dart:3755`), with two methods:

* ``"ema"`` — exponential smoothing of per-track face geometry, keyed by
  tracking ID (requires ``enable_tracking``).
* ``"one_euro"`` — the reference's actual algorithm: greedy IoU >= 0.2
  track matching (`main.dart:3775-3791`) + a One-Euro filter per track on
  mesh/iris point positions (`main.dart:3820-3852`; filter parameters
  minCutoff=1.0, beta=0.1, dCutoff=1.0 at `main.dart:3830`).  Adaptive:
  heavy smoothing when still, responsive under fast motion.  Needs no
  tracker; boxes/keypoints pass through unfiltered, mesh-less faces pass
  through whole, presence/blendshape scores are preserved
  (`main.dart:3860-3868`).

Purely host-side stream state, like the tracker: a copy of the JAX
package's module, float64 numpy in both packages, building this package's
``Face``.  The filters are vectorized over the whole (n_points, 2) array
per track rather than one scalar-filter object per coordinate.  A smoothed
face carries no precomputed head pose: its pose is re-derived from the
smoothed mesh on first access, as in the JAX package.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from .types import Detection, Face, FaceMesh, RectF

__all__ = ["FaceSmoother", "OneEuroFilter"]


def _iou_ltrb(a, b) -> float:
    """IoU of two (left, top, right, bottom) boxes (flutter_litert's
    ``iouLTRB`` used at `main.dart:3788,3826`)."""
    iw = max(0.0, min(a[2], b[2]) - max(a[0], b[0]))
    ih = max(0.0, min(a[3], b[3]) - max(a[1], b[1]))
    inter = iw * ih
    area_a = max(0.0, a[2] - a[0]) * max(0.0, a[3] - a[1])
    area_b = max(0.0, b[2] - b[0]) * max(0.0, b[3] - b[1])
    union = area_a + area_b - inter
    return inter / union if union > 0.0 else 0.0


class OneEuroFilter:
    """One-Euro filter (Casiez, Roussel & Vogel, CHI 2012), vectorized.

    The cutoff frequency adapts to the signal's speed:
    ``cutoff = min_cutoff + beta * |dx_hat|`` — low when the signal is
    still (strong smoothing, no jitter), high when it moves fast (little
    smoothing, no lag).  ``filter(x, t_sec)`` accepts any-shape arrays and
    filters elementwise.
    """

    def __init__(self, min_cutoff: float = 1.0, beta: float = 0.1,
                 d_cutoff: float = 1.0):
        if min_cutoff <= 0 or d_cutoff <= 0:
            raise ValueError("cutoff frequencies must be positive")
        self.min_cutoff = float(min_cutoff)
        self.beta = float(beta)
        self.d_cutoff = float(d_cutoff)
        self._x: Optional[np.ndarray] = None
        self._dx: Optional[np.ndarray] = None
        self._t: Optional[float] = None

    @staticmethod
    def _alpha(dt: float, cutoff) -> np.ndarray:
        r = 2.0 * np.pi * cutoff * dt
        return r / (r + 1.0)

    def filter(self, x, t_sec: float) -> np.ndarray:
        # State is stored AND returned as copies: np.asarray aliases a
        # caller-owned float64 array, and handing out the internal
        # accumulator would let `out += offset` silently corrupt every
        # later output (the arrays are a few KB — copies are noise).
        x = np.asarray(x, np.float64)
        if self._x is None or self._x.shape != x.shape:
            self._x, self._dx, self._t = x.copy(), np.zeros_like(x), \
                float(t_sec)
            return self._x.copy()
        dt = float(t_sec) - self._t
        if dt <= 0.0:
            return self._x.copy()
        self._t = float(t_sec)
        dx = (x - self._x) / dt
        a_d = self._alpha(dt, self.d_cutoff)
        self._dx = a_d * dx + (1.0 - a_d) * self._dx
        cutoff = self.min_cutoff + self.beta * np.abs(self._dx)
        a = self._alpha(dt, cutoff)
        self._x = a * x + (1.0 - a) * self._x
        return self._x.copy()

    def reset(self) -> None:
        self._x = self._dx = self._t = None


class _EuroTrack:
    __slots__ = ("box", "missed", "mesh_f", "iris_f")

    def __init__(self):
        self.box = None           # last observed LTRB (normalized)
        self.missed = 0
        self.mesh_f = OneEuroFilter()
        self.iris_f = OneEuroFilter()


class FaceSmoother:
    """Temporal face smoothing; see the module docstring for the two
    methods.

    For ``method="ema"``: ``alpha`` is the weight of the NEW observation
    (1.0 = no smoothing); faces without a tracking ID pass through
    unsmoothed.  For ``method="one_euro"``: tracks are matched by IoU and
    ``smooth(faces, t_sec=...)`` should be called with a monotonically
    increasing timestamp (frames are assumed 30 fps apart when omitted).
    In both methods, tracks absent for ``max_missed_frames`` consecutive
    smoothed frames are forgotten.
    """

    #: Minimum IoU for a face to continue an existing one-euro track
    #: (`main.dart:3758`).
    MIN_IOU = 0.2

    def __init__(self, alpha: float = 0.5, max_missed_frames: int = 5,
                 method: str = "ema"):
        if not 0.0 < alpha <= 1.0:
            raise ValueError("alpha must be in (0, 1]")
        if method not in ("ema", "one_euro"):
            raise ValueError(f"unknown smoothing method: {method!r}")
        self.alpha = alpha
        self.method = method
        self.max_missed_frames = max_missed_frames
        self._state: dict[int, dict] = {}
        self._missed: dict[int, int] = {}
        self._tracks: list[_EuroTrack] = []
        self._frame = 0

    def _ema(self, tid: int, key: str, value: Optional[np.ndarray]):
        if value is None:
            # Forget the key rather than keep it frozen: a mesh that
            # reappears after N mesh-less frames on a still-matched track
            # would otherwise blend 50% with arbitrarily stale points (a
            # visible ghost jump).  The one_euro path already degrades
            # gracefully via its dt-adaptive alpha.
            self._state[tid].pop(key, None)
            return None
        # Copy in and out: np.asarray aliases caller-owned float64 input,
        # and the returned array is wrapped into the emitted Face — an
        # in-place edit there (e.g. scaling for rendering) must not
        # rewrite the accumulator.
        value = np.array(value, np.float64)
        prev = self._state[tid].get(key)
        if prev is None or prev.shape != value.shape:
            out = value
        else:
            out = prev * (1.0 - self.alpha) + value * self.alpha
        self._state[tid][key] = out.copy()
        return out

    def smooth(self, faces: list[Face],
               t_sec: Optional[float] = None) -> list[Face]:
        """Returns smoothed copies of ``faces`` (tracking IDs preserved)."""
        self._frame += 1
        if self.method == "one_euro":
            return self._smooth_one_euro(
                faces, self._frame / 30.0 if t_sec is None else float(t_sec))
        seen = set()
        out = []
        for f in faces:
            tid = f.tracking_id
            if tid is None:
                out.append(f)
                continue
            seen.add(tid)
            state = self._state.setdefault(tid, {})
            self._missed[tid] = 0

            b = f.bounding_box
            # Guard against ID reuse after detector.reset_tracking(): if the
            # stored box and the new one don't plausibly belong to the same
            # track (no overlap and far apart), restart the EMA rather than
            # blending two different faces.
            prev_box = state.get("box")
            if prev_box is not None:
                pw = max(prev_box[2] - prev_box[0], 1e-6)
                ph = max(prev_box[3] - prev_box[1], 1e-6)
                pcx = (prev_box[0] + prev_box[2]) / 2
                pcy = (prev_box[1] + prev_box[3]) / 2
                ncx, ncy = (b.xmin + b.xmax) / 2, (b.ymin + b.ymax) / 2
                diag = float(np.hypot(pw, ph))
                if float(np.hypot(ncx - pcx, ncy - pcy)) > 1.5 * diag:
                    state.clear()
            box = self._ema(tid, "box",
                            [b.xmin, b.ymin, b.xmax, b.ymax])
            kp = self._ema(tid, "kp", f.detection_data.keypoints_xy)
            mesh_pts = self._ema(
                tid, "mesh", f.mesh.points if f.mesh is not None else None)
            iris = self._ema(
                tid, "iris",
                f.iris_points if len(f.iris_points) else None)

            det = Detection(RectF(*map(float, box)),
                            f.detection_data.score, np.asarray(kp))
            mesh = (FaceMesh(mesh_pts, score=f.mesh.score)
                    if mesh_pts is not None else None)
            out.append(Face(
                detection=det, mesh=mesh,
                irises=iris if iris is not None else np.zeros((0, 3)),
                original_size=f.original_size,
                blendshape_scores=(f.blendshapes.scores
                                   if f.blendshapes is not None else None),
                tracking_id=tid, embedding=f.embedding))

        for tid in list(self._state):
            if tid not in seen:
                self._missed[tid] = self._missed.get(tid, 0) + 1
                if self._missed[tid] > self.max_missed_frames:
                    self._state.pop(tid, None)
                    self._missed.pop(tid, None)
        return out

    def _smooth_one_euro(self, faces: list[Face], t_sec: float
                         ) -> list[Face]:
        """Greedy IoU matching + per-track One-Euro filtering
        (`main.dart:3768-3852`)."""
        if not faces:
            # Reference early-return (`main.dart:3768-3770`): empty frames
            # do NOT age tracks, so a face occluded for many frames
            # resumes its existing filter state instead of jumping.
            return faces
        unmatched = list(range(len(self._tracks)))
        out = []
        for f in faces:
            b = f.bounding_box
            ltrb = (b.xmin, b.ymin, b.xmax, b.ymax)
            best_iou, best_t = self.MIN_IOU, -1
            for t in unmatched:
                tb = self._tracks[t].box
                if tb is None:
                    continue
                iou = _iou_ltrb(ltrb, tb)
                if iou > best_iou:
                    best_iou, best_t = iou, t
            if best_t >= 0:
                track = self._tracks[best_t]
                track.missed = 0
                unmatched.remove(best_t)
            else:
                track = _EuroTrack()
                self._tracks.append(track)
            track.box = ltrb
            out.append(self._filter_face(f, track, t_sec))

        for t in unmatched:
            self._tracks[t].missed += 1
        self._tracks = [t for t in self._tracks
                        if t.missed <= self.max_missed_frames]
        return out

    @staticmethod
    def _filter_face(face: Face, track: _EuroTrack, t_sec: float) -> Face:
        """Filters mesh + iris x/y (z passes through); detection box and
        keypoints are not filtered; presence and blendshape scores are
        preserved (`main.dart:3820-3868`)."""
        if face.mesh is None:
            return face
        mesh_pts = np.array(face.mesh.points, np.float64, copy=True)
        mesh_pts[:, :2] = track.mesh_f.filter(mesh_pts[:, :2], t_sec)
        iris = np.array(face.iris_points, np.float64, copy=True)
        if len(iris):
            iris[:, :2] = track.iris_f.filter(iris[:, :2], t_sec)
        return Face(
            detection=face.detection_data,
            mesh=FaceMesh(mesh_pts, score=face.mesh.score),
            irises=iris,
            original_size=face.original_size,
            blendshape_scores=(face.blendshapes.scores
                               if face.blendshapes is not None else None),
            tracking_id=face.tracking_id, embedding=face.embedding)

    def reset(self) -> None:
        self._state.clear()
        self._missed.clear()
        self._tracks.clear()
        self._frame = 0
