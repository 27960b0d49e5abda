"""Temporal face tracker — stateful host-side ID association.

Port of `lib/src/shared/face_tracker.dart` (TemporalFaceTracker).  Tracking
is inherently sequential per-stream state, so it stays on the host (the
reference reaches the same conclusion for its isolates; see SURVEY §2.4).
Operates purely on normalized detector boxes — geometric association, not
identity recognition.  A copy of the JAX package's module, in plain Python
floats in both packages, so that candidate order and ties (and with them
the IDs) are the same.

Matching (face_tracker.dart:62-180): globally score-ordered greedy
assignment; score = 0.65*IoU + 0.25*proximity + 0.10*scaleSimilarity;
admission = predicted-vs-observed center distance <= (1.5 + 0.25*missed)
average diagonals, scale similarity >= 0.25; constant-velocity prediction
with EMA velocity 0.6/0.4 (first hit snaps); tracks retire after
maxMissedFrames consecutive processed frames without a match.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

from .config import DEFAULT_MAX_MISSED_FRAMES

__all__ = ["TemporalFaceTracker", "validate_tracking_config"]


def validate_tracking_config(max_missed_frames: int) -> None:
    """Fail-fast config check (`face_tracker.dart:11-19`)."""
    if max_missed_frames < 0:
        raise ValueError("max_missed_frames must be zero or greater")


@dataclasses.dataclass
class _TrackBox:
    xmin: float
    ymin: float
    xmax: float
    ymax: float

    @property
    def width(self):
        return self.xmax - self.xmin

    @property
    def height(self):
        return self.ymax - self.ymin

    @property
    def area(self):
        return self.width * self.height

    @property
    def center(self):
        return ((self.xmin + self.xmax) * 0.5, (self.ymin + self.ymax) * 0.5)

    @property
    def diagonal(self):
        return math.hypot(self.width, self.height)

    @property
    def is_valid(self):
        return (all(math.isfinite(v) for v in
                    (self.xmin, self.ymin, self.xmax, self.ymax))
                and self.width > 0.0 and self.height > 0.0)

    def shifted(self, dx, dy):
        return _TrackBox(self.xmin + dx, self.ymin + dy,
                         self.xmax + dx, self.ymax + dy)

    def iou(self, other: "_TrackBox") -> float:
        iw = max(0.0, min(self.xmax, other.xmax) - max(self.xmin, other.xmin))
        ih = max(0.0, min(self.ymax, other.ymax) - max(self.ymin, other.ymin))
        inter = iw * ih
        union = self.area + other.area - inter
        return inter / union if union > 0.0 else 0.0


class _FaceTrack:
    def __init__(self, track_id: int, box: _TrackBox):
        self.id = track_id
        self.box = box
        self.velocity = (0.0, 0.0)
        self.missed_frames = 0
        self.hits = 1

    @property
    def predicted_box(self) -> _TrackBox:
        k = self.missed_frames + 1
        return self.box.shifted(self.velocity[0] * k, self.velocity[1] * k)

    def match(self, observed: _TrackBox) -> None:
        elapsed = self.missed_frames + 1
        ocx, ocy = observed.center
        cx, cy = self.box.center
        ovx = (ocx - cx) / elapsed
        ovy = (ocy - cy) / elapsed
        if self.hits == 1:
            self.velocity = (ovx, ovy)
        else:
            self.velocity = (self.velocity[0] * 0.6 + ovx * 0.4,
                             self.velocity[1] * 0.6 + ovy * 0.4)
        self.box = observed
        self.missed_frames = 0
        self.hits += 1


class TemporalFaceTracker:
    """Assigns stable integer IDs to face boxes across processed frames."""

    def __init__(self, max_missed_frames: int = DEFAULT_MAX_MISSED_FRAMES,
                 max_normalized_center_distance: float = 1.5,
                 min_scale_similarity: float = 0.25):
        validate_tracking_config(max_missed_frames)
        if max_normalized_center_distance < 1.0:
            raise ValueError("max_normalized_center_distance must be >= 1")
        if not 0.0 <= min_scale_similarity <= 1.0:
            raise ValueError("min_scale_similarity must be in [0, 1]")
        self.max_missed_frames = max_missed_frames
        self.max_normalized_center_distance = max_normalized_center_distance
        self.min_scale_similarity = min_scale_similarity
        self._tracks: dict[int, _FaceTrack] = {}
        self._next_id = 1

    def update(self, boxes: Sequence[Sequence[float]]) -> list[int]:
        """Associates normalized (xmin, ymin, xmax, ymax) boxes with tracks.

        Returns one tracking ID per input box, input order preserved.
        """
        tboxes = [_TrackBox(*map(float, b)) for b in boxes]
        candidates = []
        for track in self._tracks.values():
            for di, det in enumerate(tboxes):
                c = self._candidate(track, di, det)
                if c is not None:
                    candidates.append(c)

        # Global score ordering, deterministic ties (track id, det index).
        candidates.sort(key=lambda c: (-c[0], c[1].id, c[2]))

        matched_tracks: set[int] = set()
        matched_dets: set[int] = set()
        assignments: list[Optional[int]] = [None] * len(tboxes)
        for score, track, di in candidates:
            if track.id in matched_tracks or di in matched_dets:
                continue
            track.match(tboxes[di])
            matched_tracks.add(track.id)
            matched_dets.add(di)
            assignments[di] = track.id

        for track in self._tracks.values():
            if track.id not in matched_tracks:
                track.missed_frames += 1
        self._tracks = {tid: t for tid, t in self._tracks.items()
                        if t.missed_frames <= self.max_missed_frames}

        for i in range(len(tboxes)):
            if assignments[i] is None:
                tid = self._next_id
                self._next_id += 1
                self._tracks[tid] = _FaceTrack(tid, tboxes[i])
                assignments[i] = tid
        return assignments  # type: ignore[return-value]

    def _candidate(self, track: _FaceTrack, det_index: int, det: _TrackBox):
        predicted = track.predicted_box
        if not predicted.is_valid or not det.is_valid:
            return None
        max_area = max(predicted.area, det.area)
        scale_sim = (min(predicted.area, det.area) / max_area
                     if max_area else 0.0)
        if scale_sim < self.min_scale_similarity:
            return None
        iou = predicted.iou(det)
        pcx, pcy = predicted.center
        dcx, dcy = det.center
        center_dist = math.hypot(pcx - dcx, pcy - dcy)
        ref_diag = max(0.05, (predicted.diagonal + det.diagonal) * 0.5)
        norm_dist = center_dist / ref_diag
        limit = (self.max_normalized_center_distance
                 + track.missed_frames * 0.25)
        if norm_dist > limit:
            return None
        proximity = min(max(1.0 - norm_dist / limit, 0.0), 1.0)
        score = iou * 0.65 + proximity * 0.25 + scale_sim * 0.10
        return (score, track, det_index)

    def reset(self) -> None:
        """Drops all temporal state; ID allocation restarts at 1."""
        self._tracks.clear()
        self._next_id = 1

    @property
    def active_track_count(self) -> int:
        return len(self._tracks)
