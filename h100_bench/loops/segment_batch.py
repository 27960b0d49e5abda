"""``segment_batch``: ``FaceDetector.detect_faces_with_segmentation_batch(
frames, mode)`` on host batches of the mix's ``batch`` frames cycled
through the pool, one caller, one batch at a time (a closed loop).  A
unit is one batch; a frame's answer is ``{"faces": [...], "mask":
SegmentationMask}``."""

from __future__ import annotations

import time


def run(setup, due, inputs, sample) -> dict:
    ends, units = [], []
    k = 0
    while due(k):
        x, idx = next(inputs)
        out = setup.detector.detect_faces_with_segmentation_batch(
            x, setup.mode)
        ends.append(time.perf_counter())
        units.append((idx, [len(faces) for faces, _ in out]))
        if sample is not None:
            sample.offer(k, (idx, [{"faces": faces, "mask": mask}
                                   for faces, mask in out]))
        k += 1
    return {"ends": ends, "latencies": [], "units": units}
