"""``single``: ``FaceDetector.detect_faces(frame, mode)``, one frame of the
pool a call, one caller (a closed loop).  A unit is one call; its
latency runs from the call to its faces."""

from __future__ import annotations

import time


def run(setup, due, inputs, sample) -> dict:
    ends, lat, units = [], [], []
    k = 0
    while due(k):
        x, idx = next(inputs)
        t0 = time.perf_counter()
        faces = setup.detector.detect_faces(x[0], setup.mode)
        ends.append(time.perf_counter())
        lat.append(ends[-1] - t0)
        units.append((idx, [len(faces)]))
        if sample is not None:
            sample.offer(k, (idx, [faces]))
        k += 1
    return {"ends": ends, "latencies": lat, "units": units}
