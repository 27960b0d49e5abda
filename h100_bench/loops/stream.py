"""``stream``: ``FaceDetector.detect_faces_batch_stream(batches, mode,
depth=...)`` over host batches of the mix's ``batch`` frames cycled
through the pool, one caller with the mix's ``depth`` batches in flight
(a closed loop).  A unit is one batch."""

from __future__ import annotations

import time


def run(setup, due, inputs, sample) -> dict:
    ends, units, order = [], [], []

    def feed():
        k = 0
        while due(k):
            x, idx = next(inputs)
            order.append(idx)
            yield x
            k += 1

    for k, faces in enumerate(setup.detector.detect_faces_batch_stream(
            feed(), setup.mode, depth=setup.mix["depth"])):
        ends.append(time.perf_counter())
        units.append((order[k], [len(f) for f in faces]))
        if sample is not None:
            sample.offer(k, (order[k], faces))
    return {"ends": ends, "latencies": [], "units": units}
