"""``segment_pipeline``: ``ServingPipeline(detector, mode, depth=...,
with_segmentation=True)`` over host batches of the mix's ``batch`` frames
cycled through the pool.  One caller submits the batches and takes the
futures in submit order, with at most ``2 * depth + 1`` batches
submitted and not yet taken (the most the pipeline holds alive: ``depth``
queued, ``depth + 1`` on the device), so a closed loop.  The caller's
thread uploads each batch; the pipeline's worker queues the segmenter and
the detection of the next batch before this one's readbacks block.  A
unit is one batch; a frame's answer is ``{"faces": [...], "mask":
MulticlassSegmentationMask}``.  The pipeline is closed at the loop's
end."""

from __future__ import annotations

import collections
import time

from face_detection_tflite_torch.pipeline.serving import ServingPipeline


def run(setup, due, inputs, sample) -> dict:
    depth = setup.mix["depth"]
    ends, units = [], []
    futures: collections.deque = collections.deque()

    def take():
        k, idx, fut = futures.popleft()
        out = fut.result()
        ends.append(time.perf_counter())
        units.append((idx, [len(faces) for faces, _ in out]))
        if sample is not None:
            sample.offer(k, (idx, [{"faces": faces, "mask": mask}
                                   for faces, mask in out]))

    pipe = ServingPipeline(setup.detector, setup.mode, depth=depth,
                           with_segmentation=True)
    try:
        k = 0
        while due(k):
            x, idx = next(inputs)
            futures.append((k, idx, pipe.submit(x)))
            k += 1
            if len(futures) > 2 * depth:
                take()
        while futures:
            take()
    finally:
        pipe.close()
    return {"ends": ends, "latencies": [], "units": units}
