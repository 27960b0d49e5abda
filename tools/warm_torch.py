#!/usr/bin/env python
"""Warms the PyTorch port before serving: builds the CUDA kernels and
captures the CUDA graph of each program key of the benchmark bucket.

The port's counterpart of ``tools/warm_tpu.py``.  The port keeps no
compile cache (PyTorch runs eagerly), so "warm" means two things here:

1. build K1 (``csrc/nms.cu``) and K2 (``csrc/warp.cu``) into the
   package's ``kernels/_build/`` (``kernels/build.py::build``), so that a
   later process loads them at once instead of running ``nvcc``;
2. run ``FaceDetector.warmup`` for each program key of the benchmark
   bucket (853x1280, the BACK_CAMERA detector): FAST, STANDARD and FULL at
   the batch size (with the adaptive modes' overflow face-stage program),
   then STANDARD at each size of the batch ladder 1, 2, 4 and 8 that the
   HTTP micro-batcher drains into.  ``warmup`` runs under
   ``pipeline.graphs.capture_now()``, so each key runs once eagerly and
   is captured on that call, where a key met later is captured only once
   it repeats.

    python tools/warm_torch.py [--batch 16]

Run as a script, only step 1 outlasts the process: the first calls and
the CUDA graphs of step 2 (cuDNN's algorithm choice, the allocator's
pool, the graph pool) belong to the process that makes them.  They spare a server its first calls only where
:func:`warm` runs inside the serving process, on its own detector.

It prints each step's seconds.  There is no CPU fallback: without a
usable CUDA card (or with ``FDT_FORCE_CPU`` set) it exits 1.  The JAX
tool's ``--demo`` bucket and its entry program have no counterpart.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

#: The benchmark bucket: one 853x1280 frame.
BENCH_SHAPE = (853, 1280, 3)
#: The micro-batcher's smaller STANDARD batch sizes.
LADDER = (1, 2, 4, 8)


def log(*a):
    print(*a, flush=True)


def warm(detector, batch: int = 16, shape: tuple = BENCH_SHAPE
         ) -> list[tuple[str, float]]:
    """Builds the kernels, then runs ``detector.warmup`` for each program
    key of ``shape`` (module docstring).  Returns (label, seconds) of each
    step, in order."""
    from face_detection_tflite_torch import FaceDetectionMode
    from face_detection_tflite_torch.kernels import build

    steps = []

    def step(label, fn):
        t0 = time.perf_counter()
        fn()
        steps.append((label, time.perf_counter() - t0))
        log(f"{label}: {steps[-1][1]:.2f}s")

    step("kernels build", build.build)
    step(f"bench fast, standard, full b={batch}",
         lambda: detector.warmup(shape, batch))
    for b in LADDER:
        if b < batch:
            step(f"bucket standard b={b}",
                 lambda b=b: detector.warmup(
                     shape, b, [FaceDetectionMode.STANDARD]))
    return steps


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int,
                    default=int(os.environ.get("FDT_BENCH_BATCH", "16")))
    args = ap.parse_args(argv)

    from face_detection_tflite_torch.utils.backend import (
        BackendUnavailable, ensure_backend, force_cpu)
    if force_cpu():
        print("warm_torch: FDT_FORCE_CPU is set, but warming builds the "
              "CUDA kernels and runs the card's first calls; there is "
              "nothing to warm on the CPU", file=sys.stderr)
        return 1
    try:
        ensure_backend()
    except BackendUnavailable as e:
        print(f"warm_torch: {e}", file=sys.stderr)
        return 1

    from face_detection_tflite_torch import FaceDetectionModel, FaceDetector
    from face_detection_tflite_torch.pipeline.detector import \
        resolve_model_dir
    try:
        d = resolve_model_dir()
    except FileNotFoundError as e:
        print(f"warm_torch: {e}", file=sys.stderr)
        return 1
    import torch
    log(f"device: {torch.cuda.get_device_name(0)}")
    t_all = time.perf_counter()
    det = FaceDetector(model=FaceDetectionModel.BACK_CAMERA, max_faces=16,
                       model_dir=d,
                       precision=os.environ.get("FDT_BENCH_PRECISION",
                                                "high"))
    warm(det, args.batch)
    det.dispose()
    log(f"warm done in {time.perf_counter() - t_all:.1f}s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
