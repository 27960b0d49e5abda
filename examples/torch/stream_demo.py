#!/usr/bin/env python
"""Streaming demo of the PyTorch port: FrameThrottle + FpsCounter +
temporal tracking.

The port's counterpart of ``examples/stream_demo.py``: a simulated camera
produces jittered copies of one photo faster than the detector consumes
them (the reference's live-camera scenario); stale frames drop, fresh
frames are detected on the CUDA card (``FDT_FORCE_CPU=1`` for the CPU),
tracked IDs stay stable.  The detector comes from the command line's
seam (``face_detection_tflite_torch.cli._make_detector``).

    python examples/torch/stream_demo.py photo.jpg [--frames 40]
"""

import argparse
import os
import sys
import threading
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("image", help="photo the simulated camera jitters")
    ap.add_argument("--frames", type=int, default=40,
                    help="frames the camera produces (at ~60 fps)")
    ap.add_argument("--model-dir", default=None)
    args = ap.parse_args(argv)

    from face_detection_tflite_torch.utils.backend import ensure_backend
    ensure_backend()
    from face_detection_tflite_torch import (FaceDetectionMode, FpsCounter,
                                             FrameThrottle, cli)
    from face_detection_tflite_torch.utils.image import load_image

    base = load_image(args.image)
    det = cli._make_detector(args, enable_tracking=True)
    det.detect_faces(base, FaceDetectionMode.STANDARD)  # kernels, cuDNN
    det.reset_tracking()

    throttle = FrameThrottle(maxlen=1)

    def camera():
        rng = np.random.default_rng(0)
        for i in range(args.frames):
            frame = np.roll(base, int(rng.integers(-8, 8)), axis=1)
            try:
                throttle.submit((i, frame))
            except RuntimeError:
                return
            time.sleep(1 / 60)
        throttle.close()

    producer = threading.Thread(target=camera)
    producer.start()
    fps = FpsCounter()
    processed = 0
    ids = set()
    while True:
        item = throttle.take(timeout=2.0)
        if item is None:
            break
        idx, frame = item
        faces = det.detect_faces(frame, FaceDetectionMode.STANDARD)
        processed += 1
        rate = fps.tick()
        ids.update(f.tracking_id for f in faces)
        print(f"frame {idx:3d}: {len(faces)} face(s) "
              f"id={[f.tracking_id for f in faces]} fps={rate:.1f}",
              flush=True)
    producer.join()
    print(f"\nprocessed {processed}/{throttle.submitted} frames "
          f"({throttle.dropped} dropped by the throttle), tracking ids: "
          f"{sorted(ids)}")
    print("stage timings:", det.timings.report())
    det.dispose()
    return 0


if __name__ == "__main__":
    sys.exit(main())
