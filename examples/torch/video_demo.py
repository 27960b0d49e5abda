#!/usr/bin/env python
"""Video-file demo of the PyTorch port: batched detection, tracking and
smoothing, written as an annotated copy.

The port's counterpart of ``examples/video_demo.py``: frames decoded on a
host thread, detected in batches on the CUDA card (``FDT_FORCE_CPU=1``
for the CPU), tracked, EMA-smoothed and drawn.  The detector comes from
the command line's seam (``face_detection_tflite_torch.cli.
_make_detector``).

    python examples/torch/video_demo.py input.mp4 [--out annotated.mp4]
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("video", help="input video file")
    ap.add_argument("--out", default="annotated.mp4")
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--model-dir", default=None)
    args = ap.parse_args(argv)

    import cv2
    cap = cv2.VideoCapture(args.video)
    if not cap.isOpened():
        sys.exit(f"cannot open {args.video}")
    fps = cap.get(cv2.CAP_PROP_FPS) or 30.0
    w = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH))
    h = int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
    cap.release()
    if w <= 0 or h <= 0:
        sys.exit(f"{args.video}: the container reports {w}x{h} frames")

    from face_detection_tflite_torch.utils.backend import ensure_backend
    ensure_backend()
    from face_detection_tflite_torch import (FaceDetectionMode, FaceSmoother,
                                             cli)
    from face_detection_tflite_torch.utils.render import annotate

    det = cli._make_detector(args, enable_tracking=True)
    smoother = FaceSmoother(alpha=0.5)
    writer = cv2.VideoWriter(args.out, cv2.VideoWriter_fourcc(*"mp4v"), fps,
                             (w, h))
    if not writer.isOpened():
        sys.exit(f"cannot open a video writer for {args.out} (no mp4v "
                 "encoder?)")
    # Results come in frame order, so a second capture reads the frames
    # in step with them: O(1) memory.
    cap = cv2.VideoCapture(args.video)
    frame_idx, frame = -1, None

    def frame_at(i):
        nonlocal frame_idx, frame
        while frame_idx < i:
            good, frame = cap.read()
            if not good:
                raise RuntimeError(f"frame {i} unreadable on second pass")
            frame_idx += 1
        return frame

    try:
        for result in det.detect_faces_from_video(
                args.video, FaceDetectionMode.FULL,
                batch_size=args.batch_size):
            faces = smoother.smooth(result.faces, t_sec=result.timestamp_s)
            rgb = frame_at(result.frame_index)[..., ::-1]
            out = annotate(np.ascontiguousarray(rgb), faces)
            writer.write(np.ascontiguousarray(out[..., ::-1]))
            if result.frame_index % 24 == 0:
                print(f"frame {result.frame_index}: {len(faces)} faces, "
                      f"ids={[f.tracking_id for f in faces]}")
    finally:
        cap.release()
        writer.release()
    print(f"wrote {args.out}")
    det.dispose()
    return 0


if __name__ == "__main__":
    sys.exit(main())
