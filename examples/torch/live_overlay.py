#!/usr/bin/env python
"""Live camera overlay demo of the PyTorch port (the reference's
FaceDetectionCameraOverlay).

The port's counterpart of ``examples/live_overlay.py``: a simulated
camera stream (jittered copies of one photo), detection and segmentation
per frame on the CUDA card (``FDT_FORCE_CPU=1`` for the CPU), and the
widget's layer stack (``render.compose_camera_overlay``): a virtual
background or the segmentation tint, boxes, contours and irises, per-face
info cards and a performance badge; written as an animated GIF.  The
detector comes from the command line's seam
(``face_detection_tflite_torch.cli._make_detector``).

    python examples/torch/live_overlay.py photo.jpg [--out out.gif]
        [--virtual-bg] [--frames 12]
"""

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("image", help="photo the simulated camera jitters")
    ap.add_argument("--out", default="live_overlay_out.gif")
    ap.add_argument("--virtual-bg", action="store_true",
                    help="replace the background with a gradient")
    ap.add_argument("--frames", type=int, default=12)
    ap.add_argument("--model-dir", default=None)
    args = ap.parse_args(argv)

    from face_detection_tflite_torch.utils.backend import ensure_backend
    ensure_backend()
    from PIL import Image

    from face_detection_tflite_torch import FaceDetectionMode, cli
    from face_detection_tflite_torch.utils.image import load_image
    from face_detection_tflite_torch.utils.render import \
        compose_camera_overlay

    base = load_image(args.image)
    det = cli._make_detector(args, with_segmentation=True,
                             enable_tracking=True)
    det.detect_faces(base, FaceDetectionMode.FULL)  # kernels, cuDNN
    det.reset_tracking()
    background = None
    if args.virtual_bg:
        h, w = base.shape[:2]
        yy = np.linspace(0, 1, h)[:, None, None]
        background = (np.asarray([80, 160, 230]) * (1 - yy)
                      + np.asarray([230, 200, 120]) * yy).astype(np.uint8)
        background = np.broadcast_to(background, (h, w, 3)).copy()

    rng = np.random.default_rng(0)
    frames = []
    for i in range(args.frames):
        frame = np.roll(base, int(rng.integers(-10, 10)), axis=1)
        t0 = time.perf_counter()
        faces, mask = det.detect_faces_with_segmentation(
            frame, mode=FaceDetectionMode.FULL)
        ms = (time.perf_counter() - t0) * 1e3
        out = compose_camera_overlay(
            frame, faces, mask=mask, virtual_background=background,
            show_segmentation=True, show_pose_and_scores=True,
            show_classification=True, detect_ms=ms)
        frames.append(Image.fromarray(out))
        print(f"frame {i:2d}: {len(faces)} face(s) "
              f"ids={[f.tracking_id for f in faces]} {ms:6.1f} ms")
    frames[0].save(args.out, save_all=True, append_images=frames[1:],
                   duration=120, loop=0)
    print(f"wrote {args.out} ({len(frames)} frames)")
    det.dispose()
    return 0


if __name__ == "__main__":
    sys.exit(main())
