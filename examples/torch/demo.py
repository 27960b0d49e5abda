#!/usr/bin/env python
"""Demo of the PyTorch port: the FULL face pipeline and the person mask on
one photo, drawn into an output image.

The port's counterpart of ``examples/demo.py``: detect -> mesh -> iris ->
blendshapes -> pose, plus the selfie segmentation, on the CUDA card
(``FDT_FORCE_CPU=1`` for the CPU).  The detector comes from the command
line's seam (``face_detection_tflite_torch.cli._make_detector``), so the
networks are the ``.tflite`` files of ``--model-dir`` (or
``FDT_TPU_MODEL_DIR``), or whatever a caller installs there.

    python examples/torch/demo.py photo.jpg [--out demo_out.png]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


def _fmt(v, spec=".2f"):
    return format(v, spec) if v is not None else "n/a"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("image", help="input photo")
    ap.add_argument("--out", default="demo_out.png")
    ap.add_argument("--model-dir", default=None)
    ap.add_argument("--max-dim", type=int, default=1536,
                    help="downscale the longer side to this first")
    args = ap.parse_args(argv)

    from face_detection_tflite_torch.utils.backend import ensure_backend
    ensure_backend()
    from PIL import Image

    from face_detection_tflite_torch import cli
    from face_detection_tflite_torch.utils.image import fit_max_dim, load_image
    from face_detection_tflite_torch.utils.render import annotate

    det = cli._make_detector(args, with_segmentation=True)
    img = load_image(args.image)
    h, w = img.shape[:2]
    img = fit_max_dim(img, args.max_dim)
    if img.shape[:2] != (h, w):
        print(f"downscaled {w}x{h} -> {img.shape[1]}x{img.shape[0]}")
    faces, mask = det.detect_faces_with_segmentation(img)
    print(f"{len(faces)} face(s) in {args.image} "
          f"[{det.accelerator_report['detector']}]")
    for i, f in enumerate(faces):
        a = f.head_euler_angles
        print(f"  face {i}: score={f.score:.3f} "
              f"mesh={_fmt(f.mesh_score, '.3f')} "
              f"smile={_fmt(f.smiling_probability)} "
              f"eyes L{_fmt(f.left_eye_open_probability)}"
              f"/R{_fmt(f.right_eye_open_probability)} "
              f"pose=({a.x:.1f},{a.y:.1f},{a.z:.1f})deg")
    print("stage timings:", det.timings.report())
    Image.fromarray(annotate(img, faces, mask)).save(args.out)
    print(f"annotated image -> {args.out}")
    det.dispose()
    return 0


if __name__ == "__main__":
    sys.exit(main())
