#!/usr/bin/env python
"""Demo of the PyTorch port: an AR lipstick overlay from the named lip
contours.

The port's counterpart of ``examples/lipstick_demo.py`` (the reference
app's lipstick preview): the FULL mesh on the CUDA card
(``FDT_FORCE_CPU=1`` for the CPU) -> two lip rings (outer flesh, mouth
opening) -> winding-aware dilation -> Catmull-Rom smoothing -> even-odd
fill -> a ``BlendMode.color`` tint that keeps the skin's luminance.  The
detector comes from the command line's seam
(``face_detection_tflite_torch.cli._make_detector``).

    python examples/torch/lipstick_demo.py photo.jpg [--out lipstick_out.png]
        [--color RRGGBB]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("image", help="input photo")
    ap.add_argument("--out", default="lipstick_out.png")
    ap.add_argument("--color", default=None, metavar="RRGGBB")
    ap.add_argument("--model-dir", default=None)
    ap.add_argument("--max-dim", type=int, default=1536)
    args = ap.parse_args(argv)

    from face_detection_tflite_torch.utils.backend import ensure_backend
    ensure_backend()
    from PIL import Image

    from face_detection_tflite_torch import FaceDetectionMode, cli
    from face_detection_tflite_torch.utils.image import fit_max_dim, load_image
    from face_detection_tflite_torch.utils.render import (LIPSTICK_COLOR,
                                                          draw_lipstick)

    color = (tuple(int(args.color[i:i + 2], 16) for i in (0, 2, 4))
             if args.color else LIPSTICK_COLOR)
    det = cli._make_detector(args)
    img = fit_max_dim(load_image(args.image), args.max_dim)
    faces = det.detect_faces(img, FaceDetectionMode.FULL)
    print(f"{len(faces)} face(s) in {args.image}; painting lips "
          f"#{color[0]:02X}{color[1]:02X}{color[2]:02X}")
    Image.fromarray(draw_lipstick(img, faces, color=color)).save(args.out)
    print(f"wrote {args.out}")
    det.dispose()
    return 0


if __name__ == "__main__":
    sys.exit(main())
