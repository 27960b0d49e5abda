"""`python -m face_detection_tflite_torch` — see :mod:`.cli`."""

from .cli import main

if __name__ == "__main__":
    raise SystemExit(main())
