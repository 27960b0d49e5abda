#!/usr/bin/env python
"""HTTP serving entry point of the PyTorch port — alias for
`fdt-torch serve` (`python -m face_detection_tflite_torch serve`).

The port's counterpart of `tools/serve.py`: the implementation lives in
`face_detection_tflite_torch/cli.py`.  Accepts the same flags as
`fdt-torch serve`, plus the legacy `--model short` spelling.  Runs on
the CUDA card; `FDT_FORCE_CPU=1` asks for the CPU.

    python tools/serve_torch.py --port 8080 --mode-warmup 1280x853 \
        --precision serving
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(args=None) -> int:
    argv = ["serve"] + list(sys.argv[1:] if args is None else args)
    for i, a in enumerate(argv):  # legacy spelling from the old tool
        if a == "short" and i > 0 and argv[i - 1] == "--model":
            argv[i] = "short_range"
    from face_detection_tflite_torch.cli import main as cli_main
    return cli_main(argv)


if __name__ == "__main__":
    sys.exit(main())
