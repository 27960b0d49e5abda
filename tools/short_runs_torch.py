#!/usr/bin/env python
"""Times the short runs a user of the PyTorch port waits for, on one card:
phase 8a of ``chip_smoke.py`` (a seeded 32-frame 720p clip through
``detect_faces_from_video`` on a fresh detector, 4 batches of 8) and
phase 11 (``detect --json`` on two 853x1280 PNGs, a detector per
command), on the main path's seeded full-depth networks.

    python tools/short_runs_torch.py [TREE]

``TREE`` is the root of a checkout whose ``chip_smoke.py`` and package are
run (this repository's by default), so that two trees can be timed in
turns in one call on one card (parent, change, change, parent), each in a
process of its own.  It prints the phases' own lines and then one line
``short runs <tree> <card> {json}``: frames/s of the clip and of
``detect_faces_batch`` alone, ms an image of ``detect --json``, of
``detect_faces`` alone and of the PNG decode, and (where the tree reports
them) the program keys each path captured and left pending.  It needs a
CUDA card: there is no CPU fallback.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    tree = os.path.abspath(argv[0] if argv else
                           os.path.dirname(os.path.dirname(
                               os.path.abspath(__file__))))
    sys.path.insert(0, tree)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("short_runs_torch: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    import chip_smoke as cs
    from face_detection_tflite_torch.kernels import build
    from face_detection_tflite_torch.models import random_init
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60, check=True
                          ).stdout.strip().splitlines()[0]
    build.load()
    frames_np = np.random.default_rng(cs.SEED).integers(
        0, 256, (cs.FRAMES, cs.HEIGHT, cs.WIDTH, 3), dtype=np.uint8)
    frames = torch.from_numpy(frames_np).to("cuda")
    models = random_init.random_pipeline_models(frames, seed=cs.SEED)[0]
    video = cs._video_phase(frames, card)
    cli = cs._cli_phase(models, frames_np, video, card)
    print(f"short runs {tree} {card} " + json.dumps({
        "video_fps": video["video_fps"], "batch_fps": video["batch_fps"],
        "detect_ms": cli["detect_ms"], "api_ms": cli["api_ms"],
        "decode_ms": cli["decode_ms"], "video_graphs": video.get("graphs"),
        "cli_graphs": cli.get("graphs")}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
