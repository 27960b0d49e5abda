#!/usr/bin/env python3
"""The control of the correctness check: the plain reference computed one
precision below the configurations' (fp32 with TF32 off), with every
convolution's and fully-connected layer's operands rounded to TF32, put
in the program's place and compared with the fp32 reference by the
benchmark's own comparison.  Its readings bound each limit from above
(``limits/<cell>.json``; PERF.md gives them).

    python3 h100_bench/control.py --workload <cell> --seeds 1,2,3

It runs a cell's set-up without the program (weights, frames,
calibration), draws as many frames as one run compares, and prints one
JSON line a seed.  The benchmark's own runs do not run it.
"""

from __future__ import annotations

import argparse
import json
import os
import random
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def as_program(frame: dict, scale: float) -> list[dict]:
    """A reference frame's faces in the form the program's answers take:
    the landmarks through the int16 readback's rounding."""
    import numpy as np
    out = []
    for f in frame["faces"]:
        q = {k: np.round(f[k].astype(np.float64) * scale) / scale
             for k in ("mesh", "iris")}
        out.append({"box": f["box"].astype(np.float64), "score": f["score"],
                    "kp": f["kp"].astype(np.float64),
                    "mesh_score": f["mesh_score"],
                    "bs": None if f["bs"] is None else f["bs"].astype(
                        np.float64),
                    "angles": f["angles"].astype(np.float64),
                    "emb": None if f["emb"] is None else f["emb"].astype(
                        np.float64), **q})
    return out


def readings(cell: dict, seed: int, device, operands) -> dict:
    """The comparison's numbers of ``operands``' reference against the
    fp32 reference on the frames a run of ``cell`` compares."""
    import torch

    from h100_bench.harness import check, drive
    mix = cell["mix"]
    setup = drive.Setup(cell["config"], mix, seed, device, program=False)
    n = len(setup.frames)
    units = mix["check_units"] + 1
    rng = random.Random(seed)
    picks = sorted({rng.randrange(n) for _ in range(units * mix.get(
        "batch", 1))})
    frames = torch.from_numpy(setup.frames[picks]).to(device)
    ref = drive.reference(cell["config"], setup.nets, device)
    with torch.inference_mode():
        want = ref(frames)
        got = ref(frames, operands)
    h, w = setup.frames.shape[1:3]
    scale = check.readback_scale(h, w)
    res = check.compare([(as_program(g, scale), r) for g, r in
                         zip(got, want)], h, w)
    return {"seed": seed, **res}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    args = p.parse_args(argv)
    import torch

    from h100_bench.harness import manifest
    from h100_bench.reference.interp import round_tf32
    device = (torch.device("cuda", 0) if torch.cuda.is_available()
              else torch.device("cpu"))
    cell = manifest.cell(manifest.load_manifest(), args.workload)
    for s in args.seeds.split(","):
        r = readings(cell, int(s), device, round_tf32)
        print(json.dumps({"workload": args.workload, **r}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
