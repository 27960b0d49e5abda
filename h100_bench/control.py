#!/usr/bin/env python3
"""The control of the correctness check: the plain references computed
one precision below the configurations' (fp32 with TF32 off), with every
convolution's (transposed ones too) and fully-connected layer's operands
rounded to TF32, put in the program's place in the form of its answers
(through its readbacks' rounding) and compared with the fp32 references
by each of the configuration's checks.  Its readings bound each limit
from above (``limits/<cell>.json``; PERF.md gives them).

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


def readings(cell: dict, seed: int, device, operands) -> dict:
    """Each check's comparison of ``operands``' references (every check's
    own: the face pipeline, the segmenter) against the fp32 references,
    in the program's place, on the frames a run of ``cell`` compares:
    ``{"seed", "results": {check: compare(...)}}``."""
    import torch

    from h100_bench.harness import check, drive
    config, mix = cell["config"], cell["mix"]
    setup = drive.Setup(config, mix, seed, device, program=False)
    n = len(setup.frames)
    units = mix["check_units"] + 1
    rng = random.Random(seed)
    picks = sorted({rng.randrange(n) for _ in range(units * mix.get(
        "batch", 1))})
    frames = torch.from_numpy(setup.frames[picks]).to(device)
    hw = setup.frames.shape[1:3]
    results = {}
    for name, mod in check.modules(config):
        ref = mod.reference(config, setup.nets, device)
        with torch.inference_mode():
            want = ref(frames)
            got = ref(frames, operands)
        results[name] = mod.compare([(mod.as_program(g, hw, config), r)
                                     for g, r in zip(got, want)], hw, config)
    return {"seed": seed, "results": results}


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
        print(json.dumps({"workload": args.workload, "seed": r["seed"],
                          **{name: {k: res[k] for k in ("numbers", "counts")}
                             for name, res in r["results"].items()}}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
