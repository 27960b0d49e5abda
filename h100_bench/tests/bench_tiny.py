"""Tiny cells for the CPU tests: the manifest's cells (or a cell a test
defines) with one block a network stage and small frames, run through
the whole harness on the CPU (the look for a card skipped)."""

from __future__ import annotations

import copy
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import torch  # noqa: E402

from h100_bench.harness import manifest, runner  # noqa: E402


def tiny(cell: dict) -> dict:
    """``cell`` at a test size: one block a network stage (``blocks``,
    ``blocks_per_stage``, and the last entry of each of a segmenter's
    ``stages``), 120x180 frames, small pools and batches."""
    cfg = copy.deepcopy(cell["config"])
    for spec in cfg["networks"].values():
        for key in ("blocks_per_stage", "blocks"):
            if spec and isinstance(spec.get(key), int):
                spec[key] = 1
        if spec and "stages" in spec:
            spec["stages"] = [list(s[:-1]) + [1] for s in spec["stages"]]
    mix = copy.deepcopy(cell["mix"])
    mix["frames"].update(height=120, width=180,
                         count=48 if "pool" in mix else 8)
    if "pool" in mix:
        mix["pool"] = 8
    if "batch" in mix:
        mix["batch"] = 4
    mix["check_units"] = 2
    return dict(cell, config=cfg, mix=mix)


def tiny_cell(workload: str) -> dict:
    return tiny(manifest.cell(manifest.load_manifest(), workload))


def run_tiny(workload, seconds: float = 1.5, seed: int = 2 ** 31 + 5):
    """A tiny run of the manifest's cell ``workload``, or of a cell dict
    (already at its test size)."""
    torch.set_num_threads(2)
    cell = tiny_cell(workload) if isinstance(workload, str) else workload
    return runner.run(cell["workload"]["name"], seed, seconds, False,
                      torch.device("cpu"), time.perf_counter(), cell)
