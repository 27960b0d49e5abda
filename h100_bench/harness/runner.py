"""One run of a cell, from the seed to the result line.

Set-up (``setup_s``, from the process's start to the window's first
call, less the reference's share): the seeded weights and frames, the
program, and the warm-up on the cell's own traffic until no program key
is left to capture.  The detector's calibration (and, where the mix
picks its frames, the picking) runs the plain reference; its seconds are
reported as the part ``calibration`` and left out of ``setup_s``.  Then
the window: ``seconds`` of the cell's closed loop (``--trace 0``), or
``trace_units`` units under the profiler (``--trace 1``).  Then the
program is freed, and the configuration's checks hold a seeded sample
of the window's answers to the plain reference (``check.py``).
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from . import check, drive, manifest
from .trace import traced

#: Top-level module names that may not be loaded once the window closes.
FORBIDDEN = ("jax", "jaxlib", "flax", "face_detection_tflite_tpu")


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def snapshot(timings) -> dict:
    """{stage: (total ms, calls)} of a ``DetectTimings``, then reset."""
    out = {k: (timings.total_ms[k], timings.calls[k])
           for k in list(timings.total_ms)}
    timings.reset()
    return out


class Context:
    """What a per-layer metric's reader reads: the traced window, the
    program's own counters and the yardstick's counts."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def run(workload: str, seed: int, seconds: float, trace: bool, device,
        t0: float, cell: dict | None = None) -> tuple[dict, list[str]]:
    """The result line's object and the lines for standard error."""
    cell = cell or manifest.cell(manifest.load_manifest(), workload)
    config, mix = cell["config"], cell["mix"]
    started = time.perf_counter()
    setup = drive.Setup(config, mix, seed, device)
    before = setup.warm()
    setup.detector.timings.reset()
    sample = drive.Sample(mix["check_units"], seed)
    setup_s = time.perf_counter() - t0 - setup.parts["calibration"]
    b = mix.get("batch", 1)
    if trace:
        # The host's own stage times come from the same units run once
        # without the profiler, whose callbacks would slow every launch.
        drive.drive(setup, mix["trace_units"], None)
        timings = snapshot(setup.detector.timings)
        out, tr = traced(lambda: drive.drive(setup, mix["trace_units"], None,
                                             sample))
        window_s = tr.window_s
    else:
        start = time.perf_counter()
        out = drive.drive(setup, None, start + seconds, sample)
        window_s = seconds
        deadline = start + seconds
    if not trace:
        timings = snapshot(setup.detector.timings)
    after = setup.detector.memory_report()
    peak = (torch.cuda.max_memory_allocated(device)
            if torch.device(device).type == "cuda" else 0)
    found = forbidden_modules()
    if found:
        raise RuntimeError(f"modules loaded that the port may not use: "
                           f"{found}")
    drive.free(setup)
    # With the trace, K2's bytes need every traced frame's ROIs: the
    # reference runs over the whole pool.
    res = drive.check_outputs(setup, sample.chosen(),
                              check.load_limits(cell["workload"]["name"]),
                              whole_pool=trace)
    units = len(out["ends"]) if trace else sum(
        1 for t in out["ends"] if t <= deadline)
    frames = units * b
    metrics = {}
    if trace:
        ctx = Context(trace=tr, frames=frames, units=units, timings=timings,
                      memory_before=before, memory_after=after,
                      config=config, mix=mix, ref=res["ref"],
                      traced_units=out["units"], frame_hw=setup.frames.shape[1:3],
                      device=device)
        for m in cell["per_layer"]:
            v = manifest.reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        values = {"frames_per_s": frames / window_s, "setup_s": setup_s}
        if out["latencies"]:
            lat = [x for x, t in zip(out["latencies"], out["ends"])
                   if t - x <= deadline]
            values["frame_p95_ms"] = float(np.percentile(lat, 95)) * 1e3
        for m in cell["end_to_end"]:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    dev = torch.device(device)
    result = {
        "correct": res["correct"],
        "attempted": frames,
        "failed": res["failed"],
        "metrics": metrics,
        "device": {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": (torch.cuda.get_device_name(dev)
                            if dev.type == "cuda" else "cpu"),
                   "count": cell["workload"]["chips"],
                   "memory_peak_bytes": int(peak)},
        "sample": res["counts"],
        "setup_parts": {"start and imports": started - t0, **setup.parts},
    }
    if trace:
        result["device"]["busy_s"] = tr.busy_s
        result["device"]["window_s"] = tr.window_s
        result["breakdown"] = tr.breakdown()
    result["checks"] = res["checks"]
    err = ["set-up s by part (calibration not in setup_s): " + ", ".join(
        f"{k} {v:.3f}" for k, v in result["setup_parts"].items()),
        f"host ms a call by stage: " + ", ".join(
        f"{k} {ms / max(n, 1):.3f} x{n}" for k, (ms, n) in timings.items()),
        f"sample: {res['counts']}"] + [
        f"check {k}: {v['value']!r} limit {v['limit']!r}"
        for k, v in res["checks"].items()]
    return result, err
