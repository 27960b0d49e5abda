#!/usr/bin/env python
"""Profiler-trace recipe of the PyTorch port: capture a ``torch.profiler``
trace of warm FULL batches and print where the device time goes, by
stage.

The port's counterpart of ``tools/trace_capture.py``.  On the TPU, XLA's
op metadata ties each fusion to its stage function; here every stage of
the port runs in a ``torch.profiler.record_function`` range of a fixed
name (``fdt.upload``, ``fdt.letterbox``, ``fdt.detector``,
``fdt.postprocess``, ``fdt.mesh``, ``fdt.iris``, ``fdt.blendshapes``,
``fdt.refine``, ``fdt.embedding``, ``fdt.pack``; ``fdt.segmentation`` and
``fdt.embed`` for the segmenter's and ``FaceEmbedding``'s own calls;
entered only while a profiler runs, ``pipeline.timings.stage_range``),
and :func:`stage_breakdown` reads a trace's device time by range.  The
detector's host spans (``fdt.dispatch[slab<n>]``, ``fdt.compute_wait``,
``fdt.materialize`` ...) hold the stage ranges; a launch belongs to the
innermost range around it.

    python tools/trace_capture_torch.py [--out DIR] [--batch 16] [--iters 3]
    # full timeline: chrome://tracing or https://ui.perfetto.dev on the file

It runs on the CUDA card (``FDT_FORCE_CPU=1`` asks for the CPU: a trace of
CPU ops only) and reads the ``.tflite`` files and ``landmark-ex1.jpg`` as
the JAX tool does; without them it exits 1 naming the missing directory.

A device activity (kernel, copy, memset) belongs to a stage by one of two
links, never by the wall-clock overlap of a device event with a CPU
range, since kernels run after the range that queued them has closed:

1. its launch: the CUDA runtime call with the same ``correlation`` id lies
   inside the stage's ``user_annotation`` range on the launching thread.
   This covers kernels launched through ``ctypes`` (K1 and K2), which have
   no aten op above them, and copies on the upload stream;
2. else the stage's ``gpu_user_annotation`` span on the activity's own
   stream.

What neither link reaches is the ``unattributed`` row.  Worker threads
(``ServingPipeline``, ``ReplicaPool``) reach the trace with their own
ranges and launches: ``pipeline.timings.trace`` profiles every thread.
"""

from __future__ import annotations

import argparse
import glob
import gzip
import json
import os
import sys
from collections import defaultdict

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from face_detection_tflite_torch.pipeline.timings import \
    DEVICE_CATEGORIES  # noqa: E402

#: Batches run before the trace, so that the traced ones are steady
#: (cuDNN's first calls, the speculative slab's growth).
WARM_BATCHES = 2
#: The prefix of the port's stage ranges.
STAGE_PREFIX = "fdt."
#: Chrome-trace categories of the runtime calls that launch device
#: activities.
LAUNCH_CATEGORIES = ("cuda_runtime", "cuda_driver")
UNATTRIBUTED = "unattributed"

#: Chrome-trace arg keys that say what an event computes, where the
#: exporter writes them (the JAX tool's list, kept for its summary).
_META_KEYS = ("long_name", "hlo_op", "tf_op", "hlo_module", "source",
              "kind", "hlo_category", "equation")


def _events(path: str) -> list:
    op = gzip.open if path.endswith(".gz") else open
    with op(path, "rt") as f:
        return json.load(f).get("traceEvents", [])


def summarize_chrome_trace(path: str, top: int = 25) -> list:
    """Aggregates complete ('X') events by (track, name).

    Returns rows of (track_name, event_name, total_us, count, meta) where
    ``meta`` is the metadata args of a representative event where the
    exporter writes them, sorted by total duration."""
    events = _events(path)
    pid_names: dict = {}
    tid_names: dict = {}
    for ev in events:
        if ev.get("ph") == "M" and ev.get("name") == "process_name":
            pid_names[ev.get("pid")] = ev.get("args", {}).get("name", "?")
        elif ev.get("ph") == "M" and ev.get("name") == "thread_name":
            tid_names[(ev.get("pid"), ev.get("tid"))] = \
                ev.get("args", {}).get("name", "?")
    agg = defaultdict(lambda: [0.0, 0, None])
    for ev in events:
        if ev.get("ph") == "X" and "dur" in ev:
            track = tid_names.get((ev.get("pid"), ev.get("tid")),
                                  pid_names.get(ev.get("pid"), "?"))
            a = agg[(track, ev.get("name", "?"))]
            a[0] += ev["dur"]
            a[1] += 1
            args = ev.get("args")
            if a[2] is None and args:
                a[2] = {k: str(args[k])[:200] for k in _META_KEYS
                        if k in args} or None
    rows = sorted(((tr, name, t, n, meta)
                   for (tr, name), (t, n, meta) in agg.items()),
                  key=lambda r: -r[2])
    return rows[:top]


def _innermost(spans, t: float):
    """The name of the shortest ``(start, end, name)`` span holding
    ``t``, or None."""
    best = None
    for s, e, name in spans:
        if s <= t <= e and (best is None or e - s < best[1] - best[0]):
            best = (s, e, name)
    return best and best[2]


def _union_us(spans) -> float:
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(spans):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return busy + (cur_e - cur_s if cur_e is not None else 0.0)


def stage_breakdown(path: str, top: int = 5) -> dict:
    """Device time of the Chrome trace at ``path`` by ``fdt.*`` stage.

    Returns ``{"stages": {stage: row}, "device_ms", "busy_ms",
    "window_ms", "attributed_share", "links"}``: each row holds
    ``device_ms`` (summed durations of its device activities),
    ``kernels`` and ``copies`` (counts), ``by_name`` ({kernel or copy
    name: [ms, count]}) and ``top`` (its ``top`` names by time); the
    ``unattributed`` row holds what no link reached (module docstring).
    ``busy_ms`` is the union of all device activities, ``window_ms`` the
    span from the first to the last, ``attributed_share`` the share of
    the summed device time in the ``fdt.*`` rows, and ``links`` counts
    the activities each link attributed."""
    ranges = defaultdict(list)      # (pid, tid) of a host thread
    gpu_ranges = defaultdict(list)  # (pid, tid) of a device stream
    launches = {}                   # correlation -> (pid, tid, ts)
    device = []
    for ev in _events(path):
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        cat, name = ev.get("cat"), ev.get("name", "")
        track = (ev.get("pid"), ev.get("tid"))
        ts, end = float(ev["ts"]), float(ev["ts"]) + float(ev["dur"])
        if cat == "user_annotation" and name.startswith(STAGE_PREFIX):
            ranges[track].append((ts, end, name))
        elif cat == "gpu_user_annotation" and name.startswith(STAGE_PREFIX):
            gpu_ranges[track].append((ts, end, name))
        elif cat in LAUNCH_CATEGORIES:
            corr = ev.get("args", {}).get("correlation")
            if corr is not None:
                launches[corr] = (track, ts)
        elif cat in DEVICE_CATEGORIES:
            device.append((ts, end, name, cat, track,
                           ev.get("args", {}).get("correlation")))
    stages: dict = {}
    links = {"launch": 0, "annotation": 0, "none": 0}
    for ts, end, name, cat, track, corr in device:
        stage = None
        if corr in launches:
            host_track, launched = launches[corr]
            stage = _innermost(ranges.get(host_track, ()), launched)
            if stage:
                links["launch"] += 1
        if stage is None:
            stage = _innermost(gpu_ranges.get(track, ()), ts)
            links["annotation" if stage else "none"] += 1
        row = stages.setdefault(stage or UNATTRIBUTED, {
            "device_ms": 0.0, "kernels": 0, "copies": 0, "by_name": {}})
        ms = (end - ts) / 1e3
        row["device_ms"] += ms
        row["kernels" if cat == "kernel" else "copies"] += 1
        acc = row["by_name"].setdefault(name, [0.0, 0])
        acc[0] += ms
        acc[1] += 1
    stages.setdefault(UNATTRIBUTED, {"device_ms": 0.0, "kernels": 0,
                                     "copies": 0, "by_name": {}})
    for row in stages.values():
        row["top"] = sorted(row["by_name"].items(),
                            key=lambda kv: -kv[1][0])[:top]
    total = sum(row["device_ms"] for row in stages.values())
    return {
        "stages": stages,
        "device_ms": total,
        "busy_ms": _union_us([(s, e) for s, e, *_ in device]) / 1e3,
        "window_ms": ((max(e for _, e, *_ in device)
                       - min(s for s, *_ in device)) / 1e3
                      if device else 0.0),
        "attributed_share": ((total - stages[UNATTRIBUTED]["device_ms"])
                             / total if total else 0.0),
        "links": links,
    }


def capture(detector, frames, out_dir: str, iters: int = 3, mode=None, *,
            warm: int = WARM_BATCHES):
    """Runs ``warm`` batches of ``frames`` through
    ``detector.detect_faces_batch`` outside the trace (FULL unless
    ``mode``), then ``iters`` inside ``pipeline.timings.trace(out_dir)``.
    Returns (the path of the Chrome trace written, the faces of each
    traced batch).  A caller that counts launches over the traced batches
    warms first and passes ``warm=0``."""
    from face_detection_tflite_torch import FaceDetectionMode
    from face_detection_tflite_torch.pipeline import timings
    mode = FaceDetectionMode.FULL if mode is None else mode
    for _ in range(warm):
        detector.detect_faces_batch(frames, mode)
    detector.timings.reset()
    pattern = os.path.join(out_dir, "**", "*.trace.json*")
    before = set(glob.glob(pattern, recursive=True))
    with timings.trace(out_dir):
        faces = [detector.detect_faces_batch(frames, mode)
                 for _ in range(iters)]
    new = sorted(set(glob.glob(pattern, recursive=True)) - before)
    if not new:
        raise RuntimeError(f"no Chrome trace was written under {out_dir}")
    return new[-1], faces


def print_breakdown(bd: dict, iters: int, label: str = "") -> None:
    """Prints :func:`stage_breakdown`'s rows, a batch each."""
    print(f"device time by stage{label}, a batch of {iters} traced "
          f"(ms | kernels | copies | top kernels):")
    order = sorted(bd["stages"].items(), key=lambda kv: -kv[1]["device_ms"])
    for stage, row in order:
        tops = "; ".join(f"{n[:48]} {ms / iters:.3f}"
                         for n, (ms, _) in row["top"][:3])
        print(f"  {stage:18s} {row['device_ms'] / iters:9.3f} "
              f"{row['kernels'] / iters:7.1f} {row['copies'] / iters:5.1f}"
              f"  {tops}")
    print(f"  busy {bd['busy_ms'] / iters:.3f} ms of a "
          f"{bd['window_ms']:.3f} ms window over {iters} batches; "
          f"attributed share {bd['attributed_share']:.4f}; links "
          f"{bd['links']}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=os.path.join(REPO, "traces", "torch"))
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--iters", type=int, default=3)
    args = ap.parse_args(argv)

    from face_detection_tflite_torch.pipeline.detector import \
        resolve_model_dir
    try:
        d = resolve_model_dir()
    except FileNotFoundError as e:
        print(f"trace_capture_torch: {e}", file=sys.stderr)
        return 1
    sample = os.path.join(os.path.dirname(d), "samples", "landmark-ex1.jpg")
    if not os.path.exists(sample):
        print(f"trace_capture_torch: no sample image {sample} (directory "
              f"{os.path.dirname(sample)})", file=sys.stderr)
        return 1

    from face_detection_tflite_torch.utils.backend import (
        BackendUnavailable, ensure_backend, force_cpu)
    try:
        ensure_backend()
    except BackendUnavailable as e:
        print(f"trace_capture_torch: {e}", file=sys.stderr)
        return 1
    import numpy as np

    from face_detection_tflite_torch import (FaceDetectionMode,
                                             FaceDetectionModel, FaceDetector)
    from face_detection_tflite_torch.utils.image import load_image

    img = load_image(sample)
    det = FaceDetector(model=FaceDetectionModel.BACK_CAMERA, max_faces=16,
                       model_dir=d, precision="high", detailed_timings=True,
                       device="cpu" if force_cpu() else None)
    batch = np.ascontiguousarray(np.broadcast_to(img, (args.batch,)
                                                 + img.shape))
    path, _ = capture(det, batch, args.out, args.iters,
                      FaceDetectionMode.STANDARD)
    print("host stage report (detailed_timings):")
    print(json.dumps(det.timings.report(), indent=1))
    det.dispose()
    print(f"\ntrace: {path}")
    print(f"top events by total duration over {args.iters} batches "
          f"(track | name):")
    for track, name, tot, n, meta in summarize_chrome_trace(path):
        print(f"  {tot / 1e3:9.2f} ms  x{n:<4d} [{str(track)[:28]}] "
              f"{name[:80]}")
        for k, v in (meta or {}).items():
            print(f"{'':18s}{k}: {v}")
    print_breakdown(stage_breakdown(path), args.iters)
    return 0


if __name__ == "__main__":
    sys.exit(main())
