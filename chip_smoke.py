#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root: ``python3 chip_smoke.py``.  It

1. prints the card's name and power limit (``nvidia-smi``);
2. builds the hand-written kernels (``face_detection_tflite_torch/csrc``)
   with ``nvcc`` and prints the build time and ptxas resource usage;
3. holds each kernel against its plain PyTorch version on the card:
   the weighted-NMS core (``nms_core``) at B = 16 for k = 896 with a
   sparse valid prefix, k = 896 all valid and k = 2304 (leaders equal,
   boxes within 1e-6); K1, the fused detection postprocess
   (``detection_postprocess``: decode, select, weighted NMS, slab,
   letterbox removal), at B = 16 on seeded raw outputs with every anchor
   valid (A = 896), on the full-range anchors (A = 2304, 192 px) with 5%
   and with all valid, with ``num_candidates=64``, with more leaders than
   D, with no valid anchor and with equal scores (valid, scores and
   keypoints equal, boxes within 1e-6); K2 (ROI warp + normalize) at 16
   frames x 16 faces x 192 px with mixed mirrors (bit for bit); it prints
   the kernels' times, the plain versions' and, for K2,
   ``F.grid_sample``'s (CUDA events, warm-up, median of 20);
4. drives the STANDARD main path (``_drive_main_path``): ``FaceDetector``
   over 16 seeded 853x1280 uint8 frames with the full-depth, full-width
   seeded BlazeFace-back, FaceMesh, iris and blendshape nets; prints ms
   per batch, faces/s, faces per image and the kernels' launch counts:
   one K1 launch a batch, one K2 a batch (plus one on each overflow
   re-run), no ``nms_core``, at least one face on every image; profiles
   one steady batch (``torch.profiler``: device time by layer and kernel,
   and the device's idle share); holds the card against the port on the
   CPU (plain kernels, fp32 convolutions) on two of the frames;
   then it times each kernel on the main path's own inputs twice over
   the same 20 calls: CUDA events around each call (``ms``, which
   includes the host path of the ctypes call) and the kernel's own device
   time in ``torch.profiler`` (``device_ms``, median; where two profiler
   sessions kept no device record, CUDA events around the same calls
   queued back to back behind a spin kernel, and ``device_ms_by`` says
   which; a profiled batch that kept none is printed as not
   measured); for K1 also the
   host time of a call (host clock over 1,000 calls, no synchronise), an
   empty kernel's device time (the launch floor, context only) and, as
   the yardstick, the stage K1 replaced (``decode_detections``,
   ``weighted_nms`` through ``nms_core``, ``remove_letterbox``): its event
   ms, device ms summed over its kernels and device launches per call;
   for K2 (``_time_warp``) its plain version and, as the yardstick,
   ``grid_sample`` on the same sample points;
5. drives the FULL main path (``FaceDetector``'s default mode) the same
   way over the same frames and networks, with one K1 and two K2 launches
   a batch (192 px mesh crops, 64 px eye crops, each once more on an
   overflow re-run); checks every face for 152 iris points, 52
   coefficients in [0, 1] and head angles (``_check_full_faces``); holds
   and times K2 at its iris site on the main path's own eye ROIs (right
   eyes mirrored); the card-vs-CPU check adds the refined keypoints, the
   iris, the blendshapes, head angles and ``blendshapes_valid``;
6. drives FULL with the fused embedding stage (``FaceDetector(
   embed_in_full=True)``, the seeded full-width MobileFaceNet added) the
   same way, with one K1 and three K2 launches a batch (192, 64 and
   112 px, each once more on an overflow re-run); its profiled batch
   shows MobileFaceNet as a layer of its own (the device work between two
   marker kernels launched around the network's call); checks every face
   for a 192-dim embedding of norm 1 (within 1e-4); prints the embedding
   ROIs' sizes against the face ROIs'; holds and times K2 at its 112 px site on
   the path's own embedding ROIs; times MobileFaceNet alone on the path's
   own crops (event and summed device ms, launches, its fp32 operations'
   bound); holds ``get_face_embeddings`` on one frame's faces against
   their fused embeddings (fp32 readback, within 1e-3) and checks that
   the frame was uploaded once; the card-vs-CPU check adds the
   embeddings;
7. serving, on the same frames and networks: times one batch's upload,
   pinned (``pipeline/upload.py``) against pageable; runs
   ``detect_faces_batch_stream`` over the FULL batches at depth 2 against
   the same batches' sequential ``detect_faces_batch`` calls (faces equal,
   one K1 and one K2 a crop size a batch, ms per batch of both, and the
   idle share and upload overlap of one profiled stream window); starts
   ``FaceServer`` on 127.0.0.1 over a FULL-default detector and has 8
   client threads POST 4 frames each as PNG bodies (3 of 4 in FULL, the
   rest STANDARD): every response 200 with the faces of
   ``detect_faces_batch``, a micro-batch of more than one image, one K1
   launch a micro-batch, the card in ``/v1/info``, unit embeddings from
   ``/v1/embed`` equal to ``get_face_embeddings``'s, and a second server
   with ``max_queue=2`` shedding part of a burst with 503 + Retry-After
   and then answering 200 (requests/s, p50/p99 latency, micro-batch
   sizes); runs the FULL program and MobileFaceNet on two threads at
   once, bit-identical to one thread;
8. video, camera frames and the standalone classes: (a) writes a seeded
   32-frame 1280x720 clip with cv2 (a smooth texture panned 3 px a frame;
   mp4v, else MJPG), calibrates fresh seeded full-depth networks on the
   decoded frames and runs ``detect_faces_from_video`` (FULL, tracking
   on, batches of 8): frames and timestamps in order, faces equal bit for
   bit to ``detect_faces_batch``'s on the same decoded frames in the same
   batches, IDs equal to a fresh ``TemporalFaceTracker``'s on the same
   boxes, one K1 launch and one K2 at 192 and at 64 px a batch (plus
   re-runs), and K1 and K2 held against their plain versions on every
   batch's own frames (``_check_path_kernels``: K1 on the detector's raw
   outputs, K2 on the program's face and eye ROIs, bit for bit); a run with ``frame_stride=2, max_frames=8, max_dim=640``;
   IDs from 1 after ``reset_tracking``; frames/s against
   ``detect_faces_batch`` alone, the share of IDs carried over, and the
   host ms of both smoothers; (b) four decoded frames as I420, NV12,
   NV21, RGBA and BGRA camera frames with rows padded by 64 bytes under
   the four rotations (I420 also as a duck-typed planes object) through
   the camera entry points: faces equal bit for bit to
   ``detect_faces(decode_camera_frame(frame))``'s, one K1 and one K2 at
   each site a frame, K1 and K2 against their plain versions on the first
   landscape and the first portrait frame at B = 1, the decode's host ms
   and the ms a frame; (c) standalone ``FaceDetection`` on the main
   path's frame 0, card against CPU, one K1 launch a call, K1 against its
   plain version on the call's own raw outputs, its ms a call and K1's
   device ms at B = 1;
   ``FaceLandmark``, ``IrisLandmark`` and ``FaceBlendshapesModel`` on the
   main path's own crops, card against CPU;
9. the other detector variants and selfie segmentation: (a) full-depth
   seeded FRONT_CAMERA, SHORT_RANGE and FULL detectors calibrated on the
   main path's frames to about 32 passing anchors a frame, and
   FULL_SPARSE (FULL's calibrated graph with its pruned filters stored
   sparse behind DENSIFY), each in ``FaceDetector(model=v)`` in FULL with
   the main path's mesh, iris and blendshape nets over the same frames
   for a few steady batches (launch counts set to 0 just before them:
   one K1 launch a batch, one K2 at each of 192 and 64 px, plus re-runs),
   ms a batch and faces/s, K1 and K2 against their plain versions on the
   variant's own inputs (``_check_path_kernels``: K1 at A = 896 from the
   128 px graphs and at A = 2304 from the full-range network), the card
   against the CPU on two frames; FULL_SPARSE's raw outputs and faces
   equal FULL's bit for bit; K1 timed on the full-range network's raw
   outputs; (b) the full-width seeded general (256x256), landscape
   (144x256) and multiclass (256x256, 6 classes) segmenters on the same
   frames with the float32 and the uint8 readback: ms a batch and
   masks/s, the device program, the readback and the host ``upsample``
   timed apart, the card against the CPU on two frames, one profiled
   general batch by layer (convolutions, transposed convolutions,
   resizes, elementwise); ``detect_faces_with_segmentation_batch``
   against the two calls run apart; ``/v1/segment`` and
   ``/v1/detect_with_segmentation`` on a loopback server;
10. prints the ``kernels`` JSON line and, last, the ``{"ok": true, ...}``
   line.  Each kernel's ``launches`` is its count over the STANDARD main
   path's batches (``full_launches``: over the FULL path's; ``stream_`` and
   ``server_launches``: over phase 7's stream and server requests, with
   ``server_batches`` micro-batches; ``video_launches`` over phase 8a's
   ``video_batches``, ``camera_launches`` over 8b's ``camera_frames``,
   and K1's ``standalone_launches`` over 8c's ``standalone_calls``, with
   ``standalone_ms`` a call and ``standalone_k1_ms``/``_device_ms`` at
   B = 1; ``variant_launches`` per variant over phase 9a's
   ``variant_batches`` batches each, ``full_range_network`` K1's times
   and bound on the full-range network's raw outputs, and
   ``segmentation_combined_launches`` and ``segmentation_server_launches``
   over phase 9b's combined batch and its ``/v1/detect_with_segmentation``
   requests); the iris site's
   (``warp_normalize_iris64``) is its count over the FULL path's batches
   and the embedding site's (``warp_normalize_embed112``) over the
   embedding phase's (``server_embed_launches``: one ``/v1/embed``);
   ``nms_core`` is off the main path (0) and its launches in step 3 are
   ``check_launches``.  K1's ``max_abs_err`` is its largest box error
   over every check against the plain version (steps 3, 4, 8 and 9).

Any failed check raises, and the script exits non-zero.  It exits 2
without a result where CUDA is unavailable or the package is missing.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
PACKAGE = "face_detection_tflite_torch"

# H100 SXM data sheet: HBM3 bandwidth and fp32 (non-tensor-core) peak.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_OPS_PER_S = 67e12
# fp32 operations per candidate pair of K1's scan (4 min/max, 4 sub/max0,
# 1 mul, 2 add/sub, 1 div, 1 compare) and per member in its blend (5 mul +
# 5 add); per output value of K2 (geometry ~12 per pixel amortized over 3
# channels, 6 mul + 3 add of the lerp, 2 of the normalize).
NMS_PAIR_OPS = 13
NMS_MEMBER_OPS = 10
WARP_VALUE_OPS = 15
# K1 postprocess: per anchor the clipped sigmoid and its test (2 clamp,
# exp, add, div, compare); per valid candidate the decode of its box (4
# div, 2 add, 2 mul, 4 add/sub); per leader in the slab the decode of its
# keypoints (12 div, 12 add); per slab value the letterbox removal (sub,
# div).
POST_ANCHOR_OPS = 6
POST_BOX_OPS = 12
POST_KP_OPS = 24
SLAB_VALUE_OPS = 2

SEED = 3
FRAMES, HEIGHT, WIDTH = 16, 853, 1280
# Phase 7: the stream's depth, the server's clients, the two-thread runs.
STREAM_DEPTH = 2
CLIENTS, REQUESTS_PER_CLIENT = 8, 4
THREAD_RUNS = 20
MAX_FACES = 16
MESH_SIZE, IRIS_SIZE, EMBED_SIZE = 192, 64, 112
# The name of the empty kernel of torch.cuda._sleep(0), which marks the
# embedding network's calls in the profiled batch.
MARKER = "spin_kernel"
# Card-vs-CPU tolerances of the programs' outputs (head angles in degrees;
# embeddings are unit vectors); the mesh and the iris are held to 1e-2 px
# or 1e-5 of their largest magnitude.
CPU_TOLERANCES = {"boxes": 1e-4, "raw_keypoints": 1e-4, "keypoints": 1e-4,
                  "blendshapes": 1e-4, "head_angles": 0.1,
                  "embeddings": 1e-3}


def _median_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _profiled(run, keep, what: str, sessions: int = 2):
    """``run()`` inside ``torch.profiler`` and the device activities that
    ``keep`` accepts, as (result of run, [(start us, end us, name)]).  The
    profiler can lose every device record of a session once a process has
    opened many sessions, so a session that kept none is repeated, up to
    ``sessions`` in all; after that the activities are empty and the
    caller falls back to CUDA events."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for attempt in range(sessions):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            result = run()
        device = [(e.time_range.start, e.time_range.end, e.name)
                  for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and keep(e.name)]
        if device:
            return result, device
        print(f"profile: torch.profiler session {attempt + 1} of "
              f"{sessions} recorded no device activity of {what}")
    return result, []


def _queued_ms(fn, iters: int = 20) -> float:
    """Device ms per call of ``fn`` without the profiler: a spin kernel
    holds the stream while the host enqueues ``iters`` calls between two
    CUDA events, so the events time the calls' device work back to back
    (the gaps between launches included).  The hold is sized from the
    host's own enqueue time and doubled, twice at most, until the start
    event was still pending when the last call was enqueued; None where
    it never was (``fn`` waits for the device on the host)."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    for attempt in range(3):
        # Clock cycles at ~2 GHz: four times the host's enqueue time.
        cycles = int(8e9 * host_s * 2 ** attempt) + 1_000_000
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        held = not start.query()
        end.synchronize()
        if held:
            return start.elapsed_time(end) / iters
    return None


def _kernel_ms(fn, layer: str, iters: int = 20) -> tuple[float, float, str]:
    """(event ms, device ms, where the device ms comes from) of a kernel
    wrapper that launches one kernel per call: the CUDA-event median of
    ``iters`` timed calls, which includes the host path of the call, and
    the median of the same calls' device time of the kernel in
    ``torch.profiler``, found by its layer (:func:`_layer`).  The profiler
    can lose some device records, which the median then leaves out; where
    it kept none (:func:`_profiled`), the device ms is :func:`_queued_ms`."""
    for _ in range(3):
        fn()
    ms, device = _profiled(lambda: _median_ms(fn, iters=iters, warmup=0),
                           lambda name: _layer(name) == layer, layer)
    if len(device) != iters:
        print(f"profile: torch.profiler recorded {len(device)} device "
              f"launches of {layer} for {iters} timed calls")
    if not device:
        dev_ms = _queued_ms(fn, iters)
        if dev_ms is None:
            raise RuntimeError(f"no device time for {layer}: the profiler "
                               f"kept no record and the wrapper waits for "
                               f"the device on the host")
        print(f"profile: {layer} device time from queued CUDA events: "
              f"{dev_ms:.4f} ms a call")
        return ms, dev_ms, "queued events"
    return ms, statistics.median(e - s for s, e, _ in device) / 1e3, \
        "profiler"


def _stage_ms(fn, iters: int = 20
              ) -> tuple[float, float | None, float | None, set]:
    """(event ms, device ms, device launches, layers) per call of ``fn``,
    which may launch many kernels: the CUDA-event median of ``iters`` calls
    and, over the same calls in ``torch.profiler``, the summed device time
    and the count of device activities divided by ``iters`` (a lower bound
    where the profiler lost records), and the layers they belong to.
    Where the profiler kept no record (:func:`_profiled`), the device ms
    is :func:`_queued_ms` (None where ``fn`` waits on the host), and the
    launches (None) and layers (empty) are not measured."""
    for _ in range(3):
        fn()
    ms, device = _profiled(lambda: _median_ms(fn, iters=iters, warmup=0),
                           lambda name: True, "the stage")
    if not device:
        dev_ms = _queued_ms(fn, iters)
        print(f"profile: stage device time from queued CUDA events: "
              f"{_num(dev_ms, '.4f')} ms a call; its launches and layers "
              f"are not measured")
        return ms, dev_ms, None, set()
    return (ms, sum(e - s for s, e, _ in device) / 1e3 / iters,
            len(device) / iters, {_layer(name) for _, _, name in device})


def _num(x, spec: str = "g") -> str:
    """A measured number for a printout; None is not measured."""
    return "(not measured)" if x is None else format(x, spec)


def _host_ms(fn, calls: int = 1000) -> float:
    """Host time of one call of ``fn``: a host clock over ``calls`` calls
    with no synchronise in between (the enqueue, not the device work)."""
    import torch
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    ms = (time.perf_counter() - t0) * 1e3 / calls
    torch.cuda.synchronize()
    return ms


def _clustered_candidates(rng, b: int, k: int, valid_frac: float):
    """[B, k] candidates in clusters, as the NMS tests build them."""
    import numpy as np
    boxes = np.empty((b, k, 4), np.float32)
    for i in range(b):
        c = rng.uniform(0.1, 0.9, (k // 4 + 1, 2))
        wh = rng.uniform(0.05, 0.3, (k // 4 + 1, 2))
        pick = rng.integers(0, len(c), k)
        ctr = c[pick] + rng.normal(0, 0.01, (k, 2))
        half = wh[pick] * 0.5 * rng.uniform(0.9, 1.1, (k, 2))
        boxes[i] = np.concatenate([ctr - half, ctr + half], 1)
    scores = rng.uniform(0, 1, (b, k)).astype(np.float32)
    valid = scores >= 1.0 - valid_frac
    kp = rng.uniform(0, 1, (b, k, 6, 2)).astype(np.float32)
    return boxes, kp, scores, valid


def _bound(nbytes: int, ops: int) -> tuple[float, str]:
    """(ms, what bounds it): the larger of the bytes over HBM3 bandwidth
    and the fp32 operations over the fp32 peak."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, ops / PEAK_FP32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else \
        "operations"


def _nms_bound(valid_counts, b: int, k: int) -> tuple[float, str]:
    """Least time for K1 on these inputs.  Bytes: the valid flags of all k
    candidates, and the box and score of each valid one, read once; the
    leader flags and blended boxes of all k written once.  Operations:
    n^2/2 IoUs plus the blend of the n valid candidates."""
    nbytes = b * k + sum(valid_counts) * (16 + 4) + b * k * (1 + 16)
    ops = sum(n * (n + 1) // 2 * NMS_PAIR_OPS + n * NMS_MEMBER_OPS
              for n in valid_counts)
    return _bound(nbytes, ops)


def _postprocess_bound(valid_counts, slab_leaders: int, b: int, a: int,
                       d: int) -> tuple[float, str]:
    """Least time for K1 on these inputs.  Bytes: all A raw scores, the raw
    box (16 B) and anchor (8 B) of each valid candidate and the raw
    keypoints (48 B) of each of the ``slab_leaders`` leaders that fill the
    slab, read once; the [B, D] slab (69 B a row) written once.
    Operations: the score test of every anchor, the decode of each valid
    candidate's box and each slab leader's keypoints, n^2/2 IoUs and the
    blend of the n valid candidates, the letterbox removal of the slab."""
    nbytes = (b * a * 4 + sum(valid_counts) * (16 + 8) + slab_leaders * 48
              + b * d * 69)
    ops = (b * a * POST_ANCHOR_OPS + sum(valid_counts) * POST_BOX_OPS
           + slab_leaders * POST_KP_OPS
           + sum(n * (n + 1) // 2 * NMS_PAIR_OPS + n * NMS_MEMBER_OPS
                 for n in valid_counts) + b * d * 16 * SLAB_VALUE_OPS)
    return _bound(nbytes, ops)


def _check_postprocess(label: str, args, kw: dict, card: str) -> float:
    """Holds K1 against its plain version on ``args`` (raw_boxes,
    raw_scores, anchors, input_size, padding): valid, scores and
    keypoints equal, boxes within 1e-6.  Returns the boxes' max error."""
    import torch
    from face_detection_tflite_torch.ops import detections
    got = detections.detection_postprocess(*args, **kw)
    torch.cuda.synchronize()
    want = detections.detection_postprocess_plain(*args, **kw)
    names = ("boxes", "keypoints", "scores", "valid")
    for name, g, w in zip(names[1:], got[1:], want[1:]):
        if not torch.equal(g, w):
            bits = (g.view(torch.int32).long() - w.view(torch.int32).long()
                    ).abs().max().item() if g.dtype == torch.float32 else 0
            raise AssertionError(f"K1 detection_postprocess {label}: {name} "
                                 f"differ (max {bits} ulp)")
    err = (got[0] - want[0]).abs().max().item()
    if err > 1e-6:
        raise AssertionError(f"K1 detection_postprocess {label}: boxes "
                             f"differ by {err}")
    print(f"K1 detection_postprocess {label}: slab rows per image "
          f"{got[3].sum(1).tolist()}, max_abs_err={err:.3g} (valid, scores, "
          f"keypoints equal)  [{card}]")
    return err


def _tap_footprint(sx, sy, h: int, w: int) -> int:
    """Distinct in-image source pixels that the four bilinear taps at
    ``sx, sy [B, F, S, S]`` read, summed over the frames."""
    import torch
    b = sx.shape[0]
    x0 = torch.floor(sx).long().reshape(b, -1)
    y0 = torch.floor(sy).long().reshape(b, -1)
    touched = torch.zeros((b, h * w + 1), dtype=torch.bool, device=sx.device)
    for dy in (0, 1):
        for dx in (0, 1):
            x, y = x0 + dx, y0 + dy
            inside = (x >= 0) & (x < w) & (y >= 0) & (y < h)
            # Outside taps land in the spare last slot, which is not counted.
            touched.scatter_(1, torch.where(inside, y * w + x, h * w), True)
    return int(touched[:, :h * w].sum())


def _warp_bound(touched_px: int, b: int, faces: int, s: int
                ) -> tuple[float, str]:
    """Least time for K2 on these ROIs.  Bytes: the source pixels the taps
    touch (3 uint8 each) and five float32 parameters per ROI, read once;
    the [B, F, S, S, 3] float32 crops written once.  Operations: its fp32
    work per output value."""
    nbytes = touched_px * 3 + b * faces * 5 * 4 + b * faces * s * s * 3 * 4
    return _bound(nbytes, b * faces * s * s * 3 * WARP_VALUE_OPS)


def _sample_grid(cx, cy, size, cos_t, sin_t, s: int, flip=None):
    """Source coordinates ``sx, sy [B, F, S, S]`` of K2's bilinear taps
    (``ops/warp.py::extract_rois``), the columns mirrored where ``flip``."""
    import torch
    size_int = torch.clamp_min(torch.floor(size + 0.5), 1.0)
    scale = torch.full_like(size_int, s) / size_int
    center = s / 2.0 + 0.5 * (scale - 1.0)
    g = torch.arange(s, dtype=torch.float32, device=cx.device)
    gx = g.expand(*cx.shape, s)
    if flip is not None:
        gx = torch.where(flip[..., None], (s - 1) - gx, gx)
    dx = (gx[..., None, :] - center[..., None, None]) / scale[..., None, None]
    dy = (g[None, None, :, None] - center[..., None, None]) / \
        scale[..., None, None]
    sx = cx[..., None, None] + cos_t[..., None, None] * dx + \
        sin_t[..., None, None] * dy
    sy = cy[..., None, None] - sin_t[..., None, None] * dx + \
        cos_t[..., None, None] * dy
    return sx, sy


def _grid_sample_fn(frames, sx, sy):
    """One ``F.grid_sample`` call over the same sample points as K2 (and
    the normalize): K2's library yardstick, returning [B, F, S, S, 3]."""
    import torch
    import torch.nn.functional as F
    b, h, w = frames.shape[:3]
    f, s = sx.shape[1], sx.shape[-1]
    grid = torch.stack([(2 * sx + 1) / w - 1, (2 * sy + 1) / h - 1],
                       -1).reshape(b, -1, s, 2)

    def library():
        img = frames.permute(0, 3, 1, 2).float()
        o = F.grid_sample(img, grid, mode="bilinear", padding_mode="zeros",
                          align_corners=False)
        return o * (1.0 / 127.5) - 1.0

    return library, lambda o: o.reshape(b, 3, f, s, s).permute(0, 2, 3, 4, 1)


def _layer(kernel_name: str) -> str:
    """Layer of a device activity, from its name."""
    n = kernel_name.lower()
    if "memcpy" in n or "memset" in n:
        return "copies"
    if "detection_postprocess" in n:
        return "K1 detection_postprocess"
    if "nms_core" in n:
        return "nms_core"
    if "empty_kernel" in n:
        return "launch floor"
    if "warp_normalize" in n:
        return "K2 warp_normalize"
    if any(t in n for t in ("conv", "cudnn", "implicit", "winograd", "nhwc",
                            "fprop")):
        return "convolutions"
    if any(t in n for t in ("gemm", "xmma", "sm90", "sm80")):
        return "matmuls"
    return "other torch ops"


def _profile_batch(det, frames_np, mode, card: str, net=None) -> None:
    """One steady main-path batch under torch.profiler: device time by
    layer and by kernel, and the device's idle share of the window.  With
    ``net`` (the embedding network the batch runs), an empty marker kernel
    (``torch.cuda._sleep(0)``) is launched just before and just after each
    of its calls; the device work between a pair of markers on the one
    stream is a layer of its own, ``MobileFaceNet``, split again by
    :func:`_layer`, and the markers themselves are left out.  Where the
    profiler kept no record of the batch (:func:`_profiled`), or not a
    pair of markers a network call, the breakdown is printed as not
    measured."""
    import torch
    if net is not None:
        call = net.forward

        def marked(*args):
            torch.cuda._sleep(0)
            out = call(*args)
            torch.cuda._sleep(0)
            return out
        net.forward = marked
    def run():
        t0 = time.perf_counter()
        det.detect_faces_batch(frames_np, mode)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    try:
        wall_ms, device = _profiled(run, lambda name: True, "the batch")
    finally:
        if net is not None:
            del net.forward
    device.sort()
    if not any(MARKER not in name for _, _, name in device):
        print("profile: the batch's breakdown is not measured")
        return
    marks = [s for s, _, name in device if MARKER in name]
    if (net is None and marks) or \
            (net is not None and (not marks or len(marks) % 2)):
        print(f"profile: {len(marks)} {MARKER} markers around the embedding "
              f"network, not a pair a call; the batch's breakdown is not "
              f"measured")
        return
    windows = list(zip(marks[0::2], marks[1::2]))
    spans = [(s, e, name, any(a < s < b for a, b in windows))
             for s, e, name in device if MARKER not in name]
    by_layer: dict[str, float] = {}
    by_name: dict[str, list] = {}
    net_layers: dict[str, list] = {}
    busy, cur_s, cur_e = 0.0, None, None
    for s, e, name, mine in sorted(spans):
        layer = "MobileFaceNet" if mine else _layer(name)
        by_layer[layer] = by_layer.get(layer, 0.0) + (e - s)
        if mine:
            acc = net_layers.setdefault(_layer(name), [0.0, 0])
            acc[0] += e - s
            acc[1] += 1
        acc = by_name.setdefault(name, [0.0, 0])
        acc[0] += e - s
        acc[1] += 1
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    window = max(sp[1] for sp in spans) - min(sp[0] for sp in spans)
    print(f"profile (one steady batch, host wall {wall_ms:.2f} ms) "
          f"[{card}]: device busy {busy / 1e3:.3f} ms of a "
          f"{window / 1e3:.3f} ms device window "
          f"(idle share {1 - busy / window:.3f})")
    for layer, us in sorted(by_layer.items(), key=lambda kv: -kv[1]):
        print(f"  layer {layer}: {us / 1e3:.3f} ms")
    if net is not None:
        if not net_layers:
            print("  MobileFaceNet: no device work recorded between its "
                  "markers; not measured")
        for layer, (us, n) in sorted(net_layers.items(),
                                     key=lambda kv: -kv[1][0]):
            print(f"  MobileFaceNet's {layer}: {us / 1e3:.3f} ms over {n} "
                  f"device activities")
    for name, (us, n) in sorted(by_name.items(),
                                key=lambda kv: -kv[1][0])[:12]:
        print(f"  kernel {us / 1e3:8.3f} ms x{n:<4d} {name[:90]}")
    print(f"  host-to-device copies: "
          f"{sorted(name for name in by_name if 'HtoD' in name)}")


def _card_vs_cpu(got: dict, want: dict, label: str) -> None:
    """Holds a program's output on the card against the same program's on
    the CPU: valid and blendshapes_valid equal, head angles NaN in the same
    places, each value within its tolerance (:data:`CPU_TOLERANCES`; the
    mesh and the iris within 1e-2 px or 1e-5 of their largest
    magnitude)."""
    import numpy as np
    got = {k: v.cpu().numpy() for k, v in got.items()}
    want = {k: v.numpy() for k, v in want.items()}
    for key in ("valid", "blendshapes_valid"):
        if key in want and not np.array_equal(got[key], want[key]):
            raise AssertionError(f"{label}: card and CPU disagree on {key}")
    if "head_angles" in want and not np.array_equal(
            np.isnan(got["head_angles"]), np.isnan(want["head_angles"])):
        raise AssertionError(f"{label}: card and CPU disagree on NaN head "
                             f"angles")
    tols = {k: CPU_TOLERANCES.get(k)
            or float(max(1e-2, 1e-5 * np.abs(want[k]).max()))
            for k in want if k in CPU_TOLERANCES or k in ("mesh", "iris")}
    errs = {k: float(np.nanmax(np.abs(got[k] - want[k]))) for k in tols}
    print(f"{label} card vs CPU (2 frames): max errors {errs}, tolerances "
          f"{tols}")
    if any(errs[k] > tols[k] for k in tols):
        raise AssertionError(f"{label}: card and CPU disagree beyond "
                             f"tolerance")


def _drive_main_path(models, cpu_models, frames, frames_np, mode, runs: int,
                     card: str, embed: bool = False) -> dict:
    """Drives ``mode`` through ``FaceDetector`` for ``runs`` batches (FULL,
    the default, without a mode argument; with ``embed``, a detector with
    ``embed_in_full``), with every launch count set to 0 just before, and
    checks one K1 launch a batch, one K2 launch a batch for each crop size
    of the mode (plus one on each overflow re-run), no ``nms_core`` and a
    face with a finite mesh on every image; profiles one steady batch;
    builds the slab of every frame on the card (``min_score=0.5``: the
    kernel rows' inputs) and holds the card against the CPU on two frames.
    Returns the last batch's faces, the launches and that slab."""
    import numpy as np
    import torch
    from face_detection_tflite_torch import FaceDetectionMode, FaceDetector
    from face_detection_tflite_torch.ops import detections
    from face_detection_tflite_torch.ops import nms as nms_mod
    from face_detection_tflite_torch.ops import warp as warp_mod
    from face_detection_tflite_torch.pipeline.programs import \
        build_pipeline_program

    full = mode is FaceDetectionMode.FULL
    name = mode.name + ("+embeddings" if embed else "")
    det = FaceDetector(models=models, device=frames.device,
                       max_faces=MAX_FACES, embed_in_full=embed,
                       allow_untrained_embeddings=True)
    detections.detection_postprocess.launches = 0
    nms_mod.nms_core.launches = 0
    warp_mod.warp_normalize.launches = 0
    warp_mod.warp_normalize.launches_by_size = {}
    mode_args = () if full else (mode,)
    batch_ms, faces = [], None
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        faces = det.detect_faces_batch(frames_np, *mode_args)
        torch.cuda.synchronize()
        batch_ms.append((time.perf_counter() - t0) * 1e3)
    launches = {
        "detection_postprocess": detections.detection_postprocess.launches,
        "warp_normalize": dict(warp_mod.warp_normalize.launches_by_size),
        "nms_core": nms_mod.nms_core.launches}
    reruns = _reruns(det)
    per_image = [len(f) for f in faces]
    steady = statistics.median(batch_ms[2:])
    print(f"{name} main path: {runs} batches of {FRAMES} x {HEIGHT}x{WIDTH}:"
          f" ms/batch {['%.2f' % t for t in batch_ms]}, steady median "
          f"{steady:.2f} ms = {FRAMES * np.mean(per_image) * 1e3 / steady:.1f}"
          f" faces/s  [{card}]")
    print(f"{name} faces per image: {per_image}")
    print(f"{name} launches over the {runs} batches ({reruns} overflow "
          f"re-runs): {launches}")
    print(f"{name} timings: {det.timings!r}")
    sizes = (MESH_SIZE,) + ((IRIS_SIZE,) if full else ()) + \
        ((EMBED_SIZE,) if embed else ())
    if launches["detection_postprocess"] != runs or launches["nms_core"] \
            or launches["warp_normalize"] != {s: runs + reruns
                                              for s in sizes}:
        raise AssertionError(f"{name}: the main path did not run one K1 "
                             f"launch a batch and one K2 a batch and crop "
                             f"size (plus one a re-run): {launches}")
    if min(per_image) < 1:
        raise AssertionError(f"{name}: an image came back with no face")
    for face in (f for per in faces for f in per):
        if face.mesh.points.shape != (468, 3) or \
                not np.isfinite(face.mesh.points).all():
            raise AssertionError("mesh is not a finite [468, 3] array")
    _profile_batch(det, frames_np, mode, card,
                   net=models.embedding if embed else None)
    det.dispose()

    two = torch.from_numpy(frames_np[:2])
    kw = {"max_faces": MAX_FACES, "with_embeddings": embed}
    with torch.inference_mode():
        slab = build_pipeline_program(models, HEIGHT, WIDTH, mode,
                                      min_score=0.5, **kw)(frames)
        got = build_pipeline_program(models, HEIGHT, WIDTH, mode, **kw)(
            two.to(frames.device))
        want = build_pipeline_program(cpu_models, HEIGHT, WIDTH, mode,
                                      **kw)(two)
    _card_vs_cpu(got, want, name)
    return {"faces": faces, "launches": launches, "slab": slab}


def _check_full_faces(faces, slab) -> None:
    """FULL's own checks: every face has a finite [152, 3] iris, 52
    coefficients in [0, 1] and head angles that are finite or NaN; and in
    the slab each iris's nearest point to its centroid wins by more than
    1e-3 px^2 (else the refined keypoint would hang on an ulp)."""
    import numpy as np
    import torch
    for face in (f for per in faces for f in per):
        angles = face.head_euler_angles
        bs = face.blendshapes
        if face.iris_points.shape != (152, 3) or \
                not np.isfinite(face.iris_points).all():
            raise AssertionError("iris is not a finite [152, 3] array")
        if bs is None or bs.scores.shape != (52,) or \
                not ((bs.scores >= 0) & (bs.scores <= 1)).all():
            raise AssertionError("blendshapes are not 52 values in [0, 1]")
        if angles is None or np.isinf([angles.x, angles.y, angles.z]).any():
            raise AssertionError("head angles are missing or infinite")
    gaps = []
    for sl in (slice(71, 76), slice(147, 152)):
        pts = slab["iris"][..., sl, :2].double()
        d = torch.sort(((pts - pts.mean(-2, keepdim=True)) ** 2).sum(-1),
                       dim=-1).values
        gaps.append((d[..., 1] - d[..., 0])[slab["valid"]].min().item())
    print(f"iris centers: nearest point wins by >= {min(gaps):.4g} px^2 on "
          f"the main path's {int(slab['valid'].sum())} faces")
    if min(gaps) <= 1e-3:
        raise AssertionError("an iris center is within 1e-3 px^2 of a tie: "
                             "pick another seed")


def _check_embeddings(faces) -> None:
    """Every face of the fused embedding stage has a finite 192-dim
    embedding of norm 1 (within 1e-4)."""
    import numpy as np
    for face in (f for per in faces for f in per):
        e = face.embedding
        if e is None or e.shape != (192,) or not np.isfinite(e).all() or \
                abs(float(np.linalg.norm(e)) - 1.0) > 1e-4:
            raise AssertionError("a face lacks a unit 192-dim embedding")


def _check_standalone_embeddings(models, frames_np, card: str) -> None:
    """``get_face_embeddings`` on one frame's faces against their fused
    embeddings, within 1e-3 (the JAX package's bound for the same
    comparison): with the fp32 readback both align on the program's own
    eye points, in float64 on the host and float32 in the program.  The frame must be uploaded once for the
    detection and the embeddings (the one-entry upload cache)."""
    import numpy as np
    from face_detection_tflite_torch import FaceDetector
    det = FaceDetector(models=models, device=models.device,
                       max_faces=MAX_FACES, embed_in_full=True,
                       allow_untrained_embeddings=True,
                       quantized_readback=False)
    img = frames_np[0]
    faces = det.detect_faces(img)
    uploaded = det._devput_cache[2]
    sep = det.get_face_embeddings(faces, img)
    if det._devput_cache[2] is not uploaded:
        raise AssertionError("get_face_embeddings uploaded the frame again")
    err = max(float(np.abs(f.embedding - e).max())
              for f, e in zip(faces, sep))
    print(f"get_face_embeddings on frame 0's {len(faces)} faces vs their "
          f"fused embeddings: max_abs_err={err:.3g} (one upload)  [{card}]")
    if err > 1e-3:
        raise AssertionError("standalone and fused embeddings disagree")
    det.dispose()


def _time_mobilefacenet(net, frames, roi, card: str) -> dict:
    """MobileFaceNet alone on the embedding path's own ``[B * D]`` crops:
    event ms, device ms summed over its kernels and device launches per
    call (:func:`_stage_ms`), and the least time of its convolutions' fp32
    operations (``torch.utils.flop_counter``) at the fp32 peak."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode
    from face_detection_tflite_torch.ops import warp as warp_mod
    with torch.inference_mode():
        x = warp_mod.warp_normalize(frames, *roi, out_size=EMBED_SIZE
                                    ).reshape(-1, EMBED_SIZE, EMBED_SIZE, 3)
        with FlopCounterMode(display=False) as counter:
            net(x)
        flops = counter.get_total_flops()
        ms, dev_ms, launches, layers = _stage_ms(lambda: net(x), iters=10)
    bound = flops / PEAK_FP32_OPS_PER_S * 1e3
    print(f"MobileFaceNet on the path's {x.shape[0]} crops: {ms:.3f} ms event,"
          f" {_num(dev_ms, '.3f')} ms device over {_num(launches)} device "
          f"launches a call (layers {sorted(layers)}); "
          f"{flops / 1e9:.1f} GFLOP of "
          f"convolutions, {flops / x.shape[0] / 2e6:.1f} M multiply-adds a "
          f"face, fp32-peak bound {bound:.3f} ms  [{card}]")
    return {"ms": ms, "device_ms": dev_ms, "launches": launches,
            "gflop": flops / 1e9, "bound_ms": bound}


def _check_warp(frames, roi, s: int, flip, label: str):
    """Holds K2 bit for bit against its plain version on ``roi`` (cx, cy,
    size, cos, sin, each [B, F]) at ``s`` px.  Returns the kernel's
    crops."""
    import torch
    from face_detection_tflite_torch.ops import warp as warp_mod
    with torch.inference_mode():
        out = warp_mod.warp_normalize(frames, *roi, out_size=s, flip=flip)
        torch.cuda.synchronize()
        err = (out - warp_mod.warp_normalize_plain(
            frames, *roi, out_size=s, flip=flip)).abs().max().item()
    if err != 0:
        raise AssertionError(f"K2 {label}: kernel differs from plain by "
                             f"{err}")
    return out


def _check_path_kernels(label: str, models, images, card: str) -> float:
    """Holds K1 and K2 against their plain versions on a path's own
    inputs.  ``images`` are the path's frames as it uploads them ([B, H,
    W, 3] uint8 on the card); K1 gets the detector's raw outputs for
    them at the detector's own input size and anchors
    (:func:`_check_postprocess`), K2 the mesh ROIs of the FULL
    program's detections at 192 px and the eye ROIs of its meshes at
    64 px, right eyes mirrored, as the program's stages make them, each
    bit for bit (:func:`_check_warp`).  Returns K1's box error."""
    import torch
    from face_detection_tflite_torch import FaceDetectionMode
    from face_detection_tflite_torch.ops.letterbox import (letterbox_image,
                                                           letterbox_params)
    from face_detection_tflite_torch.pipeline import geometry
    from face_detection_tflite_torch.pipeline.config import MIN_SCORE
    from face_detection_tflite_torch.pipeline.programs import (
        _identify_detector_outputs, build_pipeline_program)
    b, h, w = images.shape[:3]
    size = models.detector_input_size
    lbp = letterbox_params(h, w, size, size)
    with torch.inference_mode():
        raw_boxes, raw_scores = _identify_detector_outputs(
            models.detector(letterbox_image(images, lbp)))
        err = _check_postprocess(
            f"{label} (B={b}, {w}x{h}, A={raw_scores.shape[1]})",
            (raw_boxes, raw_scores, models.anchors, float(size),
             lbp.padding), {"max_detections": MAX_FACES}, card)
        slab = build_pipeline_program(
            models, h, w, FaceDetectionMode.FULL, max_faces=MAX_FACES,
            min_score=MIN_SCORE)(images)
        faces = int(slab["valid"].sum())
        theta, cx, cy, size = geometry.compute_face_alignment(
            slab["raw_keypoints"], float(w), float(h))
        mroi = [t.contiguous() for t in
                (cx, cy, size, torch.cos(-theta), torch.sin(-theta))]
        ecx, ecy, esize, etheta = (
            t.reshape(b, -1) for t in geometry.eye_rois_from_mesh(slab["mesh"]))
        iroi = [t.contiguous() for t in (ecx, ecy, esize, torch.cos(etheta),
                                         torch.sin(etheta))]
        flip = (torch.arange(2 * MAX_FACES, device=images.device) % 2 == 1
                ).expand(b, -1).contiguous()
    if faces == 0:
        raise AssertionError(f"{label}: no face to hold K2 on")
    _check_warp(images, mroi, MESH_SIZE, None, f"{label} mesh site")
    _check_warp(images, iroi, IRIS_SIZE, flip, f"{label} iris site")
    print(f"K2 warp_normalize {label} (B={b}, {w}x{h}): equal to plain bit "
          f"for bit at {MESH_SIZE} px on {b}x{MAX_FACES} face ROIs and at "
          f"{IRIS_SIZE} px on {b}x{2 * MAX_FACES} eye ROIs ({faces} faces "
          f"valid)  [{card}]")
    return err


def _time_warp(frames, roi, s: int, flip, label: str, sizes, card: str
               ) -> dict:
    """Holds K2 bit for bit against its plain version on ``roi`` (cx, cy,
    size, cos, sin, each [B, F]) at ``s`` px, times it (event and device
    ms), its plain version and ``grid_sample`` on the same sample points,
    and bounds it; ``sizes`` are the valid ROIs' sizes, for the printout.
    Returns those fields of a ``kernels`` entry."""
    import torch
    from face_detection_tflite_torch.ops import warp as warp_mod

    def kernel():
        return warp_mod.warp_normalize(frames, *roi, out_size=s, flip=flip)

    def plain():
        return warp_mod.warp_normalize_plain(frames, *roi, out_size=s,
                                             flip=flip)

    out, err = _check_warp(frames, roi, s, flip, label), 0.0
    with torch.inference_mode():
        ms, dev_ms, dev_by = _kernel_ms(kernel, "K2 warp_normalize")
        plain_ms = _median_ms(plain, iters=5, warmup=1)
        sx, sy = _sample_grid(*roi, s, flip)
        touched_px = _tap_footprint(sx, sy, HEIGHT, WIDTH)
        library, lib_layout = _grid_sample_fn(frames, sx, sy)
        lib_ms = _median_ms(library)
        lib_err = (lib_layout(library()) - out).abs().max().item()
    b, f = roi[0].shape
    bound, by = _warp_bound(touched_px, b, f, s)
    print(f"K2 {label} ({b}x{f} ROIs at {s} px, valid ones "
          f"{sizes.min().item():.1f}-{sizes.max().item():.1f} px, taps touch "
          f"{touched_px} source pixels): max_abs_err={err:.3g}, kernel "
          f"{ms:.4f} ms (device {dev_ms:.4f} ms), plain {plain_ms:.4f} ms, "
          f"grid_sample {lib_ms:.4f} ms (max diff {lib_err:.3g}), bound "
          f"{bound:.6f} ms ({by})  [{card}]")
    return {"max_abs_err": err, "ms": ms, "device_ms": dev_ms,
            "device_ms_by": dev_by,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
            "library_ms": lib_ms}


def _embedding_phase(models, cpu_models, frames, frames_np, runs: int,
                     card: str) -> tuple[dict, dict]:
    """Step 6: FULL with the fused embedding stage through
    :func:`_drive_main_path`, its faces' embeddings, the embedding ROIs'
    sizes, K2 at its 112 px site on the path's own ROIs, MobileFaceNet
    alone, and the standalone embeddings.  Returns the path's result and
    the 112 px site's ``kernels`` fields."""
    import torch
    from face_detection_tflite_torch import FaceDetectionMode
    from face_detection_tflite_torch.models.embedding import \
        alignment_from_eyes
    from face_detection_tflite_torch.pipeline import geometry
    emb = _drive_main_path(models, cpu_models, frames, frames_np,
                           FaceDetectionMode.FULL, runs, card, embed=True)
    _check_embeddings(emb["faces"])
    with torch.inference_mode():
        kp, valid = emb["slab"]["keypoints"], emb["slab"]["valid"]
        ecx, ecy, esize, etheta = alignment_from_eyes(
            kp[..., 0, 0] * WIDTH, kp[..., 0, 1] * HEIGHT,
            kp[..., 1, 0] * WIDTH, kp[..., 1, 1] * HEIGHT)
        # The embedding stage warps with the negated angle.
        eroi = [t.contiguous() for t in (ecx, ecy, esize, torch.cos(-etheta),
                                         torch.sin(-etheta))]
        face_size = geometry.compute_face_alignment(
            emb["slab"]["raw_keypoints"], float(WIDTH), float(HEIGHT))[3]
        ratio = (esize / face_size)[valid]
    print(f"embedding ROIs of the {int(valid.sum())} faces: "
          f"{esize[valid].min().item():.1f}-{esize[valid].max().item():.1f} "
          f"px, {ratio.min().item():.3f}-{ratio.max().item():.3f} of the "
          f"face ROI; face ROIs {face_size[valid].min().item():.1f}-"
          f"{face_size[valid].max().item():.1f} px")
    embed_site = _time_warp(frames, eroi, EMBED_SIZE, None, "embedding site",
                            esize[valid], card)
    _time_mobilefacenet(models.embedding, frames, eroi, card)
    _check_standalone_embeddings(models, frames_np, card)
    return emb, embed_site


def _png_bytes(frame) -> bytes:
    """An 8-bit RGB PNG of ``frame [H, W, 3]`` uint8, written with the
    standard library (filter 0 on every row): lossless, so it decodes to
    the exact frame."""
    import struct
    import zlib
    import numpy as np
    h, w, _ = frame.shape

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data)))

    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           frame.reshape(h, w * 3)], axis=1)
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), 1))
            + chunk(b"IEND", b""))


#: Phase 7's tolerances on faces held against ``detect_faces_batch``'s:
#: normalized boxes, scores and blendshapes; pixel positions (mesh, iris,
#: eye landmarks) one step of the int16 readback (2 * 1280 / 32000 px)
#: plus float rounding; head angles in degrees.  The stream runs the same
#: programs on the same batches as the calls it is held to.
SERVE_TOL = {"unit": 1e-6, "px": 2.0 * WIDTH / 32000.0 + 1e-3,
             "degrees": 1e-3}
#: The server's micro-batches run the networks at other batch sizes than
#: the reference's one batch of 16, and cuDNN picks its algorithms by
#: shape, so unit values may differ in their last bits.
SERVER_TOL = dict(SERVE_TOL, unit=1e-5)
_PX_KEYS = ("mesh", "eyes", "landmarks")


def _payload_errors(got, want, path: str = "", errs=None) -> dict:
    """``{kind: (max abs difference, where)}`` of two ``Face.to_dict``
    payloads (or lists of them) by kind of value (:data:`SERVE_TOL`);
    raises where their structure differs (a face count, a key, a None)."""
    errs = {} if errs is None else errs
    if isinstance(want, dict):
        if not isinstance(got, dict) or set(got) != set(want):
            raise AssertionError(f"faces differ in structure at {path}")
        for k in want:
            _payload_errors(got[k], want[k], f"{path}/{k}", errs)
    elif isinstance(want, list):
        if not isinstance(got, list) or len(got) != len(want):
            raise AssertionError(f"faces differ in count at {path}")
        for i, (g, w) in enumerate(zip(got, want)):
            _payload_errors(g, w, f"{path}/{i}", errs)
    elif isinstance(want, (int, float)) and not isinstance(want, bool):
        kind = ("px" if any(f"/{k}" in path for k in _PX_KEYS) else
                "degrees" if "head_euler_angles" in path else "unit")
        err = abs(float(got) - float(want))
        if err >= errs.get(kind, (0.0, ""))[0]:
            errs[kind] = (err, path)
    elif got != want:
        raise AssertionError(f"faces differ at {path}: {got!r} != {want!r}")
    return errs


def _max_errors(pairs) -> dict:
    """:func:`_payload_errors` over ``(got, want)`` pairs, merged."""
    errs: dict = {}
    for got, want in pairs:
        for k, v in _payload_errors(got, want).items():
            if v[0] >= errs.get(k, (0.0, ""))[0]:
                errs[k] = v
    return errs


def _check_errors(errs: dict, tol: dict, label: str) -> None:
    if any(errs.get(k, (0.0,))[0] > t for k, t in tol.items()):
        raise AssertionError(f"{label}: faces differ beyond {tol}: {errs}")


def _payload(faces) -> list:
    """Per-image lists of ``Face.to_dict`` payloads with the mesh and the
    iris, through a JSON round trip (as the server sends them)."""
    return json.loads(json.dumps([[f.to_dict(include_mesh=True,
                                              include_iris=True)
                                   for f in per] for per in faces]))


def _reset_launches() -> None:
    from face_detection_tflite_torch.ops import detections
    from face_detection_tflite_torch.ops import warp as warp_mod
    detections.detection_postprocess.launches = 0
    warp_mod.warp_normalize.launches = 0
    warp_mod.warp_normalize.launches_by_size = {}


def _launches() -> dict:
    from face_detection_tflite_torch.ops import detections
    from face_detection_tflite_torch.ops import warp as warp_mod
    return {"detection_postprocess": detections.detection_postprocess.launches,
            "warp_normalize": dict(warp_mod.warp_normalize.launches_by_size)}


def _reruns(det) -> int:
    """The detector's overflow re-runs so far (its face-stage calls)."""
    return sum(n for k, n in det.timings.calls.items()
               if k.startswith("face_stages["))


def _check_launches(launches: dict, calls: int, reruns: int, label: str
                    ) -> None:
    """One K1 launch a call, one K2 launch at 192 and at 64 px a call
    (plus one each on an overflow re-run)."""
    want = {"detection_postprocess": calls,
            "warp_normalize": {MESH_SIZE: calls + reruns,
                               IRIS_SIZE: calls + reruns}}
    if launches != want:
        raise AssertionError(f"{label}: launches {launches}, want {want}")


def _busy_us(spans) -> float:
    """Length of the union of ``(start, end)`` spans."""
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(spans):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return busy + (cur_e - cur_s if cur_e is not None else 0.0)


def _upload_times(frames_np, card: str) -> dict:
    """Device and event ms of one frame batch's upload, pinned
    (``pipeline/upload.py``) against pageable (``tensor.to``)."""
    import torch
    from face_detection_tflite_torch.pipeline.upload import upload
    dev = torch.device("cuda")
    out = {}
    for name, fn in (
            ("pinned", lambda: upload(frames_np, dev)),
            ("pageable", lambda: torch.from_numpy(frames_np).to(dev))):
        ms, dev_ms, _, _ = _stage_ms(fn, iters=5)
        out[name] = {"ms": ms, "device_ms": dev_ms}
    print(f"upload of one batch ({frames_np.nbytes / 1e6:.1f} MB): pinned "
          f"{out['pinned']['ms']:.3f} ms event, "
          f"{_num(out['pinned']['device_ms'], '.3f')} ms device; pageable "
          f"{out['pageable']['ms']:.3f} ms event, "
          f"{_num(out['pageable']['device_ms'], '.3f')} ms device  [{card}]")
    return out


def _stream_phase(models, frames_np, runs: int, card: str) -> dict:
    """Phase 7a: ``detect_faces_batch_stream`` over ``runs`` FULL batches
    at depth :data:`STREAM_DEPTH` against the same batches' sequential
    ``detect_faces_batch`` calls, timed in turns (sequential, stream,
    stream, sequential) after a warm-up of both (the speculation state and
    the allocator's blocks for depth + 1 batches in flight); launches and
    faces of the first stream, and the idle share and upload overlap of
    one profiled stream window."""
    import torch
    from face_detection_tflite_torch import FaceDetector
    det = FaceDetector(models=models, device=models.device,
                       max_faces=MAX_FACES)

    def sequential():
        return [det.detect_faces_batch(frames_np) for _ in range(runs)]

    def stream():
        return list(det.detect_faces_batch_stream([frames_np] * runs,
                                                  depth=STREAM_DEPTH))

    det.detect_faces_batch(frames_np)
    list(det.detect_faces_batch_stream([frames_np] * (STREAM_DEPTH + 1),
                                       depth=STREAM_DEPTH))
    ms: dict = {"sequential": [], "stream": []}
    outs: dict = {}
    for name in ("sequential", "stream", "stream", "sequential"):
        reruns0 = _reruns(det)
        _reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = (sequential if name == "sequential" else stream)()
        torch.cuda.synchronize()
        ms[name].append((time.perf_counter() - t0) * 1e3 / runs)
        if name not in outs:
            outs[name] = out
            if name == "stream":
                launches = _launches()
                reruns = _reruns(det) - reruns0
    seq, streamed = outs["sequential"], outs["stream"]
    seq_ms, stream_ms = ms["sequential"], ms["stream"]
    _check_launches(launches, runs, reruns, "stream")
    errs = _max_errors((_payload(g), _payload(w))
                       for g, w in zip(streamed, seq))
    print(f"stream (depth {STREAM_DEPTH}) of {runs} FULL batches of {FRAMES}"
          f" x {HEIGHT}x{WIDTH}, in turns sequential, stream, stream, "
          f"sequential: stream {['%.2f' % t for t in stream_ms]} ms a batch "
          f"against sequential {['%.2f' % t for t in seq_ms]}; faces equal "
          f"them within {errs}; launches {launches} ({reruns} re-runs)  "
          f"[{card}]")
    _check_errors(errs, SERVE_TOL, "stream")

    def window():
        t0 = time.perf_counter()
        list(det.detect_faces_batch_stream([frames_np] * 4,
                                           depth=STREAM_DEPTH))
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    wall_ms, device = _profiled(window, lambda name: True, "the stream")
    result = {"stream_ms": stream_ms, "sequential_ms": seq_ms,
              "launches": launches}
    if not device:
        print("profile: the stream window is not measured")
        det.dispose()
        return result
    copies = [(s, e) for s, e, n in device if "HtoD" in n]
    work = [(s, e) for s, e, n in device if "Memcpy" not in n
            and "Memset" not in n]
    window_us = max(e for _, e, _ in device) - min(s for s, _, _ in device)
    busy = _busy_us([(s, e) for s, e, _ in device])
    # Upload time that runs under kernels: each copy against the union of
    # the kernels that overlap it.
    overlap = sum(_busy_us([(max(s, ks), min(e, ke)) for ks, ke in work
                            if ks < e and ke > s]) for s, e in copies)
    copy_us = sum(e - s for s, e in copies)
    kinds = sorted({n for _, _, n in device if "HtoD" in n})
    print(f"profile (stream of 4 FULL batches, depth {STREAM_DEPTH}, host "
          f"wall {wall_ms:.2f} ms) [{card}]: device busy "
          f"{busy / 1e3:.3f} ms of {window_us / 1e3:.3f} ms (idle share "
          f"{1 - busy / window_us:.3f}); uploads {copy_us / 1e3:.3f} ms, of "
          f"it {overlap / 1e3:.3f} ms ({overlap / max(copy_us, 1e-9):.3f}) "
          f"under kernels; copies {kinds}")
    result.update(idle_share=1 - busy / window_us,
                  upload_overlap=overlap / max(copy_us, 1e-9))
    det.dispose()
    return result


def _version(module: str) -> str:
    """A module's version, or "absent"."""
    import importlib
    try:
        return getattr(importlib.import_module(module), "__version__", "?")
    except ImportError:
        return "absent"


def _post(url: str, body: bytes, timeout: float = 120.0):
    """(status, JSON payload, headers, seconds) of one POST."""
    import urllib.error
    import urllib.request
    t0 = time.perf_counter()
    req = urllib.request.Request(url, data=body, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read()), dict(r.headers), \
                time.perf_counter() - t0
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), dict(e.headers), \
            time.perf_counter() - t0


def _client(job) -> list:
    """One client process of phase 7b: POSTs its ``(frame index, mode,
    PNG body)`` requests to ``base`` one after another; returns ``(frame
    index, mode, status, payload, start, end)`` with wall-clock times."""
    base, requests = job
    out = []
    for i, mode, body in requests:
        t0 = time.time()
        status, payload, _, _ = _post(
            f"{base}/v1/detect?mode={mode}&mesh=1&iris=1", body)
        out.append((i, mode, status, payload, t0, time.time()))
    return out


def _get(url: str):
    import urllib.request
    with urllib.request.urlopen(url, timeout=60) as r:
        body = r.read()
    return json.loads(body) if url.endswith("info") else body.decode()


def _server_phase(models, frames_np, kind: str, card: str) -> dict:
    """Phase 7b: ``FaceServer`` on 127.0.0.1 over a FULL-default detector;
    :data:`CLIENTS` client processes (their JSON parsing stays out of the
    server's interpreter) each POST :data:`REQUESTS_PER_CLIENT` of the
    frames as PNG bodies (3 of 4 ``mode=full``, the rest standard), each
    response held against ``detect_faces_batch``; the micro-batches, K1's
    launches against them, ``/v1/info``, ``/v1/embed``, and a second
    server with ``max_queue=2`` shedding a burst with 503 + Retry-After."""
    import multiprocessing
    import threading
    import numpy as np
    import torch
    from face_detection_tflite_torch import (FaceDetectionMode, FaceDetector,
                                             FaceServer)
    det = FaceDetector(models=models, device=models.device,
                       max_faces=MAX_FACES, allow_untrained_embeddings=True)
    modes = {"full": FaceDetectionMode.FULL,
             "standard": FaceDetectionMode.STANDARD}
    want = {m: _payload(det.detect_faces_batch(frames_np, mode))
            for m, mode in modes.items()}
    from face_detection_tflite_torch.utils import native
    print(f"decoder: native {native.runtime_status()}; PIL "
          f"{_version('PIL')}, cv2 {_version('cv2')}")
    t0 = time.perf_counter()
    bodies = [_png_bytes(f) for f in frames_np]
    print(f"PNG bodies: {sum(map(len, bodies)) / 1e6:.1f} MB for {FRAMES} "
          f"frames, encoded in {time.perf_counter() - t0:.2f} s")
    # A 50 ms window (4 by default): each client sends its next request
    # when its answer comes, so requests arrive about one micro-batch's
    # time over the clients apart.
    server = FaceServer(det, batch_window_ms=50.0).start()
    sizes: list = []
    hist = server._m_batch

    class _Recorder:
        def observe(self, v):
            sizes.append(v)
            hist.observe(v)

    server._batcher._metrics["batch_size"] = _Recorder()
    jobs = [(server.address, [
        ((c * REQUESTS_PER_CLIENT + j) % FRAMES,
         "standard" if j == REQUESTS_PER_CLIENT - 1 else "full",
         bodies[(c * REQUESTS_PER_CLIENT + j) % FRAMES])
        for j in range(REQUESTS_PER_CLIENT)]) for c in range(CLIENTS)]
    with multiprocessing.get_context("spawn").Pool(CLIENTS) as pool:
        pool.map(time.sleep, [0.5] * CLIENTS)    # every client is up
        torch.cuda.synchronize()
        _reset_launches()
        results = [r for per in pool.map(_client, jobs, chunksize=1)
                   for r in per]
    wall = max(r[5] for r in results) - min(r[4] for r in results)
    launches = _launches()
    batch_sizes = list(sizes)
    n_req = CLIENTS * REQUESTS_PER_CLIENT
    statuses = [r[2] for r in results]
    if len(results) != n_req or set(statuses) != {200}:
        raise AssertionError(f"server: {statuses.count(200)} of {n_req} "
                             f"requests answered 200: {statuses}")
    errs = _max_errors((payload["faces"], want[mode][i])
                       for i, mode, _, payload, _, _ in results)
    lat = sorted((r[5] - r[4]) * 1e3 for r in results)
    metrics = _get(f"{server.address}/metrics")
    count = next(float(line.split()[-1]) for line in metrics.splitlines()
                 if line.startswith("fdt_detect_batch_size_count"))
    print(f"server: {n_req} requests from {CLIENTS} client processes in "
          f"{wall:.3f} s "
          f"= {n_req / wall:.1f} requests/s; latency p50 "
          f"{np.percentile(lat, 50):.1f} ms, p99 {np.percentile(lat, 99):.1f}"
          f" ms; micro-batch sizes {batch_sizes}; launches {launches}; faces "
          f"equal detect_faces_batch's within {errs}  [{card}]")
    _check_errors(errs, SERVER_TOL, "server")
    if max(batch_sizes) < 2:
        raise AssertionError("server: no micro-batch held more than one "
                             "image")
    if launches["detection_postprocess"] != len(batch_sizes) or \
            count != len(batch_sizes):
        raise AssertionError(f"server: {launches['detection_postprocess']} "
                             f"K1 launches for {len(batch_sizes)} micro-batches "
                             f"({count} in /metrics)")
    info = _get(f"{server.address}/v1/info")
    if kind not in info["accelerator_report"]["detector"]:
        raise AssertionError(f"/v1/info does not name the card: {info}")
    print(f"/v1/info accelerator_report {info['accelerator_report']}, "
          f"memory_report {info['memory_report']}")

    # /v1/embed on frame 0 against get_face_embeddings on its faces.
    _reset_launches()
    status, emb, _, _ = _post(f"{server.address}/v1/embed", bodies[0])
    embed_launches = _launches()
    faces0 = det.detect_faces(frames_np[0], FaceDetectionMode.STANDARD)
    ref = det.get_face_embeddings(faces0, frames_np[0])
    got = [f["embedding"] for f in emb["faces"]]
    if status != 200 or emb["pretrained"] is not False or \
            len(got) != len(ref) or any(e is None for e in got):
        raise AssertionError(f"/v1/embed: status {status}, pretrained "
                             f"{emb.get('pretrained')}, {len(got)} faces "
                             f"against {len(ref)}")
    norm_err = max(abs(float(np.linalg.norm(e)) - 1.0) for e in got)
    emb_err = max(float(np.abs(np.asarray(g) - r).max())
                  for g, r in zip(got, ref))
    print(f"/v1/embed on frame 0: {len(got)} faces, unit within "
          f"{norm_err:.3g}, get_face_embeddings within {emb_err:.3g}; "
          f"launches {embed_launches}  [{card}]")
    if norm_err > 1e-4 or emb_err > 1e-4:
        raise AssertionError("/v1/embed disagrees with get_face_embeddings")
    server.close()

    # A second server with max_queue=2 and one image a micro-batch sheds
    # part of a burst, then answers again.
    shed_server = FaceServer(det, max_queue=2, max_batch=1).start()
    burst: list = []
    lock = threading.Lock()

    def one(i):
        r = _post(f"{shed_server.address}/v1/detect?mode=full",
                  bodies[i % FRAMES])
        with lock:
            burst.append(r)

    threads = [threading.Thread(target=one, args=(i,)) for i in range(16)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    shed = [r for r in burst if r[0] == 503]
    later = _post(f"{shed_server.address}/v1/detect?mode=full", bodies[1])
    print(f"shedding (max_queue=2, max_batch=1): burst of 16 gave statuses "
          f"{sorted(r[0] for r in burst)}, Retry-After "
          f"{[r[2].get('Retry-After') for r in shed][:3]}; a later request "
          f"{later[0]}")
    if not shed or any(r[2].get("Retry-After") is None for r in shed) or \
            set(r[0] for r in burst) - {200, 503} or later[0] != 200:
        raise AssertionError("server: the burst was not shed with 503 + "
                             "Retry-After, or no later request succeeded")
    shed_server.close()
    det.dispose()
    return {"requests_per_s": n_req / wall, "p50_ms": np.percentile(lat, 50),
            "p99_ms": np.percentile(lat, 99), "batch_sizes": batch_sizes,
            "launches": launches, "embed_launches": embed_launches}


def _bit_equal(a, b) -> bool:
    """Bit for bit equality (NaN, which the head angles of empty slab
    slots hold, equals itself)."""
    import torch
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a, b)


def _threads_phase(models, frames, card: str) -> None:
    """Phase 7c: the FULL program and MobileFaceNet on two threads at once,
    :data:`THREAD_RUNS` times; both outputs must equal their
    single-threaded outputs bit for bit (TF32 stays off in both)."""
    import threading
    import torch
    from face_detection_tflite_torch import FaceDetectionMode
    from face_detection_tflite_torch.pipeline.programs import \
        build_pipeline_program
    prog = build_pipeline_program(models, HEIGHT, WIDTH,
                                  FaceDetectionMode.FULL,
                                  max_faces=MAX_FACES)
    x = frames[:4]
    crops = torch.rand((64, EMBED_SIZE, EMBED_SIZE, 3), device=x.device,
                       generator=torch.Generator(x.device).manual_seed(SEED)
                       ) * 2 - 1
    with torch.inference_mode():
        want_full = prog(x)
        (want_emb,) = models.embedding(crops)
    torch.cuda.synchronize()
    bad: list = []

    def run(fn, want, what):
        with torch.inference_mode():
            for i in range(THREAD_RUNS):
                got = fn()
                torch.cuda.synchronize()
                if isinstance(want, dict):
                    same = all(_bit_equal(got[k], want[k]) for k in want)
                else:
                    same = _bit_equal(got[0], want)
                if not same:
                    bad.append((what, i))

    threads = [threading.Thread(target=run, args=(lambda: prog(x), want_full,
                                                  "FULL program")),
               threading.Thread(target=run, args=(
                   lambda: models.embedding(crops), want_emb,
                   "MobileFaceNet"))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    print(f"two threads, {THREAD_RUNS} runs each of the FULL program (4 "
          f"frames) and MobileFaceNet (64 crops): "
          f"{'bit-identical to one thread' if not bad else bad}  [{card}]")
    if bad:
        raise AssertionError(f"two-thread outputs differ: {bad}")


# -- phase 8: video, camera, standalone ----------------------------------------

#: Phase 8a: a 32-frame 720p clip (a 720p camera's frame), decoded batches
#: of 8 through ``detect_faces_from_video``.
VIDEO_FRAMES, VIDEO_H, VIDEO_W, VIDEO_BATCH = 32, 720, 1280, 8
VIDEO_FPS, VIDEO_PAN = 25.0, 3
#: Phase 8b: camera frames made from the first decoded frames, padded rows.
CAMERA_FRAMES, CAMERA_ROW_PAD = 4, 64
#: Phase 8c: standalone ``FaceDetection`` calls counted and timed.
STANDALONE_CALLS = 20


def _texture_frames(seed: int, n: int, h: int, w: int, pan: int):
    """``n`` RGB uint8 frames of a smooth seeded texture (noise at 1/8
    resolution, upscaled with cv2's cubic filter), panned ``pan`` px a
    frame, so that detections move coherently from frame to frame."""
    import cv2
    import numpy as np
    rng = np.random.default_rng(seed)
    small = rng.integers(0, 256, (h // 8 + 2, (w + pan * n) // 8 + 2, 3),
                         dtype=np.uint8)
    big = cv2.resize(small, (small.shape[1] * 8, small.shape[0] * 8),
                     interpolation=cv2.INTER_CUBIC)
    return np.stack([big[:h, i * pan:i * pan + w] for i in range(n)])


def _write_clip(frames, directory: str) -> tuple[str, str]:
    """Writes ``frames`` (RGB) as a clip in ``directory`` with cv2: mp4v,
    else MJPG.  Returns (path, codec)."""
    import cv2
    import numpy as np
    h, w = frames.shape[1:3]
    for codec, ext in (("mp4v", "mp4"), ("MJPG", "avi")):
        path = os.path.join(directory, f"clip.{ext}")
        writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*codec),
                                 VIDEO_FPS, (w, h))
        if writer.isOpened():
            for f in frames:
                writer.write(np.ascontiguousarray(f[..., ::-1]))
            writer.release()
            return path, codec
    raise RuntimeError("cv2 can write neither mp4v nor MJPG here")


def _read_clip(path: str):
    """(every frame of the clip as cv2 decodes it, RGB, stacked; its frame
    rate)."""
    import cv2
    import numpy as np
    cap = cv2.VideoCapture(path)
    frames = []
    try:
        fps = cap.get(cv2.CAP_PROP_FPS) or 30.0
        while True:
            ok, f = cap.read()
            if not ok:
                break
            frames.append(f[..., ::-1])
    finally:
        cap.release()
    return np.stack(frames), fps


def _face_json(faces) -> list:
    """Per-image JSON strings of the faces' payloads without their
    tracking IDs: Python floats print exactly, so equal strings are equal
    values bit for bit (NaN head angles included)."""
    out = []
    for per in faces:
        payload = [f.to_dict(include_mesh=True, include_iris=True)
                   for f in per]
        for p in payload:
            p.pop("tracking_id")
        out.append(json.dumps(payload))
    return out


def _video_phase(frames_dev, card: str) -> dict:
    """Phase 8a: a seeded 720p clip written and decoded with cv2, the
    detector calibrated on the decoded frames, ``detect_faces_from_video``
    (FULL, tracking on) against ``detect_faces_batch`` on the same decoded
    frames in the same batches (faces bit for bit, from two fresh
    detectors, so that both run the same speculative slabs), the IDs
    against a fresh ``TemporalFaceTracker`` on the same boxes, the
    launches, K1 and K2 against their plain versions on every batch's
    frames (:func:`_check_path_kernels`), a strided and downscaled run,
    ``reset_tracking``, and the smoothers' host time on the tracked
    faces.  Returns the models and
    decoded frames (for phase 8b) and the counts and times."""
    import tempfile
    import numpy as np
    import torch
    from face_detection_tflite_torch import (FaceDetector, FaceSmoother,
                                             TemporalFaceTracker)
    from face_detection_tflite_torch.models import random_init
    from face_detection_tflite_torch.pipeline.video import _read_frames
    dev = frames_dev.device
    raw = _texture_frames(SEED, VIDEO_FRAMES, VIDEO_H, VIDEO_W, VIDEO_PAN)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        path, codec = _write_clip(raw, tmp)
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        decoded, fps = _read_clip(path)
        read_s = time.perf_counter() - t0
        if decoded.shape != raw.shape:
            raise AssertionError(f"clip decodes to {decoded.shape}, wrote "
                                 f"{raw.shape}")
        print(f"video: {VIDEO_FRAMES} frames of {VIDEO_W}x{VIDEO_H} written "
              f"as {codec} ({os.path.getsize(path) / 1e6:.2f} MB) in "
              f"{write_s:.2f} s, decoded in {read_s:.2f} s; decoded vs "
              f"written mean abs diff "
              f"{np.abs(decoded.astype(np.int16) - raw).mean():.2f}")
        t0 = time.perf_counter()
        models, *_ = random_init.random_pipeline_models(
            torch.from_numpy(decoded).to(dev), seed=SEED)
        print(f"video models: seeded full-depth networks calibrated on the "
              f"decoded frames in {time.perf_counter() - t0:.2f} s")

        def detector(tracking: bool):
            return FaceDetector(models=models, device=dev,
                                max_faces=MAX_FACES,
                                enable_tracking=tracking)

        batches = [decoded[i:i + VIDEO_BATCH]
                   for i in range(0, VIDEO_FRAMES, VIDEO_BATCH)]
        warm = detector(True)
        for b in batches:
            warm.detect_faces_batch(b)
        warm.dispose()

        det = detector(True)
        _reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results = list(det.detect_faces_from_video(path,
                                                   batch_size=VIDEO_BATCH))
        torch.cuda.synchronize()
        video_s = time.perf_counter() - t0
        launches = _launches()
        reruns = _reruns(det)
        ref_det = detector(False)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref = [faces for b in batches for faces in ref_det.detect_faces_batch(b)]
        torch.cuda.synchronize()
        batch_s = time.perf_counter() - t0
        ref_det.dispose()

        n_batches = len(batches)
        _check_launches(launches, n_batches, reruns, "video")
        if [r.frame_index for r in results] != list(range(VIDEO_FRAMES)) or \
                any(r.timestamp_s != r.frame_index / fps for r in results):
            raise AssertionError("video: frames or timestamps out of order")
        got = [r.faces for r in results]
        if _face_json(got) != _face_json(ref):
            raise AssertionError("video: faces differ from detect_faces_batch"
                                 "'s on the same decoded frames")
        tracker = TemporalFaceTracker()
        ids = [[f.tracking_id for f in per] for per in got]
        want_ids = [tracker.update([[f.bounding_box.xmin, f.bounding_box.ymin,
                                     f.bounding_box.xmax, f.bounding_box.ymax]
                                    for f in per]) for per in got]
        if ids != want_ids:
            raise AssertionError("video: tracking IDs differ from a fresh "
                                 "tracker's on the same boxes")
        n_faces = sum(map(len, got))
        if n_faces == 0:
            raise AssertionError("video: no face in any frame")
        post_err = max(_check_path_kernels(f"video batch {i}", models,
                                           torch.from_numpy(b).to(dev), card)
                       for i, b in enumerate(batches))
        carried = sum(1 for prev, cur in zip(ids, ids[1:])
                      for i in cur if i in prev)
        share = carried / max(1, sum(map(len, ids[1:])))
        print(f"video (FULL, tracking, batches of {VIDEO_BATCH}): "
              f"detect_faces_from_video {VIDEO_FRAMES / video_s:.1f} frames/s "
              f"({video_s * 1e3 / VIDEO_FRAMES:.2f} ms a frame) against "
              f"detect_faces_batch alone on the decoded frames "
              f"{VIDEO_FRAMES / batch_s:.1f} frames/s "
              f"({batch_s * 1e3 / VIDEO_FRAMES:.2f} ms a frame); faces per "
              f"frame {[len(p) for p in got]}, equal bit for bit; "
              f"{len({i for per in ids for i in per})} IDs, {share:.3f} of "
              f"the faces carried their ID over from the frame before; "
              f"launches {launches} ({reruns} re-runs)  [{card}]")

        # The host work of the video path alone: the reader (cv2's decode
        # and BGR-to-RGB conversion) and the batch's np.stack of its
        # frames; as a yardstick for the reader's contiguous conversion,
        # np.stack of one batch of negative-stride BGR-to-RGB views (the
        # JAX reader's frames).
        t0 = time.perf_counter()
        rgb = [f for _, _, f in _read_frames(path, 1, None)]
        read_ms = (time.perf_counter() - t0) * 1e3 / len(rgb)
        stack_ms = {}
        t0 = time.perf_counter()
        for i in range(0, len(rgb), VIDEO_BATCH):
            np.stack(rgb[i:i + VIDEO_BATCH])
        stack_ms["reader's frames"] = (time.perf_counter() - t0) * 1e3 / \
            n_batches
        views = [np.ascontiguousarray(f[..., ::-1])[..., ::-1]
                 for f in rgb[:VIDEO_BATCH]]
        t0 = time.perf_counter()
        np.stack(views)
        stack_ms["views"] = (time.perf_counter() - t0) * 1e3
        print(f"video host work alone: reader {read_ms:.2f} ms a frame "
              f"(cv2 decode, BGR-to-RGB conversion); np.stack a batch of "
              f"{VIDEO_BATCH}: {stack_ms} ms  [{card}]")

        smooth_ms = {}
        for method in ("one_euro", "ema"):
            sm = FaceSmoother(method=method)
            t0 = time.perf_counter()
            for r in results:
                sm.smooth(r.faces, t_sec=r.timestamp_s)
            smooth_ms[method] = (time.perf_counter() - t0) * 1e3 / \
                VIDEO_FRAMES
        print(f"smoothing on the host, ms a frame of "
              f"{n_faces / VIDEO_FRAMES:.1f} faces: {smooth_ms}  [{card}]")

        # Strided and downscaled to half size, then a reset: IDs restart
        # at 1.
        half = VIDEO_W // 2
        strided = list(det.detect_faces_from_video(
            path, batch_size=VIDEO_BATCH, frame_stride=2, max_frames=8,
            max_dim=half))
        sizes = {f.original_size for r in strided for f in r.faces}
        if [r.frame_index for r in strided] != list(range(0, 16, 2)) or \
                sizes != {(half, VIDEO_H // 2)}:
            raise AssertionError(f"video: frame_stride=2, max_frames=8, "
                                 f"max_dim={half} gave frames "
                                 f"{[r.frame_index for r in strided]} of "
                                 f"sizes {sizes}")
        det.reset_tracking()
        again = list(det.detect_faces_from_video(path, batch_size=VIDEO_BATCH,
                                                 max_frames=VIDEO_BATCH))
        first = next([f.tracking_id for f in r.faces] for r in again
                     if r.faces)
        if sorted(first) != list(range(1, len(first) + 1)):
            raise AssertionError(f"video: IDs after reset_tracking {first}")
        print(f"video: frame_stride=2, max_frames=8, max_dim={half} gave "
              f"frames "
              f"{[r.frame_index for r in strided]} of {sizes}; after "
              f"reset_tracking the first frame's IDs are {first}")
        det.dispose()
    return {"models": models, "decoded": decoded, "launches": launches,
            "batches": n_batches, "post_err": post_err, "video_fps": VIDEO_FRAMES / video_s,
            "batch_fps": VIDEO_FRAMES / batch_s, "carried": share,
            "read_ms": read_ms, "stack_ms": stack_ms,
            "smooth_ms": smooth_ms}


def _camera_frames(rgb):
    """The camera frames of phase 8b from one RGB frame: I420, NV12 and
    NV21 (cv2's BT.601 ``COLOR_RGB2YUV_I420``, chroma interleaved for the
    NV layouts), RGBA and BGRA, every row padded by
    :data:`CAMERA_ROW_PAD` bytes, as (format, bytes, Y or RGBA row
    stride)."""
    import cv2
    import numpy as np
    h, w = rgb.shape[:2]
    yuv = cv2.cvtColor(np.ascontiguousarray(rgb), cv2.COLOR_RGB2YUV_I420)
    y = yuv[:h]
    u = yuv[h:h + h // 4].reshape(h // 2, w // 2)
    v = yuv[h + h // 4:].reshape(h // 2, w // 2)

    def pad(plane, stride):
        out = np.zeros((plane.shape[0], stride), np.uint8)
        out[:, :plane.shape[1]] = plane
        return out.tobytes()

    def inter(a, b):
        out = np.empty((a.shape[0], 2 * a.shape[1]), np.uint8)
        out[:, 0::2], out[:, 1::2] = a, b
        return out

    ys = w + CAMERA_ROW_PAD
    alpha = np.full((h, w, 1), 255, np.uint8)
    return [
        ("i420", pad(y, ys) + pad(u, (ys + 1) // 2) + pad(v, (ys + 1) // 2),
         ys),
        ("nv12", pad(y, ys) + pad(inter(u, v), ys), ys),
        ("nv21", pad(y, ys) + pad(inter(v, u), ys), ys),
        ("rgba", pad(np.concatenate([rgb, alpha], -1).reshape(h, -1),
                     4 * w + CAMERA_ROW_PAD), 4 * w + CAMERA_ROW_PAD),
        ("bgra", pad(np.concatenate([rgb[..., ::-1], alpha], -1).reshape(
            h, -1), 4 * w + CAMERA_ROW_PAD), 4 * w + CAMERA_ROW_PAD)]


class _Plane:
    """A duck-typed camera plane (Flutter's ``CameraImage`` shape)."""

    def __init__(self, data: bytes, bytes_per_row: int,
                 bytes_per_pixel: int = 1):
        self.bytes = data
        self.bytesPerRow = bytes_per_row
        self.bytesPerPixel = bytes_per_pixel


def _camera_phase(models, decoded, card: str) -> dict:
    """Phase 8b: :data:`CAMERA_FRAMES` decoded frames as I420, NV12, NV21,
    RGBA and BGRA camera frames with padded rows under the four
    rotations, through ``detect_faces_from_camera_frame`` (FULL), and the
    I420 ones also as a duck-typed planes object through
    ``detect_faces_from_camera_image``: faces equal bit for bit to
    ``detect_faces(decode_camera_frame(frame))`` on a second fresh
    detector over the same sequence; one K1 launch and one K2 launch at
    each site a frame (plus re-runs); K1 and K2 against their plain
    versions on the first landscape and the first portrait frame
    (:func:`_check_path_kernels`); the host ms of the decode and the ms a
    frame."""
    import numpy as np
    import torch
    from face_detection_tflite_torch import (CameraFormat, CameraFrame,
                                             CameraRotation, FaceDetector,
                                             decode_camera_frame)
    dev = models.device
    calls = []     # (camera-path call, the frame it decodes to)
    formats = []   # each call's format and rotation
    decode_ms: dict = {}
    for i, rgb in enumerate(decoded[:CAMERA_FRAMES]):
        h, w = rgb.shape[:2]
        for j, (fmt, data, stride) in enumerate(_camera_frames(rgb)):
            rot = CameraRotation((90 * (i + j)) % 360)
            frame = CameraFrame(data, w, h, CameraFormat(fmt), rot,
                                row_stride=stride)
            t0 = time.perf_counter()
            image = decode_camera_frame(frame)
            decode_ms.setdefault(fmt, []).append(
                (time.perf_counter() - t0) * 1e3)
            calls.append((lambda d, fr=frame: d.detect_faces_from_camera_frame(
                fr), image))
            formats.append(f"{fmt} {rot.value}")
            if fmt == "i420":
                ys, cs = stride, (stride + 1) // 2
                y_n, c_n = ys * h, cs * (h // 2)
                cam = {"width": w, "height": h, "planes": [
                    _Plane(data[:y_n], ys), _Plane(data[y_n:y_n + c_n], cs),
                    _Plane(data[y_n + c_n:], cs)]}
                calls.append((lambda d, c=cam, r=rot:
                              d.detect_faces_from_camera_image(
                                  c, rotation=r), image))
                formats.append(f"i420 planes {rot.value}")
    det = FaceDetector(models=models, device=dev, max_faces=MAX_FACES)
    # Warm the programs of both orientations.
    for image in {image.shape: image for _, image in calls}.values():
        det.detect_faces(image)
    det.dispose()
    det = FaceDetector(models=models, device=dev, max_faces=MAX_FACES)
    _reset_launches()
    got, frame_ms = [], []
    for call, _ in calls:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got.append(call(det))
        torch.cuda.synchronize()
        frame_ms.append((time.perf_counter() - t0) * 1e3)
    launches = _launches()
    reruns = _reruns(det)
    det.dispose()
    _check_launches(launches, len(calls), reruns, "camera")
    ref_det = FaceDetector(models=models, device=dev, max_faces=MAX_FACES)
    want, detect_ms = [], []
    for _, image in calls:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want.append(ref_det.detect_faces(image))
        torch.cuda.synchronize()
        detect_ms.append((time.perf_counter() - t0) * 1e3)
    ref_det.dispose()
    if _face_json(got) != _face_json(want):
        raise AssertionError("camera: faces differ from detect_faces("
                             "decode_camera_frame(frame))'s")
    if sum(map(len, got)) == 0:
        raise AssertionError("camera: no face in any frame")
    first = {}     # the first frame of each orientation
    for (_, image), name in zip(calls, formats):
        first.setdefault(image.shape, (name, image))
    post_err = max(_check_path_kernels(
        f"camera {name}", models,
        torch.from_numpy(np.ascontiguousarray(image)[None]).to(dev), card)
        for name, image in first.values())
    decode = {k: statistics.median(v) for k, v in decode_ms.items()}
    print(f"camera (FULL, {len(calls)} frames: {CAMERA_FRAMES} frames x 5 "
          f"formats, rows padded by {CAMERA_ROW_PAD} B, rotations 0-270, "
          f"I420 also as planes): faces per frame "
          f"{[len(f) for f in got]}, equal bit for bit; decode ms "
          f"{ {k: round(v, 3) for k, v in decode.items()} }; ms a frame "
          f"median {statistics.median(frame_ms):.2f} (min "
          f"{min(frame_ms):.2f}, max {max(frame_ms):.2f}), of it "
          f"detect_faces on the decoded frame median "
          f"{statistics.median(detect_ms):.2f}; launches {launches} "
          f"({reruns} re-runs)  [{card}]")
    return {"launches": launches, "frames": len(calls), "post_err": post_err,
            "decode_ms": decode, "frame_ms": statistics.median(frame_ms),
            "detect_ms": statistics.median(detect_ms)}


def _standalone_phase(models, cpu_models, frames, frames_np, slab, iroi,
                      card: str) -> dict:
    """Phase 8c: standalone ``FaceDetection`` on frame 0 of the main path
    (card against CPU: the same count, boxes and keypoints within
    :data:`CPU_TOLERANCES`, scores within 1e-6; one K1 launch a call over
    :data:`STANDALONE_CALLS` calls; K1 against its plain version on the
    call's own raw outputs; ms a call and K1's device ms at B = 1), then ``FaceLandmark``, ``IrisLandmark`` and
    ``FaceBlendshapesModel`` on the main path's own crops (K2's 192 and
    64 px crops turned back to uint8, the 146 packed points of a FULL
    face), card against CPU within 1e-5 of the largest magnitude (the
    blendshapes within :data:`CPU_TOLERANCES`)."""
    import numpy as np
    import torch
    from face_detection_tflite_torch import (FaceBlendshapesModel,
                                             FaceDetection, FaceLandmark,
                                             IrisLandmark)
    from face_detection_tflite_torch.ops import detections
    from face_detection_tflite_torch.ops import warp as warp_mod
    from face_detection_tflite_torch.ops.letterbox import (letterbox_image,
                                                           letterbox_params)
    from face_detection_tflite_torch.pipeline import geometry
    from face_detection_tflite_torch.pipeline.blendshape_input import \
        pack_blendshape_input
    from face_detection_tflite_torch.pipeline.programs import \
        _identify_detector_outputs
    img = frames_np[0]
    card_fd = FaceDetection(model=models.detector, device=models.device,
                            max_detections=MAX_FACES)
    cpu_fd = FaceDetection(model=cpu_models.detector, device="cpu",
                           max_detections=MAX_FACES)
    card_fd(img)
    detections.detection_postprocess.launches = 0
    for _ in range(STANDALONE_CALLS):
        got = card_fd(img)
    launches = detections.detection_postprocess.launches
    if launches != STANDALONE_CALLS:
        raise AssertionError(f"standalone FaceDetection: {launches} K1 "
                             f"launches for {STANDALONE_CALLS} calls")
    want = cpu_fd(img)
    if len(got) != len(want) or not got:
        raise AssertionError(f"standalone FaceDetection: {len(got)} "
                             f"detections on the card, {len(want)} on the "
                             f"CPU")
    box_err = max(float(np.abs(np.subtract(
        [g.bounding_box.xmin, g.bounding_box.ymin, g.bounding_box.xmax,
         g.bounding_box.ymax],
        [w.bounding_box.xmin, w.bounding_box.ymin, w.bounding_box.xmax,
         w.bounding_box.ymax])).max()) for g, w in zip(got, want))
    kp_err = max(float(np.abs(g.keypoints_xy - w.keypoints_xy).max())
                 for g, w in zip(got, want))
    score_err = max(abs(g.score - w.score) for g, w in zip(got, want))
    ms = _median_ms(lambda: card_fd(img))
    lbp = letterbox_params(HEIGHT, WIDTH, 256, 256)
    with torch.inference_mode():
        rb, rs = _identify_detector_outputs(
            models.detector(letterbox_image(frames[:1], lbp)))
        post_err = _check_postprocess(
            "standalone FaceDetection (B=1)",
            (rb, rs, models.anchors, 256.0, lbp.padding),
            {"max_detections": MAX_FACES}, card)
        k1_ms, k1_dev_ms, k1_by = _kernel_ms(
            lambda: detections.detection_postprocess(
                rb, rs, models.anchors, 256.0, lbp.padding,
                max_detections=MAX_FACES), "K1 detection_postprocess")
    print(f"standalone FaceDetection on frame 0 ({len(got)} detections): "
          f"card vs CPU boxes within {box_err:.3g}, keypoints within "
          f"{kp_err:.3g}, scores within {score_err:.3g}; {launches} K1 "
          f"launches for {STANDALONE_CALLS} calls; {ms:.3f} ms a call; K1 at "
          f"B = 1: {k1_ms:.4f} ms event, {k1_dev_ms:.4f} ms device ({k1_by})"
          f"  [{card}]")
    if box_err > CPU_TOLERANCES["boxes"] or \
            kp_err > CPU_TOLERANCES["keypoints"] or score_err > 1e-6:
        raise AssertionError("standalone FaceDetection: card and CPU "
                             "disagree")

    # The crop networks on the main path's own crops of frame 0's first face.
    d = int(torch.nonzero(slab["valid"][0])[0, 0])
    with torch.inference_mode():
        theta, cx, cy, size = geometry.compute_face_alignment(
            slab["raw_keypoints"][:1, d:d + 1], float(WIDTH), float(HEIGHT))
        face = warp_mod.warp_normalize(
            frames[:1], cx.contiguous(), cy.contiguous(), size.contiguous(),
            torch.cos(-theta).contiguous(), torch.sin(-theta).contiguous(),
            out_size=MESH_SIZE)[0, 0]
        eye = warp_mod.warp_normalize(
            frames[:1], *(t[:1, 2 * d:2 * d + 1].contiguous() for t in iroi),
            out_size=IRIS_SIZE)[0, 0]
        pts = pack_blendshape_input(slab["mesh"][:1, d:d + 1],
                                    slab["iris"][:1, d:d + 1])[0, 0]

    def to_u8(x):
        return torch.clamp(torch.round((x + 1.0) * 127.5), 0, 255).to(
            torch.uint8).cpu().numpy()

    face_u8, eye_u8, pts_np = to_u8(face), to_u8(eye), pts.cpu().numpy()
    errs = {}
    for name, cls, m_card, m_cpu, arg in (
            ("FaceLandmark", FaceLandmark, models.mesh, cpu_models.mesh,
             face_u8),
            ("IrisLandmark", IrisLandmark, models.iris, cpu_models.iris,
             eye_u8),
            ("FaceBlendshapesModel", FaceBlendshapesModel,
             models.blendshapes, cpu_models.blendshapes, pts_np)):
        a = cls(model=m_card, device=models.device)
        b = cls(model=m_cpu, device="cpu")
        if name == "FaceLandmark":
            (ga, sa), (gb, sb) = a.call_with_score(arg), b.call_with_score(arg)
            errs["presence"] = abs(sa - sb)
        else:
            ga, gb = a(arg), b(arg)
        if ga is None or gb is None:
            raise AssertionError(f"{name}: no output ({ga is None}, "
                                 f"{gb is None})")
        tol = (CPU_TOLERANCES["blendshapes"] if name == "FaceBlendshapesModel"
               else 1e-5 * float(np.abs(gb).max()))
        errs[name] = (float(np.abs(ga - gb).max()), tol)
    print(f"standalone crop networks on the main path's crops, card vs CPU "
          f"(max error, tolerance): {errs}  [{card}]")
    if any(e > t for k, (e, t) in ((k, v) for k, v in errs.items()
                                   if k != "presence")) or \
            errs["presence"] > 1e-6:
        raise AssertionError("standalone crop networks: card and CPU "
                             "disagree")
    return {"launches": launches, "calls": STANDALONE_CALLS, "ms": ms,
            "post_err": post_err,
            "k1_ms": k1_ms, "k1_device_ms": k1_dev_ms, "k1_device_by": k1_by}


def _variant_launches(variants: dict, kernel: str, size=None) -> dict:
    """A kernel's launches over phase 9a's batches of each variant (K2's
    at crop size ``size``), for the ``kernels`` line."""
    per = {}
    for v, o in variants["variants"].items():
        n = o["launches"][kernel]
        per[v] = n[size] if size is not None else n
    return {"variant_launches": per, "variant_batches": VARIANT_RUNS}


def _video_camera_launches(video: dict, camera: dict, size: int) -> dict:
    """K2's launches at crop size ``size`` over phase 8a's video batches
    and 8b's camera frames, for the ``kernels`` line."""
    return {"video_launches": video["launches"]["warp_normalize"][size],
            "video_batches": video["batches"],
            "camera_launches": camera["launches"]["warp_normalize"][size],
            "camera_frames": camera["frames"]}


# Phase 9: the other detector variants and selfie segmentation.
VARIANTS = ("front", "short_range", "full", "full_sparse")
VARIANT_RUNS = 3
SEGMENTERS = ("general", "landscape", "multiclass")
SEG_RUNS = 3
SEG_REQUESTS = 2
# Card-vs-CPU tolerance of the segmenters' mask planes.
SEG_CPU_TOL = 1e-4


def _variant_path(v: str, ir, models, cpu_models, frames, frames_np,
                  card: str) -> dict:
    """Phase 9a for one variant: ``FaceDetector(model=v)`` in FULL over the
    main path's frames for :data:`VARIANT_RUNS` steady batches after one
    warm-up (the launch counts set to 0 just before them and read just
    after: one K1 launch a batch and one K2 at each crop size, plus one on
    an overflow re-run), ms a batch and faces/s; the FULL faces' checks
    on the slab of every frame; K1 and K2 against their plain versions on
    the variant's own inputs (:func:`_check_path_kernels`); the card
    against the CPU on two frames."""
    import numpy as np
    import torch
    from face_detection_tflite_torch import (FaceDetectionMode, FaceDetector,
                                             FaceDetectionModel)
    from face_detection_tflite_torch.convert.executor import convert_model
    from face_detection_tflite_torch.pipeline.programs import (
        PipelineModels, build_pipeline_program)
    vm = PipelineModels(convert_model(ir, name=f"blazeface-{v}-random"), v,
                        mesh=models.mesh, device=frames.device,
                        iris=models.iris, blendshapes=models.blendshapes)
    det = FaceDetector(FaceDetectionModel(v), models=vm, device=frames.device,
                       max_faces=MAX_FACES)
    det.detect_faces_batch(frames_np)
    reruns0 = _reruns(det)
    _reset_launches()
    batch_ms, faces = [], None
    for _ in range(VARIANT_RUNS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        faces = det.detect_faces_batch(frames_np)
        torch.cuda.synchronize()
        batch_ms.append((time.perf_counter() - t0) * 1e3)
    launches = _launches()
    reruns = _reruns(det) - reruns0
    _check_launches(launches, VARIANT_RUNS, reruns, f"variant {v}")
    per_image = [len(f) for f in faces]
    steady = statistics.median(batch_ms)
    print(f"variant {v} ({vm.detector_input_size} px, "
          f"{vm.anchors.shape[0]} anchors, {vm.detector.num_params} "
          f"detector weights) FULL: {VARIANT_RUNS} batches of {FRAMES} x "
          f"{HEIGHT}x{WIDTH}: ms/batch {['%.2f' % t for t in batch_ms]}, "
          f"median {steady:.2f} ms = "
          f"{FRAMES * np.mean(per_image) * 1e3 / steady:.1f} faces/s; faces "
          f"per image {per_image}; launches {launches} ({reruns} overflow "
          f"re-runs)  [{card}]")
    if min(per_image) < 1:
        raise AssertionError(f"variant {v}: an image came back with no face")
    with torch.inference_mode():
        slab = build_pipeline_program(vm, HEIGHT, WIDTH,
                                      FaceDetectionMode.FULL,
                                      max_faces=MAX_FACES,
                                      min_score=0.5)(frames)
    _check_full_faces(faces, slab)
    post_err = _check_path_kernels(f"variant {v}", vm, frames, card)
    cpu_vm = PipelineModels(convert_model(ir), v, mesh=cpu_models.mesh,
                            device="cpu", iris=cpu_models.iris,
                            blendshapes=cpu_models.blendshapes)
    two = torch.from_numpy(frames_np[:2])
    with torch.inference_mode():
        got = build_pipeline_program(vm, HEIGHT, WIDTH,
                                     FaceDetectionMode.FULL,
                                     max_faces=MAX_FACES)(two.to(frames.device))
        want = build_pipeline_program(cpu_vm, HEIGHT, WIDTH,
                                      FaceDetectionMode.FULL,
                                      max_faces=MAX_FACES)(two)
    _card_vs_cpu(got, want, f"variant {v} FULL")
    det.dispose()
    return {"models": vm, "faces": faces, "launches": launches,
            "ms": batch_ms, "post_err": post_err}


def _variants_phase(models, cpu_models, frames, frames_np, card: str
                    ) -> dict:
    """Phase 9a: FRONT_CAMERA, SHORT_RANGE, FULL and FULL_SPARSE, each a
    full-depth seeded detector calibrated on the main path's frames to
    about 32 passing anchors a frame (:func:`random_init.
    calibrated_detector_ir`; FULL_SPARSE is the calibrated full-range IR
    with its pruned filters stored sparse) beside the main path's mesh,
    iris and blendshape nets (:func:`_variant_path`); FULL_SPARSE's raw
    outputs and faces equal FULL's bit for bit; K1 timed on the
    full-range network's own raw outputs (A = 2304)."""
    import torch
    from face_detection_tflite_torch.models import random_init
    from face_detection_tflite_torch.ops import detections
    from face_detection_tflite_torch.ops.detections import (
        _topk_candidates, decode_detections)
    from face_detection_tflite_torch.ops.letterbox import (letterbox_image,
                                                           letterbox_params)
    from face_detection_tflite_torch.pipeline.programs import \
        _identify_detector_outputs
    out, irs = {}, {}
    for v in VARIANTS:
        t0 = time.perf_counter()
        irs[v] = (random_init.sparse_detector_ir(irs["full"])
                  if v == "full_sparse" else
                  random_init.calibrated_detector_ir(v, frames, SEED))
        print(f"variant {v}: seeded full-depth detector, {len(irs[v].ops)} "
              f"ops, built and calibrated in "
              f"{time.perf_counter() - t0:.2f} s")
        out[v] = _variant_path(v, irs[v], models, cpu_models, frames,
                               frames_np, card)
    full, sparse = out["full"]["models"], out["full_sparse"]["models"]
    lbp = letterbox_params(HEIGHT, WIDTH, 192, 192)
    with torch.inference_mode():
        x = letterbox_image(frames, lbp)
        raw = _identify_detector_outputs(full.detector(x))
        if not all(torch.equal(a, b) for a, b in
                   zip(raw, _identify_detector_outputs(sparse.detector(x)))):
            raise AssertionError("FULL_SPARSE's raw outputs differ from "
                                 "FULL's")
    if _payload(out["full"]["faces"]) != _payload(out["full_sparse"]["faces"]):
        raise AssertionError("FULL_SPARSE's faces differ from FULL's")
    print("FULL_SPARSE equals FULL: raw outputs and faces bit for bit")
    with torch.inference_mode():
        args = (*raw, full.anchors, 192.0, lbp.padding)
        kw = {"max_detections": MAX_FACES}

        def fused():
            return detections.detection_postprocess(*args, **kw)

        ms, dev_ms, dev_by = _kernel_ms(fused, "K1 detection_postprocess")
        plain_ms = _median_ms(lambda: detections.detection_postprocess_plain(
            *args, **kw), iters=5, warmup=1)
        boxes, kp, scores, valid = decode_detections(*args[:4])
        counts = _topk_candidates(boxes, kp, scores, valid,
                                  2304)[3].sum(1).tolist()
        leaders = int(fused()[3].sum())
    bound, by = _postprocess_bound(counts, leaders, FRAMES, 2304, MAX_FACES)
    print(f"K1 detection_postprocess on the full-range network's raw outputs "
          f"(A = 2304, valid per image {counts}, {leaders} slab leaders): "
          f"kernel {ms:.4f} ms (device {dev_ms:.4f} ms, {dev_by}), plain "
          f"{plain_ms:.4f} ms, bound {bound:.7f} ms ({by})  [{card}]")
    return {"variants": out,
            "full_range_k1": {"valid_per_image": counts,
                              "slab_leaders": leaders, "ms": ms,
                              "device_ms": dev_ms, "device_ms_by": dev_by,
                              "plain_ms": plain_ms, "bound_ms": bound,
                              "bound_by": by},
            "post_err": max(o["post_err"] for o in out.values())}


def _seg_layer(kernel_name: str) -> str:
    """Layer of a device activity of a segmentation batch, from its name:
    cuDNN runs a transposed convolution as a convolution's data gradient
    (``dgrad``); PyTorch's ``avg_pool2d`` kernels are pooling, though
    their names carry ``nhwc``; the letterbox and RESIZE_BILINEAR are
    index gathers."""
    n = kernel_name.lower()
    if "memcpy" in n or "memset" in n:
        return "copies"
    if "dgrad" in n or "col2im" in n:
        return "transposed convolutions"
    if "pool" in n:
        return "pooling (the squeeze-excite gates' AVERAGE_POOL_2D)"
    if "index" in n or "gather" in n:
        return "resizes (letterbox and RESIZE_BILINEAR gathers)"
    if any(t in n for t in ("conv", "cudnn", "implicit", "winograd", "nhwc",
                            "fprop", "gemm", "xmma", "sm90", "sm80")):
        return "convolutions"
    return "elementwise and other torch ops"


def _profile_segmentation(seg, frames_np, card: str) -> None:
    """One segmentation batch under ``torch.profiler``: device time by
    layer (:func:`_seg_layer`), the top kernels, and the idle share of
    the device window; "not measured" where the profiler kept no
    record."""
    import torch

    def run():
        seg(frames_np)
        torch.cuda.synchronize()

    _, device = _profiled(run, lambda name: True, "the segmentation batch")
    if not device:
        print("profile: the segmentation batch's breakdown is not measured")
        return
    by_layer: dict[str, float] = {}
    by_name: dict[str, list] = {}
    for s, e, name in device:
        layer = _seg_layer(name)
        by_layer[layer] = by_layer.get(layer, 0.0) + (e - s)
        acc = by_name.setdefault(name, [0.0, 0])
        acc[0] += e - s
        acc[1] += 1
    busy = _busy_us([(s, e) for s, e, _ in device])
    window = max(e for _, e, _ in device) - min(s for s, _, _ in device)
    print(f"profile (one segmentation batch) [{card}]: device busy "
          f"{busy / 1e3:.3f} ms of a {window / 1e3:.3f} ms window (idle "
          f"share {1 - busy / window:.3f})")
    for layer, us in sorted(by_layer.items(), key=lambda kv: -kv[1]):
        print(f"  layer {layer}: {us / 1e3:.3f} ms")
    for name, (us, n) in sorted(by_name.items(),
                                key=lambda kv: -kv[1][0])[:8]:
        print(f"  kernel {us / 1e3:8.3f} ms x{n:<4d} {name[:90]}")


def _segmenter_timing(kind: str, ir, frames, frames_np, card: str) -> dict:
    """Phase 9b for one segmenter at full width: for the float32 and the
    uint8 readback, :data:`SEG_RUNS` batches of the main path's frames
    through ``SelfieSegmentation`` (dispatch and materialize, the upload
    included) after a warm-up, ms a batch and masks/s; split into the
    device program (CUDA events around the letterbox, the net and the
    planes on frames already on the card), the readback (host clock
    around the non-blocking copy to pinned memory and its event) and the
    host ``upsample`` of the batch's masks to the frames' size.  The
    float32 masks against the CPU on two frames, within
    :data:`SEG_CPU_TOL`."""
    import numpy as np
    import torch
    from face_detection_tflite_torch.convert.executor import convert_model
    from face_detection_tflite_torch.models.segmentation import \
        SelfieSegmentation
    from face_detection_tflite_torch.ops.letterbox import letterbox_params
    from face_detection_tflite_torch.pipeline.upload import download_async
    multiclass = kind == "multiclass"
    net = convert_model(ir, name=f"segmenter-{kind}-random")
    result = {"weights": net.num_params}
    for dtype in ("float32", "uint8"):
        seg = SelfieSegmentation(net, multiclass, mask_dtype=dtype,
                                 device=frames.device)
        masks = seg(frames_np)
        batch_ms = []
        for _ in range(SEG_RUNS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            masks = seg(frames_np)
            batch_ms.append((time.perf_counter() - t0) * 1e3)
        lbp = letterbox_params(HEIGHT, WIDTH, seg.in_h, seg.in_w)
        with torch.inference_mode():
            device_ms = _median_ms(lambda: seg._planes(seg.model, frames, lbp),
                                   iters=5, warmup=1)
            planes = seg._planes(seg.model, frames, lbp)
            torch.cuda.synchronize()
            reads = []
            for _ in range(5):
                t0 = time.perf_counter()
                _, event = download_async(planes)
                event.synchronize()
                reads.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        for m in masks:
            m.upsample()
        up_ms = (time.perf_counter() - t0) * 1e3
        steady = statistics.median(batch_ms)
        if not all(np.isfinite(m.data).all() and m.data.min() >= 0
                   and m.data.max() <= 1 for m in masks):
            raise AssertionError(f"segmenter {kind}: a mask is not in [0, 1]")
        print(f"segmenter {kind} ({seg.in_h}x{seg.in_w}, {net.num_params} "
              f"weights) {dtype} readback: {SEG_RUNS} batches of {FRAMES} x "
              f"{HEIGHT}x{WIDTH}: ms/batch {['%.2f' % t for t in batch_ms]}, "
              f"median {steady:.2f} ms = {FRAMES * 1e3 / steady:.1f} masks/s; "
              f"device program {device_ms:.3f} ms, readback of "
              f"{planes.numel() * planes.element_size()} B "
              f"{statistics.median(reads):.3f} ms, host upsample of the "
              f"batch to {WIDTH}x{HEIGHT} {up_ms:.2f} ms  [{card}]")
        result[dtype] = {"ms": batch_ms, "device_ms": device_ms,
                         "readback_ms": statistics.median(reads),
                         "upsample_ms": up_ms}
        if dtype == "float32":
            want = SelfieSegmentation(convert_model(ir), multiclass,
                                      device="cpu")(frames_np[:2])
            err = max(float(np.abs(g.data - w.data).max()) for g, w in
                      zip(masks[:2], want))
            if multiclass:
                err = max(err, max(float(np.abs(g.class_data - w.class_data
                                                ).max())
                                   for g, w in zip(masks[:2], want)))
            print(f"segmenter {kind} card vs CPU (2 frames): max error "
                  f"{err:.3g}, tolerance {SEG_CPU_TOL}  [{card}]")
            if err > SEG_CPU_TOL or any(g.padding != w.padding
                                        for g, w in zip(masks, want)):
                raise AssertionError(f"segmenter {kind}: card and CPU "
                                     f"disagree")
            if kind == "general":
                _profile_segmentation(seg, frames_np, card)
    return result


def _segmentation_phase(models, frames, frames_np, card: str) -> dict:
    """Phase 9b: the general (256x256), landscape (144x256) and multiclass
    (256x256, 6 classes) segmenters at full width
    (:func:`_segmenter_timing`); then a FULL detector with the general
    segmenter: ``detect_faces_with_segmentation_batch`` against
    ``detect_faces_batch`` and the segmenter run apart (faces equal after
    the JSON round trip, masks bit for bit; the launch counts set to 0
    just before the combined call and read after it: one K1 launch and
    one K2 at each crop size, plus re-runs); and ``FaceServer`` on
    127.0.0.1 answering :data:`SEG_REQUESTS` PNG requests each to
    ``/v1/segment`` (uint8 bytes equal ``get_segmentation_mask``'s) and
    ``/v1/detect_with_segmentation`` (200, faces within the server
    tolerances of ``detect_faces``, one K1 launch a request)."""
    import base64
    import numpy as np
    from face_detection_tflite_torch import (FaceDetectionMode, FaceDetector,
                                             FaceServer)
    from face_detection_tflite_torch.convert.executor import convert_model
    from face_detection_tflite_torch.models import random_init
    from face_detection_tflite_torch.models.segmentation import \
        SelfieSegmentation
    from face_detection_tflite_torch.pipeline.programs import PipelineModels
    out = {}
    irs = {}
    for kind in SEGMENTERS:
        irs[kind] = random_init.segmenter_ir(kind, SEED + 5)
        out[kind] = _segmenter_timing(kind, irs[kind], frames, frames_np,
                                      card)
    seg_models = PipelineModels(
        models.detector, "back", mesh=models.mesh, device=frames.device,
        iris=models.iris, blendshapes=models.blendshapes,
        segmentation=convert_model(irs["general"]))
    det = FaceDetector(models=seg_models, device=frames.device,
                       max_faces=MAX_FACES, with_segmentation=True)
    det.detect_faces_with_segmentation_batch(frames_np)
    reruns0 = _reruns(det)
    _reset_launches()
    t0 = time.perf_counter()
    pairs = det.detect_faces_with_segmentation_batch(frames_np)
    combined_ms = (time.perf_counter() - t0) * 1e3
    combined = _launches()
    _check_launches(combined, 1, _reruns(det) - reruns0,
                    "detect_faces_with_segmentation_batch")
    t0 = time.perf_counter()
    faces = det.detect_faces_batch(frames_np)
    masks = SelfieSegmentation(seg_models.segmentation,
                               device=frames.device)(frames_np)
    apart_ms = (time.perf_counter() - t0) * 1e3
    if _payload([f for f, _ in pairs]) != _payload(faces) or not all(
            np.array_equal(m.data, w.data) for (_, m), w in zip(pairs, masks)):
        raise AssertionError("detect_faces_with_segmentation_batch differs "
                             "from the two calls run apart")
    print(f"detect_faces_with_segmentation_batch: {combined_ms:.2f} ms, the "
          f"two calls apart {apart_ms:.2f} ms, faces and masks equal; "
          f"launches {combined}  [{card}]")

    want_faces = [_payload([det.detect_faces(
        frames_np[i], FaceDetectionMode.STANDARD)])[0]
        for i in range(SEG_REQUESTS)]
    srv = FaceServer(det, batch_window_ms=5.0).start()
    errs, statuses = [], []
    try:
        _reset_launches()
        for i in range(SEG_REQUESTS):
            body = _png_bytes(frames_np[i])
            status, payload, _, _ = _post(f"{srv.address}/v1/segment", body)
            statuses.append(status)
            want = det.get_segmentation_mask(frames_np[i]).serialize("uint8")
            if status != 200 or base64.b64decode(
                    payload["mask"]["data_b64"]) != want["data"]:
                raise AssertionError(f"/v1/segment: status {status}, or its "
                                     f"mask differs")
        seg_launches = _launches()
        _reset_launches()
        for i in range(SEG_REQUESTS):
            body = _png_bytes(frames_np[i])
            status, payload, _, _ = _post(
                f"{srv.address}/v1/detect_with_segmentation?mesh=1&iris=1",
                body)
            statuses.append(status)
            if status != 200:
                raise AssertionError(f"/v1/detect_with_segmentation: status "
                                     f"{status}: {payload}")
            errs.append((payload["faces"], want_faces[i]))
        served = _launches()
        info = _get(f"{srv.address}/v1/info")
    finally:
        srv.close()
    det.dispose()
    err = _max_errors(errs)
    _check_errors(err, SERVER_TOL, "/v1/detect_with_segmentation")
    if seg_launches["detection_postprocess"] or \
            served["detection_postprocess"] != SEG_REQUESTS or \
            not info["segmentation_ready"]:
        raise AssertionError(f"segmentation routes: K1 launches "
                             f"{seg_launches} / {served}, info {info}")
    print(f"segmentation server: {len(statuses)} requests, statuses "
          f"{statuses}; /v1/segment masks equal get_segmentation_mask's; "
          f"/v1/detect_with_segmentation faces within {err} of "
          f"detect_faces; K1 launches {served['detection_postprocess']} "
          f"for {SEG_REQUESTS} requests  [{card}]")
    return {"segmenters": out, "combined_launches": combined,
            "server_launches": served, "server_requests": SEG_REQUESTS}


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this run "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(REPO, PACKAGE)):
        print(f"chip_smoke: {PACKAGE}/ is not beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from face_detection_tflite_torch import FaceDetectionMode
    from face_detection_tflite_torch.convert.executor import convert_model
    from face_detection_tflite_torch.kernels import build
    from face_detection_tflite_torch.models import random_init
    from face_detection_tflite_torch.models.embedding import \
        build_mobilefacenet
    from face_detection_tflite_torch.ops import detections
    from face_detection_tflite_torch.ops import nms as nms_mod
    from face_detection_tflite_torch.ops import warp as warp_mod
    from face_detection_tflite_torch.ops.anchors import (SSD_BACK, SSD_FULL,
                                                         generate_anchors)
    from face_detection_tflite_torch.ops.detections import (
        _topk_candidates, decode_detections, remove_letterbox, weighted_nms)
    from face_detection_tflite_torch.ops.letterbox import (letterbox_image,
                                                           letterbox_params)
    from face_detection_tflite_torch.pipeline import geometry
    from face_detection_tflite_torch.pipeline.programs import (
        PipelineModels, _identify_detector_outputs)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {kind}, count {torch.cuda.device_count()}")
    dev = torch.device("cuda")
    # The main path's frames come from their own generator, so that they
    # do not depend on the kernel phases' draws.
    frames_np = np.random.default_rng(SEED).integers(
        0, 256, (FRAMES, HEIGHT, WIDTH, 3), dtype=np.uint8)
    rng = np.random.default_rng(SEED + 1)

    # -- 1. build -------------------------------------------------------------
    t0 = time.perf_counter()
    build.load()
    print(f"build: {time.perf_counter() - t0:.2f} s")
    for line in build.build_log().splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print(f"  ptxas: {line.strip()}")

    # -- 2. nms_core and K1 against their plain versions ---------------------
    nms_mod.nms_core.launches = 0
    k1_err = 0.0
    for k, frac in ((896, 30 / 896), (896, 1.0), (2304, 0.05)):
        args = [torch.from_numpy(a).to(dev)
                for a in _clustered_candidates(rng, 16, k, frac)]
        tb, _, ts, tv = _topk_candidates(*args, k)
        leader, blended = nms_mod.nms_core(tb, ts, tv)
        torch.cuda.synchronize()
        p_leader, p_blended = nms_mod.nms_core_plain(tb, ts, tv)
        if not torch.equal(leader, p_leader):
            raise AssertionError(f"nms_core k={k}: leader masks differ")
        err = (blended - p_blended).abs().max().item()
        if err > 1e-6:
            raise AssertionError(f"nms_core k={k}: blended boxes differ by "
                                 f"{err}")
        k1_err = max(k1_err, err)
        ms = _median_ms(lambda: nms_mod.nms_core(tb, ts, tv))
        plain = _median_ms(lambda: nms_mod.nms_core_plain(tb, ts, tv),
                           iters=5, warmup=1)
        print(f"nms_core B=16 k={k} valid/image~{int(tv.sum(1).float().mean())}"
              f" leaders={int(leader.sum())}: max_abs_err={err:.3g} "
              f"kernel {ms:.4f} ms, plain {plain:.4f} ms  [{card}]")
    check_launches = nms_mod.nms_core.launches

    # Seeded raw outputs: (anchors, input size, valid per image, clusters,
    # num_candidates, equal scores); the main path's own come in phase 4.
    post_err = 0.0
    for case, (label, (opts, size, nv, clusters, cand, equal)) in enumerate({
            "A=896 all valid": (SSD_BACK, 256, 896, 200, None, False),
            "A=2304 5% valid": (SSD_FULL, 192, 115, 30, None, False),
            "A=2304 all valid": (SSD_FULL, 192, 2304, 400, None, False),
            "num_candidates=64": (SSD_BACK, 256, 200, 40, 64, False),
            "more leaders than D": (SSD_BACK, 256, 120, 80, None, False),
            "no valid anchor": (SSD_BACK, 256, 0, 1, None, False),
            "equal scores": (SSD_BACK, 256, 40, 10, None, True)}.items()):
        anchors_np = generate_anchors(opts)
        raw = random_init.random_raw_detections(
            SEED + 2 + case, FRAMES, anchors_np, float(size), nv,
            clusters=clusters, equal_scores=equal)
        args = [torch.from_numpy(a).to(dev) for a in (*raw, anchors_np)]
        pad = letterbox_params(HEIGHT, WIDTH, size, size).padding
        post_err = max(post_err, _check_postprocess(
            label, (*args, float(size), pad),
            {"max_detections": MAX_FACES, "num_candidates": cand}, card))

    # -- 3. K2 against its plain version -------------------------------------
    s = MESH_SIZE
    frames = torch.from_numpy(frames_np).to(dev)
    roi = [torch.from_numpy(a.astype(np.float32)).to(dev) for a in (
        rng.uniform(0, WIDTH, (FRAMES, 16)), rng.uniform(0, HEIGHT, (FRAMES, 16)),
        rng.uniform(60, 700, (FRAMES, 16)), rng.uniform(-np.pi, np.pi,
                                                        (FRAMES, 16)))]
    cx, cy, size, theta = roi
    ct, st = torch.cos(theta), torch.sin(theta)
    flip = torch.from_numpy(rng.uniform(size=(FRAMES, 16)) < 0.5).to(dev)
    out = warp_mod.warp_normalize(frames, cx, cy, size, ct, st, out_size=s,
                                  flip=flip)
    torch.cuda.synchronize()
    ref = warp_mod.warp_normalize_plain(frames, cx, cy, size, ct, st,
                                        out_size=s, flip=flip)
    k2_err = (out - ref).abs().max().item()
    if k2_err != 0:
        raise AssertionError(f"K2: kernel differs from plain by {k2_err}")
    print(f"K2 warp_normalize 16x16x{s}^2 mixed flips: max_abs_err={k2_err:.3g}")

    # -- 4. the STANDARD main path --------------------------------------------
    t0 = time.perf_counter()
    models, det_ir, mesh_ir, iris_ir, bs_ir = \
        random_init.random_pipeline_models(frames, seed=SEED)
    print(f"models: BlazeFace back {len(det_ir.ops)} ops / "
          f"{models.detector.num_params} weights, FaceMesh "
          f"{len(mesh_ir.ops)} ops / {models.mesh.num_params} weights, "
          f"iris {len(iris_ir.ops)} ops / {models.iris.num_params} weights, "
          f"blendshapes {len(bs_ir.ops)} ops / "
          f"{models.blendshapes.num_params} weights (fp16 behind "
          f"DEQUANTIZE), MobileFaceNet {models.embedding.num_params} "
          f"weights, seed {SEED}, built in "
          f"{time.perf_counter() - t0:.2f} s")
    cpu_models = PipelineModels(convert_model(det_ir), "back",
                                mesh=convert_model(mesh_ir), device="cpu",
                                iris=convert_model(iris_ir),
                                blendshapes=convert_model(bs_ir),
                                embedding=build_mobilefacenet(SEED + 4))
    runs = 7
    std = _drive_main_path(models, cpu_models, frames, frames_np,
                           FaceDetectionMode.STANDARD, runs, card)

    # The main path's own kernel inputs, for the timed kernel rows.
    lbp = letterbox_params(HEIGHT, WIDTH, 256, 256)
    with torch.inference_mode():
        raw_boxes, raw_scores = _identify_detector_outputs(
            models.detector(letterbox_image(frames, lbp)))
        post_args = (raw_boxes, raw_scores, models.anchors, 256.0,
                     lbp.padding)
        post_kw = {"max_detections": MAX_FACES}
        post_err = max(post_err, _check_postprocess(
            "main path", post_args, post_kw, card))

        def fused():
            return detections.detection_postprocess(*post_args, **post_kw)

        def replaced_stage():
            b_, k_, s_, v_ = decode_detections(*post_args[:4])
            b_, k_, s_, v_ = weighted_nms(b_, k_, s_, v_, **post_kw)
            return (*remove_letterbox(b_, k_, lbp.padding), s_, v_)

        post_ms, post_dev_ms, post_dev_by = _kernel_ms(
            fused, "K1 detection_postprocess")
        post_host_ms = _host_ms(fused)
        before = detections.detection_postprocess.launches
        fused()
        fused_launches = detections.detection_postprocess.launches - before
        _, _, recorded, layers = _stage_ms(fused)
        if fused_launches != 1 or (recorded is not None and
                                   layers != {"K1 detection_postprocess"}):
            raise AssertionError(f"K1 made {fused_launches} launches a call "
                                 f"and device work in {layers}")
        post_plain_ms = _median_ms(lambda: detections.detection_postprocess_plain(
            *post_args, **post_kw), iters=5, warmup=1)
        stage_ms, stage_dev_ms, stage_launches, _ = _stage_ms(replaced_stage)
        lib = build.load()
        stream = torch.cuda.current_stream().cuda_stream
        _, empty_dev_ms, _ = _kernel_ms(lambda: build.check(
            lib.fdt_empty_kernel(stream), "empty kernel"), "launch floor")

        boxes, kp, scores, valid = decode_detections(*post_args[:4])
        tb, tkp, ts, tv = _topk_candidates(boxes, kp, scores, valid, 896)
        counts = tv.sum(1).tolist()
        slab_leaders = int(fused()[3].sum())
        print(f"valid candidates per image: {counts}; leaders in the slab: "
              f"{slab_leaders}")
        nms_ms, nms_dev_ms, nms_dev_by = _kernel_ms(
            lambda: nms_mod.nms_core(tb, ts, tv), "nms_core")
        nms_plain_ms = _median_ms(lambda: nms_mod.nms_core_plain(tb, ts, tv),
                                  iters=5, warmup=1)
        leader, blended = nms_mod.nms_core(tb, ts, tv)
        p_leader, p_blended = nms_mod.nms_core_plain(tb, ts, tv)
        if not torch.equal(leader, p_leader):
            raise AssertionError("nms_core on the main path: leader masks "
                                 "differ")
        k1_err = max(k1_err, (blended - p_blended).abs().max().item())
        slab = std["slab"]
        theta_m, cx_m, cy_m, size_m = geometry.compute_face_alignment(
            slab["raw_keypoints"], float(WIDTH), float(HEIGHT))
        mroi = [t.contiguous() for t in
                (cx_m, cy_m, size_m, torch.cos(-theta_m), torch.sin(-theta_m))]
    print(f"K1 detection_postprocess main-path inputs: kernel {post_ms:.4f} "
          f"ms (device {post_dev_ms:.4f} ms, host {post_host_ms:.4f} ms a "
          f"call, {fused_launches:g} launch a call, device work in "
          f"{sorted(layers) or 'layers not measured'}, {_num(recorded)} "
          f"recorded by the profiler), plain "
          f"{post_plain_ms:.4f} ms; empty kernel device {empty_dev_ms:.4f} "
          f"ms  [{card}]")
    print(f"replaced stage (decode_detections + weighted_nms via nms_core "
          f"+ remove_letterbox) on the same inputs: {stage_ms:.4f} ms event, "
          f"{_num(stage_dev_ms, '.4f')} ms device over "
          f"{_num(stage_launches)} device launches a call  [{card}]")
    print(f"nms_core main-path candidates: kernel {nms_ms:.4f} ms (device "
          f"{nms_dev_ms:.4f} ms), plain {nms_plain_ms:.4f} ms  [{card}]")
    mesh_site = _time_warp(frames, mroi, s, None, "mesh site",
                           size_m[slab["valid"]], card)

    # -- 5. the FULL main path ------------------------------------------------
    full = _drive_main_path(models, cpu_models, frames, frames_np,
                            FaceDetectionMode.FULL, runs, card)
    _check_full_faces(full["faces"], full["slab"])
    with torch.inference_mode():
        ecx, ecy, esize, etheta = (
            t.reshape(FRAMES, -1) for t in
            geometry.eye_rois_from_mesh(full["slab"]["mesh"]))
        iroi = [t.contiguous() for t in (ecx, ecy, esize, torch.cos(etheta),
                                         torch.sin(etheta))]
        # Odd slots are right eyes, mirrored, as the iris stage has them.
        eye_flip = (torch.arange(2 * MAX_FACES, device=dev) % 2 == 1
                    ).expand(FRAMES, -1).contiguous()
    iris_site = _time_warp(
        frames, iroi, IRIS_SIZE, eye_flip, "iris site, right eyes mirrored",
        esize[full["slab"]["valid"].repeat_interleave(2, dim=1)], card)

    # -- 6. FULL with the fused embedding stage --------------------------------
    emb, embed_site = _embedding_phase(models, cpu_models, frames, frames_np,
                                       runs, card)

    # -- 7. serving: the stream, the server, two threads ------------------------
    _upload_times(frames_np, card)
    stream = _stream_phase(models, frames_np, runs, card)
    serve = _server_phase(models, frames_np, kind, card)
    _threads_phase(models, frames, card)

    # -- 8. video, camera frames, standalone classes ----------------------------
    video = _video_phase(frames, card)
    camera = _camera_phase(video["models"], video["decoded"], card)
    alone = _standalone_phase(models, cpu_models, frames, frames_np,
                              full["slab"], iroi, card)
    # -- 9. detector variants and selfie segmentation --------------------------
    variants = _variants_phase(models, cpu_models, frames, frames_np, card)
    seg = _segmentation_phase(models, frames, frames_np, card)
    post_err = max(post_err, video["post_err"], camera["post_err"],
                   alone["post_err"], variants["post_err"])

    # -- 10. result lines -----------------------------------------------------
    post_bound, post_by = _postprocess_bound(counts, slab_leaders, FRAMES,
                                             896, MAX_FACES)
    nms_bound, nms_by = _nms_bound(counts, FRAMES, 896)
    print(f"bounds: K1 detection_postprocess {post_bound:.7f} ms ({post_by}),"
          f" nms_core {nms_bound:.7f} ms ({nms_by})")
    std_k2 = std["launches"]["warp_normalize"]
    full_k2 = full["launches"]["warp_normalize"]
    kernels = [
        {"name": "detection_postprocess", "route": "cuda",
         "source": f"{PACKAGE}/csrc/nms.cu",
         "replaces": "face_detection_tflite_tpu/ops/nms_pallas.py:36",
         "fuses": "face_detection_tflite_tpu/ops/detections.py:219",
         "launches": std["launches"]["detection_postprocess"],
         "full_launches": full["launches"]["detection_postprocess"],
         "stream_launches": stream["launches"]["detection_postprocess"],
         "server_launches": serve["launches"]["detection_postprocess"],
         "server_batches": len(serve["batch_sizes"]),
         "video_launches": video["launches"]["detection_postprocess"],
         "video_batches": video["batches"],
         "camera_launches": camera["launches"]["detection_postprocess"],
         "camera_frames": camera["frames"],
         "standalone_launches": alone["launches"],
         "standalone_calls": alone["calls"], "standalone_ms": alone["ms"],
         "standalone_k1_ms": alone["k1_ms"],
         "standalone_k1_device_ms": alone["k1_device_ms"],
         **_variant_launches(variants, "detection_postprocess"),
         "full_range_network": variants["full_range_k1"],
         "segmentation_combined_launches":
             seg["combined_launches"]["detection_postprocess"],
         "segmentation_server_launches":
             seg["server_launches"]["detection_postprocess"],
         "segmentation_server_requests": seg["server_requests"],
         "max_abs_err": post_err, "ms": post_ms, "device_ms": post_dev_ms,
         "device_ms_by": post_dev_by,
         "host_ms": post_host_ms, "plain_ms": post_plain_ms,
         "bound_ms": post_bound, "bound_by": post_by, "library_ms": None,
         "empty_kernel_device_ms": empty_dev_ms,
         "replaced_stage": {"ms": stage_ms, "device_ms": stage_dev_ms,
                            "device_launches": stage_launches}},
        {"name": "nms_core", "route": "cuda",
         "source": f"{PACKAGE}/csrc/nms.cu",
         "replaces": "face_detection_tflite_tpu/ops/nms_pallas.py:36",
         "launches": std["launches"]["nms_core"],
         "check_launches": check_launches, "max_abs_err": k1_err,
         "ms": nms_ms, "device_ms": nms_dev_ms, "device_ms_by": nms_dev_by,
         "plain_ms": nms_plain_ms,
         "bound_ms": nms_bound,
         "bound_by": nms_by, "library_ms": None},
        {"name": "warp_normalize", "route": "cuda",
         "source": f"{PACKAGE}/csrc/warp.cu",
         "replaces": "face_detection_tflite_tpu/ops/warp.py:34",
         "launches": std_k2[MESH_SIZE], "full_launches": full_k2[MESH_SIZE],
         "stream_launches": stream["launches"]["warp_normalize"][MESH_SIZE],
         "server_launches": serve["launches"]["warp_normalize"][MESH_SIZE],
         **_video_camera_launches(video, camera, MESH_SIZE),
         **_variant_launches(variants, "warp_normalize", MESH_SIZE),
         "segmentation_combined_launches":
             seg["combined_launches"]["warp_normalize"][MESH_SIZE],
         **mesh_site, "max_abs_err": max(k2_err, mesh_site["max_abs_err"])},
        {"name": "warp_normalize_iris64", "route": "cuda",
         "source": f"{PACKAGE}/csrc/warp.cu",
         "replaces": "face_detection_tflite_tpu/ops/warp.py:34",
         "launches": full_k2[IRIS_SIZE],
         "stream_launches": stream["launches"]["warp_normalize"][IRIS_SIZE],
         "server_launches": serve["launches"]["warp_normalize"].get(
             IRIS_SIZE, 0), **_video_camera_launches(video, camera, IRIS_SIZE),
         **_variant_launches(variants, "warp_normalize", IRIS_SIZE),
         "segmentation_combined_launches":
             seg["combined_launches"]["warp_normalize"][IRIS_SIZE],
         **iris_site},
        {"name": "warp_normalize_embed112", "route": "cuda",
         "source": f"{PACKAGE}/csrc/warp.cu",
         "replaces": "face_detection_tflite_tpu/ops/warp.py:34",
         "launches": emb["launches"]["warp_normalize"][EMBED_SIZE],
         "server_embed_launches": serve["embed_launches"][
             "warp_normalize"].get(EMBED_SIZE, 0), **embed_site},
    ]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
