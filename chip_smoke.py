#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root: ``python3 chip_smoke.py``.  It

1. prints the card's name and power limit (``nvidia-smi``);
2. builds the hand-written kernels (``face_detection_tflite_torch/csrc``)
   with ``nvcc`` and prints the build time and ptxas resource usage;
3. holds each kernel against its plain PyTorch version on the card:
   K1 (weighted-NMS core) at B = 16 for k = 896 with a sparse valid
   prefix, k = 896 all valid and k = 2304 (leaders equal, boxes within
   1e-6); K2 (ROI warp + normalize) at 16 frames x 16 faces x 192 px with
   mixed mirrors (bit for bit); it prints each kernel's time, the plain
   version's and, for K2, ``F.grid_sample``'s (CUDA events, warm-up,
   median of 20);
4. drives the main path: ``FaceDetector`` in STANDARD mode over 16 seeded
   853x1280 uint8 frames, with the full-depth, full-width seeded
   BlazeFace-back and FaceMesh; prints ms per batch, faces/s, candidates
   and faces per image and the kernels' launch counts, all of which must
   be > 0, with at least one face on every image; then profiles one
   steady batch (``torch.profiler``: device time by layer and kernel, and
   the device's idle share);
   it times each kernel on the main path's own inputs twice over the same
   20 calls: CUDA events around each call (``ms``, which includes the host
   path of the ctypes call) and the kernel's own device time in
   ``torch.profiler`` (``device_ms``, median);
5. checks the card's output against the port on the CPU (plain kernels,
   fp32 convolutions) on two of the frames;
6. prints the ``kernels`` JSON line and, last, the ``{"ok": true, ...}``
   line.

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

SEED = 3
FRAMES, HEIGHT, WIDTH = 16, 853, 1280
MAX_FACES = 16


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


def _kernel_ms(fn, layer: str, iters: int = 20) -> tuple[float, float]:
    """(event ms, device ms) of a kernel wrapper that launches one kernel per
    call: the CUDA-event median of ``iters`` timed calls, which includes the
    host path of the call, and the median of the same calls' device time of
    the kernel in ``torch.profiler``, found by its layer (:func:`_layer`).
    Raises when the profiler did not record one kernel per call."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        ms = _median_ms(fn, iters=iters, warmup=0)
    device_us = [e.time_range.end - e.time_range.start
                 for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and _layer(e.name) == layer]
    if len(device_us) != iters:
        print(f"profile: torch.profiler recorded {len(device_us)} device "
              f"launches of {layer} for {iters} timed calls")
        raise RuntimeError(f"no device time for {layer}")
    return ms, statistics.median(device_us) / 1e3


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


def _layer(kernel_name: str) -> str:
    """Layer of a device activity, from its name."""
    n = kernel_name.lower()
    if "memcpy" in n or "memset" in n:
        return "copies"
    if "nms_core" in n:
        return "K1 nms_core"
    if "warp_normalize" in n:
        return "K2 warp_normalize"
    if any(t in n for t in ("conv", "cudnn", "xmma", "implicit", "sm90",
                            "winograd", "gemm", "nhwc", "fprop")):
        return "convolutions"
    return "other torch ops"


def _profile_batch(det, frames_np, mode, card: str) -> None:
    """One steady main-path batch under torch.profiler: device time by
    layer and by kernel, and the device's idle share of the window."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        det.detect_faces_batch(frames_np, mode)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans = [(e.time_range.start, e.time_range.end, e.name)
             for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    if not spans:
        print("profile: torch.profiler recorded no device activity")
        raise RuntimeError("no device activity in the profiled batch")
    by_layer: dict[str, float] = {}
    by_name: dict[str, list] = {}
    busy, cur_s, cur_e = 0.0, None, None
    for s, e, name in sorted(spans):
        by_layer[_layer(name)] = by_layer.get(_layer(name), 0.0) + (e - s)
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
    window = max(e for _, e, _ in spans) - min(s for s, _, _ in spans)
    print(f"profile (one steady batch, host wall {wall_ms:.2f} ms) "
          f"[{card}]: device busy {busy / 1e3:.3f} ms of a "
          f"{window / 1e3:.3f} ms device window "
          f"(idle share {1 - busy / window:.3f})")
    for layer, us in sorted(by_layer.items(), key=lambda kv: -kv[1]):
        print(f"  layer {layer}: {us / 1e3:.3f} ms")
    for name, (us, n) in sorted(by_name.items(),
                                key=lambda kv: -kv[1][0])[:12]:
        print(f"  kernel {us / 1e3:8.3f} ms x{n:<4d} {name[:90]}")


def main() -> int:
    import numpy as np
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this run "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(REPO, PACKAGE)):
        print(f"chip_smoke: {PACKAGE}/ is not beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from face_detection_tflite_torch import FaceDetectionMode, FaceDetector
    from face_detection_tflite_torch.convert.executor import convert_model
    from face_detection_tflite_torch.kernels import build
    from face_detection_tflite_torch.models import random_init
    from face_detection_tflite_torch.ops import nms as nms_mod
    from face_detection_tflite_torch.ops import warp as warp_mod
    from face_detection_tflite_torch.ops.detections import (
        _topk_candidates, decode_detections)
    from face_detection_tflite_torch.ops.letterbox import (letterbox_image,
                                                           letterbox_params)
    from face_detection_tflite_torch.pipeline import geometry
    from face_detection_tflite_torch.pipeline.programs import (
        PipelineModels, build_pipeline_program)

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

    # -- 2. K1 against its plain version ------------------------------------
    k1_err = 0.0
    for k, frac in ((896, 30 / 896), (896, 1.0), (2304, 0.05)):
        args = [torch.from_numpy(a).to(dev)
                for a in _clustered_candidates(rng, 16, k, frac)]
        tb, _, ts, tv = _topk_candidates(*args, k)
        leader, blended = nms_mod.nms_core(tb, ts, tv)
        torch.cuda.synchronize()
        p_leader, p_blended = nms_mod.nms_core_plain(tb, ts, tv)
        if not torch.equal(leader, p_leader):
            raise AssertionError(f"K1 k={k}: leader masks differ")
        err = (blended - p_blended).abs().max().item()
        if err > 1e-6:
            raise AssertionError(f"K1 k={k}: blended boxes differ by {err}")
        k1_err = max(k1_err, err)
        ms = _median_ms(lambda: nms_mod.nms_core(tb, ts, tv))
        plain = _median_ms(lambda: nms_mod.nms_core_plain(tb, ts, tv),
                           iters=5, warmup=1)
        print(f"K1 nms_core B=16 k={k} valid/image~{int(tv.sum(1).float().mean())}"
              f" leaders={int(leader.sum())}: max_abs_err={err:.3g} "
              f"kernel {ms:.4f} ms, plain {plain:.4f} ms  [{card}]")

    # -- 3. K2 against its plain version and grid_sample ---------------------
    s = 192
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

    # -- 4. the main path -----------------------------------------------------
    t0 = time.perf_counter()
    models, det_ir, mesh_ir = random_init.random_pipeline_models(
        frames, seed=SEED)
    print(f"models: BlazeFace back {len(det_ir.ops)} ops / "
          f"{models.detector.num_params} weights, FaceMesh "
          f"{len(mesh_ir.ops)} ops / {models.mesh.num_params} weights, "
          f"seed {SEED}, built in {time.perf_counter() - t0:.2f} s")
    det = FaceDetector(models=models, device="cuda", max_faces=MAX_FACES)
    mode = FaceDetectionMode.STANDARD
    nms_mod.nms_core.launches = 0
    warp_mod.warp_normalize.launches = 0
    batch_ms, faces = [], None
    runs = 7
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        faces = det.detect_faces_batch(frames_np, mode)
        torch.cuda.synchronize()
        batch_ms.append((time.perf_counter() - t0) * 1e3)
    launches = {"nms_core": nms_mod.nms_core.launches,
                "warp_normalize": warp_mod.warp_normalize.launches}
    per_image = [len(f) for f in faces]
    steady = statistics.median(batch_ms[2:])
    print(f"main path: {runs} batches of {FRAMES} x {HEIGHT}x{WIDTH}: "
          f"ms/batch {['%.2f' % t for t in batch_ms]}, steady median "
          f"{steady:.2f} ms = {FRAMES * np.mean(per_image) * 1e3 / steady:.1f}"
          f" faces/s  [{card}]")
    print(f"faces per image: {per_image}")
    print(f"launches over the {runs} batches: {launches}")
    print(f"timings: {det.timings!r}")
    if min(per_image) < 1:
        raise AssertionError("an image came back with no face")
    if min(launches.values()) < 1:
        raise AssertionError(f"a kernel never ran on the main path: "
                             f"{launches}")
    for f in faces:
        for face in f:
            if face.mesh.points.shape != (468, 3) or \
                    not np.isfinite(face.mesh.points).all():
                raise AssertionError("mesh is not a finite [468, 3] array")

    _profile_batch(det, frames_np, mode, card)

    # The main path's own kernel inputs, for the timed kernel rows.
    lbp = letterbox_params(HEIGHT, WIDTH, 256, 256)
    with torch.inference_mode():
        raw_boxes, raw_scores = models.detector(letterbox_image(frames, lbp))
        boxes, kp, scores, valid = decode_detections(
            raw_boxes.reshape(FRAMES, -1, 16), raw_scores, models.anchors,
            256.0)
        tb, tkp, ts, tv = _topk_candidates(boxes, kp, scores, valid, 896)
        counts = tv.sum(1).tolist()
        print(f"valid candidates per image: {counts}")
        nms_ms, nms_dev_ms = _kernel_ms(
            lambda: nms_mod.nms_core(tb, ts, tv), "K1 nms_core")
        nms_plain_ms = _median_ms(lambda: nms_mod.nms_core_plain(tb, ts, tv),
                                  iters=5, warmup=1)
        leader, blended = nms_mod.nms_core(tb, ts, tv)
        p_leader, p_blended = nms_mod.nms_core_plain(tb, ts, tv)
        if not torch.equal(leader, p_leader):
            raise AssertionError("K1 on the main path: leader masks differ")
        k1_err = max(k1_err, (blended - p_blended).abs().max().item())
        prog = build_pipeline_program(models, HEIGHT, WIDTH, mode,
                                      max_faces=MAX_FACES, min_score=0.5)
        slab = prog(frames)
        theta_m, cx_m, cy_m, size_m = geometry.compute_face_alignment(
            slab["raw_keypoints"], float(WIDTH), float(HEIGHT))
        mroi = [t.contiguous() for t in
                (cx_m, cy_m, size_m, torch.cos(-theta_m), torch.sin(-theta_m))]
        warp_ms, warp_dev_ms = _kernel_ms(lambda: warp_mod.warp_normalize(
            frames, *mroi, out_size=s), "K2 warp_normalize")
        warp_plain_ms = _median_ms(lambda: warp_mod.warp_normalize_plain(
            frames, *mroi, out_size=s), iters=5, warmup=1)
        w_out = warp_mod.warp_normalize(frames, *mroi, out_size=s)
        w_ref = warp_mod.warp_normalize_plain(frames, *mroi, out_size=s)
        k2_err = max(k2_err, (w_out - w_ref).abs().max().item())
        if k2_err != 0:
            raise AssertionError(f"K2 on the main path: error {k2_err}")

        # Library yardstick: grid_sample over the same sample points.
        cx_, cy_, sz_, c_, s_ = mroi
        size_int = torch.clamp_min(torch.floor(sz_ + 0.5), 1.0)
        scale = torch.full_like(size_int, s) / size_int
        center = s / 2.0 + 0.5 * (scale - 1.0)
        g = torch.arange(s, dtype=torch.float32, device=dev)
        dx = (g[None, None, None, :] - center[..., None, None]) / \
            scale[..., None, None]
        dy = (g[None, None, :, None] - center[..., None, None]) / \
            scale[..., None, None]
        sx = cx_[..., None, None] + c_[..., None, None] * dx + \
            s_[..., None, None] * dy
        sy = cy_[..., None, None] - s_[..., None, None] * dx + \
            c_[..., None, None] * dy
        touched_px = _tap_footprint(sx, sy, HEIGHT, WIDTH)
        grid =torch.stack([(2 * sx + 1) / WIDTH - 1, (2 * sy + 1) / HEIGHT - 1],
                           -1).reshape(FRAMES, -1, s, 2)

        def library():
            img = frames.permute(0, 3, 1, 2).float()
            o = F.grid_sample(img, grid, mode="bilinear",
                              padding_mode="zeros", align_corners=False)
            return o * (1.0 / 127.5) - 1.0

        lib_ms = _median_ms(library)
        lib_err = (library().reshape(FRAMES, 3, -1, s, s).permute(
            0, 2, 3, 4, 1) - w_out).abs().max().item()
    print(f"K1 main-path inputs: kernel {nms_ms:.4f} ms (device "
          f"{nms_dev_ms:.4f} ms), plain {nms_plain_ms:.4f} ms  [{card}]")
    print(f"K2 main-path inputs ({FRAMES}x{MAX_FACES} ROIs, taps touch "
          f"{touched_px} source pixels): kernel {warp_ms:.4f} ms (device "
          f"{warp_dev_ms:.4f} ms), plain "
          f"{warp_plain_ms:.4f} ms, grid_sample {lib_ms:.4f} ms (max diff "
          f"{lib_err:.3g})  [{card}]")

    # -- 5. the card against the CPU, on two frames --------------------------
    cpu_models = PipelineModels(convert_model(det_ir), "back",
                                mesh=convert_model(mesh_ir), device="cpu")
    two = frames_np[:2]
    with torch.inference_mode():
        got = build_pipeline_program(models, HEIGHT, WIDTH, mode,
                                     max_faces=MAX_FACES)(
            torch.from_numpy(two).to(dev))
        want = build_pipeline_program(cpu_models, HEIGHT, WIDTH, mode,
                                      max_faces=MAX_FACES)(
            torch.from_numpy(two))
    got = {k: v.cpu().numpy() for k, v in got.items()}
    want = {k: v.numpy() for k, v in want.items()}
    if not np.array_equal(got["valid"], want["valid"]):
        raise AssertionError("card and CPU disagree on the valid mask")
    box_err = max(np.abs(got[k] - want[k]).max()
                  for k in ("boxes", "raw_keypoints"))
    mesh_err = np.abs(got["mesh"] - want["mesh"]).max()
    mesh_tol = max(1e-2, 1e-5 * np.abs(want["mesh"]).max())
    print(f"card vs CPU (2 frames): box/keypoint max err {box_err:.3g}, "
          f"mesh max err {mesh_err:.3g} px (tolerance {mesh_tol:.3g})")
    if box_err > 1e-4 or mesh_err > mesh_tol:
        raise AssertionError("card and CPU disagree beyond tolerance")

    # -- 6. result lines ------------------------------------------------------
    nms_bound, nms_by = _nms_bound(counts, FRAMES, 896)
    warp_bound, warp_by = _warp_bound(touched_px, FRAMES, MAX_FACES, s)
    print(f"bounds: K1 {nms_bound:.6f} ms ({nms_by}), K2 {warp_bound:.6f} ms "
          f"({warp_by})")
    kernels = [
        {"name": "nms_core", "route": "cuda",
         "source": f"{PACKAGE}/csrc/nms.cu",
         "replaces": "face_detection_tflite_tpu/ops/nms_pallas.py:36",
         "launches": launches["nms_core"], "max_abs_err": k1_err,
         "ms": nms_ms, "device_ms": nms_dev_ms, "plain_ms": nms_plain_ms,
         "bound_ms": nms_bound,
         "bound_by": nms_by, "library_ms": None},
        {"name": "warp_normalize", "route": "cuda",
         "source": f"{PACKAGE}/csrc/warp.cu",
         "replaces": "face_detection_tflite_tpu/ops/warp.py:34",
         "launches": launches["warp_normalize"], "max_abs_err": k2_err,
         "ms": warp_ms, "device_ms": warp_dev_ms, "plain_ms": warp_plain_ms,
         "bound_ms": warp_bound,
         "bound_by": warp_by, "library_ms": lib_ms},
    ]
    det.dispose()
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
