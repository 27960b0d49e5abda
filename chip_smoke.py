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
   ``F.grid_sample``'s (CUDA events, warm-up, median of 20); K5, the
   convolutions' bias, residual add and activation (``residual_act``),
   bit for bit at the largest tensor of each of its sites on the main
   paths, each with its convolution's bias (iris 512 x 32x32x64 and mesh
   256 x 96x96x16 with a residual and PReLU, the mesh's channel pad
   256 x 48x48x32 from 16, MobileFaceNet's stem 256 x 56x56x64 PReLU alone,
   the detector 16 x 128x128x24 with a residual and ReLU, the multiclass
   segmenter's standalone ReLU 16 x 128x128x48 and its bare residual ADD
   16 x 128x128x24, and in place the bias alone of the iris net's
   depthwise convolution 512 x 32x32x64 and the detector stem's bias
   and ReLU 16 x 128x128x24; seeded values with -0.0, NaN and +-inf
   planted in y, the residual and the bias), with its ms, device ms, the
   plain version's ms and its byte bound; K5's affine instance
   (``residual_act_affine``: the pass, then a batch norm the graph keeps
   as a per-channel MUL and ADD) the same way at iresnet50's stem, a
   stage-1 block's end and its head at 256 crops (on its main path, see
   6b; ``--affine-phase`` runs the build, these sites and 6b alone);
   K6, MobileFaceNet's 1x1
   convolutions with their bias, PReLU or residual (``pointwise_conv``),
   at each of its 32 sites at 256 crops against its plain version (cuDNN,
   then K5) within the float32 rounding of its sums, with its ms, device
   ms, the plain version's and cuDNN's convolution's device ms and its
   bound, and 32 launches a forward (``--pointwise-phase`` runs the build
   and this step alone);
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
6b. drives FULL with the fused embedding stage and iresnet50 at its
   published widths as the embedding network (the cell
   ``full_arcface.stream16``'s path) through ``detect_faces_batch_stream``
   at depth 2 over replayed batches: 25 K5 affine launches a call and
   re-run, none op by op, K5's other passes, K1 and K2 as on the other
   paths, unit 512-dim embeddings, the last batch's embeddings bit for
   bit those of the eager program with the plain affine passes
   (``_arcface_phase``);
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
   ``detect_faces_batch`` alone, the program keys the video's fresh
   detector captured and left pending and the card's graph pool bytes
   after it, the share of IDs carried over, and the host ms of both
   smoothers; (b) four decoded frames as I420, NV12,
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
10. precision tiers and the int8 detector (``_tiers_phase``): FULL through
   ``FaceDetector(precision=...)`` on the main path's networks and frames
   at "highest" and at "high", "mixed", "serving", "default" and
   ``{"detector": "default", "mesh": "highest"}``, 3 steady batches each
   (launch counts set to 0 just before them: one K1 and one K2 at each
   of 192 and 64 px a batch), ms a batch, device busy and convolution ms
   of one profiled batch, faces a frame, and on the faces paired by IoU
   with the "highest" run the box, mesh and iris errors in px and the
   blendshapes' largest error (unpaired faces counted, not failed on;
   "high" must equal "highest"); K1 and K2 against their plain versions
   on each tier's own inputs; the general segmenter at
   ``SegmentationConfig()`` ("high", equal to "highest") and "default",
   masks against "highest"; MobileFaceNet at "default" on the FULL
   path's embedding crops, ms a batch and the least cosine to "highest";
   the int8 BlazeFace back (``random_init.quantized_ir`` of the main
   path's detector) through FULL, its raw outputs on the card against
   the CPU within one step of each output's grid, K1 and K2 held and
   counted;
11. the command line (``_cli_phase``), in this process through
   ``cli.main`` with the main path's networks through its
   ``_make_detector``/``_make_segmenter`` seam, on two of the main frames
   written as PNGs: ``detect --json`` (each line equal to
   ``detect_faces``'s faces bit for bit; launch counts set to 0 just
   before it: one K1 and one K2 at 192 and at 64 px an image, plus
   re-runs; K1 and K2 against their plain versions on each image at
   B = 1; its ms an image beside ``detect_faces``'s and the PNG
   decode's, the program keys the command's detector captured and left
   pending and the card's graph pool bytes), ``detect --annotate`` (the
   PNG equal to
   ``render.annotate``), ``embed`` (equal
   to the API's similarity and distance; one K2 at 112 px an image),
   ``segment --format binary`` (the seeded general segmenter's mask),
   ``video --json --max-frames 8`` on phase 8a's clip (equal to its
   results after the One-Euro smoother), ``serve`` (one ``/v1/detect``
   answers 200 with the detect command's faces), ``info`` (the card) and
   ``doctor --json`` (only "model assets" FAILs: the ``.tflite`` files
   are not in the checkout);
12. scale-out (``_replica_phase``) on the FULL networks and frames:
   ``ReplicaPool`` over ``[cuda:0]`` and ``[cuda:0, cuda:0]`` beside one
   ``ServingPipeline`` (8 batches at depth 2 each, in turns: ms a batch,
   frames/s, the idle share of a profiled window; every whole batch equal
   to ``detect_faces_batch`` bit for bit; launch counts set to 0 just
   before the first two-replica run: one K1 and one K2 at 192 and at
   64 px a batch, plus re-runs; ``stats``), K1 and K2 against their plain
   versions on the replicas' inputs; ``detect_faces_batch_stream(devices=
   [cuda:0, cuda:0])`` against the sequential calls;
   ``FaceDetector(data_parallel=True)``: no mesh on one card (faces equal
   the plain detector's), and through the ``visible_devices`` seam a
   two-shard mesh of the card on a batch of 15 (face counts equal, boxes
   within 1e-5, scores within 1e-6; one K1 launch a shard; K1 and K2
   against their plain versions on each shard's inputs);
   ``seg_device="auto"`` (None on one card) and ``place_on`` (the
   combined batch equal to the unpinned one); ``serve --replicas 1``
   (``/v1/detect`` and ``/v1/info``'s replica fields), ``video --replicas
   1 --max-frames 8`` (equal to phase 8a's results), ``--replicas`` above
   the card count (exit 1); a pool and a mesh over ``cuda:0`` and
   ``cuda:1`` where there are two cards, else a line saying so;
13. the profiler trace with stage ranges (``_trace_phase``), in a child
   process of its own (``python3 chip_smoke.py --trace-phase``: the
   profiler can lose a session's device records after the many sessions
   of the phases before it), on fresh seeded networks of the same seed:
   FULL and FULL with embeddings on the main frames through
   ``tools/trace_capture_torch.py``'s ``capture`` (2 warm batches, launch
   counts set to 0, 3 batches under ``pipeline.timings.trace``) and
   ``stage_breakdown``; a ``trace`` JSON line a cell (device ms, kernels,
   copies and K1/K2 launches of each ``fdt.*`` stage a batch, busy and
   window ms, the attributed share); it fails unless the ranges hold at
   least 98% of the device time, K1's launches lie in ``fdt.postprocess``
   only and K2's in ``fdt.mesh``, ``fdt.iris`` and ``fdt.embedding``
   only, each equal to the wrappers' counts over the traced batches, and
   the traced batches' faces equal the same batches' untraced bit for
   bit; then 2 batches through ``ServingPipeline`` under the trace (the
   worker thread's ranges must reach it, K1 in its ``fdt.postprocess``,
   faces equal the direct calls'), one traced ``detect_faces`` and one
   traced ``detect_faces_from_camera_frame`` at B = 1 (their ranges
   counted), ``tools/warm_torch.py``'s ``warm`` on the FULL detector
   (seconds a step), and the host cost of the ranges of a FULL +
   embeddings batch and of each B = 1 call with no profiler running (µs a
   call through ``stage_range``, as the port enters them, and through
   ``record_function`` alone, over 10,000 rounds, beside the call's ms);
14. the programs as captured CUDA graphs (``_graphs_phase``, before
   phase 13; ``python3 chip_smoke.py --graphs-phase`` runs it alone on the
   same seeded networks and frames): the copy-in of a frame batch into a
   graph's static input, timed alone; STANDARD, FULL and FULL with
   embeddings at B = 16 on a fresh detector each (``_graph_cell``): the
   first batches under ``graphs.capture_now`` (each key captured on its
   first call) and each key's capture by part (``_capture_split``: the
   pool's adopt and whether it renewed the pool, the program's run under
   capture, ``capture_end``, the first replay, the card's reservations
   added), launches over 5
   replayed batches (one K1 and one K2 at each site a batch, plus
   re-runs), the replayed faces against the same detector's eager calls
   (``graphs.eager``) bit for bit, the replayed outputs of the steady
   key, the 2-face speculative key and a forced overflow re-run at 16
   faces against ``build_pipeline_program``'s eager program, the
   readback packed in the replay against the eager outputs packed op by
   op (largest difference printed, 0 required), ms a batch replayed and
   eager in
   turns (each replayed turn must find its keys captured), the host's ms
   to queue a batch already on the card with no
   synchronise, the graphs and the pool's bytes, and 3 batches of each
   in a plain ``torch.profiler`` window (busy ms a batch and idle share;
   CUDA events where the profiler kept no record); the capture schedule
   on a fresh FULL detector's steady key (``_graph_schedule``: calls 1 to
   ``graphs.CAPTURE_AT_CALL`` - 1 eager, the next captures, 3 replays
   after, each call's outputs against the eager program bit for bit and
   its ms from CUDA events, one K1 and one K2 at each site a call); K1 and
   K2 against their plain versions on the cells' frames; ``detect_faces`` and
   ``detect_faces_from_camera_frame`` at B = 1 (faces against the eager
   calls', launches, ms a call both ways, K1 and K2 on the frame); the
   standalone ``FaceDetection`` (one program per size: detections against
   the eager program's, one K1 launch a call, ms a call both ways,
   capture ms, pool bytes); two threads on one key and a depth-2 stream
   whose every batch re-runs its face stages on its replay's ``det_*``
   slab, each equal to the sequential calls bit for bit; the FULL
   readback packed inside the 2-face key's graph against the same
   program captured without it and packed op by op after the replay, on
   15 of 16 rows (``_graph_pack``: ``readback.fetch_finish``'s arrays bit
   for bit, the host µs of the fetch step in turns, the operators the host
   launches for a replayed batch's call and fetch either way);
   ``SelfieSegmentation`` at B = 16, the general segmenter in float32 and
   uint8 and the multiclass one in float32 (``_graph_segmentation``: the
   size's replayed planes against its eager run, bit for bit, ms a batch
   both ways in turns, the host's ms to queue a batch, 3 batches in a
   plain profiler window each way, capture ms, pool bytes);
   ``FaceEmbedding.embed_batch`` on frame 0 at N = 1, 3, 4 and 16 seeded
   eye pairs (``_graph_embedding``: slabs 1, 4 and 16, the embeddings
   against the eager calls' bit for bit, one K2 launch at 112 px a
   replayed call from the capture's tally, K2 against its plain version
   on the replay's ROIs, ms a call both ways); ``FaceLandmark``,
   ``IrisLandmark`` and ``FaceBlendshapesModel`` at B = 1 on seeded
   inputs (``_graph_single``: bit for bit, ms a call both ways); the
   call at which each key timed both ways would capture by the rule
   ``graphs.CAPTURE_AT_CALL`` follows (``_capture_at_call``); a
   ``graphs`` JSON line of the numbers; ``time:`` lines give the seconds
   into the phase (and into the run, a line a phase);
15. prints the ``kernels`` JSON line and, last, the ``{"ok": true, ...}``
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
   requests; ``tier_launches`` per tier and ``int8_launches`` over phase
   10's ``tier_batches`` batches each; ``cli_launches`` over phase 11's
   ``detect`` run of ``cli_images`` images, the embedding site's over its
   ``embed`` run; ``replica_launches`` over phase 12's first two-replica
   run of ``replica_batches`` batches, ``dp_launches`` over its
   ``dp_batches`` data-parallel batches of two shards each); the iris
   site's
   (``warp_normalize_iris64``) is its count over the FULL path's batches
   and the embedding site's (``warp_normalize_embed112``) over the
   embedding phase's (``server_embed_launches``: one ``/v1/embed``);
   ``graph_launches`` over phase 14's ``graph_batches`` replayed batches
   of each B = 16 cell and its ``graph_calls`` replayed B = 1 calls (K1
   also over the standalone calls, the embedding site also over the
   ``embed_batch_calls`` replayed ``embed_batch`` calls, and over the
   ``schedule_calls`` calls of the schedule check);
   ``nms_core`` is off the main path (0, and 0 over phase 11's ``detect``
   run, both counted) and its launches in step 3 are ``check_launches``.
   K5's (``residual_act``) are counted over the same runs of each path
   (``embed_launches``: the embedding phase's batches), held on the main
   paths and the captured cells to one launch a planned pass of each
   network call (``per_call``: the detector's, the mesh's, the iris
   net's and MobileFaceNet's, one a float32 convolution with a bias
   besides the passes that take no bias; the Mixer has none), with
   ``op_by_op_launches`` the PRELUs and RELU ADDs that ran op by op there
   and ``bias_op_by_op_launches`` the float32 convolutions' biases that
   PyTorch added (both 0 on every main path).
   K1's ``max_abs_err`` is its largest box error over every check
   against the plain version (steps 3, 4, 8, 9, 10, 11, 12 and 14).

Any failed check raises, and the script exits non-zero.  It exits 2
without a result where CUDA is unavailable or the package is missing.
"""

from __future__ import annotations

import collections
import contextlib
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
    caller falls back to CUDA events.  The ``fdt.*`` stage ranges, which
    the profiler also reports on the device's timeline (each a
    ``gpu_user_annotation`` span over its stage's kernels), are not
    device work and are left out."""
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
                  and not e.name.startswith("fdt.") and keep(e.name)]
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
    if "residual_act_affine" in n:
        return "K5 residual_act_affine"
    if "residual_act" in n:
        return "K5 residual_act"
    if "pointwise_conv" in n:
        return "K6 pointwise_conv"
    if "depthwise_conv" in n:
        return "K7 depthwise_conv"
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
    measured.  With ``net`` the batch runs its eager program
    (``graphs.eager``): a captured graph's replay does not call the
    network's ``forward``, so it would launch no marker."""
    import torch
    from face_detection_tflite_torch.pipeline import graphs
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
        with graphs.eager() if net is not None else contextlib.nullcontext():
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
    _reset_k5_counts()
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
        "nms_core": nms_mod.nms_core.launches, **_k5_counts()}
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
    k5 = _k5_want(models, runs, reruns, full, embed)
    if {k: launches[k] for k in k5} != k5:
        raise AssertionError(f"{name}: K5 and op-by-op launches "
                             f"{launches}, want {k5} (one K5 launch a "
                             f"planned pass of each network call, "
                             f"{_k5_per_call(models)})")
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


def _check_embeddings(faces, dim: int = 192) -> None:
    """Every face of the fused embedding stage has a finite ``dim``-dim
    embedding of norm 1 (within 1e-4)."""
    import numpy as np
    for face in (f for per in faces for f in per):
        e = face.embedding
        if e is None or e.shape != (dim,) or not np.isfinite(e).all() or \
                abs(float(np.linalg.norm(e)) - 1.0) > 1e-4:
            raise AssertionError(f"a face lacks a unit {dim}-dim embedding")


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
    operations (``torch.utils.flop_counter`` over a CPU copy on one crop,
    which runs every convolution through PyTorch, K6's too) at the fp32
    peak."""
    import copy
    import torch
    from torch.utils.flop_counter import FlopCounterMode
    from face_detection_tflite_torch.ops import warp as warp_mod
    with torch.inference_mode():
        x = warp_mod.warp_normalize(frames, *roi, out_size=EMBED_SIZE
                                    ).reshape(-1, EMBED_SIZE, EMBED_SIZE, 3)
        with FlopCounterMode(display=False) as counter:
            copy.deepcopy(net).cpu()(x[:1].cpu())
        flops = counter.get_total_flops() * x.shape[0]
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


#: K5's sites (``ops/epilogue.py``): name -> (N, H, W, C, C_r (0: no
#: residual), act, in place), the largest tensor of each site of the main
#: paths' networks at their batch (16 frames, 256 face crops, 512 eye
#: crops, 256 embedding crops), each with its convolution's bias: the
#: blocks' ends, a standalone ReLU and a bare residual ADD of the
#: multiclass segmenter, and in place a depthwise convolution's bias
#: alone and the detector stem's bias and fused ReLU.
K5_SITES = {
    "iris": (512, 32, 32, 64, 64, "PRELU", False),
    "mesh": (256, 96, 96, 16, 16, "PRELU", False),
    "mesh_pad": (256, 48, 48, 32, 16, "PRELU", False),
    "mobilefacenet": (256, 56, 56, 64, 0, "PRELU", False),
    "detector": (16, 128, 128, 24, 24, "RELU", False),
    "segmenter_relu": (16, 128, 128, 48, 0, "RELU", False),
    "segmenter_add": (16, 128, 128, 24, 24, None, False),
    "iris_dw_bias": (512, 32, 32, 64, 0, None, True),
    "detector_stem": (16, 128, 128, 24, 0, "RELU", True),
}


def _k5_sites(card: str) -> dict:
    """Holds K5 bit for bit against its plain version at each site of
    :data:`K5_SITES` on seeded values with -0.0, +0.0, NaN and +-inf
    planted (in y, the residual and the bias), one launch a call, and
    times both: the kernel's event and device ms (:func:`_kernel_ms`),
    the plain version's event ms, and the bound of its bytes (y, the
    residual and the bias read once, the output written once, over HBM3
    bandwidth).  An in-place site writes over a fresh copy of y each
    check.  Returns the ``kernels`` fields by site."""
    import torch
    from face_detection_tflite_torch.ops import epilogue
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + 20)

    def draw(shape, planted=64):
        x = torch.randn(shape, generator=g, device=dev)
        flat = x.view(-1)
        picks = torch.randint(0, flat.numel(), (5 * planted,), generator=g,
                              device=dev)
        for j, v in enumerate((-0.0, 0.0, float("nan"), float("inf"),
                               float("-inf"))):
            flat[picks[j::5]] = v
        return x

    out = {}
    for site, (n, h, w, c, cr, act, inplace) in K5_SITES.items():
        y = draw((n, h, w, c))
        r = draw((n, h, w, cr)) if cr else None
        alpha = ((torch.rand(c, generator=g, device=dev) - 0.5)
                 if act == "PRELU" else None)
        bias = draw((c,), planted=1)

        def kernel():
            return epilogue.residual_act(y, r, act, alpha, bias, inplace)

        def plain():
            return epilogue.residual_act_plain(y, r, act, alpha, bias)

        before = epilogue.residual_act.launches
        want = plain()
        y_in = y.clone()
        got = kernel()
        torch.cuda.synchronize()
        if epilogue.residual_act.launches != before + 1:
            raise AssertionError(f"K5 {site}: "
                                 f"{epilogue.residual_act.launches - before}"
                                 f" launches a call")
        if (got.data_ptr() == y.data_ptr()) != inplace:
            raise AssertionError(f"K5 {site}: in place {inplace}, the "
                                 f"output at y {not inplace}")
        if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
            raise AssertionError(f"K5 {site}: the kernel differs from its "
                                 f"plain version")
        y.copy_(y_in)
        del y_in, got, want
        ms, dev_ms, dev_by = _kernel_ms(kernel, "K5 residual_act")
        plain_ms = _median_ms(plain, iters=5, warmup=1)
        nbytes = 4 * (2 * y.numel() + c +
                      (r.numel() if r is not None else 0))
        bound_ms, bound_by = _bound(nbytes, 2 * y.numel())
        out[site] = {"shape": [n, h, w, c], "residual_channels": cr,
                     "act": act, "bias": True, "in_place": inplace,
                     "max_abs_err": 0.0, "ms": ms,
                     "device_ms": dev_ms, "device_ms_by": dev_by,
                     "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by}
        print(f"K5 residual_act {site} {n}x{h}x{w}x{c}, residual C_r={cr}, "
              f"{act}, bias{', in place' if inplace else ''}: bit for bit; "
              f"kernel {ms:.4f} ms (device {dev_ms:.4f} ms, {dev_by}), "
              f"plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
              f"({bound_by}; the device time "
              f"{100 * bound_ms / dev_ms:.0f}% of it)  [{card}]")
        del y, r
    return out


#: K5's affine sites (``ops/epilogue.py::residual_act_affine``): name ->
#: (N, H, W, C, act, residual, keep), iresnet50's at 256 crops: the stem's
#: PReLU and a stage-1 block's end, both kept for the identity or the
#: downsample, and the head's BN2d after the last block, written alone;
#: each with its convolution's bias.
K5_AFFINE_SITES = {
    "stem_prelu": (256, 112, 112, 64, "PRELU", False, True),
    "block_end_56": (256, 56, 56, 64, None, True, True),
    "head_7": (256, 7, 7, 512, None, True, False),
}


def _k5_affine_sites(card: str) -> dict:
    """Holds K5's affine instance bit for bit against its plain version
    (the pass, then the graph's MUL and ADD one by one) at each site of
    :data:`K5_AFFINE_SITES` on seeded values with -0.0, NaN and +-inf
    planted, one launch a call, and times both, with the bound of its
    bytes (y and the residual read once, z and, where kept, the pass's
    output written once).  Returns the ``kernels`` fields by site."""
    import torch
    from face_detection_tflite_torch.ops import epilogue
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + 26)

    def draw(shape):
        x = torch.randn(shape, generator=g, device=dev)
        flat = x.view(-1)
        picks = torch.randint(0, flat.numel(), (5 * 64,), generator=g,
                              device=dev)
        for j, v in enumerate((-0.0, 0.0, float("nan"), float("inf"),
                               float("-inf"))):
            flat[picks[j::5]] = v
        return x

    out = {}
    for site, (n, h, w, c, act, res, keep) in K5_AFFINE_SITES.items():
        y = draw((n, h, w, c))
        r = draw((n, h, w, c)) if res else None
        alpha = ((torch.rand(c, generator=g, device=dev) - 0.5)
                 if act == "PRELU" else None)
        bias, scale, shift = (torch.randn(c, generator=g, device=dev)
                              for _ in range(3))

        def kernel():
            return epilogue.residual_act_affine(y, r, act, alpha, bias,
                                                scale, shift, keep)

        def plain():
            return epilogue.residual_act_affine_plain(y, r, act, alpha, bias,
                                                      scale, shift, keep)

        before = epilogue.residual_act_affine.launches
        want_out, want = plain()
        got_out, got = kernel()
        torch.cuda.synchronize()
        if epilogue.residual_act_affine.launches != before + 1:
            raise AssertionError(f"K5 affine {site}: not one launch a call")
        if not torch.equal(got.view(torch.int32), want.view(torch.int32)) \
                or (got_out is None) != (want_out is None) or (
                    keep and not torch.equal(got_out.view(torch.int32),
                                             want_out.view(torch.int32))):
            raise AssertionError(f"K5 affine {site}: the kernel differs "
                                 f"from its plain version")
        del got_out, got, want_out, want
        ms, dev_ms, dev_by = _kernel_ms(kernel, "K5 residual_act_affine")
        plain_ms = _median_ms(plain, iters=5, warmup=1)
        nbytes = 4 * y.numel() * ((2 if res else 1) + (2 if keep else 1))
        bound_ms, bound_by = _bound(nbytes, 3 * y.numel())
        out[site] = {"shape": [n, h, w, c], "act": act, "residual": res,
                     "keep": keep, "bias": True, "max_abs_err": 0.0,
                     "ms": ms, "device_ms": dev_ms, "device_ms_by": dev_by,
                     "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by}
        print(f"K5 residual_act_affine {site} {n}x{h}x{w}x{c}, {act}, "
              f"residual {res}, bias, out kept {keep}: bit for bit; kernel "
              f"{ms:.4f} ms (device {dev_ms:.4f} ms, {dev_by}), plain "
              f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}; the "
              f"device time {100 * bound_ms / dev_ms:.0f}% of it)  [{card}]")
        del y, r
    return out


#: Replayed batches of the iresnet50 path (:func:`_arcface_phase`).
ARC_RUNS = 4


def _arcface_phase(models, frames_np, card: str) -> dict:
    """Phase 6b, the path of the cell ``full_arcface.stream16``: FULL with
    ``embed_in_full`` and iresnet50 at its published widths as the
    embedding network (``tests/iresnet_reference.py``, seeded; the main
    path's other networks and frames), through
    ``detect_faces_batch_stream`` at depth :data:`STREAM_DEPTH`.  Warmed
    under ``graphs.capture_now`` (each key captured on its first call),
    then :data:`ARC_RUNS` replayed batches with every count set to 0 just
    before: one K5 affine launch a planned pair of each embedding call
    (25 a call of ``FRAMES * MAX_FACES`` crops, and of each overflow
    re-run), none op by op, K5's other passes, K1 and K2 as on the other
    paths (:func:`_k5_want`), and a unit 512-dim embedding a face; the
    last batch's embeddings bit for bit those of the same detector's
    eager program with ``residual_act_affine_plain`` in place of the
    kernel.  Returns the counts for the ``kernels`` entry."""
    import numpy as np
    import torch
    from face_detection_tflite_torch import FaceDetector
    from face_detection_tflite_torch.convert import executor
    from face_detection_tflite_torch.ops import epilogue
    from face_detection_tflite_torch.pipeline import graphs
    from face_detection_tflite_torch.pipeline.programs import PipelineModels
    from tests import iresnet_reference as ires
    from tests.iresnet_ir import to_ir
    net = executor.convert_model(to_ir(ires.tflite_form(ires.seeded(
        ires.IResNet(), SEED + 27))), name="iresnet50")
    arc = PipelineModels(models.detector, models.variant, mesh=models.mesh,
                         iris=models.iris, blendshapes=models.blendshapes,
                         embedding=net, device=models.device)
    det = FaceDetector(models=arc, device=models.device, max_faces=MAX_FACES,
                       embed_in_full=True, allow_untrained_embeddings=True)
    def stream():
        return list(det.detect_faces_batch_stream([frames_np] * ARC_RUNS,
                                                  depth=STREAM_DEPTH))

    # As the benchmark warms a cell: until no program key is left
    # uncaptured.
    t0 = time.perf_counter()
    for cycle in range(4):
        with graphs.capture_now():
            stream()
        before = det.memory_report()
        if before["pending_keys"] == 0:
            break
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    reruns0 = _reruns(det)
    _reset_launches()
    t0 = time.perf_counter()
    faces = stream()
    torch.cuda.synchronize()
    batch_ms = (time.perf_counter() - t0) * 1e3 / ARC_RUNS
    launches, reruns = _launches(), _reruns(det) - reruns0
    after = det.memory_report()
    calls = {k: after[k] - before[k] for k in ("eager_calls", "replays",
                                               "captured_keys")}
    per_call = _affine_per_call(arc)
    want = {"detection_postprocess": ARC_RUNS,
            "warp_normalize": {s: ARC_RUNS + reruns
                               for s in (MESH_SIZE, IRIS_SIZE, EMBED_SIZE)},
            **_k5_want(arc, ARC_RUNS, reruns, True, True)}
    if per_call != 25 or before["pending_keys"] or calls["eager_calls"] \
            or calls["captured_keys"] or calls["replays"] < ARC_RUNS or \
            {k: launches[k] for k in want} != want:
        raise AssertionError(f"iresnet50 path: {per_call} affine passes a "
                             f"call (want 25); after {cycle + 1} warm-up "
                             f"cycles {before['pending_keys']} keys pending;"
                             f" over {ARC_RUNS} batches {calls}; launches "
                             f"{launches}, want {want}")
    _check_embeddings([per for batch in faces for per in batch], 512)
    real = executor.residual_act_affine
    executor.residual_act_affine = epilogue.residual_act_affine_plain
    try:
        with graphs.eager():
            plain = det.detect_faces_batch(frames_np)
    finally:
        executor.residual_act_affine = real
    got = [f.embedding for per in faces[-1] for f in per]
    ref = [f.embedding for per in plain for f in per]
    if len(got) != len(ref) or not all(
            np.array_equal(a.view(np.uint32), b.view(np.uint32))
            for a, b in zip(got, ref)):
        raise AssertionError("iresnet50 path: the replayed embeddings differ "
                             "from the plain affine passes'")
    print(f"iresnet50 path (FULL + embed_in_full, stream depth "
          f"{STREAM_DEPTH}): warm-up and captures {warm_s:.1f} s ({cycle + 1}"
          f" cycles); {ARC_RUNS} replayed batches of {FRAMES} x {HEIGHT}x"
          f"{WIDTH} ({calls['replays']} replays, no eager call, {reruns} "
          f"re-runs), {batch_ms:.2f} ms a batch; K5 affine "
          f"{launches['affine']} launches ({per_call} a call), op by op "
          f"{launches['affine_op_by_op']}, other K5 passes "
          f"{launches['residual_act']}; the last batch's {len(got)} "
          f"embeddings bit for bit with the plain affine passes  [{card}]")
    det.dispose()
    return {"per_call": per_call, "calls": ARC_RUNS, "reruns": reruns,
            "launches": launches["affine"],
            "op_by_op": launches["affine_op_by_op"],
            "residual_act": launches["residual_act"]}


def _affine_phase_alone() -> int:
    """``python3 chip_smoke.py --affine-phase``: the build, K5's affine
    sites (:func:`_k5_affine_sites`) and the iresnet50 path
    (:func:`_arcface_phase`, on the main path's seeded networks and
    frames) alone."""
    import numpy as np
    import torch
    from face_detection_tflite_torch.kernels import build
    from face_detection_tflite_torch.models import random_init
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(f"card: {card}")
    t0 = time.perf_counter()
    build.load()
    print(f"build: {time.perf_counter() - t0:.2f} s")
    for line in build.build_log().splitlines():
        if "affine" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")
    _k5_affine_sites(card)
    frames_np = np.random.default_rng(SEED).integers(
        0, 256, (FRAMES, HEIGHT, WIDTH, 3), dtype=np.uint8)
    models = random_init.random_pipeline_models(
        torch.from_numpy(frames_np).to("cuda"), seed=SEED)[0]
    _arcface_phase(models, frames_np, card)
    print(card)
    return 0


#: Crops a batch on the embedding path: 16 frames x 16 faces.
K6_CROPS = 256


def _k6_site_shapes(crops: int) -> list:
    """MobileFaceNet's 32 1x1 convolutions at ``crops`` crops, in the
    network's order: ``(name, M, K, N, PReLU, residual)``, M the NHWC rows
    (``crops`` x H x W)."""
    from face_detection_tflite_torch.models.embedding import \
        _pointwise_sites
    return [(name, crops * hw * hw, k, n, prelu, res)
            for name, hw, k, n, prelu, res in _pointwise_sites()]


def _k6_sites(card: str, net=None) -> dict:
    """Holds K6 against its plain version (cuDNN's convolution, then K5)
    at each of MobileFaceNet's 32 1x1 convolutions at the embedding
    path's 256 crops, with seeded weights, nonzero biases and PReLU slopes
    (within ``pointwise.rounding_bound``), one launch a call, and times
    it: its event and device ms, the plain version's device ms (cuDNN's
    kernels, its transposes and the K5 pass), cuDNN's convolution alone,
    the short library route on the NHWC rows (cuBLAS's ``addmm`` with the
    bias, then a K5 pass of the PReLU or residual where the site has one;
    and ``mm``, then a K5 pass of the bias with them, held to the same
    bound), and its bound (the larger of 2 M K N operations at the fp32 peak and x,
    the filter, the bias, the residual read and the output written once
    over HBM3 bandwidth).  Then one forward of the network at 256 crops:
    32 K6 launches.  Returns the ``kernels`` fields by site and their
    sums."""
    import torch
    import torch.nn.functional as F
    from face_detection_tflite_torch.convert.executor import \
        fp32_on_the_card
    from face_detection_tflite_torch.models.embedding import \
        build_mobilefacenet
    from face_detection_tflite_torch.ops import epilogue, pointwise
    dev = torch.device("cuda")
    fp32_on_the_card(dev)
    if net is None:
        net = build_mobilefacenet(SEED + 21)
        g = torch.Generator().manual_seed(SEED + 21)
        for key, b in net.named_buffers():
            if key.endswith("_b"):
                b.copy_(0.1 * torch.randn(b.shape, generator=g))
            elif key.endswith("_a"):
                b.copy_(torch.rand(b.shape, generator=g) - 0.5)
        net = net.to(dev).eval()
    g = torch.Generator(device=dev).manual_seed(SEED + 22)
    out, sums = {}, {"device_ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
                     "addmm_k5_ms": 0.0, "mm_k5_ms": 0.0, "bound_ms": 0.0}
    for name, m, k, n, prelu, res in _k6_site_shapes(K6_CROPS):
        hw = round((m // K6_CROPS) ** 0.5)
        x = torch.randn((K6_CROPS, hw, hw, k), generator=g, device=dev)
        r = (torch.randn((K6_CROPS, hw, hw, n), generator=g, device=dev)
             if res else None)
        w = net._buffers[f"_kn_{name}_w"]
        bias = getattr(net, f"{name}_b")
        act = "PRELU" if prelu else None
        alpha = getattr(net, f"{name}_a") if prelu else None
        oihw = getattr(net, f"{name}_w")

        def kernel():
            return pointwise.pointwise_conv(x, w, bias, act, alpha, r)

        def plain():
            return pointwise.pointwise_conv_plain(x, w, bias, act, alpha, r)

        def library():
            return F.conv2d(x.permute(0, 3, 1, 2), oihw)

        def addmm_k5():
            y = torch.addmm(bias, x.view(-1, k), w).view(*x.shape[:3], n)
            if act is None and r is None:
                return y
            return epilogue.residual_act(y, r, act, alpha)

        def mm_k5():
            y = torch.mm(x.view(-1, k), w).view(*x.shape[:3], n)
            return epilogue.residual_act(y, r, act, alpha, bias,
                                         inplace=act is None and r is None)

        with torch.inference_mode():
            before = pointwise.pointwise_conv.launches
            got = kernel()
            torch.cuda.synchronize()
            if pointwise.pointwise_conv.launches != before + 1:
                raise AssertionError(f"K6 {name}: "
                                     f"{pointwise.pointwise_conv.launches - before}"
                                     f" launches a call")
            want = plain()
            tol = pointwise.rounding_bound(x, w, bias, alpha, r)
            for label, alt in (("addmm + K5", addmm_k5), ("mm + K5", mm_k5)):
                if not bool(((alt() - want).abs().double() <= tol).all()):
                    raise AssertionError(f"{label} {name}: outside the "
                                         f"rounding bound of the plain "
                                         f"version")
            gap = (got - want).abs()
            if not bool((gap.double() <= tol).all()):
                worst = (gap.double() / tol).max().item()
                raise AssertionError(f"K6 {name}: the kernel differs from its "
                                     f"plain version by {worst:.3g} times the "
                                     f"rounding bound")
            err = gap.max().item()
            ratio = (gap.double() / tol).max().item()
            del got, want, gap, tol
            ms, dev_ms, dev_by = _kernel_ms(kernel, "K6 pointwise_conv",
                                            iters=10)
            _, plain_ms, _, _ = _stage_ms(plain, iters=5)
            _, lib_ms, _, _ = _stage_ms(library, iters=5)
            _, addmm_ms, _, _ = _stage_ms(addmm_k5, iters=10)
            _, mm_ms, _, _ = _stage_ms(mm_k5, iters=10)
        nbytes = 4 * (m * k + k * n + n + m * n * (2 if res else 1))
        bound_ms, bound_by = _bound(nbytes, 2 * m * k * n)
        out[name] = {"shape": [m, k, n], "act": act, "residual": res,
                     "bias": True, "max_abs_err": err,
                     "err_over_bound": ratio, "ms": ms, "device_ms": dev_ms,
                     "device_ms_by": dev_by, "plain_ms": plain_ms,
                     "library_ms": lib_ms, "addmm_k5_ms": addmm_ms,
                     "mm_k5_ms": mm_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by}
        for key in sums:
            sums[key] += out[name][key] or 0.0
        print(f"K6 pointwise_conv {name} M={m} K={k} N={n}"
              f"{', PReLU' if prelu else ''}{', residual' if res else ''}: "
              f"max_abs_err={err:.3g} ({ratio:.3g} of the rounding bound); "
              f"kernel {ms:.4f} ms (device {dev_ms:.4f} ms, {dev_by}), "
              f"plain {_num(plain_ms, '.4f')} ms device, cuDNN's convolution "
              f"{_num(lib_ms, '.4f')} ms device, addmm + K5 "
              f"{_num(addmm_ms, '.4f')} ms device, mm + K5 "
              f"{_num(mm_ms, '.4f')} ms device, bound {bound_ms:.4f} ms "
              f"({bound_by}; {100 * bound_ms / dev_ms:.0f}% of the device "
              f"time)  [{card}]")
        del x, r
    x = torch.rand((K6_CROPS, EMBED_SIZE, EMBED_SIZE, 3), generator=g,
                   device=dev) * 2 - 1
    before = pointwise.pointwise_conv.launches
    with torch.inference_mode():
        net(x)
    torch.cuda.synchronize()
    launches = pointwise.pointwise_conv.launches - before
    if launches != len(out):
        raise AssertionError(f"K6: one MobileFaceNet forward launched it "
                             f"{launches} times, want {len(out)}")
    print(f"K6 pointwise_conv, the 32 sites at {K6_CROPS} crops: device "
          f"{sums['device_ms']:.4f} ms, bound {sums['bound_ms']:.4f} ms "
          f"({100 * sums['bound_ms'] / sums['device_ms']:.0f}%), plain "
          f"(cuDNN and K5) {sums['plain_ms']:.4f} ms, cuDNN's convolutions "
          f"alone {sums['library_ms']:.4f} ms, addmm + K5 "
          f"{sums['addmm_k5_ms']:.4f} ms, mm + K5 {sums['mm_k5_ms']:.4f} ms; "
          f"{launches} launches a forward"
          f"  [{card}]")
    return {"sites": out, "totals": sums, "forward_launches": launches}


def _pointwise_phase_alone() -> int:
    """``python3 chip_smoke.py --pointwise-phase``: the build and K6's
    sites alone (:func:`_k6_sites`)."""
    from face_detection_tflite_torch.kernels import build
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(f"card: {card}")
    t0 = time.perf_counter()
    build.load()
    print(f"build: {time.perf_counter() - t0:.2f} s")
    for line in build.build_log().splitlines():
        if "pointwise" in line or "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")
    _k6_sites(card)
    print(card)
    return 0


#: The batch each network of the stream16 cells runs its depthwise
#: convolutions at: 16 frames (the detector, the multiclass segmenter),
#: 256 face slots (the mesh), 512 eye slots (the iris net), 256 crops
#: (MobileFaceNet).
K7_BATCH = {"detector": 16, "mesh": 256, "iris": 512, "embedding": 256,
            "segmenter": 16}
#: The batch of FULL's networks in the single720 cell: one frame, the
#: 2-face slab, its 4 eyes.
K7_SINGLE_BATCH = {"detector": 1, "mesh": 2, "iris": 4}


def _k7_site_shapes() -> list:
    """Every distinct depthwise convolution of the benchmark's five
    networks as K7 runs it, with how many a network call runs:
    ``((role, h, w, c, k, stride, pads, act), count)``, from the seeded
    full-depth graphs' plans and MobileFaceNet's layers."""
    from face_detection_tflite_torch.convert.executor import (
        _conv_padding, _same_pads, convert_model)
    from face_detection_tflite_torch.models import random_init
    from face_detection_tflite_torch.models.embedding import \
        _depthwise_sites
    counts = collections.Counter()
    for role, ir in (("detector", random_init.blazeface_back_ir(SEED)),
                     ("mesh", random_init.face_mesh_ir(SEED)),
                     ("iris", random_init.iris_landmark_ir(SEED)),
                     ("segmenter", random_init.selfie_multiclass_ir(SEED))):
        m = convert_model(ir)
        for i, dw in m._depthwise.items():
            op = m._ops[i]
            _, h, w, c = m._shapes[op.inputs[0]]
            k = m._shapes[op.inputs[1]][1]
            pads = tuple(map(tuple, _conv_padding(op.options, h, w, k, k)))
            counts[(role, h, w, c, k, op.options["stride_h"], pads,
                    dw.act)] += 1
    for _, hw, c, k, st, prelu, same in _depthwise_sites():
        pads = (_same_pads(hw, st, k),) * 2 if same else ((0, 0), (0, 0))
        counts[("embedding", hw, hw, c, k, st, pads,
                "PRELU" if prelu else None)] += 1
    return list(counts.items())


def _k7_sites(card: str) -> dict:
    """Holds K7 against its plain version (cuDNN's convolution, then K5's
    plain pass) at every distinct depthwise site of the five networks at
    the stream16 cells' batch (:data:`K7_BATCH`), and FULL's at the
    single720 cell's (:data:`K7_SINGLE_BATCH`), within the float32
    rounding of its sums (``depthwise.rounding_bound``), on seeded inputs,
    filters, nonzero biases and PReLU slopes, one launch a call; and
    times it: its device ms, its bound (the input read and the output
    written once, with the filter, bias and slope, over HBM3 bandwidth;
    the 2 k^2 operations an output are far below the fp32 peak) and its
    share of it, beside the route it replaces on the same inputs
    (``library_ms``: ``executor.conv2d``, cuDNN with its ``F.pad`` copy
    where the pads are asymmetric, then the K5 pass the plan gave it, in
    place where it has no PReLU).  Inputs repeat across the timed calls,
    so a site whose input fits in the 50 MB L2 reads it warm.  Sums over
    a batch weight each site by the network calls' count of it.  Returns
    the ``kernels`` fields by site and the sums."""
    import torch
    from face_detection_tflite_torch.convert.executor import (
        conv2d, fp32_on_the_card)
    from face_detection_tflite_torch.ops import depthwise, epilogue
    dev = torch.device("cuda")
    fp32_on_the_card(dev)
    g = torch.Generator(device=dev).manual_seed(SEED + 27)
    out = {}
    sums = {group: {"device_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0}
            for group in ("full", "embedding", "segmenter", "single720")}
    runs = [(site, count, K7_BATCH[site[0]], "")
            for site, count in _k7_site_shapes()]
    runs += [(site, count, K7_SINGLE_BATCH[site[0]], "single720_")
             for site, count, _, _ in runs if site[0] in K7_SINGLE_BATCH]
    for (role, h, w, c, k, st, pads, act), count, n, tag in runs:
        x = torch.randn((n, h, w, c), generator=g, device=dev)
        wt = torch.randn((c, 1, k, k), generator=g, device=dev) / k
        bias = 0.1 * torch.randn(c, generator=g, device=dev)
        alpha = (torch.rand(c, generator=g, device=dev) - 0.5
                 if act == "PRELU" else None)

        def kernel():
            return depthwise.depthwise_conv(x, wt, bias, stride=st,
                                            pads=pads, act=act, alpha=alpha)

        def library():
            y, rest = conv2d(x, wt, bias, stride=(st, st), pads=pads,
                             groups=c)
            return epilogue.residual_act(y, None, act, alpha, rest,
                                         inplace=act != "PRELU")

        with torch.inference_mode():
            before = depthwise.depthwise_conv.launches
            got = kernel()
            torch.cuda.synchronize()
            if depthwise.depthwise_conv.launches != before + 1:
                raise AssertionError(f"K7 {role} {(h, w, c, k, st)}: "
                                     f"{depthwise.depthwise_conv.launches - before}"
                                     f" launches a call")
            want = depthwise.depthwise_conv_plain(
                x, wt, bias, stride=st, pads=pads, act=act, alpha=alpha)
            tol = depthwise.rounding_bound(x, wt, bias, alpha, stride=st,
                                           pads=pads)
            gap = (got - want).abs().double()
            if not bool((gap <= tol).all()):
                raise AssertionError(
                    f"K7 {role} {(h, w, c, k, st, pads, act)}: the kernel "
                    f"differs from its plain version by "
                    f"{(gap / tol).max().item():.3g} times the rounding "
                    f"bound")
            err, ratio = gap.max().item(), (gap / tol).max().item()
            oh, ow = got.shape[1:3]
            del got, want, gap, tol
            ms, dev_ms, dev_by = _kernel_ms(kernel, "K7 depthwise_conv",
                                            iters=10)
            _, lib_ms, _, _ = _stage_ms(library, iters=10)
        nbytes = 4 * (x.numel() + n * oh * ow * c + c * k * k + 2 * c)
        bound_ms, bound_by = _bound(nbytes, 2 * k * k * n * oh * ow * c)
        name = f"{tag}{role}_{h}x{w}x{c}_k{k}s{st}_{act or 'none'}"
        if name in out:
            name += f"_pad{pads[0][0]}{pads[0][1]}"
        out[name] = {"count": count, "shape": [n, h, w, c], "k": k,
                     "stride": st, "pads": pads, "act": act, "bias": True,
                     "max_abs_err": err, "err_over_bound": ratio, "ms": ms,
                     "device_ms": dev_ms, "device_ms_by": dev_by,
                     "library_ms": lib_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by,
                     "bound_share": 100 * bound_ms / dev_ms}
        group = "single720" if tag else "full" if role in (
            "detector", "mesh", "iris") else role
        for key in sums[group]:
            sums[group][key] += count * (out[name][key] or 0.0)
        print(f"K7 depthwise_conv {name} x{count}: max_abs_err={err:.3g} "
              f"({ratio:.3g} of the rounding bound); device {dev_ms:.4f} ms "
              f"({dev_by}), bound {bound_ms:.4f} ms "
              f"({100 * bound_ms / dev_ms:.0f}%), library (cuDNN and K5) "
              f"{_num(lib_ms, '.4f')} ms  [{card}]")
        del x
    sums["full_embedding"] = {key: sums["full"][key] + sums["embedding"][key]
                              for key in sums["full"]}
    for group, tot in sums.items():
        print(f"K7 depthwise_conv, {group} sites a batch: device "
              f"{tot['device_ms']:.4f} ms, bound {tot['bound_ms']:.4f} ms "
              f"({100 * tot['bound_ms'] / tot['device_ms']:.1f}%), library "
              f"(cuDNN and K5) {tot['library_ms']:.4f} ms  [{card}]")
    return {"sites": out, "totals": sums}


def _depthwise_phase_alone() -> int:
    """``python3 chip_smoke.py --depthwise-phase``: the build and K7's
    sites alone (:func:`_k7_sites`)."""
    from face_detection_tflite_torch.kernels import build
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(f"card: {card}")
    t0 = time.perf_counter()
    build.load()
    print(f"build: {time.perf_counter() - t0:.2f} s")
    for line in build.build_log().splitlines():
        if "depthwise" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")
    k7 = _k7_sites(card)
    print(card)
    print(json.dumps({"card": card, **k7}))
    return 0


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


#: K5's counters (``ops/epilogue.py``) as the launch dicts name them.
_K5_COUNTS = {"residual_act": "residual_act", "op_by_op": "ran_op_by_op",
              "bias_folded": "bias_folded", "bias_alone": "bias_alone",
              "bias_op_by_op": "bias_op_by_op",
              "affine": "residual_act_affine",
              "affine_op_by_op": "affine_op_by_op"}


def _reset_k5_counts() -> None:
    """Sets K5's counters and K6's and K7's launches to 0."""
    from face_detection_tflite_torch.ops import depthwise, epilogue, pointwise
    for attr in _K5_COUNTS.values():
        getattr(epilogue, attr).launches = 0
    pointwise.pointwise_conv.launches = 0
    depthwise.depthwise_conv.launches = 0
    depthwise.library_depthwise.launches = 0


def _k5_counts() -> dict:
    """K5's counters, K6's launches (``pointwise_conv``), K7's
    (``depthwise_conv``) and the depthwise convolutions ``F.conv2d`` ran
    (``depthwise_library``)."""
    from face_detection_tflite_torch.ops import depthwise, epilogue, pointwise
    return {**{key: getattr(epilogue, attr).launches
               for key, attr in _K5_COUNTS.items()},
            "pointwise_conv": pointwise.pointwise_conv.launches,
            "depthwise_conv": depthwise.depthwise_conv.launches,
            "depthwise_library": depthwise.library_depthwise.launches}


def _reset_launches() -> None:
    from face_detection_tflite_torch.ops import detections
    from face_detection_tflite_torch.ops import warp as warp_mod
    detections.detection_postprocess.launches = 0
    warp_mod.warp_normalize.launches = 0
    warp_mod.warp_normalize.launches_by_size = {}
    _reset_k5_counts()


def _launches() -> dict:
    from face_detection_tflite_torch.ops import detections
    from face_detection_tflite_torch.ops import warp as warp_mod
    return {"detection_postprocess": detections.detection_postprocess.launches,
            "warp_normalize": dict(warp_mod.warp_normalize.launches_by_size),
            **_k5_counts()}


def _k6_per_call(models) -> int:
    """K6 launches one MobileFaceNet call makes on a card: one a float32
    1x1 convolution (each has a ``[K, N]`` filter copy), none at a bf16
    tier or without the network."""
    m = getattr(models, "embedding", None)
    return sum(1 for k in getattr(m, "_buffers", {}) if k.startswith("_kn_"))


def _k7_per_call(models) -> dict:
    """K7 launches one call of each network makes: one a depthwise
    convolution its plan gives K7 (``ConvertedModel._depthwise``);
    MobileFaceNet's 17 at a float32 tier, none at a bf16 tier."""
    from face_detection_tflite_torch.models.embedding import \
        _depthwise_sites
    out = {}
    for role in ("detector", "mesh", "iris", "blendshapes", "embedding"):
        m = getattr(models, role, None)
        if m is not None:
            out[role] = len(m._depthwise) if hasattr(m, "_depthwise") else \
                0 if m.runs_bf16 else len(_depthwise_sites())
    return out


def _k5_per_call(models) -> dict:
    """K5 launches one call of each network makes: its planned passes
    (``ConvertedModel._epilogues`` and its convolutions' own bias passes,
    ``_bias_passes``); MobileFaceNet one a convolution in float32 (its
    bias with the PReLU, the residual or alone) but its 1x1 and depthwise
    convolutions, which run in K6 and K7 (:func:`_k6_per_call`,
    :func:`_k7_per_call`), else one a PReLU."""
    out = {}
    for role in ("detector", "mesh", "iris", "blendshapes", "embedding"):
        m = getattr(models, role, None)
        if m is None:
            continue
        if hasattr(m, "_epilogues"):
            out[role] = sum(ep.scale is None for ep in m._epilogues.values()
                            ) + len(m._bias_passes)
        else:
            last = "_a" if m.runs_bf16 else "_b"
            out[role] = sum(1 for k, _ in m.named_buffers()
                            if k.endswith(last)) - _k6_per_call(models) \
                - _k7_per_call(models)["embedding"]
    return out


def _affine_per_call(models) -> int:
    """K5 affine launches one call of the networks makes: one a planned
    pass that takes a per-channel affine pair (none in the main paths'
    networks)."""
    return sum(ep.scale is not None
               for role in ("detector", "mesh", "iris", "blendshapes",
                            "embedding")
               for ep in getattr(getattr(models, role, None), "_epilogues",
                                 {}).values())


def _k5_want(models, calls: int, reruns: int, full: bool,
             embed: bool) -> dict:
    """K5, op-by-op, K6 and K7 launches of ``calls`` calls of a path with
    ``reruns`` overflow re-runs of the face stages: the detector's passes
    a call, the face networks' a call and a re-run; no depthwise
    convolution left to ``F.conv2d``."""
    per, dw = _k5_per_call(models), _k7_per_call(models)

    def faces(p):
        return p["mesh"] + (p["iris"] + p.get("blendshapes", 0)
                            if full else 0) + (p["embedding"] if embed
                                               else 0)
    return {"residual_act": calls * per["detector"]
            + (calls + reruns) * faces(per),
            "depthwise_conv": calls * dw["detector"]
            + (calls + reruns) * faces(dw), "depthwise_library": 0,
            "op_by_op": 0, "bias_op_by_op": 0,
            "affine": (calls + reruns) * _affine_per_call(models),
            "affine_op_by_op": 0,
            "pointwise_conv": (calls + reruns) * _k6_per_call(models)
            if embed else 0}


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
    if {k: launches[k] for k in want} != want:
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


def _graphs_held(det) -> dict:
    """What a path's detector captured (``memory_report``): the program
    keys captured, those called but not captured, and the card's graph
    pool bytes, which the process's captured programs share."""
    report = det.memory_report()
    return {k: report[k] for k in ("captured_keys", "pending_keys",
                                   "graph_pool_bytes")}


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
        graphs_held = _graphs_held(det)
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
              f"launches {launches} ({reruns} re-runs); {graphs_held}  "
              f"[{card}]")

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
    return {"models": models, "raw": raw, "decoded": decoded,
            "results": results, "launches": launches,
            "batches": n_batches, "post_err": post_err, "video_fps": VIDEO_FRAMES / video_s,
            "batch_fps": VIDEO_FRAMES / batch_s, "carried": share,
            "graphs": graphs_held,
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
    device program (CUDA events around the size's program, the letterbox,
    the net and the planes packed with the stage stamps, replayed on
    frames already on the card; the clone out of the graph included), the
    readback (host clock around ``readback.start`` of the packed rows'
    non-blocking copy to pinned memory and ``readback.wait``) and the
    host ``upsample`` of the batch's masks to the frames' size.  The
    float32 masks against the CPU on two frames, within
    :data:`SEG_CPU_TOL`."""
    import numpy as np
    import torch
    from face_detection_tflite_torch.convert.executor import convert_model
    from face_detection_tflite_torch.models.segmentation import \
        SelfieSegmentation
    from face_detection_tflite_torch.pipeline import readback
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
        [(_, prog)] = seg._programs.items()
        with torch.inference_mode():
            device_ms = _median_ms(lambda: prog(frames), iters=5, warmup=1)
            packed = prog(frames)
            torch.cuda.synchronize()
            reads = []
            for _ in range(5):
                t0 = time.perf_counter()
                readback.wait(readback.start(packed))
                reads.append((time.perf_counter() - t0) * 1e3)
        nbytes = packed["packed"].numel() * packed["packed"].element_size()
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
              f"{nbytes} B "
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


# -- phase 10: precision tiers, the int8 detector ------------------------------

#: The tiers phase 10 runs FULL at, against "highest": each label and the
#: ``precision`` that ``FaceDetector`` takes.
TIERS = (("high", "high"), ("mixed", "mixed"), ("serving", "serving"),
         ("default", "default"),
         ("detector=default,mesh=highest",
          {"detector": "default", "mesh": "highest"}))
TIER_RUNS = 3
#: IoU that pairs a face of a tier with one of the "highest" run.
MATCH_IOU = 0.5


def _matched_errors(got, want) -> dict:
    """Faces of two runs over the same frames paired by bounding-box IoU
    (greedy, at least :data:`MATCH_IOU`), and over the pairs the box
    corners' largest error and its mean over the faces, the mesh's and
    the iris's largest and mean error (px, x and y), the count of faces
    whose mesh moved by at most 1 px, and the blendshapes' largest
    error; the faces of either run left without a partner are counted,
    not failed on."""
    import numpy as np

    def corners(f):
        return np.asarray(f.bounding_box_pixels, np.float64)

    def iou(a, b):
        iw = max(0.0, min(a[2], b[2]) - max(a[0], b[0]))
        ih = max(0.0, min(a[3], b[3]) - max(a[1], b[1]))
        inter = iw * ih
        union = ((a[2] - a[0]) * (a[3] - a[1]) + (b[2] - b[0]) * (b[3] - b[1])
                 - inter)
        return inter / union if union > 0 else 0.0

    pairs, unmatched = [], 0
    for g_img, w_img in zip(got, want):
        free = list(range(len(g_img)))
        for w in w_img:
            best = max(free, key=lambda i: iou(corners(g_img[i]), corners(w)),
                       default=None)
            if best is None or iou(corners(g_img[best]),
                                   corners(w)) < MATCH_IOU:
                unmatched += 1
                continue
            free.remove(best)
            pairs.append((g_img[best], w))
        unmatched += len(free)
    if not pairs:
        return {"matched": 0, "unmatched": unmatched}
    mesh = np.stack([np.abs(g.mesh.points[:, :2] - w.mesh.points[:, :2])
                     for g, w in pairs])
    iris = np.concatenate([np.abs(g.iris_points[:, :2] - w.iris_points[:, :2])
                           .ravel() for g, w in pairs])
    box = np.asarray([np.abs(corners(g) - corners(w)).max() for g, w in pairs])
    return {"matched": len(pairs), "unmatched": unmatched,
            "box_px_max": float(box.max()), "box_px_mean": float(box.mean()),
            "mesh_px_max": float(mesh.max()), "mesh_px_mean": float(mesh.mean()),
            "faces_mesh_within_1px": int((mesh.max(axis=(1, 2)) <= 1.0).sum()),
            "iris_px_max": float(iris.max()), "iris_px_mean": float(iris.mean()),
            "blendshapes_max": float(max(
                np.abs(g.blendshapes.scores - w.blendshapes.scores).max()
                for g, w in pairs))}


def _tier_batches(label: str, det, frames_np, card: str) -> dict:
    """:data:`TIER_RUNS` steady FULL batches of ``det`` after one warm-up,
    the launch counts set to 0 just before them and read just after (one
    K1 launch a batch, one K2 at each of 192 and 64 px, plus re-runs); ms a
    batch, and one more batch under ``torch.profiler``: device busy ms
    and the convolutions' and matmuls' ms (not measured where the
    profiler kept no record)."""
    import numpy as np
    import torch
    det.detect_faces_batch(frames_np)
    reruns0 = _reruns(det)
    _reset_launches()
    batch_ms, faces = [], None
    for _ in range(TIER_RUNS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        faces = det.detect_faces_batch(frames_np)
        torch.cuda.synchronize()
        batch_ms.append((time.perf_counter() - t0) * 1e3)
    launches = _launches()
    reruns = _reruns(det) - reruns0
    _check_launches(launches, TIER_RUNS, reruns, label)
    per_image = [len(f) for f in faces]
    if min(per_image) < 1:
        raise AssertionError(f"{label}: an image came back with no face")

    def run():
        det.detect_faces_batch(frames_np)
        torch.cuda.synchronize()
    _, device = _profiled(run, lambda name: True, label)
    layers: dict = {}
    for s, e, name in device:
        layers[_layer(name)] = layers.get(_layer(name), 0.0) + (e - s) / 1e3
    busy = _busy_us([(s, e) for s, e, _ in device]) / 1e3 if device else None
    steady = statistics.median(batch_ms)
    print(f"{label} FULL: {TIER_RUNS} batches of {FRAMES} x {HEIGHT}x{WIDTH}:"
          f" ms/batch {['%.2f' % t for t in batch_ms]}, median {steady:.2f} "
          f"ms = {FRAMES * np.mean(per_image) * 1e3 / steady:.1f} faces/s; "
          f"faces per image {per_image}; launches {launches} ({reruns} "
          f"overflow re-runs); profiled batch: device busy {_num(busy, '.3f')}"
          f" ms, convolutions {_num(layers.get('convolutions'), '.3f')} ms, "
          f"matmuls {_num(layers.get('matmuls'), '.3f')} ms  [{card}]")
    return {"faces": faces, "launches": launches, "ms": batch_ms,
            "busy_ms": busy, "conv_ms": layers.get("convolutions"),
            "matmul_ms": layers.get("matmuls")}


def _tiers_phase(models, det_ir, frames, frames_np, card: str) -> dict:
    """Phase 10: FULL through ``FaceDetector(precision=...)`` at "highest"
    and at each of :data:`TIERS` on the main path's networks and frames
    (:func:`_tier_batches`), each tier's faces against "highest"'s
    (:func:`_matched_errors`), K1 and K2 against their plain versions on
    each tier's own inputs (:func:`_check_path_kernels`); the general
    segmenter at ``SegmentationConfig()`` ("high") and at "default"
    against "highest"; MobileFaceNet at "default" against "highest" on the
    FULL path's embedding crops; the int8 detector
    (``random_init.quantized_ir`` of the main path's calibrated detector,
    calibrated on a seeded half of the frames) through FULL, its raw
    outputs on the card against the CPU within one step of each output's
    grid, K1 and K2 held and counted."""
    import numpy as np
    import torch
    from face_detection_tflite_torch import (FaceDetectionMode, FaceDetector,
                                             SegmentationConfig)
    from face_detection_tflite_torch.convert.executor import convert_model
    from face_detection_tflite_torch.models import random_init
    from face_detection_tflite_torch.models.embedding import (
        alignment_from_eyes, build_mobilefacenet)
    from face_detection_tflite_torch.ops import warp as warp_mod
    from face_detection_tflite_torch.ops.letterbox import (letterbox_image,
                                                           letterbox_params)
    from face_detection_tflite_torch.pipeline.programs import (
        PipelineModels, build_pipeline_program)
    dev = frames.device
    out = {"tiers": {}}
    ref = FaceDetector(models=models, device=dev, max_faces=MAX_FACES)
    base = _tier_batches("tier highest", ref, frames_np, card)
    ref_faces = base["faces"]
    ref.dispose()
    post_err = 0.0
    for label, precision in TIERS:
        det = FaceDetector(models=models, device=dev, max_faces=MAX_FACES,
                           precision=precision)
        res = _tier_batches(f"tier {label}", det, frames_np, card)
        res["errors"] = _matched_errors(res["faces"], ref_faces)
        print(f"tier {label} against highest: {res['errors']}  [{card}]")
        if label == "high" and res["errors"].get("mesh_px_max", 1.0) != 0.0:
            raise AssertionError("tier high: faces differ from highest's "
                                 "(it runs the same fp32 ops)")
        post_err = max(post_err, _check_path_kernels(f"tier {label}",
                                                     det.models, frames, card))
        det.dispose()
        del res["faces"]
        out["tiers"][label] = res

    # The general segmenter at its config's default tier and at "default".
    seg_ir = random_init.segmenter_ir("general", SEED + 5)
    seg_models = PipelineModels(
        models.detector, "back", mesh=models.mesh, device=dev,
        iris=models.iris, blendshapes=models.blendshapes,
        segmentation=convert_model(seg_ir, name="segmenter-general-random"))
    masks = {}
    for label, cfg in (("highest", SegmentationConfig.safe()),
                       ("high", SegmentationConfig()),
                       ("default", SegmentationConfig(precision="default"))):
        det = FaceDetector(models=seg_models, device=dev, max_faces=MAX_FACES,
                           segmentation_config=cfg)
        seg = det._segmentation
        seg(frames_np)
        times = []
        for _ in range(TIER_RUNS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            masks[label] = np.stack([m.data for m in seg(frames_np)])
            times.append((time.perf_counter() - t0) * 1e3)
        err = float(np.abs(masks[label] - masks["highest"]).max())
        print(f"segmenter general at SegmentationConfig("
              f"{'' if label == 'high' else repr(cfg.precision)}) "
              f"(tier {cfg.precision}): ms/batch "
              f"{['%.2f' % t for t in times]}, masks' max abs error against "
              f"highest {err:.3g}  [{card}]")
        out[f"segmenter_{label}"] = {"ms": times, "max_abs_err": err}
        det.dispose()
    if out["segmenter_high"]["max_abs_err"] != 0.0:
        raise AssertionError("segmenter at high differs from highest")

    # MobileFaceNet at "default" on the FULL path's embedding crops.
    with torch.inference_mode():
        kp = build_pipeline_program(
            models, HEIGHT, WIDTH, FaceDetectionMode.FULL,
            max_faces=MAX_FACES, min_score=0.5)(frames)["keypoints"]
        ecx, ecy, esize, etheta = alignment_from_eyes(
            kp[..., 0, 0] * WIDTH, kp[..., 0, 1] * HEIGHT,
            kp[..., 1, 0] * WIDTH, kp[..., 1, 1] * HEIGHT)
        crops = warp_mod.warp_normalize(
            frames, ecx.contiguous(), ecy.contiguous(), esize.contiguous(),
            torch.cos(-etheta).contiguous(), torch.sin(-etheta).contiguous(),
            out_size=EMBED_SIZE).reshape(-1, EMBED_SIZE, EMBED_SIZE, 3)
        nets = {p: build_mobilefacenet(SEED + 4, precision=p).to(dev).eval()
                for p in ("highest", "default")}
        emb = {}
        for p, net in nets.items():
            (e,) = net(crops)
            emb[p] = e / e.norm(dim=1, keepdim=True)
            ms, dev_ms, launches, _ = _stage_ms(lambda: net(crops), iters=10)
            out[f"mobilefacenet_{p}"] = {"ms": ms, "device_ms": dev_ms,
                                         "launches": launches}
        cos = (emb["highest"] * emb["default"]).sum(1).min().item()
    out["mobilefacenet_default"]["least_cosine"] = cos
    print(f"MobileFaceNet on {crops.shape[0]} crops: highest "
          f"{out['mobilefacenet_highest']['ms']:.3f} ms event "
          f"({_num(out['mobilefacenet_highest']['device_ms'], '.3f')} ms "
          f"device), default {out['mobilefacenet_default']['ms']:.3f} ms "
          f"event ({_num(out['mobilefacenet_default']['device_ms'], '.3f')} "
          f"ms device); least cosine of default to highest {cos:.6f}  "
          f"[{card}]")
    if not cos > 0.99:
        raise AssertionError("MobileFaceNet at default drifted from highest")

    # The int8 detector through FULL.
    t0 = time.perf_counter()
    qir = random_init.quantized_ir(det_ir, frames, SEED)
    qmodels = PipelineModels(convert_model(qir, name="blazeface-back-int8"),
                             "back", mesh=models.mesh, device=dev,
                             iris=models.iris, blendshapes=models.blendshapes)
    print(f"int8 detector: {len(qir.ops)} ops, quantized and calibrated in "
          f"{time.perf_counter() - t0:.2f} s")
    det = FaceDetector(models=qmodels, device=dev, max_faces=MAX_FACES)
    res = _tier_batches("int8 detector", det, frames_np, card)
    res["errors"] = _matched_errors(res["faces"], ref_faces)
    print(f"int8 detector against highest: {res['errors']}  [{card}]")
    post_err = max(post_err, _check_path_kernels("int8 detector", qmodels,
                                                 frames, card))
    det.dispose()
    # Each graph output's grid: the DEQUANTIZE ops at the end of the graph
    # read the int8 outputs in the graph's output order (boxes, scores).
    steps = [float(qir.tensors[op.inputs[0]].quant["scale"][0])
             for op in qir.ops[-len(qir.outputs):]]
    lbp = letterbox_params(HEIGHT, WIDTH, 256, 256)
    two = torch.from_numpy(frames_np[:2])
    with torch.inference_mode():
        got = qmodels.detector(letterbox_image(two.to(dev), lbp))
        want = convert_model(qir)(letterbox_image(two, lbp))
    errs = [(g.cpu() - w).abs().max().item() for g, w in zip(got, want)]
    print(f"int8 detector card vs CPU (2 frames): raw boxes' and scores' max "
          f"errors {errs}, output grid steps {steps}  [{card}]")
    if any(e > st * (1 + 1e-6) for e, st in zip(errs, steps)):
        raise AssertionError("int8 detector: card and CPU differ by more "
                             "than one output grid step")
    del res["faces"]
    out["int8"] = dict(res, card_vs_cpu=errs, grid_steps=steps)
    out["highest"] = {k: v for k, v in base.items() if k != "faces"}
    out["post_err"] = post_err
    return out


CLI_IMAGES = 2
CLI_VIDEO_FRAMES = 8


def _cli(argv, seeded: dict, out=None):
    """(exit code, stdout, stderr) of ``cli.main(argv)`` in this process,
    with the seeded networks through the command line's seam:
    ``seeded["models"]`` for every detector (the detectors built are
    appended to ``seeded["made"]``) and ``seeded["segmenter"]`` for the
    segmenter.  Standard output goes to ``out`` (a new buffer by
    default) while it runs."""
    import contextlib
    import io
    from face_detection_tflite_torch import cli
    make_det, make_seg = cli._make_detector, cli._make_segmenter

    def detector(args, **extra):
        seeded["made"].append(make_det(args, models=seeded["models"],
                                       **extra))
        return seeded["made"][-1]

    cli._make_detector = detector
    cli._make_segmenter = lambda args: make_seg(
        args, model=seeded["segmenter"])
    out = io.StringIO() if out is None else out
    err = io.StringIO()
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = cli.main(argv)
    finally:
        cli._make_detector, cli._make_segmenter = make_det, make_seg
    return rc, out.getvalue(), err.getvalue()


def _cli_serve(png: str, seeded: dict, extra=(), info: bool = False):
    """``serve --port 0`` (and ``extra`` arguments) on a thread through
    :func:`_cli`, its address read from its announce line; one POST of
    ``png`` to ``/v1/detect?mode=full`` (then, with ``info``, a GET of
    ``/v1/info``); stopped through ``_serve_stop``.  Returns the status
    and the payload (and the info).  Nothing else prints meanwhile
    (standard output is the command's while it runs)."""
    import io
    import re
    import threading
    from face_detection_tflite_torch import cli
    box: dict = {}
    announced = io.StringIO()
    th = threading.Thread(target=lambda: box.update(zip(
        ("rc", "out", "err"),
        _cli(["serve", "--port", "0", *extra], seeded, out=announced))),
        daemon=True)
    th.start()
    deadline = time.time() + 300
    addr = None
    try:
        while addr is None and th.is_alive() and time.time() < deadline:
            m = re.search(r"http://([0-9.]+:\d+)", announced.getvalue())
            addr = m and m.group(1)
            time.sleep(0.05)
        if addr is None:
            raise AssertionError(f"cli serve did not announce: {box}")
        with open(png, "rb") as f:
            status, payload, _, _ = _post(
                f"http://{addr}/v1/detect?mode=full", f.read())
        about = _get(f"http://{addr}/v1/info") if info else None
    finally:
        while cli._serve_stop is None and th.is_alive():
            time.sleep(0.01)
        if cli._serve_stop is not None:
            cli._serve_stop.set()
        th.join(120)
    if th.is_alive() or box.get("rc") != 0:
        raise AssertionError(f"cli serve did not stop cleanly: {box}")
    return (status, payload, about) if info else (status, payload)


def _cli_phase(models, frames_np, video: dict, card: str) -> dict:
    """Phase 11: the command line, in this process (``cli.main``), on the
    main path's full-depth seeded networks through its
    ``_make_detector``/``_make_segmenter`` seam, on the main frames
    written as PNGs (853x1280, under ``--max-dim``'s 1536): ``detect
    --json`` on two images (each line ``Face.to_dict()`` of
    ``detect_faces`` on the same decoded image bit for bit; launch counts
    set to 0 just before it: one K1 and one K2 at 192 and at 64 px an
    image, plus re-runs, and no ``nms_core``; K1 and K2 against their plain versions on each
    image at B = 1), its ms an image; ``detect --annotate`` (the PNG is
    ``render.annotate`` of the API's faces); ``embed --json --allow-untrained`` on the two (similarity and
    distance equal ``compare_faces``/``face_distance`` of
    ``get_face_embedding``; one K2 launch at 112 px an image); ``segment
    --format binary`` (the general segmenter; the mask PNG equal
    ``SelfieSegmentation``'s); ``video --json --max-frames 8`` on phase
    8a's clip with its networks (lines equal phase 8a's first results
    after the One-Euro smoother); ``serve`` (one ``/v1/detect`` answers
    200 with the ``detect`` command's faces); ``info`` (the card);
    ``doctor --json`` (exactly "model assets" FAILs: the ``.tflite``
    files are absent)."""
    import tempfile
    import numpy as np
    import torch
    from PIL import Image
    from face_detection_tflite_torch import (FaceDetectionMode, FaceDetector,
                                             FaceSmoother)
    from face_detection_tflite_torch.convert.executor import convert_model
    from face_detection_tflite_torch.models import random_init
    from face_detection_tflite_torch.models.segmentation import \
        SelfieSegmentation
    from face_detection_tflite_torch.ops import nms as nms_mod
    from face_detection_tflite_torch.utils.render import annotate
    dev = models.device
    seeded = {"models": models, "made": [], "segmenter": convert_model(
        random_init.segmenter_ir("general", SEED + 5),
        name="segmenter-general-random")}
    out: dict = {}
    with tempfile.TemporaryDirectory() as tmp:
        pngs = []
        for i in range(CLI_IMAGES):
            pngs.append(os.path.join(tmp, f"frame{i}.png"))
            Image.fromarray(frames_np[i]).save(pngs[-1])
        images = [np.asarray(Image.open(p).convert("RGB")) for p in pngs]
        annotated = os.path.join(tmp, "annotated.png")

        # detect: a warm-up run, then the counted and timed one; the
        # annotated copy in a run of its own, so that its drawing and PNG
        # encode stay out of the time.
        detect = ["detect", *pngs, "--json"]
        _cli(detect, seeded)
        seeded["made"].clear()
        _reset_launches()
        nms_mod.nms_core.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rc, text, err = _cli(detect, seeded)
        torch.cuda.synchronize()
        cli_ms = (time.perf_counter() - t0) * 1e3 / CLI_IMAGES
        launches = _launches()
        nms_launches = nms_mod.nms_core.launches
        if rc != 0:
            raise AssertionError(f"cli detect exited {rc}: {err}")
        (det,) = seeded["made"]
        reruns = _reruns(det)
        graphs_held = _graphs_held(det)
        _check_launches(launches, CLI_IMAGES, reruns, "cli detect")
        if nms_launches:
            raise AssertionError(f"cli detect launched nms_core "
                                 f"{nms_launches} times; K1 runs fused")
        from face_detection_tflite_torch.utils.image import load_image
        t0 = time.perf_counter()
        for p in pngs:
            load_image(p)
        decode_ms = (time.perf_counter() - t0) * 1e3 / CLI_IMAGES
        api = FaceDetector(models=models, device=dev, max_faces=MAX_FACES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = [api.detect_faces(img) for img in images]
        torch.cuda.synchronize()
        api_ms = (time.perf_counter() - t0) * 1e3 / CLI_IMAGES
        api.dispose()
        lines = [json.loads(line) for line in text.splitlines()]
        for line, path, faces in zip(lines, pngs, want):
            if (line["image"], line["width"], line["height"]) != \
                    (path, WIDTH, HEIGHT):
                raise AssertionError(f"cli detect line header {line}")
            if json.dumps(line["faces"]) != \
                    json.dumps([f.to_dict() for f in faces]):
                raise AssertionError(f"cli detect: {path}'s faces differ "
                                     "from detect_faces's")
        if len(lines) != CLI_IMAGES or not all(want):
            raise AssertionError(f"cli detect gave {len(lines)} lines, "
                                 f"faces {[len(f) for f in want]}")
        rc, _, err = _cli(["detect", pngs[0], "--annotate", annotated],
                          seeded)
        if rc != 0 or not np.array_equal(np.asarray(Image.open(annotated)),
                                         annotate(images[0], want[0])):
            raise AssertionError(f"cli detect --annotate (exit {rc}) differs "
                                 "from render.annotate on the API's faces")
        post_err = max(_check_path_kernels(
            f"cli detect image {i}", models,
            torch.from_numpy(img)[None].to(dev), card)
            for i, img in enumerate(images))
        print(f"cli detect --json (FULL, {CLI_IMAGES} PNGs of "
              f"{WIDTH}x{HEIGHT}): {cli_ms:.2f} ms an image (PNG decode, "
              f"detect, JSON) against detect_faces alone {api_ms:.2f} ms and "
              f"the PNG decode alone {decode_ms:.2f} ms; faces "
              f"{[len(f) for f in want]}, equal bit for bit, --annotate "
              f"equal to render.annotate; launches {launches} ({reruns} "
              f"re-runs); {graphs_held}  [{card}]")
        out.update(detect_launches=launches, nms_launches=nms_launches,
                   graphs=graphs_held,
                   detect_ms=cli_ms, api_ms=api_ms,
                   decode_ms=decode_ms, post_err=post_err)

        # embed
        _reset_launches()
        rc, text, err = _cli(["embed", *pngs, "--json", "--allow-untrained"],
                             seeded)
        embed_launches = _launches()
        if rc != 0:
            raise AssertionError(f"cli embed exited {rc}: {err}")
        got = json.loads(text)
        api = FaceDetector(models=models, device=dev,
                           allow_untrained_embeddings=True)
        embs = [api.get_face_embedding(
            api.detect_faces(img, FaceDetectionMode.STANDARD)[0], img)
            for img in images]
        api.dispose()
        if (got["cosine_similarity"], got["euclidean_distance"]) != (
                float(FaceDetector.compare_faces(*embs)),
                float(FaceDetector.face_distance(*embs))):
            raise AssertionError(f"cli embed {got} differs from the API's")
        if embed_launches["warp_normalize"].get(EMBED_SIZE) != CLI_IMAGES:
            raise AssertionError(f"cli embed launches {embed_launches}")
        print(f"cli embed --json: cosine {got['cosine_similarity']:.6f}, "
              f"distance {got['euclidean_distance']:.6f}, equal to the "
              f"API's; launches {embed_launches}  [{card}]")
        out["embed_launches"] = embed_launches

        # segment
        mask_png = os.path.join(tmp, "mask.png")
        rc, text, err = _cli(["segment", pngs[0], "--format", "binary",
                              "--out", mask_png], seeded)
        if rc != 0:
            raise AssertionError(f"cli segment exited {rc}: {err}")
        seg = SelfieSegmentation(seeded["segmenter"].with_precision("high"),
                                 device=dev)
        want_mask = seg(images[0][None])[0].upsample().to_binary(0.5)
        if not np.array_equal(np.asarray(Image.open(mask_png)), want_mask):
            raise AssertionError("cli segment's mask differs from "
                                 "SelfieSegmentation's")
        print(f"cli segment --format binary: {text.strip()}; equal to "
              f"SelfieSegmentation's  [{card}]")

        # video, on phase 8a's clip and networks
        clip, _ = _write_clip(video["raw"], tmp)
        decoded, _ = _read_clip(clip)
        if not np.array_equal(decoded, video["decoded"]):
            raise AssertionError("the clip rewritten for the CLI decodes "
                                 "to other frames than phase 8a's")
        video_seeded = dict(seeded, models=video["models"])
        rc, text, err = _cli(["video", clip, "--json", "--max-frames",
                              str(CLI_VIDEO_FRAMES)], video_seeded)
        if rc != 0:
            raise AssertionError(f"cli video exited {rc}: {err}")
        smoother = FaceSmoother(alpha=0.5, method="one_euro")
        want_video = [
            {"frame": r.frame_index, "timestamp_s": round(r.timestamp_s, 4),
             "faces": [f.to_dict() for f in smoother.smooth(
                 r.faces, t_sec=r.timestamp_s)]}
            for r in video["results"][:CLI_VIDEO_FRAMES]]
        if text.splitlines() != [json.dumps(w) for w in want_video]:
            raise AssertionError("cli video lines differ from phase 8a's "
                                 "detect_faces_from_video results")
        print(f"cli video --json --max-frames {CLI_VIDEO_FRAMES}: "
              f"{len(want_video)} lines, "
              f"{sum(len(w['faces']) for w in want_video)} faces, equal to "
              f"phase 8a's results after the One-Euro smoother  [{card}]")

        # serve
        status, payload = _cli_serve(pngs[0], seeded)
        if status != 200:
            raise AssertionError(f"cli serve answered {status}: {payload}")
        _check_errors(_payload_errors(payload["faces"], lines[0]["faces"]),
                      SERVER_TOL, "cli serve /v1/detect")
        print(f"cli serve: /v1/detect?mode=full answered 200 with the "
              f"detect command's {len(lines[0]['faces'])} faces  [{card}]")

    # info and doctor
    rc, text, err = _cli(["info"], seeded)
    info = json.loads(text)
    kind = torch.cuda.get_device_name(0)
    if rc != 0 or info["backend"] != "cuda" or \
            not any(kind in d for d in info["devices"]) or \
            not all(v == f"cuda:{kind}" for k, v in
                    info["accelerator_report"].items() if k != "precision"):
        raise AssertionError(f"cli info: {rc} {info}")
    rc, text, err = _cli(["doctor", "--json"], seeded)
    doctor = json.loads(text)
    checks = {c["check"]: c for c in doctor["checks"]}
    failed = {c["check"] for c in doctor["checks"]
              if c["required"] and not c["ok"]}
    if rc != 1 or failed != {"model assets"} or \
            not checks["device backend"]["ok"] or \
            not checks["kernel build"]["ok"]:
        raise AssertionError(f"cli doctor: exit {rc}, {doctor}")
    print(f"cli info: backend cuda, devices {info['devices']}; cli doctor: "
          f"exit 1, FAILED {sorted(failed)} (the .tflite files are not in "
          f"the checkout), device backend: {checks['device backend']['detail']}"
          f"; kernel build: {checks['kernel build']['detail']}  [{card}]")
    return out


REPLICA_BATCHES = 8
REPLICA_DEPTH = 2
DP_FRAMES = 15
DP_RUNS = 3


def _idle_share(device) -> tuple:
    """(busy ms, window ms, idle share) of profiled device activities."""
    window_us = max(e for _, e, _ in device) - min(s for s, _, _ in device)
    busy = _busy_us([(s, e) for s, e, _ in device])
    return busy / 1e3, window_us / 1e3, 1 - busy / window_us


def _replica_phase(models, frames_np, video: dict, card: str) -> dict:
    """Phase 12: scale-out on the FULL cell's networks and frames.

    (a) ``ReplicaPool`` over ``[cuda:0]`` and ``[cuda:0, cuda:0]`` beside
    one ``ServingPipeline``, :data:`REPLICA_BATCHES` FULL batches at depth
    :data:`REPLICA_DEPTH` each, timed in turns (pipeline, one replica, two
    replicas, two, one, pipeline) after a warm-up: ms a batch and
    frames/s; every whole batch's faces equal ``detect_faces_batch``'s on
    the same card bit for bit; the launch counts set to 0 just before the
    first two-replica run and read after it (one K1 and one K2 at 192 and
    at 64 px a batch, plus re-runs); ``stats``; the device's idle share
    of one profiled window of each of the three; K1 and K2 against their
    plain versions on the replicas' own inputs.  (b)
    ``detect_faces_batch_stream(devices=[cuda:0, cuda:0])`` against the
    sequential calls.  (c) ``FaceDetector(data_parallel=True)``: on the
    real device list no mesh with one card, faces equal the plain
    detector's; through the ``visible_devices`` seam a two-shard mesh of
    the card and a batch of :data:`DP_FRAMES` (padded to 16): the same
    face counts, boxes within 1e-5 and scores within 1e-6 (the JAX tests'
    bounds), one K1 launch a shard (counts set to 0 just before the timed
    batches), ms a batch beside the plain detector's, K1 and K2 against
    their plain versions on each shard's own inputs.  (d)
    ``seg_device="auto"`` is None on one card; ``place_on`` of the card
    and the combined batch equal the unpinned one.  (e) ``serve
    --replicas 1`` (one ``/v1/detect``, ``/v1/info``'s replica fields),
    ``video --replicas 1 --max-frames 8`` against phase 8a's results,
    ``--replicas`` above the card count exits 1.  (f) With two cards or
    more, a pool and a mesh over ``cuda:0`` and ``cuda:1``; with one, a
    line saying that the cross-card path was not run."""
    import tempfile
    import numpy as np
    import torch
    from face_detection_tflite_torch import (FaceDetectionMode, FaceDetector,
                                             FaceSmoother, PipelineModels,
                                             ReplicaPool, ServingPipeline)
    from face_detection_tflite_torch.convert.executor import convert_model
    from face_detection_tflite_torch.models import random_init
    from face_detection_tflite_torch.parallel import sharding
    full = FaceDetectionMode.FULL
    dev = models.device
    n_cards = torch.cuda.device_count()
    out: dict = {}
    det = FaceDetector(models=models, device=dev, max_faces=MAX_FACES)
    det.detect_faces_batch(frames_np)                    # the steady slab
    faces0 = det.detect_faces_batch(frames_np)
    want = _payload(faces0)

    # -- (a) the pool beside one pipeline ---------------------------------
    executors = {
        "pipeline": lambda: ServingPipeline(det, full, depth=REPLICA_DEPTH),
        "1 replica": lambda: ReplicaPool(det, devices=[dev], mode=full,
                                         depth=REPLICA_DEPTH),
        "2 replicas": lambda: ReplicaPool(det, devices=[dev, dev],
                                          mode=full, depth=REPLICA_DEPTH)}

    def run(ex, n=REPLICA_BATCHES):
        futs = [ex.submit(frames_np) for _ in range(n)]
        return [f.result(timeout=600) for f in futs]

    made = {name: make() for name, make in executors.items()}
    try:
        for ex in made.values():
            run(ex, 2)                          # allocator blocks, threads
        ms: dict = {name: [] for name in made}
        host: dict = {}
        for name in ("pipeline", "1 replica", "2 replicas", "2 replicas",
                     "1 replica", "pipeline"):
            first = name == "2 replicas" and not ms[name]
            det.timings.reset()
            if first:
                reruns0 = _reruns(det)
                _reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = run(made[name])
            torch.cuda.synchronize()
            ms[name].append((time.perf_counter() - t0) * 1e3
                            / REPLICA_BATCHES)
            # The workers' host ms a batch: queueing the program, and
            # waiting for its readback.
            host.setdefault(name, []).append({
                k.split("[")[0]: round(v, 2)
                for k, v in det.timings.report().items()})
            if first:
                launches = _launches()
                reruns = _reruns(det) - reruns0
            errs = _max_errors((_payload(g), want) for g in got)
            if any(v[0] for v in errs.values()):
                raise AssertionError(f"{name}: a whole batch differs from "
                                     f"detect_faces_batch: {errs}")
        _check_launches(launches, REPLICA_BATCHES, reruns, "2 replicas")
        stats = made["2 replicas"].stats
        # A first session pays the profiler's own start-up: discarded.
        _profiled(lambda: run(made["1 replica"], 2), lambda n: True,
                  "a warm-up window")
        idle = {}
        for name in made:
            _, device = _profiled(lambda: run(made[name], 4),
                                  lambda n: True, f"the {name} window")
            idle[name] = _idle_share(device) if device else None
    finally:
        for ex in made.values():
            ex.close()
    med = {name: statistics.median(t) for name, t in ms.items()}
    for name in made:
        print(f"replica {name} ({REPLICA_BATCHES} FULL batches of {FRAMES}"
              f" x {HEIGHT}x{WIDTH}, depth {REPLICA_DEPTH}): "
              f"{['%.2f' % t for t in ms[name]]} ms a batch, "
              f"{FRAMES * 1e3 / med[name]:.1f} frames/s; idle share of a "
              + ("profiled 4-batch window not measured" if idle[name] is None
                 else "profiled 4-batch window %.3f (busy %.3f of %.3f ms)"
                 % (idle[name][2], idle[name][0], idle[name][1]))
              + f"; worker host ms a batch {host[name]}  [{card}]")
    print(f"replica 2 replicas: every batch equal to detect_faces_batch "
          f"bit for bit; launches {launches} ({reruns} re-runs); stats "
          f"{stats}  [{card}]")
    frames = torch.from_numpy(frames_np).to(dev)
    post_err = _check_path_kernels("replica cuda:0", models, frames, card)
    out.update(replica_ms=med, replica_host_ms=host,
               replica_launches=launches,
               replica_batches=REPLICA_BATCHES, replica_idle=idle,
               replica_stats=stats)

    # -- (b) the stream over two replicas -----------------------------------
    seq = [_payload(det.detect_faces_batch(frames_np)) for _ in range(4)]
    streamed = [_payload(f) for f in det.detect_faces_batch_stream(
        [frames_np] * 4, devices=[dev, dev])]
    errs = _max_errors(zip(streamed, seq))
    _check_errors(errs, SERVE_TOL, "stream over replicas")
    print(f"detect_faces_batch_stream(devices=[{dev}, {dev}]) of 4 FULL "
          f"batches: equal to the sequential calls within {errs}  [{card}]")

    # -- (c) data-parallel ------------------------------------------------
    batch = frames_np[:DP_FRAMES]
    plain = FaceDetector(models=models, device=dev, max_faces=MAX_FACES)
    real = FaceDetector(models=models, device=dev, max_faces=MAX_FACES,
                        data_parallel=True)
    if n_cards == 1:
        if real._mesh is not None:
            raise AssertionError("data_parallel made a mesh on one card")
        errs = _max_errors([(_payload(real.detect_faces_batch(batch)),
                             _payload(plain.detect_faces_batch(batch)))])
        if any(v[0] for v in errs.values()):
            raise AssertionError(f"data_parallel on one card: {errs}")
    visible = sharding.visible_devices
    sharding.visible_devices = lambda kind="cuda": [dev, dev]
    try:
        dp = FaceDetector(models=models, device=dev, max_faces=MAX_FACES,
                          data_parallel=True)
    finally:
        sharding.visible_devices = visible
    pad = dp._batch_pad_target(len(batch))
    if dp._mesh != (dev, dev) or pad % 2 or pad < len(batch):
        raise AssertionError(f"the seam's mesh is {dp._mesh}, a batch of "
                             f"{len(batch)} pads to {pad}")
    dp.detect_faces_batch(batch)
    plain.detect_faces_batch(batch)
    dp_ms, plain_ms = [], []
    for turn in ("dp", "plain", "plain", "dp"):
        if turn == "dp" and not dp_ms:
            reruns0 = _reruns(dp)
            _reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        faces = [(dp if turn == "dp" else plain).detect_faces_batch(batch)
                 for _ in range(DP_RUNS)]
        torch.cuda.synchronize()
        (dp_ms if turn == "dp" else plain_ms).append(
            (time.perf_counter() - t0) * 1e3 / DP_RUNS)
        if turn == "dp" and len(dp_ms) == 1:
            dp_launches = _launches()
            dp_reruns = _reruns(dp) - reruns0
            got = faces[-1]
        elif turn == "plain" and len(plain_ms) == 1:
            ref = faces[-1]
    want_dp = {"detection_postprocess": 2 * DP_RUNS,
               "warp_normalize": {MESH_SIZE: 2 * (DP_RUNS + dp_reruns),
                                  IRIS_SIZE: 2 * (DP_RUNS + dp_reruns)}}
    if {k: dp_launches[k] for k in want_dp} != want_dp:
        raise AssertionError(f"data_parallel launches {dp_launches}, want "
                             f"{want_dp}")
    if [len(f) for f in got] != [len(f) for f in ref]:
        raise AssertionError("data_parallel face counts differ")
    box_err = max((np.abs(np.subtract(
        [g.bounding_box.xmin, g.bounding_box.ymin, g.bounding_box.xmax,
         g.bounding_box.ymax],
        [r.bounding_box.xmin, r.bounding_box.ymin, r.bounding_box.xmax,
         r.bounding_box.ymax])).max()
        for gi, ri in zip(got, ref) for g, r in zip(gi, ri)), default=0.0)
    score_err = max((abs(g.score - r.score) for gi, ri in zip(got, ref)
                     for g, r in zip(gi, ri)), default=0.0)
    if box_err > 1e-5 or score_err > 1e-6:
        raise AssertionError(f"data_parallel: boxes {box_err}, scores "
                             f"{score_err} from the plain detector's")
    with torch.inference_mode():
        images = dp._prepare_batch(batch)[0]
        for i, shard in enumerate(sharding.shard_batch(images, dp._mesh)):
            post_err = max(post_err, _check_path_kernels(
                f"data-parallel shard {i}", models, shard, card))
    print(f"data_parallel over ({dev}, {dev}) through the seam, a batch of "
          f"{len(batch)} padded to {pad}: {['%.2f' % t for t in dp_ms]} ms a "
          f"batch against the plain detector's "
          f"{['%.2f' % t for t in plain_ms]}; faces {sum(map(len, got))}, "
          f"counts equal, boxes within {box_err:.3g}, scores within "
          f"{score_err:.3g}; launches {dp_launches} ({dp_reruns} re-runs) "
          f"over {DP_RUNS} batches; on the real device list "
          f"mesh={real._mesh}  [{card}]")
    out.update(dp_launches=dp_launches, dp_batches=DP_RUNS,
               dp_shards=2 * DP_RUNS, dp_ms=statistics.median(dp_ms),
               dp_plain_ms=statistics.median(plain_ms))
    for d in (dp, plain, real):
        d.dispose()

    # -- (d) the segmenter's device -----------------------------------------
    seg_models = PipelineModels(
        models.detector, models.variant, mesh=models.mesh, device=dev,
        iris=models.iris, blendshapes=models.blendshapes,
        segmentation=convert_model(random_init.segmenter_ir(
            "general", SEED + 5), name="segmenter-general-random"))
    auto = FaceDetector(models=seg_models, device=dev, max_faces=MAX_FACES,
                        with_segmentation=True, seg_device="auto")
    pinned = FaceDetector(models=seg_models, device=dev, max_faces=MAX_FACES,
                          with_segmentation=True)
    want_seg = (None if n_cards == 1 else torch.device("cuda", 1))
    if auto._seg_device != want_seg:
        raise AssertionError(f"seg_device='auto' is {auto._seg_device} on "
                             f"{n_cards} card(s)")
    pinned._segmentation.place_on(str(dev))
    got = pinned.detect_faces_with_segmentation_batch(frames_np[:4])
    base = FaceDetector(models=seg_models, device=dev, max_faces=MAX_FACES,
                        with_segmentation=True)
    ref = base.detect_faces_with_segmentation_batch(frames_np[:4])
    errs = _max_errors(([_payload([g[0]])], [_payload([r[0]])])
                       for g, r in zip(got, ref))
    if any(v[0] for v in errs.values()) or not all(
            np.array_equal(g[1].data, r[1].data) for g, r in zip(got, ref)):
        raise AssertionError(f"place_on({dev}): the combined batch differs "
                             f"from the unpinned one: {errs}")
    print(f"seg_device='auto' on {n_cards} card(s): {auto._seg_device}; "
          f"place_on({dev}) then detect_faces_with_segmentation_batch: "
          f"faces and masks equal to the unpinned call  [{card}]")
    for d in (auto, pinned, base):
        d.dispose()

    # -- (e) the command line -------------------------------------------
    seeded = {"models": models, "made": []}
    with tempfile.TemporaryDirectory() as tmp:
        png = os.path.join(tmp, "frame0.png")
        from PIL import Image
        Image.fromarray(frames_np[0]).save(png)
        status, payload, info = _cli_serve(png, seeded,
                                           ("--replicas", "1"), info=True)
        if status != 200 or not payload["faces"]:
            raise AssertionError(f"serve --replicas 1 answered {status}")
        _check_errors(_payload_errors(payload["faces"], json.loads(
            json.dumps([f.to_dict() for f in faces0[0]]))),
                      SERVER_TOL, "serve --replicas 1 /v1/detect")
        stats = info["replica_stats"]
        if info["replica_devices"] != [str(dev)] or \
                sum(s["accepted"] for v in stats.values() for s in v) != 1:
            raise AssertionError(f"serve --replicas 1 /v1/info: {info}")
        clip, _ = _write_clip(video["raw"], tmp)
        rc, text, err = _cli(["video", clip, "--json", "--max-frames",
                              str(CLI_VIDEO_FRAMES), "--replicas", "1"],
                             dict(seeded, models=video["models"]))
        if rc != 0:
            raise AssertionError(f"video --replicas 1 exited {rc}: {err}")
        smoother = FaceSmoother(alpha=0.5, method="one_euro")
        want_video = [
            {"frame": r.frame_index, "timestamp_s": round(r.timestamp_s, 4),
             "faces": [f.to_dict() for f in smoother.smooth(
                 r.faces, t_sec=r.timestamp_s)]}
            for r in video["results"][:CLI_VIDEO_FRAMES]]
        if text.splitlines() != [json.dumps(w) for w in want_video]:
            raise AssertionError("video --replicas 1 lines differ from "
                                 "phase 8a's results")
        too_many = str(n_cards + 1)
        rc, _, err = _cli(["video", clip, "--json", "--replicas", too_many],
                          seeded)
        if rc != 1 or "out of range" not in err:
            raise AssertionError(f"video --replicas {too_many}: exit {rc}, "
                                 f"{err!r}")
    print(f"cli serve --replicas 1: /v1/detect 200 with "
          f"{len(payload['faces'])} faces, /v1/info replica_devices "
          f"{info['replica_devices']}, replica_stats {stats}; cli video "
          f"--replicas 1 --max-frames {CLI_VIDEO_FRAMES}: equal to phase "
          f"8a's results after the One-Euro smoother; --replicas "
          f"{too_many} exits 1 ({err.strip()})  [{card}]")

    # -- (f) across cards ------------------------------------------------
    if n_cards < 2:
        print(f"cross-card path not run: {n_cards} card visible (a pool and "
              "a mesh over cuda:0 and cuda:1 need two)")
    else:
        pair = [torch.device("cuda", 0), torch.device("cuda", 1)]
        with ReplicaPool(det, devices=pair, mode=full) as pool:
            got = pool.map_batches([frames_np] * 4)
        errs = _max_errors((_payload(g), want) for g in got)
        _check_errors(errs, SERVE_TOL, "pool over cuda:0 and cuda:1")
        post_err = max(post_err, _check_path_kernels(
            "replica cuda:1", det._replica_params(pair[1]),
            frames.to(pair[1]), card))
        sharding.visible_devices = lambda kind="cuda": pair
        try:
            cross = FaceDetector(models=models, device=dev,
                                 max_faces=MAX_FACES, data_parallel=True)
        finally:
            sharding.visible_devices = visible
        got = cross.detect_faces_batch(batch)
        plain = FaceDetector(models=models, device=dev, max_faces=MAX_FACES)
        if [len(f) for f in got] != \
                [len(f) for f in plain.detect_faces_batch(batch)]:
            raise AssertionError("mesh over cuda:0 and cuda:1: counts differ")
        print(f"cross-card: a pool over {pair} equal to detect_faces_batch "
              f"within {errs}; a mesh over them, face counts equal  "
              f"[{card}]")
        cross.dispose()
        plain.dispose()
    det.dispose()
    out["post_err"] = post_err
    return out


def _tier_launches(tiers: dict, kernel: str, size=None) -> dict:
    """A kernel's launches over phase 10's batches at each tier and on the
    int8 detector (K2's at crop size ``size``)."""
    def count(res):
        n = res["launches"][kernel]
        return n.get(size, 0) if size is not None else n
    return {"tier_launches": {label: count(res) for label, res in
                              [("highest", tiers["highest"]),
                               *tiers["tiers"].items()]},
            "int8_launches": count(tiers["int8"]),
            "tier_batches": TIER_RUNS}


# -- phase 14: the captured programs ------------------------------------------

#: Phase 14: batches timed a turn (replayed, eager, eager, replayed), the
#: B = 1 calls timed a turn, and the calls of each concurrency check.
GRAPH_RUNS = 5
GRAPH_CALLS = 10
GRAPH_THREAD_CALLS = 4


def _program_diff(got, want) -> float:
    """Largest absolute difference of two programs' outputs (a dict of
    tensors each); raises where a key, a shape, a dtype, a NaN position or
    a boolean or integer output differs."""
    import torch
    if set(got) != set(want):
        raise AssertionError(f"outputs differ in keys: {sorted(got)} "
                             f"against {sorted(want)}")
    worst = 0.0
    for k in want:
        g, w = got[k], want[k]
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"{k}: {tuple(g.shape)} {g.dtype} against "
                                 f"{tuple(w.shape)} {w.dtype}")
        if not w.dtype.is_floating_point:
            if not torch.equal(g, w):
                raise AssertionError(f"{k} differs")
            continue
        if not torch.equal(torch.isnan(g), torch.isnan(w)):
            raise AssertionError(f"{k}: NaNs in other places")
        ok = ~torch.isnan(w)
        if ok.any():
            worst = max(worst, (g[ok] - w[ok]).abs().max().item())
    return worst


#: The speculative program's detections, kept on the card for the
#: overflow re-run (its det_count goes into the packed readback).
DET_SLAB = ("det_boxes", "det_raw_keypoints", "det_scores", "det_valid")


def _det_slab(out) -> dict:
    return {k: out[k] for k in DET_SLAB}


def _eager_fetch_async(out, scale, rows=None):
    """The readback as the detector started it before it was packed inside
    each program: the raw outputs' rows (but the det_* slab) packed op by
    op (``pack_readback``) and their copy to pinned memory started; a
    handle for ``readback.fetch_finish``."""
    from face_detection_tflite_torch.pipeline.readback import pack_readback
    from face_detection_tflite_torch.pipeline.upload import download_async
    buf, layout = pack_readback({k: v[:rows] for k, v in out.items()
                                 if k not in DET_SLAB}, scale)
    host, event = download_async(buf)
    return host, event, layout


def _eager_readback(out, scale, rows=None) -> dict:
    """:func:`_eager_fetch_async`'s arrays."""
    from face_detection_tflite_torch.pipeline.readback import fetch_finish
    return fetch_finish(_eager_fetch_async(out, scale, rows))


def _readback_diff(got: dict, want: dict) -> float:
    """Largest absolute difference of two readbacks (dicts of host
    arrays); raises where a key, a shape, a dtype, a NaN position or a
    boolean or integer array differs."""
    import numpy as np
    if set(got) != set(want):
        raise AssertionError(f"readbacks differ in keys: {sorted(got)} "
                             f"against {sorted(want)}")
    worst = 0.0
    for k in want:
        g, w = got[k], want[k]
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"{k}: {g.shape} {g.dtype} against "
                                 f"{w.shape} {w.dtype}")
        if not np.issubdtype(w.dtype, np.floating):
            if not np.array_equal(g, w):
                raise AssertionError(f"{k} differs")
            continue
        if not np.array_equal(np.isnan(g), np.isnan(w)):
            raise AssertionError(f"{k}: NaNs in other places")
        ok = ~np.isnan(w)
        if ok.any():
            worst = max(worst, float(np.abs(g[ok] - w[ok]).max()))
    return worst


def _host_ops(fn) -> dict:
    """The PyTorch operators ``fn()`` runs, by name, views and
    allocations left out: what the host launches on the card for it (a
    replay itself is no operator).  An operator that may return a view
    (``to``) counts where its result has memory of its own."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    def storages(tree):
        return {t.untyped_storage().data_ptr() for t in tree_leaves(tree)
                if isinstance(t, torch.Tensor)}

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = collections.Counter()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            name = func.overloadpacket.__name__
            if name.startswith("empty"):
                return out
            if not getattr(func, "is_view", False) or \
                    storages(out) - storages((args, kwargs)):
                self.ops[name] += 1
            return out

    with torch.inference_mode(), Count() as count:
        fn()
    return dict(count.ops)


def _graph_state(programs) -> tuple:
    """(keys captured, counted calls of the keys not captured yet) over
    the captured programs ``programs()`` returns."""
    progs = list(programs())
    return (sum(len(p.keys()) for p in progs),
            sum(sum(p.pending().values()) for p in progs))


def _in_turns(calls: int, call, programs, finish=None) -> dict:
    """Median ms of ``calls`` calls a turn, replayed and (inside
    ``graphs.eager``) eager, in turns (replayed, eager, eager, replayed),
    each after a synchronise: ``call()`` to the end of its device work,
    or with ``finish``, only the host's time to queue ``call()``, whose
    result ``finish`` then waits for, untimed.  Each replayed turn must
    find every key it calls captured: over it, neither the captured keys
    of ``programs()`` nor the counted calls of their keys not captured yet
    change."""
    import torch
    from face_detection_tflite_torch.pipeline import graphs
    ms: dict = {"replayed": [], "eager": []}
    for how in ("replayed", "eager", "eager", "replayed"):
        ctx = graphs.eager() if how == "eager" else contextlib.nullcontext()
        before = _graph_state(programs)
        with ctx:
            for _ in range(calls):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = call()
                if finish is None:
                    torch.cuda.synchronize()
                ms[how].append((time.perf_counter() - t0) * 1e3)
                if finish is not None:
                    finish(out)
        after = _graph_state(programs)
        if how == "replayed" and (after != before or not after[0]):
            raise AssertionError(f"a replayed turn met a key not captured: "
                                 f"(captured keys, calls of the others) "
                                 f"{before} -> {after}")
    return {how: statistics.median(v) for how, v in ms.items()}


def _graph_keys(det) -> list:
    """(name, program) of each of ``det``'s programs: its mode and face
    slab, or "stage" for the overflow re-run's."""
    return [(f"{key[2].name} " + ("stage" if key[3] == "stage" else
                                  f"slab {key[3] or MAX_FACES}"), prog)
            for key, prog in det._programs.items()]


def _capture_split(label: str, programs, card: str) -> list:
    """Prints each captured key's capture by part (``capture_s`` and
    ``capture_parts`` of ``pipeline/graphs.py``) of the (name, program)
    pairs ``programs`` and returns them: host ms of the pool's adopt (and
    whether it renewed the pool), the program's run under capture,
    ``capture_end`` and the key's first replay, and the MiB the card's
    reservations grew by."""
    out = []
    for name, prog in programs:
        for sig, total in prog.capture_s.items():
            parts = prog.capture_parts[sig]
            row = {"program": name,
                   "inputs": [list(shape) for shape, _ in sig],
                   "capture_ms": total * 1e3,
                   **{k[:-2] + "_ms": v * 1e3 for k, v in parts.items()
                      if k.endswith("_s")},
                   "renewed": parts["renewed"],
                   "pool_mib": parts["pool_bytes"] / 2**20}
            out.append(row)
            first = ("not yet" if "replay_ms" not in row
                     else f"{row['replay_ms']:.1f} ms")
            print(f"graphs {label} capture split, {name} inputs "
                  f"{tuple(tuple(i) for i in row['inputs'])}: "
                  f"{row['capture_ms']:.1f} ms = adopt "
                  f"{row['adopt_ms']:.1f}"
                  f"{' (a new pool)' if row['renewed'] else ''} + run "
                  f"{row['run_ms']:.1f} + capture_end {row['end_ms']:.1f} "
                  f"(+ the static clone); first replay {first}; the card's "
                  f"reservations +{row['pool_mib']:.1f} MiB  [{card}]")
    return out


def _graph_profile(call, runs: int, card: str, label: str):
    """Busy ms a batch, window ms and idle share of ``runs`` batches
    (``call()`` each) in a plain ``torch.profiler`` window, replayed and
    (inside ``graphs.eager``) eager, and the device activities a batch;
    where the profiler kept no device record, the busy time is CUDA
    events around the calls queued back to back (:func:`_queued_ms`) and
    the idle share is not measured."""
    import torch
    from face_detection_tflite_torch.pipeline import graphs
    out = {}
    for how in ("replayed", "eager"):
        def run():
            for _ in range(runs):
                call()
            torch.cuda.synchronize()
        ctx = graphs.eager() if how == "eager" else contextlib.nullcontext()
        with ctx:
            run()
            _, device = _profiled(run, lambda name: True,
                                  f"phase 14 {label} {how}")
            if not device:
                ms = _queued_ms(call, iters=runs)
                print(f"graphs {label} {how}: the profiler kept no device "
                      f"record; CUDA events around {runs} queued batches: "
                      f"{_num(ms, '.3f')} ms a batch; idle share not "
                      f"measured  [{card}]")
                out[how] = {"by": "queued events", "ms": ms}
                continue
        busy, window, idle = _idle_share(device)
        kernels = sum(1 for _, _, n in device if "Memcpy" not in n
                      and "Memset" not in n)
        out[how] = {"by": "profiler", "busy_ms": busy / runs,
                    "window_ms": window, "idle_share": idle,
                    "activities": len(device) / runs,
                    "kernels": kernels / runs}
        print(f"graphs {label} {how}: {runs} batches in a plain "
              f"torch.profiler window: device busy {busy / runs:.3f} ms a "
              f"batch, window {window:.3f} ms, idle share {idle:.3f}, "
              f"{kernels / runs:.1f} kernels and {len(device) / runs:.1f} "
              f"device activities a batch  [{card}]")
    return out


def _graph_cell(label: str, models, frames, frames_np, mode, embed: bool,
                card: str) -> dict:
    """Phase 14 on one B = 16 cell: the captured detector's first calls
    under ``graphs.capture_now`` (each key captured on its first call) and
    each key's capture by part, its replays against the eager program of
    ``build_pipeline_program`` (the steady key, the speculative 2-face key
    and a forced overflow re-run of the face stages at 16 faces) and its
    faces against the same detector's eager calls, launches over replayed
    batches, ms a batch replayed and eager in turns, the host's ms to
    queue a batch, pool bytes and a profiled window of each."""
    import torch
    from face_detection_tflite_torch import FaceDetector
    from face_detection_tflite_torch.pipeline import graphs
    from face_detection_tflite_torch.pipeline.programs import \
        build_pipeline_program
    from face_detection_tflite_torch.pipeline.readback import fetch
    det = FaceDetector(models=models, device=frames.device,
                       max_faces=MAX_FACES, embed_in_full=embed,
                       allow_untrained_embeddings=True)
    first_ms = []
    with graphs.capture_now():
        for _ in range(2):  # slab 1 and its overflow re-run, then slab 16
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            det.detect_faces_batch(frames_np, mode)
            torch.cuda.synchronize()
            first_ms.append((time.perf_counter() - t0) * 1e3)
    print(f"graphs {label}: first two batches {['%.2f' % t for t in first_ms]}"
          f" ms (under capture_now: eager first calls and captures)  "
          f"[{card}]")

    # Launches and faces over replayed batches.
    reruns0 = _reruns(det)
    _reset_launches()
    faces = [det.detect_faces_batch(frames_np, mode)
             for _ in range(GRAPH_RUNS)]
    launches, reruns = _launches(), _reruns(det) - reruns0
    sizes = (MESH_SIZE,) + ((IRIS_SIZE,) if mode.name == "FULL" else ()) + \
        ((EMBED_SIZE,) if embed else ())
    want = {"detection_postprocess": GRAPH_RUNS,
            "warp_normalize": {s: GRAPH_RUNS + reruns for s in sizes},
            **_k5_want(models, GRAPH_RUNS, reruns, mode.name == "FULL",
                       embed)}
    if {k: launches[k] for k in want} != want:
        raise AssertionError(f"graphs {label}: launches {launches} over "
                             f"{GRAPH_RUNS} replayed batches, want {want}")
    with graphs.eager():
        eager_faces = det.detect_faces_batch(frames_np, mode)
    if json.dumps(_payload(faces[-1])) != json.dumps(_payload(eager_faces)):
        raise AssertionError(f"graphs {label}: replayed faces differ from "
                             f"the eager program's")

    # Program outputs against build_pipeline_program's eager program: the
    # readback (packed in the replay) against the eager outputs packed op
    # by op, and the det_* slab the replay keeps on the card.
    kw = {"max_faces": MAX_FACES, "min_score": det.min_score,
          "with_embeddings": embed}
    scale = det._readback_scale(HEIGHT, WIDTH)
    diffs = {}
    with torch.inference_mode():
        steady = det._program(HEIGHT, WIDTH, mode, face_slab=MAX_FACES)
        diffs["steady"] = _readback_diff(
            fetch(steady(frames)), _eager_readback(
                build_pipeline_program(models, HEIGHT, WIDTH, mode, **kw)(
                    frames), scale))
        spec = det._program(HEIGHT, WIDTH, mode, face_slab=2)
        with graphs.capture_now():
            spec(frames)                           # eager, then captured
        got = spec(frames)
        want = build_pipeline_program(models, HEIGHT, WIDTH, mode,
                                      face_slab=2, **kw)(frames)
        readback = fetch(got)
        diffs["slab 2"] = max(
            _readback_diff(readback, _eager_readback(want, scale)),
            _program_diff(_det_slab(got), _det_slab(want)))
        if not (readback["det_count"] > 2).any():
            raise AssertionError(f"graphs {label}: no frame overflows a "
                                 f"2-face slab")
        prefix = [got[k][:, :MAX_FACES] for k in DET_SLAB]
        # Captured by the first batch's re-run at 16 faces.
        stage = det._face_stage_program(HEIGHT, WIDTH, mode)
        diffs["overflow re-run"] = _readback_diff(
            fetch(stage(frames, *prefix)), _eager_readback(
                build_pipeline_program(
                    models, HEIGHT, WIDTH, mode, from_detections=True,
                    with_embeddings=embed)(frames, *prefix), scale))
    print(f"graphs {label}: replayed outputs against build_pipeline_program's"
          f" eager program (the readback against its outputs packed op by "
          f"op), largest difference: {diffs}; faces equal the eager calls' "
          f"bit for bit; launches {launches} over {GRAPH_RUNS} replayed "
          f"batches ({reruns} re-runs)  [{card}]")
    if any(diffs.values()):
        raise AssertionError(f"graphs {label}: a replay differs from the "
                             f"eager program: {diffs}")

    split = _capture_split(label, _graph_keys(det), card)

    # ms a batch in turns, and the host's time to queue one.
    def progs():
        return det._programs.captured()
    med = _in_turns(GRAPH_RUNS,
                    lambda: det.detect_faces_batch(frames_np, mode), progs)
    qmed = _in_turns(GRAPH_RUNS, lambda: det._stream_dispatch(frames, mode),
                     progs, lambda handle: det._stream_finish(handle, mode))
    report = det.memory_report()
    n_faces = sum(len(f) for f in faces[-1])
    print(f"graphs {label}: ms a batch of {FRAMES} x {HEIGHT}x{WIDTH} "
          f"(pinned upload included), median of {2 * GRAPH_RUNS} in turns: "
          f"replayed {med['replayed']:.2f} "
          f"({n_faces * 1e3 / med['replayed']:.1f} faces/s), eager "
          f"{med['eager']:.2f}; host ms to queue a batch already on the card "
          f"(no synchronise): replayed {qmed['replayed']:.3f}, eager "
          f"{qmed['eager']:.3f}; {report['compiled_programs']} graphs, in "
          f"the card's graph pool of "
          f"{report['graph_pool_bytes'] / 2**20:.1f} MiB (shared by the "
          f"process's live captured programs)  [{card}]")
    if report["graph_pool_bytes"] <= 0:
        raise AssertionError(f"graphs {label}: the graph pool holds no "
                             f"device memory")
    prof = _graph_profile(lambda: det.detect_faces_batch(frames_np, mode),
                          3, card, label)
    det.dispose()
    return {"first_ms": first_ms,
            "capture_ms": [k["capture_ms"] for k in split],
            "capture_split": split,
            "diffs": diffs, "ms": med, "queue_ms": qmed,
            "pool_bytes": report["graph_pool_bytes"],
            "graphs": report["compiled_programs"], "launches": launches,
            "profile": prof, "faces": n_faces}


#: The schedule check's replayed calls after its capturing call.
SCHEDULE_EXTRA = 3


def _graph_schedule(models, frames, card: str) -> dict:
    """Phase 14's capture schedule on a fresh FULL detector's steady key at
    B = 16, called ``graphs.CAPTURE_AT_CALL + SCHEDULE_EXTRA`` times on
    the frames already on the card: calls 1 to N - 1 eager (no graph, the
    key pending), call N captures once (its result the first replay's),
    later calls replay; every call's outputs against
    ``build_pipeline_program``'s eager program bit for bit (the readback
    against its outputs packed op by op); one K1 and one K2 at each site
    a call; ms a call from CUDA events and the host's ms a call."""
    import torch
    from face_detection_tflite_torch import FaceDetectionMode, FaceDetector
    from face_detection_tflite_torch.pipeline import graphs
    from face_detection_tflite_torch.pipeline.programs import \
        build_pipeline_program
    from face_detection_tflite_torch.pipeline.readback import fetch
    mode = FaceDetectionMode.FULL
    n = graphs.CAPTURE_AT_CALL
    det = FaceDetector(models=models, device=frames.device,
                       max_faces=MAX_FACES)
    prog = det._program(HEIGHT, WIDTH, mode, face_slab=MAX_FACES)
    with torch.inference_mode():
        want = build_pipeline_program(models, HEIGHT, WIDTH, mode,
                                      max_faces=MAX_FACES,
                                      min_score=det.min_score)(frames)
    want_rb = _eager_readback(want, det._readback_scale(HEIGHT, WIDTH))
    calls = []
    _reset_launches()
    for call in range(1, n + SCHEDULE_EXTRA + 1):
        how = "eager" if call < n else "capture" if call == n else "replay"
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        with torch.inference_mode():
            out = prog(frames)
        end.record()
        host_ms = (time.perf_counter() - t0) * 1e3
        end.synchronize()
        state = (len(prog.keys()), len(prog.pending()))
        if state != ((0, 1) if how == "eager" else (1, 0)):
            raise AssertionError(f"graphs schedule: call {call} ({how}) "
                                 f"left (captured, pending) {state}")
        diff = _readback_diff(fetch(out), want_rb)
        if diff != 0:
            raise AssertionError(f"graphs schedule: call {call} ({how}) "
                                 f"differs from the eager program by {diff}")
        calls.append({"call": call, "how": how,
                      "ms": start.elapsed_time(end), "host_ms": host_ms})
    launches = _launches()
    k = len(calls)
    want = {"detection_postprocess": k,
            "warp_normalize": {MESH_SIZE: k, IRIS_SIZE: k},
            **_k5_want(models, k, 0, True, False)}
    if {key: launches[key] for key in want} != want:
        raise AssertionError(f"graphs schedule: launches {launches} over "
                             f"{k} calls")
    split = _capture_split("schedule FULL", [("slab 16", prog)], card)
    print(f"graphs schedule (FULL, fresh detector, {FRAMES} x "
          f"{HEIGHT}x{WIDTH} on the card, CAPTURE_AT_CALL = {n}): "
          + "; ".join(f"call {c['call']} {c['how']} {c['ms']:.2f} ms "
                      f"(host {c['host_ms']:.2f})" for c in calls)
          + f" (CUDA events); each equal to the eager program bit for bit;"
          f" launches {launches} over {k} calls  [{card}]")
    det.dispose()
    return {"capture_at_call": n, "calls": calls, "capture_split": split,
            "launches": launches}


def _graph_b1(models, frames, frames_np, card: str) -> dict:
    """Phase 14 at B = 1: ``detect_faces`` and
    ``detect_faces_from_camera_frame`` (an RGBA frame of the same image)
    on a FULL detector: replayed faces against the eager calls', one K1
    and one K2 at each site a replayed call, ms a call replayed and eager
    in turns, and K1 and K2 against their plain versions on the frame."""
    from face_detection_tflite_torch import FaceDetector
    from face_detection_tflite_torch.pipeline import graphs
    from face_detection_tflite_torch.utils.camera import \
        camera_frame_from_image
    det = FaceDetector(models=models, device=frames.device,
                       max_faces=MAX_FACES)
    frame = frames_np[0]
    cam = camera_frame_from_image(frame)
    out = {}
    for label, call in (
            ("detect_faces", lambda: det.detect_faces(frame)),
            ("detect_faces_from_camera_frame",
             lambda: det.detect_faces_from_camera_frame(cam))):
        with graphs.capture_now():  # the 1-face slab, its re-run, slab 16
            for _ in range(3):
                call()
        reruns0 = _reruns(det)
        _reset_launches()
        got = [call() for _ in range(GRAPH_CALLS)]
        launches = _launches()
        _check_launches(launches, GRAPH_CALLS, _reruns(det) - reruns0,
                        f"graphs {label}")
        with graphs.eager():
            want = call()
        if json.dumps(_payload([got[-1]])) != json.dumps(_payload([want])):
            raise AssertionError(f"graphs {label}: replayed faces differ "
                                 f"from the eager call's")
        med = _in_turns(GRAPH_CALLS, call, det._programs.captured)
        print(f"graphs {label} (B = 1, {WIDTH}x{HEIGHT}, FULL): ms a call, "
              f"median of {2 * GRAPH_CALLS} in turns: replayed "
              f"{med['replayed']:.2f}, eager {med['eager']:.2f}; "
              f"{len(want)} faces equal the eager call's bit for bit; "
              f"launches {launches} over {GRAPH_CALLS} replayed calls  "
              f"[{card}]")
        out[label] = {"ms": med, "launches": launches}
    out["capture_split"] = _capture_split("B = 1", _graph_keys(det), card)
    det.dispose()
    out["post_err"] = _check_path_kernels("phase 14 B = 1", models,
                                          frames[:1], card)
    return out


def _graph_standalone(models, frames, frames_np, card: str) -> dict:
    """Phase 14's standalone ``FaceDetection`` at B = 1: one program per
    image size, replayed; its detections against the eager program's bit
    for bit, one K1 launch a call, ms a call replayed and eager in
    turns."""
    from face_detection_tflite_torch.models.standalone import FaceDetection
    from face_detection_tflite_torch.ops import detections
    from face_detection_tflite_torch.pipeline import graphs
    from face_detection_tflite_torch.pipeline.config import \
        FaceDetectionModel
    fd = FaceDetection(FaceDetectionModel.BACK_CAMERA, model=models.detector,
                       max_detections=MAX_FACES, device=frames.device)
    frame = frames_np[0]
    with graphs.capture_now():
        for _ in range(3):
            fd(frame)
    detections.detection_postprocess.launches = 0
    got = [fd(frame) for _ in range(GRAPH_CALLS)]
    launches = detections.detection_postprocess.launches
    with graphs.eager():
        want = fd(frame)
    same = [(d.bounding_box, d.score, d.keypoints_xy.tolist()) for d in want]
    if [(d.bounding_box, d.score, d.keypoints_xy.tolist())
            for d in got[-1]] != same or launches != GRAPH_CALLS:
        raise AssertionError(f"graphs FaceDetection: replayed detections "
                             f"differ from the eager program's, or "
                             f"{launches} K1 launches over {GRAPH_CALLS} "
                             f"calls")
    (prog,) = fd._programs.captured()
    med = _in_turns(GRAPH_CALLS, lambda: fd(frame), lambda: [prog])
    capture_ms = [s * 1e3 for s in prog.capture_s.values()]
    split = _capture_split("FaceDetection", [("size", prog)], card)
    pool = graphs.pool_for(fd.device).nbytes()
    print(f"graphs FaceDetection (B = 1, {WIDTH}x{HEIGHT}): ms a call, "
          f"median of {2 * GRAPH_CALLS} in turns: replayed "
          f"{med['replayed']:.3f}, eager {med['eager']:.3f}; {len(want)} "
          f"detections equal the eager program's bit for bit; "
          f"{launches} K1 launches over {GRAPH_CALLS} calls; capture "
          f"{['%.1f' % c for c in capture_ms]} ms; the card's graph pool "
          f"{pool / 2**20:.1f} MiB  [{card}]")
    fd.dispose()
    return {"ms": med, "launches": launches, "calls": GRAPH_CALLS,
            "capture_ms": capture_ms, "capture_split": split,
            "pool_bytes": pool}


def _graph_concurrency(models, frames_np, card: str) -> None:
    """Phase 14's concurrency checks on one FULL key: two threads calling
    one detector at once, and a depth-2 stream with every batch's face
    stages re-run on its ``det_*`` slab after the next batch's replay,
    each against the same batches' sequential calls (eager for the
    stream), faces bit for bit."""
    import threading

    import numpy as np
    import torch
    from face_detection_tflite_torch import FaceDetector
    from face_detection_tflite_torch.pipeline import graphs
    a = frames_np
    b = np.ascontiguousarray(frames_np[::-1])
    det = FaceDetector(models=models, device=models.device,
                       max_faces=MAX_FACES)
    with graphs.capture_now():
        for _ in range(3):
            det.detect_faces_batch(a)
            det.detect_faces_batch(b)
    want = {0: json.dumps(_payload(det.detect_faces_batch(a))),
            1: json.dumps(_payload(det.detect_faces_batch(b)))}
    errors = []

    def worker(first: int):
        try:
            with torch.inference_mode():
                for i in range(GRAPH_THREAD_CALLS):
                    which = (first + i) % 2
                    got = det.detect_faces_batch(a if which == 0 else b)
                    if json.dumps(_payload(got)) != want[which]:
                        errors.append(f"thread {first} call {i}")
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(repr(e))

    threads = [threading.Thread(target=worker, args=(t,)) for t in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise AssertionError(f"graphs: two threads on one key gave other "
                             f"faces than the sequential calls: {errors}")
    det.dispose()

    # Every batch overflows a 1-face slab, so its face stages re-run on
    # the det_* slab its replay returned, after the next batch's replay.
    pinned = FaceDetector(models=models, device=models.device,
                          max_faces=MAX_FACES)
    ref = FaceDetector(models=models, device=models.device,
                       max_faces=MAX_FACES)
    for d in (pinned, ref):
        d._speculation_bucket = lambda h, w, mode: 1
        d._note_face_count = lambda h, w, mode, n: None
    batches = [a, b, a, b, a]
    with graphs.capture_now():
        list(pinned.detect_faces_batch_stream(batches[:2], depth=2))
    reruns0 = _reruns(pinned)
    got = list(pinned.detect_faces_batch_stream(batches, depth=2))
    with graphs.eager():
        want_s = [ref.detect_faces_batch(x) for x in batches]
    if any(json.dumps(_payload(g)) != json.dumps(_payload(w))
           for g, w in zip(got, want_s)):
        raise AssertionError("graphs: the depth-2 stream's faces differ "
                             "from the eager sequential calls'")
    print(f"graphs concurrency (FULL, {FRAMES} x {HEIGHT}x{WIDTH}): two "
          f"threads x {GRAPH_THREAD_CALLS} replayed calls on one key equal "
          f"the sequential calls bit for bit; a depth-2 stream of "
          f"{len(batches)} batches, each re-running its face stages on its "
          f"replay's det_* slab ({_reruns(pinned) - reruns0} re-runs), "
          f"equal to the eager sequential calls bit for bit  [{card}]")
    pinned.dispose()
    ref.dispose()


#: Phase 14's segmenters: (kind, readback dtype) at B = 16; the faces a
#: FaceEmbedding.embed_batch call (3 and 4 share the slab-4 graph); the
#: rounds that time a fetch step.
SEG_GRAPH_CASES = (("general", "float32"), ("general", "uint8"),
                   ("multiclass", "float32"))
EMBED_NS = (1, 3, 4, 16)
FETCH_ROUNDS = 20


def _graph_segmentation(frames, frames_np, card: str) -> dict:
    """Phase 14's ``SelfieSegmentation`` at B = 16 (:data:`SEG_GRAPH_CASES`,
    seeded full-width segmenters): the size's program replayed against
    its eager run (planes bit for bit), ms a batch both ways in turns
    (upload and masks included), the host's ms to queue a batch already
    on the card, a profiled window of 3 batches both ways, capture ms and
    the card's graph pool."""
    import torch
    from face_detection_tflite_torch.convert.executor import convert_model
    from face_detection_tflite_torch.models import random_init
    from face_detection_tflite_torch.models.segmentation import \
        SelfieSegmentation
    from face_detection_tflite_torch.pipeline import graphs
    from face_detection_tflite_torch.pipeline.readback import fetch
    irs = {kind: random_init.segmenter_ir(kind, SEED + 5)
           for kind in dict(SEG_GRAPH_CASES)}
    out = {}
    for kind, dtype in SEG_GRAPH_CASES:
        label = f"segmentation {kind} {dtype}"
        seg = SelfieSegmentation(convert_model(irs[kind]),
                                 kind == "multiclass", mask_dtype=dtype,
                                 device=frames.device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with graphs.capture_now():
            seg(frames_np)                         # eager, then captured
        torch.cuda.synchronize()
        first_ms = (time.perf_counter() - t0) * 1e3
        (prog,) = seg._programs.captured()
        capture_ms = [c * 1e3 for c in prog.capture_s.values()]
        with torch.inference_mode():
            # The planes, less the stage stamps.
            got = fetch(prog(frames))["planes"]
            with graphs.eager():
                want = fetch(prog(frames))["planes"]
            if got.dtype != want.dtype or got.shape != want.shape:
                raise AssertionError(f"graphs {label}: planes {got.shape} "
                                     f"{got.dtype} against {want.shape} "
                                     f"{want.dtype}")
            diff = float(abs(got.astype("float32") -
                             want.astype("float32")).max())
        if diff != 0:
            raise AssertionError(f"graphs {label}: replayed planes differ "
                                 f"from the eager program's by {diff}")
        ms = _in_turns(GRAPH_RUNS, lambda: seg(frames_np), lambda: [prog])
        qmed = _in_turns(GRAPH_RUNS, lambda: seg.dispatch(frames),
                         lambda: [prog], seg.materialize)
        split = _capture_split(label, [("size", prog)], card)
        pool = graphs.pool_for(frames.device).nbytes()
        print(f"graphs {label} ({FRAMES} x {HEIGHT}x{WIDTH}): replayed "
              f"planes against the eager program's: largest difference "
              f"{diff:g}; ms a batch (upload and masks included), median of "
              f"{2 * GRAPH_RUNS} in turns: replayed {ms['replayed']:.2f}, "
              f"eager {ms['eager']:.2f}; host ms to queue a batch already "
              f"on the card: replayed {qmed['replayed']:.3f}, eager "
              f"{qmed['eager']:.3f}; first call {first_ms:.1f} ms, capture "
              f"{['%.1f' % c for c in capture_ms]} ms; the card's graph "
              f"pool {pool / 2**20:.1f} MiB  [{card}]")
        prof = _graph_profile(lambda: seg(frames_np), 3, card, label)
        seg.dispose()
        out[f"{kind} {dtype}"] = {"diff": diff, "ms": ms, "queue_ms": qmed,
                                  "first_ms": first_ms,
                                  "capture_ms": capture_ms,
                                  "capture_split": split,
                                  "pool_bytes": pool, "profile": prof}
    return out


def _graph_embedding(models, frames, card: str) -> dict:
    """Phase 14's ``FaceEmbedding.embed_batch`` on the main path's frame 0
    (a tensor on the card, as the detector's upload cache passes it) at
    N = :data:`EMBED_NS` seeded eye pairs (slabs 1, 4, 4 and 16; N = 3
    and 4 share one graph): the replays against the eager calls bit for
    bit, K2's 112 px launches a replayed call from the capture's tally,
    K2 against its plain version on the replay's ROIs (pads included), ms
    a call both ways in turns."""
    import math

    import numpy as np
    import torch
    from face_detection_tflite_torch.models.embedding import (
        FaceEmbedding, compute_embedding_alignment)
    from face_detection_tflite_torch.pipeline import graphs
    emb = FaceEmbedding(models.embedding, allow_untrained=True,
                        device=frames.device)
    frame = frames[0]
    rng = np.random.default_rng(SEED + 7)
    pairs = []
    for _ in range(max(EMBED_NS)):
        cx = rng.uniform(0.2 * WIDTH, 0.8 * WIDTH)
        cy = rng.uniform(0.2 * HEIGHT, 0.8 * HEIGHT)
        half, a = rng.uniform(20, 60), rng.uniform(-0.3, 0.3)
        dx, dy = half * math.cos(a), half * math.sin(a)
        pairs.append(((cx - dx, cy - dy), (cx + dx, cy + dy)))
    out = {"launches": 0, "calls": 0, "by_n": {}}
    for n in EMBED_NS:
        label = f"embed_batch N = {n}"
        with graphs.capture_now():                 # eager and captured, or
            emb.embed_batch(frame, pairs[:n])      # a replay of slab 4
        _reset_launches()
        got = [emb.embed_batch(frame, pairs[:n]) for _ in range(GRAPH_CALLS)]
        k2 = _launches()["warp_normalize"]
        if k2 != {EMBED_SIZE: GRAPH_CALLS}:
            raise AssertionError(f"graphs {label}: K2 launches {k2} over "
                                 f"{GRAPH_CALLS} replayed calls")
        out["launches"] += k2[EMBED_SIZE]
        out["calls"] += GRAPH_CALLS
        with graphs.eager():
            want = emb.embed_batch(frame, pairs[:n])
        if not all(np.array_equal(g, want) for g in got):
            raise AssertionError(f"graphs {label}: replayed embeddings "
                                 f"differ from the eager call's")
        slab = 1 << (n - 1).bit_length()
        aligns = [compute_embedding_alignment(le, re) for le, re in
                  pairs[:n]] + [(0.0, 0.0, 1.0, 0.0)] * (slab - n)
        cx, cy, size, theta = (
            torch.tensor([[a[i] for a in aligns]], dtype=torch.float32,
                         device=frame.device) for i in range(4))
        _check_warp(frame[None], [cx, cy, size, torch.cos(-theta),
                                  torch.sin(-theta)], EMBED_SIZE, None,
                    f"embedding site, {label}")
        ms = _in_turns(GRAPH_CALLS, lambda: emb.embed_batch(frame, pairs[:n]),
                       emb._programs.captured)
        print(f"graphs {label} (slab {slab}, {WIDTH}x{HEIGHT} frame on the "
              f"card): replayed embeddings equal the eager call's bit for "
              f"bit; K2 {k2[EMBED_SIZE]} launches at {EMBED_SIZE} px over "
              f"{GRAPH_CALLS} replayed calls; K2 equals its plain version "
              f"on the replay's {slab} ROIs; ms a call, median of "
              f"{2 * GRAPH_CALLS} in turns: replayed {ms['replayed']:.3f}, "
              f"eager {ms['eager']:.3f}  [{card}]")
        out["by_n"][n] = {"slab": slab, "ms": ms}
    (prog,) = emb._programs.captured()
    slabs = sorted(k[1][0][1] for k in prog.keys())
    if slabs != [1, 4, 16]:
        raise AssertionError(f"graphs embed_batch: graphs of slabs {slabs}, "
                             f"want [1, 4, 16]")
    out["capture_ms"] = [c * 1e3 for c in prog.capture_s.values()]
    out["capture_split"] = _capture_split("embed_batch", [("slab", prog)],
                                          card)
    emb.dispose()
    return out


def _graph_single(models, card: str) -> dict:
    """Phase 14's three single-network classes at B = 1 on seeded inputs
    (a 192 px face crop, a 64 px eye crop, 146 points): each replay
    against the eager call bit for bit, ms a call both ways in turns."""
    import numpy as np
    from face_detection_tflite_torch import (FaceBlendshapesModel,
                                             FaceLandmark, IrisLandmark)
    from face_detection_tflite_torch.pipeline import graphs
    rng = np.random.default_rng(SEED + 8)
    dev = models.device
    nets = (
        ("FaceLandmark", FaceLandmark(model=models.mesh, device=dev),
         rng.integers(0, 256, (MESH_SIZE, MESH_SIZE, 3), dtype=np.uint8)),
        ("IrisLandmark", IrisLandmark(model=models.iris, device=dev),
         rng.integers(0, 256, (IRIS_SIZE, IRIS_SIZE, 3), dtype=np.uint8)),
        ("FaceBlendshapesModel",
         FaceBlendshapesModel(model=models.blendshapes, device=dev),
         rng.uniform(0, WIDTH, (146, 2)).astype(np.float32)))
    out = {}
    for label, net, x in nets:
        call = (net.call_with_score if label == "FaceLandmark" else net)
        with graphs.capture_now():
            for _ in range(3):
                call(x)
        got = call(x)
        with graphs.eager():
            want = call(x)
        if label == "FaceLandmark":
            same = np.array_equal(got[0], want[0]) and got[1] == want[1]
        else:
            same = np.array_equal(got, want)
        if not same:
            raise AssertionError(f"graphs {label}: the replay differs from "
                                 f"the eager call")
        (prog,) = net._programs.captured()
        ms = _in_turns(GRAPH_CALLS, lambda: call(x), lambda: [prog])
        capture_ms = [c * 1e3 for c in prog.capture_s.values()]
        split = _capture_split(label, [("input", prog)], card)
        print(f"graphs {label} (B = 1): the replay equals the eager call "
              f"bit for bit; ms a call, median of {2 * GRAPH_CALLS} in "
              f"turns: replayed {ms['replayed']:.3f}, eager "
              f"{ms['eager']:.3f}; capture "
              f"{['%.1f' % c for c in capture_ms]} ms  [{card}]")
        net.dispose()
        out[label] = {"ms": ms, "capture_ms": capture_ms,
                      "capture_split": split}
    return out


def _graph_pack(models, frames, card: str) -> dict:
    """Phase 14's readback on the FULL B = 16 cell, packed inside the
    2-face speculative key's graph against the form before it (the same
    program captured without the pack, which then runs op by op after
    the replay), on the first 15 rows: ``readback.fetch_finish``'s arrays
    bit for
    bit, the host µs of the fetch step (from the replay's outputs to the
    copy's start) in turns, and the operators the host launches for a
    replayed batch's program call and fetch step (copy-in, clones, pack,
    copy to the host), each form."""
    import torch
    from face_detection_tflite_torch import FaceDetectionMode, FaceDetector
    from face_detection_tflite_torch.pipeline import graphs, readback
    from face_detection_tflite_torch.pipeline.programs import \
        build_pipeline_program
    mode = FaceDetectionMode.FULL
    det = FaceDetector(models=models, device=frames.device,
                       max_faces=MAX_FACES)
    scale = det._readback_scale(HEIGHT, WIDTH)
    rows = FRAMES - 1
    folded = det._program(HEIGHT, WIDTH, mode, face_slab=2)
    unfolded = graphs.program(build_pipeline_program(
        models, HEIGHT, WIDTH, mode, max_faces=MAX_FACES,
        min_score=det.min_score, face_slab=2), frames.device)

    def fetch(how, out):
        return (readback.fetch_async(out, rows) if how == "folded"
                else _eager_fetch_async(out, scale, rows))
    with torch.inference_mode():
        outs = {}
        for how, prog in (("folded", folded), ("eager", unfolded)):
            with graphs.capture_now():
                prog(frames)                       # eager, then captured
            outs[how] = prog(frames)
        got = readback.fetch_finish(fetch("folded", outs["folded"]))
        want = readback.fetch_finish(fetch("eager", outs["eager"]))
        diff = _readback_diff(got, want)
        if diff != 0:
            raise AssertionError(f"graphs pack: the folded readback differs "
                                 f"from the eager pack's by {diff}")
        fetch_us: dict = {"folded": [], "eager": []}
        for how in ("folded", "eager", "eager", "folded"):
            for _ in range(FETCH_ROUNDS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                handle = fetch(how, outs[how])
                fetch_us[how].append((time.perf_counter() - t0) * 1e6)
                readback.wait(handle)
        ops = {how: _host_ops(lambda: readback.wait(fetch(how,
                                                          prog(frames))))
               for how, prog in (("folded", folded), ("eager", unfolded))}
    med = {how: statistics.median(v) for how, v in fetch_us.items()}
    total = {how: sum(v.values()) for how, v in ops.items()}
    print(f"graphs pack (FULL, slab 2, {rows} of {FRAMES} rows): "
          f"fetch_finish's arrays of the pack inside the graph against the "
          f"eager pack's: largest difference {diff:g}; host us of the fetch "
          f"step, median of {2 * FETCH_ROUNDS} in turns: folded "
          f"{med['folded']:.1f}, eager pack {med['eager']:.1f}; operators "
          f"the host launches for a replayed batch's program call and fetch "
          f"step: folded {total['folded']} {ops['folded']}, eager pack "
          f"{total['eager']} {ops['eager']}  [{card}]")
    unfolded.release()
    det.dispose()
    return {"diff": diff, "fetch_us": med, "ops": ops, "ops_total": total}


def _graph_launches(graphs: dict, kernel: str, size=None) -> dict:
    """A kernel's launches over phase 14's replayed batches of each B = 16
    cell and its replayed B = 1 calls (K1 also over the standalone
    calls)."""
    def count(launches):
        n = launches.get(kernel, 0)
        return n.get(size, 0) if size is not None else n
    out = {"graph_launches": {
        **{label: count(c["launches"]) for label, c in
           graphs["cells"].items()},
        **{label: count(v["launches"]) for label, v in graphs["b1"].items()
           if label not in ("post_err", "capture_split")},
        "schedule": count(graphs["schedule"]["launches"])},
        "graph_batches": GRAPH_RUNS, "graph_calls": GRAPH_CALLS,
        "schedule_calls": len(graphs["schedule"]["calls"])}
    if kernel == "detection_postprocess":
        out["graph_launches"]["FaceDetection"] = graphs["standalone"][
            "launches"]
    if size == EMBED_SIZE:
        out["graph_launches"]["embed_batch"] = graphs["embedding"][
            "launches"]
        out["embed_batch_calls"] = graphs["embedding"]["calls"]
    return out


def _capture_at_call(cells, b1, alone, seg, embedding, single,
                     card: str) -> dict:
    """The capture's call by the rule ``graphs.CAPTURE_AT_CALL`` follows:
    capture once a key's eager calls have lost, against replays, about
    what its capture costs, so N = 1 + round(C / (E - R)), with E and R a
    call's median ms eager and replayed in turns and C the key's capture
    ms less the pool's adopt (a renewal happens only once the pool held
    no graph; a process's first capture allocates its memory in the
    run).  For each key phase 14 timed both ways; the B = 1 owners' median
    is the one the constant takes."""
    def rule(ms, row):
        lost = ms["eager"] - ms["replayed"]
        cost = row["capture_ms"] - row["adopt_ms"]
        return {"eager_ms": ms["eager"], "replayed_ms": ms["replayed"],
                "capture_ms": cost,
                "n": 1 + round(cost / lost) if lost > 0 else None}

    def steady(rows):
        return next(r for r in rows if r["program"].endswith("slab 16"))
    b1_keys = {"detect_faces": rule(b1["detect_faces"]["ms"],
                                    steady(b1["capture_split"])),
               "FaceDetection": rule(alone["ms"], alone["capture_split"][0]),
               "embed_batch N = 1": rule(
                   embedding["by_n"][1]["ms"],
                   next(r for r in embedding["capture_split"]
                        if r["inputs"][1] == [1, 1])),
               **{k: rule(v["ms"], v["capture_split"][0])
                  for k, v in single.items()}}
    b16_keys = {**{k: rule(v["ms"], steady(v["capture_split"]))
                   for k, v in cells.items()},
                **{f"segmentation {k}": rule(v["ms"], v["capture_split"][0])
                   for k, v in seg.items()}}
    ns = [v["n"] for v in b1_keys.values() if v["n"] is not None]
    out = {"b1": b1_keys, "b16": b16_keys,
           "b1_median": statistics.median(ns) if ns else None}
    print("graphs capture call by the rule, N = 1 + round(capture ms less "
          "adopt / (eager - replayed ms)): B = 1 "
          + ", ".join(f"{k} {v['n']} ({v['capture_ms']:.1f} / "
                      f"({v['eager_ms']:.2f} - {v['replayed_ms']:.2f}))"
                      for k, v in b1_keys.items())
          + f"; median {out['b1_median']}; B = 16 "
          + ", ".join(f"{k} {v['n']} ({v['capture_ms']:.1f} / "
                      f"({v['eager_ms']:.2f} - {v['replayed_ms']:.2f}))"
                      for k, v in b16_keys.items()) + f"  [{card}]")
    return out


def _graphs_phase_alone() -> int:
    """``python3 chip_smoke.py --graphs-phase``: phase 14 alone, on the
    main path's seeded networks and frames."""
    import numpy as np
    import torch
    from face_detection_tflite_torch.kernels import build
    from face_detection_tflite_torch.models import random_init
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(f"card: {card}")
    build.load()
    frames_np = np.random.default_rng(SEED).integers(
        0, 256, (FRAMES, HEIGHT, WIDTH, 3), dtype=np.uint8)
    frames = torch.from_numpy(frames_np).to("cuda")
    models = random_init.random_pipeline_models(frames, seed=SEED)[0]
    _graphs_phase(models, frames, frames_np, card)
    print(card)
    return 0


def _graphs_phase(models, frames, frames_np, card: str) -> dict:
    """Phase 14: the programs as captured CUDA graphs
    (``pipeline/graphs.py``) on the STANDARD, FULL and FULL + embeddings
    cells at B = 16, ``detect_faces`` and a camera frame at B = 1, the
    standalone ``FaceDetection`` and two concurrency checks; the copy-in
    of a frame batch into a graph's static input, timed alone; K1 and K2
    against their plain versions on the cells' frames."""
    import torch
    from face_detection_tflite_torch import FaceDetectionMode
    t0 = time.perf_counter()

    def stamp(what):
        print(f"time: phase 14 {what} done {time.perf_counter() - t0:.1f} s "
              f"into the phase")
    static = torch.empty_like(frames)
    copy_ms = _median_ms(lambda: static.copy_(frames))
    print(f"graphs: the copy-in of a {FRAMES} x {HEIGHT}x{WIDTH} uint8 batch "
          f"({frames.numel() / 1e6:.1f} MB) into a graph's static input: "
          f"{copy_ms:.4f} ms (CUDA events, median of 20)  [{card}]")
    del static
    cells = {}
    for label, mode, embed in (
            ("STANDARD", FaceDetectionMode.STANDARD, False),
            ("FULL", FaceDetectionMode.FULL, False),
            ("FULL + embeddings", FaceDetectionMode.FULL, True)):
        cells[label] = _graph_cell(label, models, frames, frames_np, mode,
                                   embed, card)
        stamp(label)
    schedule = _graph_schedule(models, frames, card)
    post_err = _check_path_kernels("phase 14 B = 16", models, frames, card)
    b1 = _graph_b1(models, frames, frames_np, card)
    alone = _graph_standalone(models, frames, frames_np, card)
    _graph_concurrency(models, frames_np, card)
    stamp("B = 1, FaceDetection and concurrency")
    pack = _graph_pack(models, frames, card)
    seg = _graph_segmentation(frames, frames_np, card)
    stamp("pack and segmentation")
    embedding = _graph_embedding(models, frames, card)
    single = _graph_single(models, card)
    stamp("embed_batch and single networks")
    by_rule = _capture_at_call(cells, b1, alone, seg, embedding, single,
                               card)
    splits = {**{k: v["capture_split"] for k, v in cells.items()},
              "B = 1": b1["capture_split"],
              "FaceDetection": alone["capture_split"],
              **{f"segmentation {k}": v["capture_split"]
                 for k, v in seg.items()},
              "embed_batch": embedding["capture_split"],
              **{k: v["capture_split"] for k, v in single.items()},
              "schedule": schedule["capture_split"]}
    print("graphs: " + json.dumps({
        "card": card, "copy_in_ms": copy_ms,
        "capture_median_ms": statistics.median(
            r["capture_ms"] for rows in splits.values() for r in rows),
        "capture_split": splits, "capture_at_call_by_rule": by_rule,
        "schedule": {x: schedule[x] for x in ("capture_at_call", "calls")},
        "cells": {k: {x: v[x] for x in ("ms", "queue_ms", "capture_ms",
                                         "pool_bytes", "graphs", "diffs",
                                         "profile")}
                  for k, v in cells.items()},
        "b1": {k: v["ms"] for k, v in b1.items()
               if k not in ("post_err", "capture_split")},
        "standalone": {x: alone[x] for x in ("ms", "capture_ms",
                                             "pool_bytes")},
        "pack": pack,
        "segmentation": {k: {x: y for x, y in v.items()
                             if x != "capture_split"}
                         for k, v in seg.items()},
        "embed_batch": {"by_n": embedding["by_n"],
                        "capture_ms": embedding["capture_ms"],
                        "k2_launches": embedding["launches"],
                        "calls": embedding["calls"]},
        "single": {k: {x: y for x, y in v.items() if x != "capture_split"}
                   for k, v in single.items()}}))
    return {"cells": cells, "b1": b1, "standalone": alone,
            "copy_in_ms": copy_ms, "embedding": embedding,
            "schedule": schedule,
            "post_err": max(post_err, b1["post_err"])}


# Phase 13: the traced batches a cell, the rounds of the ranges' host cost,
# the share of device time the ranges must hold, and the kernels' names.
TRACE_ITERS = 3
TRACE_WARM = 2
SERVE_TRACE_BATCHES = 2
RANGE_ROUNDS = 10_000
TRACE_SHARE = 0.98
K1_KERNEL = "detection_postprocess_kernel"
K2_KERNEL = "warp_normalize_kernel"


def _tool(name: str):
    """``tools/<name>.py`` as a module."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _kernel_counts(bd: dict, kernel: str) -> dict:
    """{stage: launches of ``kernel`` in it} of a stage breakdown."""
    return {stage: sum(n for name, (_, n) in row["by_name"].items()
                       if kernel in name)
            for stage, row in bd["stages"].items()}


def _only_in(counts: dict, want: dict, label: str) -> None:
    """``counts`` holds exactly ``want``'s stages with their counts, and
    every other stage (``unattributed`` included) none."""
    got = {k: v for k, v in counts.items() if v}
    if got != {k: v for k, v in want.items() if v} or not all(want.values()):
        raise AssertionError(f"{label}: launches by stage {got}, want "
                             f"{want}")


def _ranges_a_batch(path: str, tool, iters: int) -> dict:
    """{range: entries a batch} of the ``fdt.*`` ranges in a trace."""
    counts: dict = {}
    for ev in tool._events(path):
        if ev.get("cat") == "user_annotation" and \
                ev.get("name", "").startswith("fdt."):
            counts[ev["name"]] = counts.get(ev["name"], 0) + 1
    return {k: v / iters for k, v in sorted(counts.items())}


def _trace_cell(label: str, det, frames_np, out_dir: str, tool,
                card: str) -> dict:
    """One cell of phase 13: warm batches, then ``capture`` of
    :data:`TRACE_ITERS` FULL batches with the launch counts set to 0 just
    before; the stage breakdown and its checks (module docstring, step
    13); the same batches untraced, faces bit for bit."""
    from face_detection_tflite_torch import FaceDetectionMode
    embed = det.embed_in_full
    for _ in range(TRACE_WARM):
        det.detect_faces_batch(frames_np)
    _reset_launches()
    path, faces = tool.capture(det, frames_np, out_dir, TRACE_ITERS,
                               FaceDetectionMode.FULL, warm=0)
    launches = _launches()
    untraced = [det.detect_faces_batch(frames_np)
                for _ in range(TRACE_ITERS)]
    if [_face_json(f) for f in faces] != [_face_json(f) for f in untraced]:
        raise AssertionError(f"trace {label}: the traced batches' faces "
                             f"differ from the same batches untraced")
    bd = tool.stage_breakdown(path)
    k1 = _kernel_counts(bd, K1_KERNEL)
    k2 = _kernel_counts(bd, K2_KERNEL)
    by_size = launches["warp_normalize"]
    _only_in(k1, {"fdt.postprocess": launches["detection_postprocess"]},
             f"trace {label} K1")
    _only_in(k2, {"fdt.mesh": by_size.get(MESH_SIZE, 0),
                  "fdt.iris": by_size.get(IRIS_SIZE, 0),
                  **({"fdt.embedding": by_size.get(EMBED_SIZE, 0)}
                     if embed else {})}, f"trace {label} K2")
    if launches["detection_postprocess"] != TRACE_ITERS:
        raise AssertionError(f"trace {label}: {launches} over "
                             f"{TRACE_ITERS} traced batches")
    n = TRACE_ITERS
    line = {"cell": label, "batches": n, "frames": FRAMES,
            "card": card, "stages": {
                stage: {"device_ms": row["device_ms"] / n,
                        "kernels": row["kernels"] / n,
                        "copies": row["copies"] / n,
                        "K1_launches": k1[stage], "K2_launches": k2[stage],
                        "top": [[name[:60], ms / n, c / n]
                                for name, (ms, c) in row["top"][:3]]}
                for stage, row in sorted(
                    bd["stages"].items(),
                    key=lambda kv: -kv[1]["device_ms"])},
            "busy_ms": bd["busy_ms"] / n, "window_ms": bd["window_ms"],
            "device_ms": bd["device_ms"] / n,
            "attributed_share": bd["attributed_share"],
            "links": bd["links"], "wrapper_launches": launches}
    print(f"trace {label}: " + json.dumps(line))
    tool.print_breakdown(bd, n, f" ({label}, {card})")
    if bd["attributed_share"] < TRACE_SHARE:
        raise AssertionError(
            f"trace {label}: the fdt.* ranges hold "
            f"{bd['attributed_share']:.4f} of the device time, below "
            f"{TRACE_SHARE}")
    return {"path": path, "faces": untraced[-1]}


def _range_host_us(ranges: dict, gated: bool) -> float:
    """Host µs of entering and leaving a call's ranges (``ranges``:
    {name: entries a call}, rounded to whole entries) with no profiler
    running, through ``timings.stage_range`` as the port enters them
    (``gated``) or through ``record_function`` itself: a host clock over
    :data:`RANGE_ROUNDS` rounds."""
    from torch.profiler import record_function

    from face_detection_tflite_torch.pipeline import timings
    enter = timings.stage_range if gated else record_function
    names = [name for name, k in ranges.items() for _ in range(round(k))]
    for name in names:
        with enter(name):
            pass
    t0 = time.perf_counter()
    for _ in range(RANGE_ROUNDS):
        for name in names:
            with enter(name):
                pass
    return (time.perf_counter() - t0) * 1e6 / RANGE_ROUNDS


def _single_frame_ranges(det, frame, out_dir: str, tool) -> dict:
    """{path: ({range: entries a call}, median ms a call untraced)} of the
    B = 1 paths on ``frame``: ``detect_faces`` and
    ``detect_faces_from_camera_frame`` (an RGBA frame, decoded on the
    host), each traced for one warm call."""
    from face_detection_tflite_torch.pipeline import timings
    from face_detection_tflite_torch.utils.camera import \
        camera_frame_from_image
    cam = camera_frame_from_image(frame)
    out = {}
    for label, call in (
            ("detect_faces", lambda: det.detect_faces(frame)),
            ("detect_faces_from_camera_frame",
             lambda: det.detect_faces_from_camera_frame(cam))):
        call()
        call()
        d = os.path.join(out_dir, label)
        with timings.trace(d):
            call()
        (path,) = [os.path.join(d, f) for f in os.listdir(d)
                   if f.endswith(".pt.trace.json")]
        out[label] = (_ranges_a_batch(path, tool, 1),
                      _median_ms(call, iters=10, warmup=1))
    return out


def _print_range_cost(label: str, ranges: dict, call_ms: float,
                      card: str) -> None:
    """The ranges' host cost of one call of ``label`` as the port enters
    them (no profiler running) and as ``record_function`` alone would."""
    n = sum(round(k) for k in ranges.values())
    gated, plain = _range_host_us(ranges, True), _range_host_us(ranges,
                                                                False)
    print(f"ranges of {label}: {ranges} ({n} entries); host cost with no "
          f"profiler running {gated:.3f} us a call through stage_range "
          f"({gated / n:.3f} us an entry; {plain:.2f} us through "
          f"record_function alone), over {RANGE_ROUNDS} rounds; the call "
          f"{call_ms:.3f} ms untraced  [{card}]")


def _serving_trace(det, frames_np, out_dir: str, tool, card: str,
                   want_faces) -> None:
    """:data:`SERVE_TRACE_BATCHES` FULL batches through
    ``ServingPipeline`` under ``trace`` entered on this thread: the
    worker thread's ranges must reach the trace, every K1 launch lie in
    ``fdt.postprocess``, and the faces equal ``want_faces``."""
    import threading

    from face_detection_tflite_torch import (FaceDetectionMode,
                                             ServingPipeline)
    from face_detection_tflite_torch.pipeline import timings
    full = FaceDetectionMode.FULL
    with ServingPipeline(det, full, depth=2) as pipe:
        pipe.submit(frames_np).result()   # the worker's first batch
        _reset_launches()
        with timings.trace(out_dir):
            futs = [pipe.submit(frames_np)
                    for _ in range(SERVE_TRACE_BATCHES)]
            results = [f.result() for f in futs]
        launches = _launches()
    (path,) = [os.path.join(out_dir, f) for f in os.listdir(out_dir)
               if f.endswith(".pt.trace.json")]
    main_tid = threading.get_native_id()
    threads: dict = {}
    for ev in tool._events(path):
        if ev.get("cat") == "user_annotation" and \
                ev.get("name", "").startswith("fdt."):
            who = "main" if ev.get("tid") == main_tid else "worker"
            threads.setdefault(who, set()).add(ev["name"])
    bd = tool.stage_breakdown(path)
    k1 = _kernel_counts(bd, K1_KERNEL)
    print(f"trace ServingPipeline ({SERVE_TRACE_BATCHES} FULL batches, "
          f"depth 2) [{card}]: ranges by thread "
          f"{ {k: sorted(v) for k, v in threads.items()} }, attributed "
          f"share {bd['attributed_share']:.4f}, links {bd['links']}, K1 "
          f"by stage { {k: v for k, v in k1.items() if v} }, wrappers "
          f"{launches}")
    if "fdt.postprocess" not in threads.get("worker", ()):
        raise AssertionError("trace ServingPipeline: the worker thread's "
                             "ranges did not reach the trace")
    _only_in(k1, {"fdt.postprocess": launches["detection_postprocess"]},
             "trace ServingPipeline K1")
    if any(_face_json(r) != _face_json(want_faces) for r in results):
        raise AssertionError("trace ServingPipeline: faces differ from "
                             "the direct calls'")


def _trace_phase(device: str = "cuda") -> int:
    """Step 13, run as ``python3 chip_smoke.py --trace-phase`` in a process
    of its own (module docstring), on ``device`` (a rehearsal passes
    "cpu")."""
    import tempfile

    import numpy as np
    import torch

    from face_detection_tflite_torch import FaceDetector
    from face_detection_tflite_torch.models import random_init

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    tool = _tool("trace_capture_torch")
    warm_tool = _tool("warm_torch")
    frames_np = np.random.default_rng(SEED).integers(
        0, 256, (FRAMES, HEIGHT, WIDTH, 3), dtype=np.uint8)
    dev = torch.device(device)
    models = random_init.random_pipeline_models(
        torch.from_numpy(frames_np).to(dev), seed=SEED)[0]
    cells = {}
    with tempfile.TemporaryDirectory(dir=REPO, prefix=".trace_") as tmp:
        for label, embed in (("FULL", False), ("FULL + embeddings", True)):
            det = FaceDetector(models=models, device=dev,
                               max_faces=MAX_FACES, embed_in_full=embed,
                               allow_untrained_embeddings=True)
            out = os.path.join(tmp, label.replace(" + ", "_"))
            cells[label] = _trace_cell(label, det, frames_np, out, tool,
                                       card)
            if embed:
                full_embed = det
            else:
                full_det = det
        ranges = {"a FULL + embeddings batch": (
            _ranges_a_batch(cells["FULL + embeddings"]["path"], tool,
                            TRACE_ITERS),
            _median_ms(lambda: full_embed.detect_faces_batch(frames_np),
                       iters=5, warmup=1))}
        _serving_trace(full_det, frames_np, os.path.join(tmp, "serving"),
                       tool, card, cells["FULL"]["faces"])
        ranges.update(_single_frame_ranges(
            full_det, frames_np[0], os.path.join(tmp, "single"), tool))
    full_embed.dispose()
    steps = warm_tool.warm(full_det, FRAMES)
    print(f"warm_torch.warm on the FULL detector [{card}]: "
          + json.dumps([[label.strip(), s] for label, s in steps]))
    full_det.dispose()
    for label, (r, call_ms) in ranges.items():
        _print_range_cost(label, r, call_ms, card)
    return 0


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
    if sys.argv[1:] == ["--trace-phase"]:
        return _trace_phase()
    if sys.argv[1:] == ["--graphs-phase"]:
        return _graphs_phase_alone()
    if sys.argv[1:] == ["--pointwise-phase"]:
        return _pointwise_phase_alone()
    if sys.argv[1:] == ["--affine-phase"]:
        return _affine_phase_alone()
    if sys.argv[1:] == ["--depthwise-phase"]:
        return _depthwise_phase_alone()
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
    t_start = time.perf_counter()

    def stamp(phases):
        print(f"time: phases {phases} done "
              f"{time.perf_counter() - t_start:.1f} s into the run")

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
    k5_sites = _k5_sites(card)
    k5_affine = {"sites": _k5_affine_sites(card)}
    k6 = _k6_sites(card)
    k7 = _k7_sites(card)

    # -- 4. the STANDARD main path --------------------------------------------
    t0 = time.perf_counter()
    models, det_ir, mesh_ir, iris_ir, bs_ir = \
        random_init.random_pipeline_models(frames, seed=SEED)
    print(f"K5 launches a network call (planned passes): "
          f"{_k5_per_call(models)}")
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
    arcface = _arcface_phase(models, frames_np, card)

    stamp("1-6")

    # -- 7. serving: the stream, the server, two threads ------------------------
    _upload_times(frames_np, card)
    stream = _stream_phase(models, frames_np, runs, card)
    serve = _server_phase(models, frames_np, kind, card)
    _threads_phase(models, frames, card)
    stamp(7)

    # -- 8. video, camera frames, standalone classes ----------------------------
    video = _video_phase(frames, card)
    camera = _camera_phase(video["models"], video["decoded"], card)
    alone = _standalone_phase(models, cpu_models, frames, frames_np,
                              full["slab"], iroi, card)
    stamp(8)
    # -- 9. detector variants and selfie segmentation --------------------------
    variants = _variants_phase(models, cpu_models, frames, frames_np, card)
    seg = _segmentation_phase(models, frames, frames_np, card)
    stamp(9)
    # -- 10. precision tiers and the int8 detector ----------------------------
    tiers = _tiers_phase(models, det_ir, frames, frames_np, card)
    stamp(10)
    # -- 11. the command line -------------------------------------------------
    cli = _cli_phase(models, frames_np, video, card)
    stamp(11)
    # -- 12. scale-out: replicas, data-parallel shards ------------------------
    scale = _replica_phase(models, frames_np, video, card)
    stamp(12)
    post_err = max(post_err, video["post_err"], camera["post_err"],
                   alone["post_err"], variants["post_err"],
                   tiers["post_err"], cli["post_err"], scale["post_err"])

    # -- 14. the programs as captured CUDA graphs ------------------------------
    graphs = _graphs_phase(models, frames, frames_np, card)
    post_err = max(post_err, graphs["post_err"])
    stamp(14)

    # -- 13. the profiler trace with stage ranges, in a fresh process ----------
    sys.stdout.flush()
    subprocess.run([sys.executable, os.path.abspath(__file__),
                    "--trace-phase"], check=True, timeout=900)
    stamp(13)

    # -- 15. result lines -----------------------------------------------------
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
         **_tier_launches(tiers, "detection_postprocess"),
         "cli_launches": cli["detect_launches"]["detection_postprocess"],
         "cli_images": CLI_IMAGES,
         "replica_launches":
             scale["replica_launches"]["detection_postprocess"],
         "replica_batches": scale["replica_batches"],
         "dp_launches": scale["dp_launches"]["detection_postprocess"],
         "dp_batches": scale["dp_batches"], "dp_shards": scale["dp_shards"],
         **_graph_launches(graphs, "detection_postprocess"),
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
         "check_launches": check_launches,
         "cli_launches": cli["nms_launches"],
         "cli_images": CLI_IMAGES, "max_abs_err": k1_err,
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
         **_tier_launches(tiers, "warp_normalize", MESH_SIZE),
         "cli_launches": cli["detect_launches"]["warp_normalize"][MESH_SIZE],
         "cli_images": CLI_IMAGES,
         "replica_launches":
             scale["replica_launches"]["warp_normalize"][MESH_SIZE],
         "dp_launches": scale["dp_launches"]["warp_normalize"][MESH_SIZE],
         **_graph_launches(graphs, "warp_normalize", MESH_SIZE),
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
         **_tier_launches(tiers, "warp_normalize", IRIS_SIZE),
         "cli_launches": cli["detect_launches"]["warp_normalize"][IRIS_SIZE],
         "cli_images": CLI_IMAGES,
         "replica_launches":
             scale["replica_launches"]["warp_normalize"][IRIS_SIZE],
         "dp_launches": scale["dp_launches"]["warp_normalize"][IRIS_SIZE],
         **_graph_launches(graphs, "warp_normalize", IRIS_SIZE),
         **iris_site},
        {"name": "warp_normalize_embed112", "route": "cuda",
         "source": f"{PACKAGE}/csrc/warp.cu",
         "replaces": "face_detection_tflite_tpu/ops/warp.py:34",
         "launches": emb["launches"]["warp_normalize"][EMBED_SIZE],
         "server_embed_launches": serve["embed_launches"][
             "warp_normalize"].get(EMBED_SIZE, 0),
         "cli_launches": cli["embed_launches"]["warp_normalize"][EMBED_SIZE],
         "cli_images": CLI_IMAGES,
         **_graph_launches(graphs, "warp_normalize", EMBED_SIZE),
         **embed_site},
        {"name": "residual_act", "route": "cuda",
         "source": f"{PACKAGE}/csrc/epilogue.cu", "replaces": None,
         "fuses": "face_detection_tflite_tpu/convert/executor.py CONV_2D "
                  "and DEPTHWISE_CONV_2D bias, ADD, RELU, PRELU and "
                  "channel PAD",
         "per_call": _k5_per_call(models),
         "launches": std["launches"]["residual_act"],
         "full_launches": full["launches"]["residual_act"],
         "embed_launches": emb["launches"]["residual_act"],
         "op_by_op_launches": {
             "launches": std["launches"]["op_by_op"],
             "full_launches": full["launches"]["op_by_op"],
             "embed_launches": emb["launches"]["op_by_op"],
             "int8_launches": tiers["int8"]["launches"]["op_by_op"]},
         "bias_op_by_op_launches": {
             key: path["launches"]["bias_op_by_op"] for key, path in (
                 ("launches", std), ("full_launches", full),
                 ("embed_launches", emb),
                 ("int8_launches", tiers["int8"]))},
         "bias_launches": {
             key: {k: path["launches"][k] for k in ("bias_folded",
                                                    "bias_alone")}
             for key, path in (("launches", std), ("full_launches", full),
                               ("embed_launches", emb))},
         "stream_launches": stream["launches"]["residual_act"],
         "server_launches": serve["launches"]["residual_act"],
         "server_batches": len(serve["batch_sizes"]),
         "video_launches": video["launches"]["residual_act"],
         "video_batches": video["batches"],
         "camera_launches": camera["launches"]["residual_act"],
         "camera_frames": camera["frames"],
         **_variant_launches(variants, "residual_act"),
         "segmentation_combined_launches":
             seg["combined_launches"]["residual_act"],
         "segmentation_server_launches":
             seg["server_launches"]["residual_act"],
         **_tier_launches(tiers, "residual_act"),
         "cli_launches": cli["detect_launches"]["residual_act"],
         "cli_images": CLI_IMAGES,
         "replica_launches": scale["replica_launches"]["residual_act"],
         "dp_launches": scale["dp_launches"]["residual_act"],
         **_graph_launches(graphs, "residual_act"),
         **k5_sites["iris"], "sites": k5_sites},
        {"name": "residual_act_affine", "route": "cuda",
         "source": f"{PACKAGE}/csrc/epilogue.cu", "replaces": None,
         "fuses": "face_detection_tflite_tpu/convert/executor.py MUL and "
                  "ADD of one constant a channel (a batch norm kept in the "
                  "graph) after a K5 pass",
         "per_call": _affine_per_call(models),
         "launches": std["launches"]["affine"],
         "full_launches": full["launches"]["affine"],
         "embed_launches": emb["launches"]["affine"],
         "op_by_op_launches": {
             key: path["launches"]["affine_op_by_op"] for key, path in (
                 ("launches", std), ("full_launches", full),
                 ("embed_launches", emb))},
         "arcface_per_call": arcface["per_call"],
         "arcface_launches": arcface["launches"],
         "arcface_calls": arcface["calls"],
         "arcface_reruns": arcface["reruns"],
         "arcface_op_by_op_launches": arcface["op_by_op"],
         "arcface_residual_act_launches": arcface["residual_act"],
         **k5_affine["sites"]["block_end_56"],
         "sites": k5_affine["sites"]},
        {"name": "pointwise_conv", "route": "cuda",
         "source": f"{PACKAGE}/csrc/pointwise.cu", "replaces": None,
         "fuses": "MobileFaceNet's 1x1 convolutions (cuDNN's NCHW implicit "
                  "GEMM and its two transposes) with the K5 pass after "
                  "each: bias, PReLU, residual add",
         "per_call": _k6_per_call(models),
         "launches": std["launches"]["pointwise_conv"],
         "full_launches": full["launches"]["pointwise_conv"],
         "embed_launches": emb["launches"]["pointwise_conv"],
         "forward_launches": k6["forward_launches"],
         **_graph_launches(graphs, "pointwise_conv"),
         **k6["sites"]["b0_0_e"], "totals": k6["totals"],
         "sites": k6["sites"]},
        {"name": "depthwise_conv", "route": "cuda",
         "source": f"{PACKAGE}/csrc/depthwise.cu", "replaces": None,
         "fuses": "every float32 DEPTHWISE_CONV_2D with multiplier 1 and "
                  "dilation 1 (cuDNN's conv2d_c1_k1_nhwc, the F.pad copy "
                  "of an asymmetric pad) with the K5 pass after it: bias, "
                  "ReLU or PReLU",
         "per_call": _k7_per_call(models),
         "launches": std["launches"]["depthwise_conv"],
         "full_launches": full["launches"]["depthwise_conv"],
         "embed_launches": emb["launches"]["depthwise_conv"],
         **_graph_launches(graphs, "depthwise_conv"),
         **k7["sites"][next(iter(k7["sites"]))], "totals": k7["totals"],
         "sites": k7["sites"]},
    ]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
