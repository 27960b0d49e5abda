"""The port's CUDA kernels against their plain PyTorch versions.

The ``cuda`` tests need the card and skip elsewhere.  This file imports
neither ``jax`` nor the JAX package, so on a machine without them it runs
with ``python -m pytest --noconftest tests/test_torch_kernels.py``.  The
other tests pin the wrappers' routing: plain version for CPU tensors, an
error for any other device, and an error (not a fallback) when ``nvcc`` is
missing."""

import math

import numpy as np
import pytest
import torch

from face_detection_tflite_torch.convert.executor import (convert_model,
                                                          fp32_on_the_card)
from face_detection_tflite_torch.kernels import build
from face_detection_tflite_torch.models import random_init
from face_detection_tflite_torch.ops import detections, nms, warp
from face_detection_tflite_torch.ops.anchors import (SSD_BACK, SSD_FULL,
                                                     generate_anchors)
from face_detection_tflite_torch.ops.detections import _topk_candidates
from face_detection_tflite_torch.ops.letterbox import letterbox_params


@pytest.fixture
def cuda_device():
    """The card, with cuDNN's TF32 off as a card model's construction
    leaves it (a bare model moved to the card checks, and raises with
    TF32 on)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    device = torch.device("cuda")
    fp32_on_the_card(device)
    return device


def _candidates(seed, b, k, valid_frac):
    rng = np.random.default_rng(seed)
    c = rng.uniform(0.1, 0.9, (b, k // 4 + 1, 2))
    wh = rng.uniform(0.05, 0.3, (b, k // 4 + 1, 2))
    pick = rng.integers(0, k // 4 + 1, (b, k))
    ctr = np.take_along_axis(c, pick[..., None], 1) + \
        rng.normal(0, 0.01, (b, k, 2))
    half = np.take_along_axis(wh, pick[..., None], 1) * 0.5
    boxes = np.concatenate([ctr - half, ctr + half], -1).astype(np.float32)
    scores = rng.uniform(0, 1, (b, k)).astype(np.float32)
    kp = rng.uniform(0, 1, (b, k, 6, 2)).astype(np.float32)
    return boxes, kp, scores, scores >= 1.0 - valid_frac


def _rois(seed, b, f, h, w):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(a.astype(np.float32)) for a in (
        rng.uniform(-20, w + 20, (b, f)), rng.uniform(-20, h + 20, (b, f)),
        rng.uniform(10, 1.5 * max(h, w), (b, f)),
        rng.uniform(-math.pi, math.pi, (b, f)))]


def test_cpu_tensors_take_the_plain_versions():
    boxes, _, scores, valid = (torch.from_numpy(a)
                               for a in _candidates(0, 2, 32, 0.5))
    before = nms.nms_core.launches
    got = nms.nms_core(boxes, scores, valid)
    want = nms.nms_core_plain(boxes, scores, valid)
    assert nms.nms_core.launches == before
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    frames = torch.randint(0, 256, (1, 20, 30, 3), dtype=torch.uint8)
    cx, cy, size, theta = _rois(1, 1, 3, 20, 30)
    before = warp.warp_normalize.launches
    a = warp.warp_normalize(frames, cx, cy, size, theta.cos(), theta.sin(),
                            out_size=8)
    assert warp.warp_normalize.launches == before
    assert torch.equal(a, warp.warp_normalize_plain(
        frames, cx, cy, size, theta.cos(), theta.sin(), out_size=8))


def test_other_devices_raise():
    with pytest.raises(ValueError, match="device"):
        nms.nms_core(torch.empty((1, 8, 4), device="meta"),
                     torch.empty((1, 8), device="meta"),
                     torch.empty((1, 8), dtype=torch.bool, device="meta"))
    z = torch.empty((1, 2), device="meta")
    with pytest.raises(ValueError, match="device"):
        warp.warp_normalize(torch.empty((1, 4, 4, 3), device="meta"),
                            z, z, z, z, z, out_size=4)


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build()


@pytest.mark.cuda
@pytest.mark.parametrize("k,frac", [(896, 30 / 896), (896, 1.0),
                                    (2304, 0.05), (2304, 1.0)])
def test_nms_kernel_matches_plain(cuda_device, k, frac):
    boxes, kp, scores, valid = (torch.from_numpy(a).to(cuda_device)
                                for a in _candidates(k, 16, k, frac))
    tb, _, ts, tv = _topk_candidates(boxes, kp, scores, valid, k)
    before = nms.nms_core.launches
    leader, blended = nms.nms_core(tb, ts, tv)
    torch.cuda.synchronize()
    assert nms.nms_core.launches == before + 1
    p_leader, p_blended = nms.nms_core_plain(tb, ts, tv)
    assert torch.equal(leader, p_leader)
    assert (blended - p_blended).abs().max().item() <= 1e-6


@pytest.mark.cuda
def test_nms_kernel_at_max_k(cuda_device):
    """k = MAX_K fits the kernel's shared memory (26 bytes a candidate);
    one more is rejected before any launch."""
    k = nms.MAX_K
    boxes, kp, scores, valid = (torch.from_numpy(a).to(cuda_device)
                                for a in _candidates(k, 2, k, 0.02))
    tb, _, ts, tv = _topk_candidates(boxes, kp, scores, valid, k)
    leader, blended = nms.nms_core(tb, ts, tv)
    torch.cuda.synchronize()
    p_leader, p_blended = nms.nms_core_plain(tb, ts, tv)
    assert torch.equal(leader, p_leader)
    assert (blended - p_blended).abs().max().item() <= 1e-6
    before = nms.nms_core.launches
    with pytest.raises(ValueError, match="exceeds"):
        nms.nms_core(*(torch.cat([t, t[:, :1]], 1).contiguous()
                       for t in (tb, ts, tv)))
    assert nms.nms_core.launches == before


#: Postprocess cases: (anchors, input size, valid anchors per image,
#: clusters, num_candidates, D, equal scores).  The main path's load
#: (about 30 valid of 896), every anchor valid (the sort, the bit rows at
#: n = 896), the full-range model at 5% and 100% valid (the on-the-fly
#: scan past n ~ 1,100), a candidate cap, more leaders than D, k < D, no
#: valid anchor and equal scores.
POSTPROCESS_CASES = {
    "main": ("back", 30, 12, None, 16, False),
    "all_valid": ("back", 896, 200, None, 16, False),
    "full_5pct": ("full", 115, 30, None, 16, False),
    "full_all_valid": ("full", 2304, 400, None, 16, False),
    "candidates_64": ("back", 200, 40, 64, 16, False),
    "more_leaders": ("back", 120, 80, None, 16, False),
    "k_below_d": ("back", 30, 12, 8, 16, False),
    "none_valid": ("back", 0, 1, None, 16, False),
    "equal_scores": ("back", 40, 10, None, 16, True),
}


def postprocess_inputs(case, batch=4, seed=0):
    """(raw_boxes, raw_scores, anchors, input_size, padding, kwargs) of a
    case, as numpy arrays; padding is the 853x1280 frame's letterbox."""
    variant, nv, clusters, cand, d, equal = POSTPROCESS_CASES[case]
    opts, size = (SSD_BACK, 256) if variant == "back" else (SSD_FULL, 192)
    anchors = generate_anchors(opts)
    raw_boxes, raw_scores = random_init.random_raw_detections(
        seed, batch, anchors, float(size), nv, clusters=clusters,
        equal_scores=equal)
    padding = letterbox_params(853, 1280, size, size).padding
    return (raw_boxes, raw_scores, anchors, float(size), padding,
            {"max_detections": d, "num_candidates": cand})


def test_postprocess_routing():
    """A CPU tensor takes the plain version (no launch); other devices
    raise."""
    rb, rs, anchors, size, pad, kw = postprocess_inputs("main", batch=2)
    args = [torch.from_numpy(a) for a in (rb, rs, anchors)]
    before = detections.detection_postprocess.launches
    got = detections.detection_postprocess(*args, size, pad, **kw)
    want = detections.detection_postprocess_plain(*args, size, pad, **kw)
    assert detections.detection_postprocess.launches == before
    assert got[3].any()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    meta = [torch.empty(a.shape, device="meta") for a in (rb, rs, anchors)]
    with pytest.raises(ValueError, match="device"):
        detections.detection_postprocess(*meta, size, pad, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(POSTPROCESS_CASES))
def test_postprocess_kernel_matches_plain(cuda_device, case):
    """One launch per batch; valid, scores and keypoints equal to the plain
    version on the card, boxes within 1e-6 (the plain blend is a matmul)."""
    rb, rs, anchors, size, pad, kw = postprocess_inputs(case)
    args = [torch.from_numpy(a).to(cuda_device) for a in (rb, rs, anchors)]
    before = detections.detection_postprocess.launches
    boxes, kp, scores, valid = detections.detection_postprocess(
        *args, size, pad, **kw)
    torch.cuda.synchronize()
    assert detections.detection_postprocess.launches == before + 1
    p_boxes, p_kp, p_scores, p_valid = \
        detections.detection_postprocess_plain(*args, size, pad, **kw)
    assert torch.equal(valid, p_valid)
    assert torch.equal(scores, p_scores)
    assert torch.equal(kp, p_kp)
    assert (boxes - p_boxes).abs().max().item() <= 1e-6
    nv = POSTPROCESS_CASES[case][1]
    assert bool(valid.any()) == (nv > 0)


def _warp_rois(kind, b, f, h, w):
    """ROIs that upsample (size 10-100), downsample (400-1300, the main
    path's range) or lie wholly outside the frame."""
    rng = np.random.default_rng(len(kind))
    if kind == "down":
        size = rng.uniform(400, 1300, (b, f))
        cx, cy = rng.uniform(0, w, (b, f)), rng.uniform(0, h, (b, f))
    else:
        size = rng.uniform(10, 100, (b, f))
        cx, cy = rng.uniform(-20, w + 20, (b, f)), rng.uniform(-20, h + 20,
                                                               (b, f))
    if kind == "outside":
        cx = rng.uniform(w + 200, w + 400, (b, f)) * rng.choice([-1, 1],
                                                                (b, f))
        cy = rng.uniform(-400, -200, (b, f))
    theta = rng.uniform(-math.pi, math.pi, (b, f))
    return [torch.from_numpy(a.astype(np.float32))
            for a in (cx, cy, size, theta)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.uint8, torch.float32])
@pytest.mark.parametrize("kind", ["up", "down", "outside"])
@pytest.mark.parametrize("s", [17, 64, 112, 192])
def test_warp_kernel_matches_plain(cuda_device, s, kind, dtype):
    """Bit for bit, at every crop size of the pipeline (17 leaves a ragged
    band of output rows), with mixed mirrors; one launch per call."""
    b, f, h, w = 4, 16, 853, 1280
    frames = torch.randint(0, 256, (b, h, w, 3), dtype=torch.uint8,
                           generator=torch.Generator().manual_seed(0))
    frames = frames.to(cuda_device, dtype)
    cx, cy, size, theta = (t.to(cuda_device)
                           for t in _warp_rois(kind, b, f, h, w))
    flip = (torch.arange(b * f).reshape(b, f) % 3 == 0).to(cuda_device)
    ct, st = theta.cos(), theta.sin()
    before = warp.warp_normalize.launches
    got = warp.warp_normalize(frames, cx, cy, size, ct, st, out_size=s,
                              flip=flip)
    torch.cuda.synchronize()
    assert warp.warp_normalize.launches == before + 1
    want = warp.warp_normalize_plain(frames, cx, cy, size, ct, st,
                                     out_size=s, flip=flip)
    assert (got - want).abs().max().item() == 0


@pytest.mark.parametrize("s", [0, warp.MAX_OUT_SIZE + 1])
def test_warp_rejects_unsupported_out_size(s):
    """The wrapper takes the crop sizes the kernel takes, on every device."""
    frames = torch.zeros((1, 8, 8, 3), dtype=torch.uint8)
    z = torch.zeros((1, 2))
    before = warp.warp_normalize.launches
    with pytest.raises(ValueError, match="out_size"):
        warp.warp_normalize(frames, z, z, z, z, z, out_size=s)
    assert warp.warp_normalize.launches == before


@pytest.mark.cuda
def test_executor_runs_fp32_on_the_card(cuda_device, monkeypatch):
    """TF32 off: the card's convs agree with the CPU's to fp32 rounding
    (TF32 would leave ~1e-3 relative); a card forward with cuDNN's TF32
    on raises."""
    model = convert_model(random_init.face_mesh_ir(0, blocks_per_stage=1))
    x = torch.rand(4, 192, 192, 3, generator=torch.Generator().manual_seed(1))
    with torch.inference_mode():
        want = model(x * 2 - 1)
        got = model.to(cuda_device)((x * 2 - 1).to(cuda_device))
        monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
        with pytest.raises(RuntimeError, match="allow_tf32"):
            model((x * 2 - 1).to(cuda_device))
    for g, r in zip(got, want):
        err = (g.cpu() - r).abs().max() / r.abs().max()
        assert err.item() <= 1e-5


@pytest.mark.cuda
def test_warp_iris_site_matches_plain(cuda_device):
    """K2 at its iris site: 64 px crops, two eyes a face with every right
    eye mirrored, and eye ROIs whose size rounds to 0 (a degenerate mesh),
    bit for bit; one launch."""
    b, f, h, w = 4, 16, 853, 1280
    frames = torch.randint(0, 256, (b, h, w, 3), dtype=torch.uint8,
                           generator=torch.Generator().manual_seed(2)
                           ).to(cuda_device)
    cx, cy, size, theta = (t.to(cuda_device)
                           for t in _rois(3, b, 2 * f, h, w))
    size[:, :4] = torch.tensor([0.0, 0.3, 0.49, 0.5])
    flip = (torch.arange(2 * f, device=cuda_device) % 2 == 1).expand(b, -1)
    ct, st = theta.cos(), theta.sin()
    before = warp.warp_normalize.launches
    got = warp.warp_normalize(frames, cx, cy, size, ct, st, out_size=64,
                              flip=flip.contiguous())
    torch.cuda.synchronize()
    assert warp.warp_normalize.launches == before + 1
    want = warp.warp_normalize_plain(frames, cx, cy, size, ct, st,
                                     out_size=64, flip=flip)
    assert (got - want).abs().max().item() == 0


@pytest.mark.cuda
def test_full_path_card_matches_cpu(cuda_device):
    """The seeded FULL program (one block per stage) on the card against
    the CPU on two 853x1280 frames: valid and blendshapes_valid equal,
    keypoints within 1e-4, mesh and iris within 1e-2 px or 1e-5 of their
    largest magnitude, blendshapes within 1e-4, head angles within 0.1
    degree."""
    from face_detection_tflite_torch.pipeline.config import FaceDetectionMode
    from face_detection_tflite_torch.pipeline.programs import (
        PipelineModels, build_pipeline_program)
    frames = torch.randint(0, 256, (2, 853, 1280, 3), dtype=torch.uint8,
                           generator=torch.Generator().manual_seed(4))
    _, *irs = random_init.random_pipeline_models(
        frames, seed=3, detector_blocks=1, mesh_blocks=1, iris_blocks=1,
        mixer_blocks=1)

    def models(device):
        det, mesh, iris, bs = (convert_model(ir) for ir in irs)
        return PipelineModels(det, "back", mesh=mesh, device=device,
                              iris=iris, blendshapes=bs)

    with torch.inference_mode():
        got = build_pipeline_program(models(cuda_device), 853, 1280,
                                     FaceDetectionMode.FULL)(
            frames.to(cuda_device))
        want = build_pipeline_program(models("cpu"), 853, 1280,
                                      FaceDetectionMode.FULL)(frames)
    got = {k: v.cpu().numpy() for k, v in got.items()}
    want = {k: v.numpy() for k, v in want.items()}
    assert want["valid"].any()
    for key in ("valid", "blendshapes_valid"):
        np.testing.assert_array_equal(got[key], want[key])
    for key in ("boxes", "raw_keypoints", "keypoints", "blendshapes"):
        assert np.abs(got[key] - want[key]).max() <= 1e-4, key
    for key in ("mesh", "iris"):
        tol = max(1e-2, 1e-5 * np.abs(want[key]).max())
        assert np.abs(got[key] - want[key]).max() <= tol, key
    np.testing.assert_array_equal(np.isnan(got["head_angles"]),
                                  np.isnan(want["head_angles"]))
    assert np.nanmax(np.abs(got["head_angles"] - want["head_angles"])) <= 0.1


@pytest.mark.cuda
def test_mobilefacenet_card_matches_cpu(cuda_device):
    """The seeded full-width MobileFaceNet on cuDNN (fp32, TF32 off)
    against the CPU: unit vectors within 1e-5."""
    from face_detection_tflite_torch.models.embedding import \
        build_mobilefacenet
    net = build_mobilefacenet(0)
    x = torch.rand(16, 112, 112, 3,
                   generator=torch.Generator().manual_seed(5)) * 2 - 1
    with torch.inference_mode():
        (want,) = net(x)
        (got,) = net.to(cuda_device)(x.to(cuda_device))
    unit = want / want.norm(dim=-1, keepdim=True)
    got = got.cpu()
    assert (got / got.norm(dim=-1, keepdim=True) - unit).abs().max() <= 1e-5


@pytest.mark.cuda
def test_full_embedding_batch_launches_k2_at_each_site(cuda_device):
    """One FULL batch with the fused embedding stage launches K2 once at
    each of its sites (192 px mesh, 64 px eyes, 112 px embedding crops)
    and returns unit-norm embeddings for the valid faces."""
    from face_detection_tflite_torch.pipeline.config import FaceDetectionMode
    from face_detection_tflite_torch.pipeline.programs import \
        build_pipeline_program
    frames = torch.randint(0, 256, (2, 853, 1280, 3), dtype=torch.uint8,
                           generator=torch.Generator().manual_seed(4)
                           ).to(cuda_device)
    models, *_ = random_init.random_pipeline_models(
        frames, seed=3, detector_blocks=1, mesh_blocks=1, iris_blocks=1,
        mixer_blocks=1)
    prog = build_pipeline_program(models, 853, 1280, FaceDetectionMode.FULL,
                                  with_embeddings=True)
    before = dict(warp.warp_normalize.launches_by_size)
    with torch.inference_mode():
        out = prog(frames)
    torch.cuda.synchronize()
    after = warp.warp_normalize.launches_by_size
    launched = {s: n - before.get(s, 0) for s, n in after.items()}
    assert {s: n for s, n in launched.items() if n} == \
        {192: 1, 64: 1, 112: 1}
    emb = out["embeddings"][out["valid"]]
    assert emb.shape[0] >= 1 and emb.shape[1] == 192
    assert (emb.norm(dim=-1) - 1).abs().max().item() <= 1e-5


def _small_card_detector(device, frames):
    from face_detection_tflite_torch import FaceDetector
    models, *_ = random_init.random_pipeline_models(
        frames, seed=3, detector_blocks=1, mesh_blocks=1, iris_blocks=1,
        mixer_blocks=1)
    return FaceDetector(models=models, device=device, max_faces=16), models


def _assert_same_faces(got, want, step):
    """Counts equal; boxes, scores and blendshapes within 1e-6; mesh and
    iris within one int16 readback step ``step`` px (plus rounding)."""
    assert [len(f) for f in got] == [len(f) for f in want]
    for g, w in zip((f for per in got for f in per),
                    (f for per in want for f in per)):
        gb, wb = g.bounding_box, w.bounding_box
        assert abs(g.score - w.score) <= 1e-6
        assert max(abs(gb.xmin - wb.xmin), abs(gb.ymin - wb.ymin),
                   abs(gb.xmax - wb.xmax), abs(gb.ymax - wb.ymax)) <= 1e-6
        assert np.abs(g.mesh.points - w.mesh.points).max() <= step + 1e-3
        assert np.abs(g.iris_points - w.iris_points).max() <= step + 1e-3
        assert np.abs(g.blendshapes.scores - w.blendshapes.scores
                      ).max() <= 1e-6


@pytest.mark.cuda
def test_stream_matches_batch_calls_on_the_card(cuda_device):
    """``detect_faces_batch_stream`` at depth 2 over FULL batches of two
    shapes equals the same batches' ``detect_faces_batch`` calls, with one
    K1 launch a batch."""
    rng = np.random.default_rng(7)
    frames = rng.integers(0, 256, (4, 427, 640, 3), dtype=np.uint8)
    det, _ = _small_card_detector(cuda_device,
                                  torch.from_numpy(frames).to(cuda_device))
    batches = [frames, frames[:2, :320, :480].copy(), frames[::-1].copy()]
    for b in batches:   # both shapes at their steady speculation state
        det.detect_faces_batch(b)
    want = [det.detect_faces_batch(b) for b in batches]
    before = detections.detection_postprocess.launches
    got = list(det.detect_faces_batch_stream(batches, depth=2))
    assert detections.detection_postprocess.launches - before == 3
    assert sum(len(f) for per in got for f in per) >= 4
    for g, w, b in zip(got, want, batches):
        _assert_same_faces(g, w, 2.0 * max(b.shape[1:3]) / 32000.0)


@pytest.mark.cuda
def test_two_threads_run_bit_identical(cuda_device):
    """The FULL program and MobileFaceNet on two threads at once give
    their single-threaded outputs bit for bit (TF32 stays off)."""
    import threading
    from face_detection_tflite_torch.pipeline.config import FaceDetectionMode
    from face_detection_tflite_torch.pipeline.programs import \
        build_pipeline_program
    frames = torch.randint(0, 256, (2, 427, 640, 3), dtype=torch.uint8,
                           generator=torch.Generator().manual_seed(4)
                           ).to(cuda_device)
    _, models = _small_card_detector(cuda_device, frames)
    prog = build_pipeline_program(models, 427, 640, FaceDetectionMode.FULL)
    crops = torch.rand((16, 112, 112, 3), device=cuda_device) * 2 - 1
    with torch.inference_mode():
        want_full, (want_emb,) = prog(frames), models.embedding(crops)
    bad = []

    def run(fn, check):
        with torch.inference_mode():
            for i in range(10):
                out = fn()
                torch.cuda.synchronize()
                if not check(out):
                    bad.append(i)

    def bits(t):   # NaN (empty slots' head angles) equals itself
        return t.view(torch.int32) if t.dtype == torch.float32 else t

    threads = [
        threading.Thread(target=run, args=(lambda: prog(frames), lambda o: all(
            torch.equal(bits(o[k]), bits(want_full[k])) for k in want_full))),
        threading.Thread(target=run, args=(
            lambda: models.embedding(crops),
            lambda o: torch.equal(bits(o[0]), bits(want_emb))))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not bad


@pytest.mark.cuda
def test_pinned_upload_of_a_reused_buffer(cuda_device):
    """A caller's numpy buffer mutated in place between two uploads: each
    upload holds the frame as it was when uploaded, through the reused
    pinned ring, on the caller's stream."""
    from face_detection_tflite_torch.pipeline.upload import RING_SLOTS, upload
    buf = np.random.default_rng(1).integers(0, 256, (2, 64, 96, 3),
                                            dtype=np.uint8)
    old = buf.copy()
    first = upload(buf, cuda_device)
    np.subtract(255, buf, out=buf)
    second = upload(buf, cuda_device)
    outs = []
    for i in range(2 * RING_SLOTS + 1):
        buf[:] = i
        outs.append(upload(buf, cuda_device))
    torch.cuda.synchronize()
    assert np.array_equal(first.cpu().numpy(), old)
    assert np.array_equal(second.cpu().numpy(), 255 - old)
    for i, t in enumerate(outs):
        assert t.is_cuda and t.dtype == torch.uint8 and bool((t == i).all())
    f = upload(buf.astype(np.float64), cuda_device)
    assert f.dtype == torch.float32 and upload(f, cuda_device) is f


@pytest.mark.cuda
def test_standalone_face_detection_card_matches_cpu(cuda_device):
    """Standalone ``FaceDetection`` (one-block seeded BlazeFace) on an
    853x1280 frame: one K1 launch a call on the card, and the card's
    detections equal the CPU's in count, with boxes and keypoints within
    1e-4 and scores within 1e-6."""
    from face_detection_tflite_torch import FaceDetection
    frame = torch.randint(0, 256, (1, 853, 1280, 3), dtype=torch.uint8,
                          generator=torch.Generator().manual_seed(4))
    _, det_ir, *_ = random_init.random_pipeline_models(
        frame, seed=3, detector_blocks=1, mesh_blocks=1, iris_blocks=1,
        mixer_blocks=1)
    img = frame[0].numpy()
    card = FaceDetection(model=convert_model(det_ir), device=cuda_device)
    cpu = FaceDetection(model=convert_model(det_ir), device="cpu")
    before = detections.detection_postprocess.launches
    got = card(img)
    assert detections.detection_postprocess.launches - before == 1
    want = cpu(img)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        gb, wb = g.bounding_box, w.bounding_box
        assert max(abs(gb.xmin - wb.xmin), abs(gb.ymin - wb.ymin),
                   abs(gb.xmax - wb.xmax), abs(gb.ymax - wb.ymax)) <= 1e-4
        assert np.abs(g.keypoints_xy - w.keypoints_xy).max() <= 1e-4
        assert abs(g.score - w.score) <= 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["full", "front"])
def test_postprocess_kernel_on_variant_networks(cuda_device, variant):
    """K1 on the raw outputs of the full-depth seeded full-range (A = 2304
    on one 48x48 layer, 192 px) and front (A = 896, 128 px) detectors,
    calibrated to ~32 passing anchors a frame, for four 853x1280 frames:
    one launch, and valid, scores and keypoints equal to the plain
    version's, boxes within 1e-6."""
    from face_detection_tflite_torch.ops.letterbox import letterbox_image
    from face_detection_tflite_torch.pipeline.programs import (
        _identify_detector_outputs, detector_anchors)
    frames = torch.randint(0, 256, (4, 853, 1280, 3), dtype=torch.uint8,
                           generator=torch.Generator().manual_seed(5)
                           ).to(cuda_device)
    det_ir = random_init.calibrated_detector_ir(variant, frames, seed=3)
    model = convert_model(det_ir).to(cuda_device)
    size = model.input_shapes[0][1]
    anchors = torch.from_numpy(detector_anchors(model, variant)).to(
        cuda_device)
    pad = letterbox_params(853, 1280, size, size)
    with torch.inference_mode():
        raw_boxes, raw_scores = _identify_detector_outputs(
            model(letterbox_image(frames, pad)))
        args = (raw_boxes, raw_scores, anchors, float(size), pad.padding)
        before = detections.detection_postprocess.launches
        got = detections.detection_postprocess(*args, max_detections=16)
        torch.cuda.synchronize()
        assert detections.detection_postprocess.launches - before == 1
        want = detections.detection_postprocess_plain(*args,
                                                      max_detections=16)
    assert raw_scores.shape[1] == anchors.shape[0]
    assert want[3].any()
    for g, w in zip(got[1:], want[1:]):
        assert torch.equal(g, w)
    assert (got[0] - want[0]).abs().max().item() <= 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["general", "landscape", "multiclass"])
def test_segmenters_card_match_cpu(cuda_device, kind):
    """The full-width seeded segmenters on the card against the CPU on two
    853x1280 frames: the person plane and the class planes within 1e-4,
    the letterbox padding equal."""
    from face_detection_tflite_torch.models.segmentation import \
        SelfieSegmentation
    frames = torch.randint(0, 256, (2, 853, 1280, 3), dtype=torch.uint8,
                           generator=torch.Generator().manual_seed(6))
    ir = random_init.segmenter_ir(kind, seed=8)
    multiclass = kind == "multiclass"
    got = SelfieSegmentation(convert_model(ir), multiclass,
                             device=cuda_device)(frames.to(cuda_device))
    want = SelfieSegmentation(convert_model(ir), multiclass,
                              device="cpu")(frames)
    for g, w in zip(got, want):
        assert g.padding == w.padding
        assert np.abs(g.data - w.data).max() <= 1e-4
        if multiclass:
            assert np.abs(g.class_data - w.class_data).max() <= 1e-4
