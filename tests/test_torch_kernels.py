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

from face_detection_tflite_torch.convert.executor import convert_model
from face_detection_tflite_torch.kernels import build
from face_detection_tflite_torch.models import random_init
from face_detection_tflite_torch.ops import nms, warp
from face_detection_tflite_torch.ops.detections import _topk_candidates


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


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
                                    (2304, 0.05)])
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
@pytest.mark.parametrize("dtype", [torch.uint8, torch.float32])
def test_warp_kernel_matches_plain(cuda_device, dtype):
    b, f, h, w, s = 4, 16, 853, 1280, 192
    frames = torch.randint(0, 256, (b, h, w, 3), dtype=torch.uint8,
                           generator=torch.Generator().manual_seed(0))
    frames = frames.to(cuda_device, dtype)
    cx, cy, size, theta = (t.to(cuda_device) for t in _rois(2, b, f, h, w))
    flip = (torch.arange(b * f).reshape(b, f) % 3 == 0).to(cuda_device)
    ct, st = theta.cos(), theta.sin()
    before = warp.warp_normalize.launches
    got = warp.warp_normalize(frames, cx, cy, size, ct, st, out_size=s,
                              flip=flip)
    torch.cuda.synchronize()
    assert warp.warp_normalize.launches == before + 1
    want = warp.warp_normalize_plain(frames, cx, cy, size, ct, st,
                                     out_size=s, flip=flip)
    assert (got - want).abs().max().item() <= 1e-6


@pytest.mark.cuda
def test_executor_runs_fp32_on_the_card(cuda_device):
    """TF32 off: the card's convs agree with the CPU's to fp32 rounding
    (TF32 would leave ~1e-3 relative)."""
    model = convert_model(random_init.face_mesh_ir(0, blocks_per_stage=1))
    x = torch.rand(4, 192, 192, 3, generator=torch.Generator().manual_seed(1))
    with torch.inference_mode():
        want = model(x * 2 - 1)
        got = model.to(cuda_device)((x * 2 - 1).to(cuda_device))
    for g, r in zip(got, want):
        err = (g.cpu() - r).abs().max() / r.abs().max()
        assert err.item() <= 1e-5
