"""The 1x1 convolution with its epilogue (``ops/pointwise.py``, K6 on a
card) on the CPU: its plain version against MobileFaceNet's own
convolution and against the op sequence it replaces, the wrapper's
refusals, the network's ``[K, N]`` filter copies, its CPU forward (which
K6 does not enter) and the counts ``FaceDetector.memory_report()``
reports.  The kernel itself is held to the plain version in
``test_torch_kernels.py`` on the card."""

import numpy as np
import pytest
import torch

from face_detection_tflite_torch.convert.executor import conv2d
from face_detection_tflite_torch.models import embedding, random_init
from face_detection_tflite_torch.ops import epilogue, pointwise
from face_detection_tflite_torch.pipeline.detector import FaceDetector


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.int32)


#: MobileFaceNet's 32 1x1 convolutions: ``(name, H = W, K, N, PReLU,
#: residual)``.
SITES = embedding._pointwise_sites()


@pytest.fixture(scope="module")
def net():
    """The seeded network with nonzero biases and PReLU slopes."""
    m = embedding.build_mobilefacenet(seed=5)
    g = torch.Generator().manual_seed(6)
    for key, b in m.named_buffers():
        if key.endswith("_b"):
            b.copy_(0.1 * torch.randn(b.shape, generator=g))
        elif key.endswith("_a"):
            b.copy_(torch.rand(b.shape, generator=g) - 0.5)
    return m.eval()


def test_the_sites_are_the_networks_1x1_convolutions(net):
    ones = [name for name, kh, kw, *_ in embedding._mfn_layers(
        embedding.EMBEDDING_DIM) if kh == kw == 1]
    assert [s[0] for s in SITES] == ones and len(ones) == 32
    assert sum(s[5] for s in SITES) == 12
    for name, _, k, n, *_ in SITES:
        assert tuple(net._buffers[f"_kn_{name}_w"].shape) == (k, n)


@pytest.mark.parametrize("site", SITES, ids=[s[0] for s in SITES])
def test_plain_equals_the_networks_convolution_bit_for_bit(net, site):
    """At each site's shape, the plain version (what the wrapper runs on
    the CPU) and MobileFaceNet's ``_conv``, which calls the wrapper, give
    bit for bit what the network ran before K6: ``executor.conv2d`` of
    the OIHW filter, then one ``residual_act`` pass of its bias, PReLU
    and residual (in place where it has neither)."""
    name, hw, k, n, prelu, res = site
    g = torch.Generator().manual_seed(SITES.index(site))
    x = torch.randn((2, hw, hw, k), generator=g)
    r = torch.randn((2, hw, hw, n), generator=g) if res else None
    act = "PRELU" if prelu else None
    alpha = getattr(net, f"{name}_a") if prelu else None
    with torch.inference_mode():
        y, bias = conv2d(x, getattr(net, f"{name}_w"),
                         getattr(net, f"{name}_b"), stride=(1, 1),
                         pads=((0, 0), (0, 0)))
        want = epilogue.residual_act(y, r, act, alpha, bias,
                                     inplace=act is None and r is None)
        got = pointwise.pointwise_conv(
            x, net._buffers[f"_kn_{name}_w"], getattr(net, f"{name}_b"),
            act, alpha, r)
        conv = net._conv(name, x, prelu=prelu, residual=r)
    assert got.shape == (2, hw, hw, n)
    assert torch.equal(_bits(got), _bits(want))
    assert torch.equal(_bits(conv), _bits(want))


@pytest.mark.parametrize("act", [None, *epilogue.ACTS])
@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("bias", [False, True])
def test_plain_equals_the_op_sequence_for_every_epilogue(act, residual,
                                                         bias):
    """``executor.conv2d`` of the OIHW filter, then the bias, the residual
    and the activation one op at a time (K5's plain version), bit for
    bit, with -0.0, NaN and inf planted; with none of the three, the
    convolution alone."""
    g = torch.Generator().manual_seed(7)
    x = torch.randn((2, 5, 6, 16), generator=g)
    x.view(-1)[:5] = torch.tensor([-0.0, 0.0, float("nan"), float("inf"),
                                   float("-inf")])
    w = torch.randn((16, 12), generator=g)
    b = torch.randn(12, generator=g) if bias else None
    r = torch.randn((2, 5, 6, 12), generator=g) if residual else None
    if r is not None:
        r.view(-1)[:2] = torch.tensor([-0.0, float("nan")])
    alpha = torch.rand(12, generator=g) - 0.5 if act == "PRELU" else None
    y, rest = conv2d(x, w.t().contiguous().reshape(12, 16, 1, 1), b,
                     stride=(1, 1), pads=((0, 0), (0, 0)))
    want = y if rest is None and r is None and act is None else \
        epilogue.residual_act_plain(y, r, act, alpha, rest)
    got = pointwise.pointwise_conv(x, w, b, act, alpha, r)
    assert torch.equal(_bits(got), _bits(want))


@pytest.mark.parametrize("args, error, match", [
    (dict(w=torch.ones(16, 12, 3, 3)), ValueError, "1x1"),
    (dict(w=torch.ones(8, 12)), ValueError, "groups 1"),
    (dict(x=torch.ones(2, 10, 12, 16)[:, ::2, ::2]), ValueError,
     "contiguous"),
    (dict(x=torch.ones(2, 5, 6, 16, dtype=torch.float64)), TypeError,
     "float32"),
    (dict(w=torch.ones(16, 12, dtype=torch.bfloat16)), TypeError, "float32"),
    (dict(x=torch.ones(5, 6, 16)), ValueError, "x must be"),
    (dict(act="PRELU"), ValueError, "alpha is given"),
    (dict(act="RELU", alpha=torch.ones(12)), ValueError, "alpha is given"),
    (dict(act="GELU"), ValueError, "act must be"),
    (dict(bias=torch.ones(11)), ValueError, "bias must be"),
    (dict(residual=torch.ones(2, 5, 6, 16)), ValueError, "residual must"),
])
def test_wrapper_refuses_what_k6_does_not_take(args, error, match):
    """A filter that is not 1x1 or not of groups 1, a strided (not
    contiguous) or non-float32 input, a bad activation, bias or residual:
    the wrapper raises on the CPU as on a card, and on another device."""
    kw = dict(x=torch.ones(2, 5, 6, 16), w=torch.ones(16, 12), bias=None,
              act=None, alpha=None, residual=None)
    kw.update(args)
    with pytest.raises(error, match=match):
        pointwise.pointwise_conv(kw["x"], kw["w"], kw["bias"], kw["act"],
                                 kw["alpha"], kw["residual"])
    with pytest.raises(ValueError, match="device"):
        pointwise.pointwise_conv(torch.empty((1, 2, 2, 4), device="meta"),
                                 torch.empty((4, 4), device="meta"), None)


def test_filter_copies_follow_the_weights_and_stay_out_of_the_state():
    """Each 1x1 filter has a non-persistent ``[K, N]`` transpose at a
    float32 tier, re-derived when weights load; the state dict and the
    JAX params keep their keys; the "default" tier has none."""
    net = embedding.build_mobilefacenet(seed=8)
    kn = {k for k in net._buffers if k.startswith("_kn_")}
    assert len(kn) == 32
    assert not kn & set(net.state_dict())
    assert set(net.jax_params()) == set(net.state_dict())
    other = embedding.build_mobilefacenet(seed=9)
    net.load_state_dict(other.state_dict())
    for key in kn:
        w = getattr(net, key[len("_kn_"):])
        assert torch.equal(net._buffers[key],
                           w.reshape(w.shape[:2]).t().contiguous())
        assert net._buffers[key].is_contiguous()
    low = embedding.build_mobilefacenet(seed=8, precision="default")
    assert not any(k.startswith("_kn_") for k in low._buffers)


def test_cpu_forward_does_not_enter_k6(net, monkeypatch):
    """On the CPU each of the 32 1x1 convolutions calls the wrapper, which
    runs the plain version and launches nothing, and the output equals bit
    for bit the network's output with every convolution run as before K6
    (``executor.conv2d``, then ``residual_act``); the existing parity
    tests hold those values against the JAX package.  A width that is
    not a multiple of 4 (``embedding_dim`` 130) takes the same route."""
    x = torch.from_numpy(np.random.default_rng(3).uniform(
        -1, 1, (2, 112, 112, 3)).astype(np.float32))
    calls = []

    def count(*args):
        calls.append(tuple(args[1].shape))
        return pointwise.pointwise_conv(*args)

    monkeypatch.setattr(embedding, "pointwise_conv", count)
    launches = pointwise.pointwise_conv.launches
    with torch.inference_mode():
        (got,) = net(x)
    assert calls == [(k, n) for _, _, k, n, *_ in SITES]
    assert pointwise.pointwise_conv.launches == launches

    def before(self, name, x, stride=1, groups=1, prelu=True, same=True,
               residual=None):
        w = getattr(self, f"{name}_w")
        pads = ((embedding._same_pads(x.shape[1], stride, w.shape[2]),
                 embedding._same_pads(x.shape[2], stride, w.shape[3]))
                if same else ((0, 0), (0, 0)))
        y, bias = conv2d(x, w, getattr(self, f"{name}_b"),
                         stride=(stride, stride), pads=pads, groups=groups)
        act = "PRELU" if prelu else None
        return epilogue.residual_act(
            y, residual, act, getattr(self, f"{name}_a") if prelu else None,
            bias, inplace=act is None and residual is None)

    for dim, model in ((embedding.EMBEDDING_DIM, net),
                       (130, embedding.build_mobilefacenet(seed=5,
                                                           embedding_dim=130))):
        with torch.inference_mode():
            (got,) = model(x)
        with monkeypatch.context() as m:
            m.setattr(embedding.MobileFaceNet, "_conv", before)
            with torch.inference_mode():
                (want,) = model(x)
        assert got.shape == (2, dim)
        assert torch.equal(_bits(got), _bits(want))


def test_memory_report_counts_k6_and_the_library(monkeypatch):
    """``memory_report()`` gives the process's float32 1x1 convolutions
    run in K6 (``pointwise_kernel``) and by ``F.conv2d`` on a card
    (``pointwise_library``): 0 off a card, then what the counters hold."""
    frames = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (2, 96, 144, 3), dtype=np.uint8))
    models, *_ = random_init.random_pipeline_models(
        frames, seed=2, detector_blocks=1, mesh_blocks=1, iris_blocks=1,
        mixer_blocks=1, per_image=12)
    det = FaceDetector(models=models, device="cpu")
    monkeypatch.setattr(pointwise.pointwise_conv, "launches", 0)
    monkeypatch.setattr(pointwise.library_convs, "launches", 0)
    det.detect_faces_batch(frames.numpy())
    report = det.memory_report()
    assert (report["pointwise_kernel"], report["pointwise_library"]) == (0, 0)
    pointwise.library_convs()
    pointwise.library_convs()
    monkeypatch.setattr(pointwise.pointwise_conv, "launches", 5)
    report = det.memory_report()
    assert (report["pointwise_kernel"], report["pointwise_library"]) == (5, 2)
