"""The depthwise convolution with its bias and activation
(``ops/depthwise.py``, K7 on a card) on the CPU: the executor's plan,
which gives K7 every float32 depthwise convolution it has with the bias
pass or the RELU or PRELU pass after it, the routes it leaves to the
library, its plain version against the op sequence it replaces (bit for
bit), the rounding bound the card tests hold the kernel to, the
wrapper's refusals, MobileFaceNet's routing and the counts
``FaceDetector.memory_report()`` reports.  The kernel itself is held to
the plain version in ``test_torch_kernels.py`` on the card."""

import numpy as np
import pytest
import torch

from face_detection_tflite_torch.convert import executor
from face_detection_tflite_torch.convert.executor import (conv2d,
                                                          convert_model)
from face_detection_tflite_torch.convert.tflite import PADDING_SAME
from face_detection_tflite_torch.models import embedding, random_init
from face_detection_tflite_torch.ops import depthwise, epilogue
from face_detection_tflite_torch.pipeline.detector import FaceDetector

from .depthwise_sites import GRAPHS as BENCH_GRAPHS
from .depthwise_sites import SITE_IDS, SITES, site_args
from .test_torch_epilogue import (_bits, _check_planned_against_unplanned,
                                  _graph, _on_grid, _plant_conv_outputs,
                                  _stem)

#: The benchmark's graphs and the other detector variants and segmenters,
#: which run the same executor.
GRAPHS = {
    **BENCH_GRAPHS,
    "front_detector": lambda: random_init.blazeface_front_ir(5),
    "full_range_detector": lambda: random_init.blazeface_full_range_ir(5),
    "segmenter": lambda: random_init.selfie_segmenter_ir(5),
    "landscape_segmenter": lambda: random_init.selfie_segmenter_ir(
        5, landscape=True),
}


@pytest.mark.parametrize("role", sorted(GRAPHS))
def test_plan_gives_every_depthwise_convolution_to_k7(role):
    """Each float32 DEPTHWISE_CONV_2D of the graphs is a K7 site with its
    bias, no bias pass of its own is left for it, and no pass reads its
    output: K7 took the RELU or PRELU pass that did (its op absorbed)."""
    m = convert_model(GRAPHS[role]())
    dws = {i for i, op in enumerate(m._ops)
           if op.name == "DEPTHWISE_CONV_2D"}
    assert dws and set(m._depthwise) == dws
    assert not dws & set(m._bias_passes) and not dws & m._bias_folded
    outs = {m._ops[i].outputs[0] for i in dws}
    assert not {ep.y for ep in m._epilogues.values()} & outs
    for i, dw in m._depthwise.items():
        assert dw.bias == m._ops[i].inputs[2]
        if dw.out != m._ops[i].outputs[0]:
            (k,) = [j for j, op in enumerate(m._ops)
                    if op.outputs[0] == dw.out]
            assert k in m._absorbed and m._ops[k].name == dw.act
    assert not m._op_by_op


def _dw(g, x, stride=1, k=3, act=None, bias=True, explicit_pad=False):
    """A depthwise convolution with a seeded nonzero bias (or none)."""
    y = g.depthwise(x, stride, k=k, explicit_pad=explicit_pad, act=act)
    op = g.ops[-1]
    if bias:
        c = g.shape(x)[3]
        op.inputs[2] = g.weight(g.rng.normal(0, 0.1, c).astype(np.float32))
    else:
        op.inputs[2] = -1
    return y


def _into_conv(g):
    x, h = _stem(g)
    return [x], [g.conv(_dw(g, h), 8, 1)]


def _two_readers(g):
    x, h = _stem(g)
    y = _dw(g, h)
    return [x], [g.conv(y, 8, 1), g.op("RELU", [y], g.shape(y))]


def _fused_relu(g):
    x, h = _stem(g)
    return [x], [_dw(g, h, act="RELU")]


def _fused_relu6(g):
    x, h = _stem(g)
    return [x], [_dw(g, h, act="RELU6")]


def _into_relu(g):
    x, h = _stem(g, size=10)
    y = _dw(g, h, stride=2)
    return [x], [g.conv(g.op("RELU", [y], g.shape(y)), 8, 1)]


def _into_prelu(g):
    x, h = _stem(g, c=12, size=12)
    return [x], [g.conv(g.prelu(_dw(g, h, stride=2, k=5)), 8, 1)]


def _into_add_relu(g):
    x, h = _stem(g)
    return [x], [g.op("ADD", [_dw(g, h), h], g.shape(h), activation="RELU")]


def _graph_output(g):
    x, h = _stem(g)
    y = g.prelu(_dw(g, h, k=7))
    return [x], [y, g.op("RELU", [y], g.shape(y))]


def _no_bias(g):
    x, h = _stem(g, c=6, size=7)
    return [x], [_dw(g, h, stride=2, k=3, act="RELU", bias=False)]


def _explicit_pad(g):
    x, h = _stem(g, c=16, size=10)
    return [x], [g.conv(_dw(g, h, stride=2, explicit_pad=True), 8, 1)]


#: name -> (graph, K7's act, whether K7 adds the bias, the op K7 took
#: (absorbed), the passes left, the ops left after the depthwise one).
PATTERNS = {
    "into_conv": (_into_conv, None, True, None, 0, ["CONV_2D"]),
    "two_readers": (_two_readers, None, True, None, 0, ["CONV_2D", "RELU"]),
    "fused_relu": (_fused_relu, "RELU", True, None, 0, []),
    "fused_relu6": (_fused_relu6, None, True, None, 0, []),
    "into_relu_s2_asymmetric": (_into_relu, "RELU", True, "RELU", 0,
                                ["CONV_2D"]),
    "into_prelu_k5_s2": (_into_prelu, "PRELU", True, "PRELU", 0,
                         ["CONV_2D"]),
    # A pass with a residual stays K5's, with the bias it took.
    "into_add_relu": (_into_add_relu, None, False, None, 1, []),
    # The PRELU's output is a graph output (and has a second reader): its
    # pass stays.
    "graph_output_k7": (_graph_output, None, False, None, 1, ["RELU"]),
    "no_bias_s2": (_no_bias, "RELU", False, None, 0, []),
    "explicit_pad_valid_s2": (_explicit_pad, None, True, None, 0,
                              ["CONV_2D"]),
}


@pytest.mark.parametrize("name", sorted(PATTERNS))
def test_plan_at_each_depthwise_pattern(name, monkeypatch):
    """The plan gives the depthwise convolution to K7 with the bias and
    activation each pattern allows, and the planned model (K7's plain
    version here) equals the ops one by one bit for bit, -0.0, NaN and
    inf planted in the convolutions' outputs, biases and the input."""
    build, act, bias, took, passes, after = PATTERNS[name]
    ir = _graph(build)
    m = convert_model(ir)
    ((i, dw),) = m._depthwise.items()
    assert (dw.act, dw.bias is not None) == (act, bias)
    taken = [j for j in m._absorbed if m._ops[j].name != "PAD"]
    assert [m._ops[j].name for j in taken] == ([took] if took else [])
    assert len(m._epilogues) == passes and not m._op_by_op
    assert i not in m._bias_passes
    live = [op.name for j, op in enumerate(m._ops) if j > i and
            j not in m._epilogues and j not in m._absorbed]
    assert live == after
    _plant_conv_outputs(monkeypatch)
    _check_planned_against_unplanned(ir, specials=True)


@pytest.mark.parametrize("grid", ["prelu_output", "depthwise_output"])
def test_plan_with_an_output_on_an_int8_grid(grid, monkeypatch):
    """A PRELU whose output lies on an int8 grid stays a K5 pass, with the
    bias it took, and K7 runs the convolution alone; a depthwise output
    on a grid takes its bias in K7 and is snapped after it.  Either way
    the planned model equals the unplanned one bit for bit."""
    ir = _graph(_into_prelu)
    dw_op = next(op for op in ir.ops if op.name == "DEPTHWISE_CONV_2D")
    prelu = next(op for op in ir.ops if op.name == "PRELU")
    t = prelu.outputs[0] if grid == "prelu_output" else dw_op.outputs[0]
    m = convert_model(_on_grid(ir, [t]))
    ((i, dw),) = m._depthwise.items()
    if grid == "prelu_output":
        assert (dw.act, dw.bias) == (None, None)
        ((k, ep),) = m._epilogues.items()
        assert m._ops[k].name == "PRELU" and ep.bias == dw_op.inputs[2]
    else:
        # The depthwise output has no pass to join: the PRELU runs alone.
        assert (dw.act, dw.bias) == (None, dw_op.inputs[2])
        assert [m._ops[k].name for k in m._epilogues] == ["PRELU"]
    _plant_conv_outputs(monkeypatch)
    _check_planned_against_unplanned(ir, specials=True)


def _library_graph(multiplier=1, dilation=1, k=3, stride=1):
    def build(g):
        x, h = _stem(g, c=4, size=10)
        c = g.shape(h)[3]
        wt = g.rng.normal(0, 0.3, (1, k, k, c * multiplier)).astype(
            np.float32)
        y = g.op("DEPTHWISE_CONV_2D",
                 [h, g.weight(wt), g.weight(g.rng.normal(
                     0, 0.1, c * multiplier).astype(np.float32))],
                 (1, -(-10 // stride), -(-10 // stride), c * multiplier),
                 padding=PADDING_SAME, stride_w=stride, stride_h=stride,
                 depth_multiplier=multiplier, activation=None,
                 dilation_w=dilation, dilation_h=dilation)
        return [x], [g.op("RELU", [y], g.shape(y))]
    return build


@pytest.mark.parametrize("case", ["bf16_tier", "multiplier_2",
                                  "dilation_2", "k_9", "stride_3"])
def test_library_keeps_what_k7_does_not_have(case, monkeypatch):
    """A bf16 tier, a channel multiplier above 1, a dilation above 1, a
    filter size or a stride K7 has not: the convolution stays with
    ``F.conv2d`` through ``executor.conv2d`` (``depthwise_library`` on a
    card), and its bias takes the K5 pass as before."""
    kwargs = {"multiplier_2": dict(multiplier=2),
              "dilation_2": dict(dilation=2), "k_9": dict(k=9),
              "stride_3": dict(stride=3)}.get(case, {})
    ir = _graph(_library_graph(**kwargs))
    m = convert_model(ir, precision="default" if case == "bf16_tier"
                      else "highest")
    assert not m._depthwise
    groups = []
    real = executor.conv2d

    def spy(*args, **kw):
        groups.append(kw.get("groups", 1))
        return real(*args, **kw)

    monkeypatch.setattr(executor, "conv2d", spy)
    entered = []
    monkeypatch.setattr(executor, "depthwise_conv",
                        lambda *a, **kw: entered.append(a))
    x = torch.from_numpy(np.random.default_rng(1).normal(
        0, 1, (2, 10, 10, 3)).astype(np.float32))
    with torch.inference_mode():
        (y,) = m(x)
    assert groups == [1, 4] and not entered
    assert torch.isfinite(y).all()


@pytest.mark.parametrize("site", SITES, ids=SITE_IDS)
def test_plain_equals_the_routes_it_replaces_bit_for_bit(site):
    """At each site of the benchmark's networks the wrapper on the CPU
    (its plain version) gives bit for bit what the networks ran before
    K7: ``executor.conv2d`` (an ``F.pad`` copy where the pads are
    asymmetric), then K5's pass of the bias and activation, in place
    where it has no PReLU; -0.0, NaN and inf planted in the input."""
    x, wt, bias, s, pads, act, alpha = site_args(site, SITES.index(site))
    with torch.inference_mode():
        y, rest = conv2d(x, wt, bias, stride=(s, s), pads=pads,
                         groups=x.shape[3])
        want = epilogue.residual_act(y, None, act, alpha, rest,
                                     inplace=act != "PRELU")
        before = depthwise.depthwise_conv.launches
        got = depthwise.depthwise_conv(x, wt, bias, stride=s, pads=pads,
                                       act=act, alpha=alpha)
    assert depthwise.depthwise_conv.launches == before
    assert got.shape == want.shape
    assert torch.equal(_bits(got), _bits(want))


@pytest.mark.parametrize("k", depthwise.SIZES)
@pytest.mark.parametrize("stride", depthwise.STRIDES)
@pytest.mark.parametrize("act", [None, *epilogue.ACTS])
def test_rounding_bound_covers_another_sum_order(k, stride, act):
    """The sum in another order (taps reversed, float32), then the bias
    and activation, lies within ``rounding_bound`` of the plain version
    at every finite output: the bound the card tests hold K7 to is not
    looser than a reordering needs and holds one."""
    g = torch.Generator().manual_seed(10 * k + stride)
    c, h = 6, 11
    x = torch.randn((2, h, h, c), generator=g) * 10
    wt = torch.randn((c, 1, k, k), generator=g)
    bias = torch.randn(c, generator=g)
    alpha = torch.rand(c, generator=g) * 4 - 2 if act == "PRELU" else None
    pads = (executor._same_pads(h, stride, k),) * 2
    want = depthwise.depthwise_conv_plain(x, wt, bias, stride=stride,
                                          pads=pads, act=act, alpha=alpha)
    (pt, pb), (pl, pr) = pads
    xp = torch.nn.functional.pad(x, (0, 0, pl, pr, pt, pb))
    oh, ow = want.shape[1:3]
    acc = torch.zeros_like(want)
    for dy in reversed(range(k)):
        for dx in reversed(range(k)):
            tap = xp[:, dy:dy + (oh - 1) * stride + 1:stride,
                     dx:dx + (ow - 1) * stride + 1:stride]
            acc = acc + tap * wt[:, 0, dy, dx]
    other = epilogue.residual_act_plain(acc, None, act, alpha, bias) \
        if act else acc + bias
    tol = depthwise.rounding_bound(x, wt, bias, alpha, stride=stride,
                                   pads=pads)
    assert tol.shape == want.shape
    assert bool(((other - want).abs().double() <= tol).all())


@pytest.mark.parametrize("args, error, match", [
    (dict(w=torch.ones(12, 1, 3, 3)), ValueError, "filter"),
    (dict(w=torch.ones(6, 1, 4, 4)), ValueError, "filter"),
    (dict(w=torch.ones(6, 1, 3, 5)), ValueError, "filter"),
    (dict(w=torch.ones(6, 2, 3, 3)), ValueError, "filter"),
    (dict(stride=3), ValueError, "stride"),
    (dict(x=torch.ones(2, 10, 12, 6)[:, ::2, ::2]), ValueError,
     "contiguous"),
    (dict(x=torch.ones(2, 5, 6, 6, dtype=torch.float64)), TypeError,
     "float32"),
    (dict(w=torch.ones(6, 1, 3, 3, dtype=torch.bfloat16)), TypeError,
     "float32"),
    (dict(x=torch.ones(5, 6, 6)), ValueError, "x must be"),
    (dict(act="PRELU"), ValueError, "alpha is given"),
    (dict(act="RELU", alpha=torch.ones(6)), ValueError, "alpha is given"),
    (dict(act="GELU"), ValueError, "act must be"),
    (dict(bias=torch.ones(5)), ValueError, "bias must be"),
    (dict(pads=((0, 0), (-1, 1))), ValueError, "pads"),
    (dict(x=torch.ones(2, 2, 6, 6)), ValueError, "smaller"),
])
def test_wrapper_refuses_what_k7_does_not_take(args, error, match):
    """A filter of another size, shape or multiplier, a stride K7 has
    not, a strided (not contiguous) or non-float32 input, a bad
    activation, bias or pad, an input smaller than the filter: the
    wrapper raises on the CPU as on a card, and on another device."""
    kw = dict(x=torch.ones(2, 5, 6, 6), w=torch.ones(6, 1, 3, 3),
              bias=None, stride=1, pads=((0, 0), (0, 0)), act=None,
              alpha=None)
    kw.update(args)
    with pytest.raises(error, match=match):
        depthwise.depthwise_conv(kw["x"], kw["w"], kw["bias"],
                                 stride=kw["stride"], pads=kw["pads"],
                                 act=kw["act"], alpha=kw["alpha"])
    with pytest.raises(ValueError, match="device"):
        depthwise.depthwise_conv(torch.empty((1, 4, 4, 4), device="meta"),
                                 torch.empty((4, 1, 3, 3), device="meta"),
                                 None, stride=1, pads=((1, 1), (1, 1)))


@pytest.mark.parametrize("shape, stride, dilation, taken", [
    ((8, 1, 3, 3), (1, 1), (1, 1), True),
    ((8, 1, 5, 5), (2, 2), (1, 1), True),
    ((8, 1, 7, 7), (1, 1), (1, 1), True),
    ((16, 1, 3, 3), (1, 1), (1, 1), False),
    ((8, 1, 3, 3), (1, 2), (1, 1), False),
    ((8, 1, 3, 3), (1, 1), (2, 2), False),
    ((8, 1, 1, 1), (1, 1), (1, 1), False),
    ((8, 1, 3, 5), (1, 1), (1, 1), False),
])
def test_takes_names_the_convolutions_k7_has(shape, stride, dilation,
                                             taken):
    assert depthwise.takes(8, shape, stride, dilation) is taken


def test_mobilefacenet_routes_its_depthwise_convolutions_to_k7(monkeypatch):
    """At a float32 tier each of MobileFaceNet's 17 depthwise convolutions
    is one ``depthwise_conv`` call with its bias and PReLU (gdconv its
    bias alone), and the output equals bit for bit the network's with
    every depthwise convolution run as before K7 (``executor.conv2d``,
    then ``residual_act``); at the "default" tier none enters it."""
    net = embedding.build_mobilefacenet(seed=5)
    g = torch.Generator().manual_seed(6)
    for key, b in net.named_buffers():
        if key.endswith("_b"):
            b.copy_(0.1 * torch.randn(b.shape, generator=g))
        elif key.endswith("_a"):
            b.copy_(torch.rand(b.shape, generator=g) - 0.5)
    x = torch.from_numpy(np.random.default_rng(3).uniform(
        -1, 1, (2, 112, 112, 3)).astype(np.float32))
    calls = []
    real = depthwise.depthwise_conv

    def count(x, w, bias, *, stride, pads, act=None, alpha=None):
        calls.append((x.shape[1], x.shape[3], w.shape[2], stride, act))
        return real(x, w, bias, stride=stride, pads=pads, act=act,
                    alpha=alpha)

    monkeypatch.setattr(embedding, "depthwise_conv", count)
    with torch.inference_mode():
        (got,) = net(x)
    assert calls == [(hw, c, k, s, "PRELU" if prelu else None)
                     for _, hw, c, k, s, prelu, _ in
                     embedding._depthwise_sites()]

    def before(x, w, bias, *, stride, pads, act=None, alpha=None):
        y, rest = conv2d(x, w, bias, stride=(stride, stride), pads=pads,
                         groups=x.shape[3])
        return epilogue.residual_act(y, None, act, alpha, rest,
                                     inplace=act is None)

    monkeypatch.setattr(embedding, "depthwise_conv", before)
    with torch.inference_mode():
        (want,) = net(x)
    assert torch.equal(_bits(got), _bits(want))
    calls.clear()
    monkeypatch.setattr(embedding, "depthwise_conv", count)
    low = embedding.build_mobilefacenet(seed=5, precision="default")
    with torch.inference_mode():
        low(x)
    assert not calls


def test_memory_report_counts_k7_and_the_library(monkeypatch):
    """``memory_report()`` gives the process's depthwise convolutions run
    in K7 (``depthwise_kernel``) and by ``F.conv2d`` on a card
    (``depthwise_library``): 0 off a card, then what the counters
    hold."""
    frames = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (2, 96, 144, 3), dtype=np.uint8))
    models, *_ = random_init.random_pipeline_models(
        frames, seed=2, detector_blocks=1, mesh_blocks=1, iris_blocks=1,
        mixer_blocks=1, per_image=12)
    det = FaceDetector(models=models, device="cpu")
    monkeypatch.setattr(depthwise.depthwise_conv, "launches", 0)
    monkeypatch.setattr(depthwise.library_depthwise, "launches", 0)
    det.detect_faces_batch(frames.numpy())
    report = det.memory_report()
    assert (report["depthwise_kernel"], report["depthwise_library"]) == \
        (0, 0)
    depthwise.library_depthwise()
    monkeypatch.setattr(depthwise.depthwise_conv, "launches", 85)
    report = det.memory_report()
    assert (report["depthwise_kernel"], report["depthwise_library"]) == \
        (85, 1)
