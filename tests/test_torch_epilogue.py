"""The residual-add-and-activation pass (``ops/epilogue.py``, K5 on a
card) on the CPU: its plain version against the op sequence it replaces,
the executor's plan over BlazeBlocks built with ``random_init``'s graph
builder, the planned models against the unplanned ones (bit for bit) and
against the JAX executor, the int8 detector, MobileFaceNet's PReLUs, and
the counts ``FaceDetector.memory_report()`` reports.  The kernel itself
is held to the plain version in ``test_torch_kernels.py`` on the card."""

import dataclasses

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from face_detection_tflite_torch.convert.executor import convert_model
from face_detection_tflite_torch.convert.tflite import PADDING_VALID
from face_detection_tflite_torch.models import embedding, random_init
from face_detection_tflite_torch.ops import epilogue
from face_detection_tflite_torch.pipeline.detector import FaceDetector

from .torch_parity import both_models, rel_err


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.int32)


def _specials(shape, seed) -> torch.Tensor:
    """Normal values with -0.0, +0.0, NaN, +inf and -inf planted."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(shape, generator=g)
    flat = x.view(-1)
    picks = torch.randperm(flat.numel(), generator=g)[:5 * 7]
    for j, v in enumerate((-0.0, 0.0, float("nan"), float("inf"),
                           float("-inf"))):
        flat[picks[j::5]] = v
    return x


def _unfused(y, r, act, alpha):
    """The executor's op sequence before the plan: PAD, ADD, then RELU or
    PRELU with its [1, 1, C] weight."""
    x = y
    if r is not None:
        if r.shape[3] < y.shape[3]:
            r = F.pad(r, [0, y.shape[3] - r.shape[3]])
        x = torch.add(x, r)
    if act == "RELU":
        x = torch.relu(x)
    else:
        a = alpha.reshape(1, 1, -1)
        x = torch.where(x >= 0, x, x * a)
    return x


@pytest.mark.parametrize("act", epilogue.ACTS)
@pytest.mark.parametrize("residual", ["none", "same", "padded"])
def test_plain_equals_the_unfused_ops_bit_for_bit(act, residual):
    y = _specials((2, 5, 6, 8), 1)
    r = {"none": None, "same": _specials((2, 5, 6, 8), 2),
         "padded": _specials((2, 5, 6, 4), 3)}[residual]
    alpha = (torch.rand(8, generator=torch.Generator().manual_seed(4)) - 0.5
             if act == "PRELU" else None)
    want = _unfused(y, r, act, alpha)
    got = epilogue.residual_act_plain(y, r, act, alpha)
    assert torch.equal(_bits(got), _bits(want))
    before = epilogue.residual_act.launches
    assert torch.equal(_bits(epilogue.residual_act(y, r, act, alpha)),
                       _bits(want))
    assert epilogue.residual_act.launches == before


def _unfused_with_bias(y, bias, r, act, alpha):
    """The convolution's bias add as the executor ran it before (after
    the convolution, on the NCHW view), then the ops of :func:`_unfused`
    (an act of None: the residual add alone)."""
    x = (y.permute(0, 3, 1, 2) + bias[:, None, None]).permute(0, 2, 3, 1)
    if act is None:
        if r.shape[3] < y.shape[3]:
            r = F.pad(r, [0, y.shape[3] - r.shape[3]])
        return torch.add(x, r)
    return _unfused(x, r, act, alpha)


@pytest.mark.parametrize("act", (None,) + epilogue.ACTS)
@pytest.mark.parametrize("residual", ["none", "same", "padded"])
def test_plain_with_a_bias_equals_the_unfused_ops_bit_for_bit(act,
                                                               residual):
    """``act((y + bias) + pad(r))``: the bias first, rounded, then the
    residual and the act, bit for bit as the ops one by one, with -0.0,
    NaN and +-inf planted in y, the bias and the residual; a bias pass
    alone (no act, no residual) is the bias add; in place the plain
    version returns the same values; off a card nothing is counted."""
    y = _specials((2, 5, 6, 8), 1)
    bias = _specials((40,), 5)[::5].contiguous()
    r = {"none": None, "same": _specials((2, 5, 6, 8), 2),
         "padded": _specials((2, 5, 6, 4), 3)}[residual]
    alpha = (torch.rand(8, generator=torch.Generator().manual_seed(4)) - 0.5
             if act == "PRELU" else None)
    if act is None and r is None:
        want = (y.permute(0, 3, 1, 2) + bias[:, None, None]).permute(
            0, 2, 3, 1)
    else:
        want = _unfused_with_bias(y, bias, r, act, alpha)
    assert torch.equal(_bits(epilogue.residual_act_plain(
        y, r, act, alpha, bias)), _bits(want))
    counts = [c.launches for c in (epilogue.residual_act, epilogue.ran_fused,
                                   epilogue.bias_folded, epilogue.bias_alone)]
    inplace = r is None and act != "PRELU"
    got = epilogue.residual_act(y.clone(), r, act, alpha, bias, inplace)
    assert torch.equal(_bits(got), _bits(want))
    assert counts == [c.launches for c in (
        epilogue.residual_act, epilogue.ran_fused, epilogue.bias_folded,
        epilogue.bias_alone)]


@pytest.mark.parametrize("args,match", [
    (dict(act="GELU"), "act must be"),
    (dict(act=None), "act must be"),
    (dict(act="PRELU"), "alpha is given"),
    (dict(act="RELU", alpha=torch.ones(8)), "alpha is given"),
    (dict(act="PRELU", alpha=torch.ones(7)), "alpha must be"),
    (dict(residual=torch.ones(2, 5, 6, 9)), "residual must be"),
    (dict(residual=torch.ones(2, 5, 5, 8)), "residual must be"),
    (dict(y=torch.ones(5, 6, 8)), "y must be"),
    (dict(bias=torch.ones(7)), "bias must be"),
    (dict(bias=torch.ones(1, 8)), "bias must be"),
    (dict(act="PRELU", alpha=torch.ones(8), bias=torch.ones(8),
          inplace=True), "in place"),
    (dict(residual=torch.ones(2, 5, 6, 8), bias=torch.ones(8),
          inplace=True), "in place"),
    (dict(inplace=True), "in place"),
])
def test_wrapper_rejects_bad_arguments_on_every_device(args, match):
    kw = dict(y=torch.ones(2, 5, 6, 8), residual=None, act="RELU",
              alpha=None, bias=None, inplace=False)
    kw.update(args)
    with pytest.raises(ValueError, match=match):
        epilogue.residual_act(kw["y"], kw["residual"], kw["act"], kw["alpha"],
                              kw["bias"], kw["inplace"])
    with pytest.raises(ValueError, match="device"):
        epilogue.residual_act(torch.empty((1, 2, 2, 4), device="meta"), None,
                              "RELU")


# -- the executor's plan ----------------------------------------------------


def _graph(build):
    """The port's IR of the graph ``build(g)`` makes on ``random_init``'s
    graph builder, returning its (inputs, outputs)."""
    g = random_init._Graph(np.random.default_rng(7))
    ins, outs = build(g)
    return g.ir(ins, outs, "test")


def _names(m, indices) -> list[str]:
    return sorted(m._ops[i].name for i in indices)


def _stem(g, c=8, size=6):
    """(graph input, a 1x1 convolution of it to ``c`` channels): the
    plan fuses activations that ops write."""
    x = g.tensor((1, size, size, 3))
    return x, g.conv(x, c, 1)


def _block(stride, prelu, cin=8, cout=16, size=12):
    def build(g):
        x, h = _stem(g, cin, size)
        return [x], [g.block(h, cout, stride=stride, prelu=prelu)]
    return build


def _stem_prelu(g):
    x = g.tensor((1, 12, 12, 3))
    return [x], [g.prelu(g.conv(x, 8, 3, stride=2))]


#: name -> (graph, the plan's anchor op, its residual's producer, the
#: absorbed ops, the pass's act).
PATTERNS = {
    "detector_block": (_block(1, False, cin=16), "ADD", "CONV_2D", [],
                       "RELU"),
    "detector_block_pad_s2": (_block(2, False), "ADD", "MAX_POOL_2D",
                              ["PAD"], "RELU"),
    "mesh_block": (_block(1, True, cin=16), "PRELU", "CONV_2D", ["ADD"],
                   "PRELU"),
    "mesh_block_pad": (_block(1, True), "PRELU", "CONV_2D", ["ADD", "PAD"],
                       "PRELU"),
    "iris_block_pad_s2": (_block(2, True), "PRELU", "MAX_POOL_2D",
                          ["ADD", "PAD"], "PRELU"),
    "stem_prelu": (_stem_prelu, "PRELU", None, [], "PRELU"),
}


@pytest.mark.parametrize("name", sorted(PATTERNS))
def test_plan_fuses_the_blazeblock_patterns(name):
    build, anchor, res_from, absorbed, act = PATTERNS[name]
    ir = _graph(build)
    m = convert_model(ir)
    ((i, ep),) = m._epilogues.items()
    assert not m._op_by_op
    assert m._ops[i].name == anchor and ep.act == act
    assert _names(m, m._absorbed) == sorted(absorbed)
    producer = {t: op.name for op in m._ops for t in op.outputs}
    if res_from is None:
        assert ep.residual is None
    else:
        assert producer[ep.residual] == res_from
    assert producer[ep.y] == "CONV_2D"
    assert (ep.alpha is not None) == (act == "PRELU")
    # A spatial PAD (before the stride-2 depthwise) is never absorbed.
    assert [op.name for op in m._ops].count("PAD") - absorbed.count("PAD") \
        == (1 if "s2" in name else 0)


def _add_then(g, x, act, pad=False):
    """conv(x) + x (x channel-padded where ``pad``)."""
    c = g.shape(x)[3]
    y = g.conv(x, 2 * c if pad else c, 1)
    r = g.pad(x, [[0, 0], [0, 0], [0, 0], [0, c]]) if pad else x
    return y, r, g.op("ADD", [y, r], g.shape(y), activation=act)


def _two_readers(g):
    x, h = _stem(g)
    _, _, s = _add_then(g, h, None)
    return [x], [g.prelu(s), g.op("RELU", [s], g.shape(s))]


def _graph_output(g):
    x, h = _stem(g)
    _, _, s = _add_then(g, h, None)
    return [x], [g.prelu(s), s]


def _pad_two_readers(g):
    x, h = _stem(g)
    y = g.conv(h, 16, 1)
    r = g.pad(h, [[0, 0], [0, 0], [0, 0], [0, 8]])
    s = g.op("ADD", [y, r], g.shape(y), activation="RELU")
    return [x], [s, g.op("RELU", [r], g.shape(r))]


def _spatial_pad(g):
    x = g.tensor((1, 6, 6, 3))
    y = g.conv(x, 8, 1)
    r = g.pad(g.conv(x, 8, 3, padding=PADDING_VALID),
              [[0, 0], [1, 1], [1, 1], [0, 0]])
    return [x], [g.op("ADD", [y, r], g.shape(y), activation="RELU")]


def _front_pad(g):
    x, h = _stem(g)
    r = g.pad(h, [[0, 0], [0, 0], [0, 0], [2, 0]])
    y = g.conv(h, 10, 1)
    return [x], [g.op("ADD", [y, r], g.shape(y), activation="RELU")]


def _broadcast(g):
    x = g.tensor((1, 6, 6, 3))
    y = g.conv(x, 8, 1)
    m = g.mean(y, [1, 2])
    return [x], [g.op("ADD", [y, m], g.shape(y), activation="RELU")]


def _constant_operand(g):
    x = g.tensor((1, 6, 6, 3))
    y = g.conv(x, 8, 1)
    c = g.const(np.ones((1, 6, 6, 8), np.float32))
    return [x], [g.op("ADD", [y, c], g.shape(y), activation="RELU")]


def _alpha_scalar(g):
    x = g.tensor((1, 6, 6, 3))
    y = g.conv(x, 8, 1)
    a = g.const(np.full((1, 1, 1), 0.2, np.float32))
    return [x], [g.op("PRELU", [y, a], g.shape(y))]


#: name -> (graph, the absorbed ops, the passes' residual count, the
#: passes, the candidates left op by op).
REFUSALS = {
    # The ADD does not join the PRELU (its output has a second reader, or
    # is a graph output); the PRELU runs alone, the ADD as a pass of its
    # own that takes its convolution's bias.
    "add_output_two_readers": (_two_readers, [], 1, 2, []),
    "add_output_is_a_graph_output": (_graph_output, [], 1, 2, []),
    # The PAD stays (a second reader; a spatial pad; a pad at the front):
    # the ADD fuses with the PAD's output as its residual.
    "pad_two_readers": (_pad_two_readers, [], 1, 1, []),
    "spatial_pad": (_spatial_pad, [], 1, 1, []),
    "pad_at_the_front": (_front_pad, [], 1, 1, []),
    # Nothing fuses.
    "broadcast_operand": (_broadcast, [], 0, 0, ["ADD"]),
    "constant_operand": (_constant_operand, [], 0, 0, ["ADD"]),
    "alpha_not_per_channel": (_alpha_scalar, [], 0, 0, ["PRELU"]),
}


def _seeded_biases(m, seed, specials=False):
    """Gives every convolution's bias of ``m`` seeded nonzero values (with
    -0.0, NaN and +-inf planted where ``specials``), so that a bias the
    plan moves shows in the outputs."""
    g = torch.Generator().manual_seed(seed)
    for op in m._ops:
        if op.name in ("CONV_2D", "DEPTHWISE_CONV_2D") and \
                len(op.inputs) > 2 and op.inputs[2] in m._param_key:
            b = getattr(m, m._param_key[op.inputs[2]])
            b.copy_(_specials(b.shape, int(torch.randint(
                1 << 30, (1,), generator=g))) if specials and b.numel() >= 35
                else 0.1 * torch.randn(b.shape, generator=g))


def _unplan(m):
    """Empties ``m``'s plan: every op one by one, every bias added by
    PyTorch after its convolution."""
    m._epilogues, m._absorbed = {}, frozenset()
    m._bias_passes, m._bias_folded = {}, frozenset()
    m._depthwise = {}


def _check_planned_against_unplanned(ir, n=3, seed=0, specials=False):
    """The planned model's outputs equal the same model's with the plan
    emptied (the ops one by one) bit for bit, at batch ``n``, on seeded
    nonzero biases (with -0.0, NaN and inf planted where ``specials``,
    and then in the input too)."""
    m = convert_model(ir)
    _seeded_biases(m, seed, specials)
    x = torch.from_numpy(np.random.default_rng(seed).normal(
        0, 1, (n,) + tuple(m.input_shapes[0][1:])).astype(np.float32))
    if specials:
        x = torch.where(_specials(x.shape, seed).isfinite(), x,
                        _specials(x.shape, seed))
    got = m(x)
    _unplan(m)
    want = m(x)
    for a, b in zip(got, want):
        assert torch.equal(_bits(a), _bits(b))
    return got


@pytest.mark.parametrize("name", sorted(REFUSALS))
def test_plan_refuses_what_it_must_not_absorb(name):
    build, absorbed, with_residual, passes, op_by_op = REFUSALS[name]
    ir = _graph(build)
    m = convert_model(ir)
    assert len(m._epilogues) == passes
    assert _names(m, m._op_by_op) == op_by_op
    assert _names(m, m._absorbed) == absorbed
    assert sum(ep.residual is not None
               for ep in m._epilogues.values()) == with_residual
    _check_planned_against_unplanned(ir)


def _on_grid(ir, tensors):
    """``ir`` with ``tensors`` on an int8 grid, as a quantized graph
    has its activations."""
    for t in tensors:
        ir.tensors[t] = dataclasses.replace(
            ir.tensors[t], dtype=np.int8,
            quant={"scale": np.asarray([0.05], np.float32),
                   "zero_point": np.asarray([3], np.int64), "dim": 0})
    return ir


@pytest.mark.parametrize("grid", ["relu_add", "prelu_add", "both"])
def test_plan_on_fake_quantised_add_outputs(grid):
    """An ADD with a fused RELU whose output lies on an int8 grid still
    runs in the pass (``forward`` snaps the pass's output as it snaps the
    ADD's); an ADD output on a grid before a PRELU is an intermediate and
    does not join it, the PRELU then running alone and the ADD as a pass
    of its own that takes its convolution's bias.  Either way the planned
    model equals the unplanned one bit for bit."""
    def build(g):
        x, h = _stem(g)
        _, _, s = _add_then(g, h, "RELU")
        _, _, t = _add_then(g, s, None)
        return [x], [g.prelu(t)]
    ir = _graph(build)
    relu_add, prelu_add = [op.outputs[0] for op in ir.ops
                           if op.name == "ADD"]
    assert len(convert_model(ir)._epilogues) == 2
    snapped = {"relu_add": [relu_add], "prelu_add": [prelu_add],
               "both": [relu_add, prelu_add]}[grid]
    m = convert_model(_on_grid(ir, snapped))
    acts = sorted((m._ops[i].name, ep.residual is None)
                  for i, ep in m._epilogues.items())
    assert not m._op_by_op
    if prelu_add in snapped:
        assert acts == [("ADD", False), ("ADD", False), ("PRELU", True)]
        assert not m._absorbed
    else:
        assert acts == [("ADD", False), ("PRELU", False)]
        assert _names(m, m._absorbed) == ["ADD"]
    _check_planned_against_unplanned(ir)


def test_int8_detector_runs_its_relu_adds_in_the_pass():
    """The int8 detector (``random_init.quantized_ir``): every ADD with a
    fused RELU is planned, its PADs, on their inputs' grids, stay; the
    planned model equals the unplanned one bit for bit."""
    frames = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (2, 96, 144, 3), dtype=np.uint8))
    det_ir = random_init.blazeface_back_ir(seed=2, blocks_per_stage=1)
    q_ir = random_init.quantized_ir(det_ir, frames, seed=1)
    q = convert_model(q_ir)
    relu_adds = [i for i, op in enumerate(q._ops) if op.name == "ADD"
                 and op.options.get("activation") == "RELU"]
    assert relu_adds and sorted(q._epilogues) == relu_adds
    assert not q._op_by_op and not q._absorbed
    assert len(relu_adds) == len(convert_model(det_ir)._epilogues)
    _check_planned_against_unplanned(q_ir, n=2, seed=3)


# -- the convolutions' biases -------------------------------------------


def _plant_conv_outputs(monkeypatch):
    """Plants -0.0, +0.0, NaN and +-inf at seeded places of every
    convolution's output (before its bias), the same places on every
    call."""
    from face_detection_tflite_torch.convert import executor
    real = executor.conv2d

    def planted(*args, **kwargs):
        y, bias = real(*args, **kwargs)
        if y.numel() < 35:
            return y, bias
        sp = _specials(y.shape, y.numel())
        return torch.where(sp.isfinite() & (sp != 0), y, sp), bias
    monkeypatch.setattr(executor, "conv2d", planted)


def _conv_out(g, x, cout, act=None):
    """A 1x1 convolution with a seeded nonzero bias."""
    y = g.conv(x, cout, 1, act=act)
    g.tensors[g.ops[-1].inputs[2]] = dataclasses.replace(
        g.tensors[g.ops[-1].inputs[2]],
        data=g.rng.normal(0, 0.1, cout).astype(np.float32))
    return y


def _bias_into_add_relu(g):
    x, h = _stem(g)
    return [x], [g.op("ADD", [_conv_out(g, h, 8), h], g.shape(h),
                      activation="RELU")]


def _bias_as_the_residual(g):
    """The convolution is the ADD's second operand: the pass takes it as
    ``y`` and the other operand as the residual."""
    x, h = _stem(g)
    p = g.op("MAX_POOL_2D", [h], g.shape(h), padding=PADDING_VALID,
             stride_w=1, stride_h=1, filter_w=1, filter_h=1, activation=None)
    return [x], [g.op("ADD", [p, _conv_out(g, h, 8)], g.shape(h),
                      activation="RELU")]


def _bias_into_prelu(g):
    x, h = _stem(g)
    return [x], [g.prelu(_conv_out(g, h, 8))]


def _bias_into_a_standalone_relu(g):
    x, h = _stem(g)
    y = _conv_out(g, h, 8)
    return [x], [g.op("RELU", [y], g.shape(y))]


def _bias_into_a_bare_add(g):
    x, h = _stem(g)
    return [x], [g.op("ADD", [h, _conv_out(g, h, 8)], g.shape(h),
                      activation=None)]


def _bias_into_a_padded_add(g):
    x, h = _stem(g)
    r = g.pad(h, [[0, 0], [0, 0], [0, 0], [0, 8]])
    return [x], [g.op("ADD", [_conv_out(g, h, 16), r], (1, 6, 6, 16),
                      activation=None)]


def _fused_relu(g):
    x, h = _stem(g)
    return [x], [_conv_out(g, h, 8, act="RELU")]


def _fused_relu6(g):
    x, h = _stem(g)
    return [x], [_conv_out(g, h, 8, act="RELU6")]


def _hard_swish(g):
    x, h = _stem(g)
    return [x], [g.hard_swish(_conv_out(g, h, 8))]


def _conv_two_readers(g):
    x, h = _stem(g)
    y = _conv_out(g, h, 8)
    return [x], [g.op("RELU", [y], g.shape(y)), g.prelu(y)]


def _conv_graph_output(g):
    x, h = _stem(g)
    y = _conv_out(g, h, 8)
    return [x], [g.op("RELU", [y], g.shape(y)), y]


#: name -> (graph, its last convolution's bias: "folded" into the pass at
#: the named op, "alone" (a pass of its own, with the act given); the
#: passes; the ops that still follow the last convolution).
BIAS_PATTERNS = {
    "into_add_relu": (_bias_into_add_relu, ("folded", "ADD"), 1, []),
    "as_the_residual": (_bias_as_the_residual, ("folded", "ADD"), 1,
                        ["MAX_POOL_2D"]),
    "into_prelu": (_bias_into_prelu, ("folded", "PRELU"), 1, []),
    "into_a_standalone_relu": (_bias_into_a_standalone_relu,
                               ("folded", "RELU"), 1, []),
    "into_a_bare_add": (_bias_into_a_bare_add, ("folded", "ADD"), 1, []),
    "into_a_padded_add": (_bias_into_a_padded_add, ("folded", "ADD"), 1,
                          []),
    "fused_relu": (_fused_relu, ("alone", "RELU"), 0, []),
    "fused_relu6": (_fused_relu6, ("alone", None), 0, []),
    "hard_swish": (_hard_swish, ("alone", None), 0, ["HARD_SWISH"]),
    # Refused: two readers (the PRELU then runs alone), a graph output.
    "two_readers": (_conv_two_readers, ("alone", None), 1, ["RELU"]),
    "graph_output": (_conv_graph_output, ("alone", None), 0, ["RELU"]),
}


@pytest.mark.parametrize("name", sorted(BIAS_PATTERNS))
def test_plan_takes_each_convolutions_bias(name, monkeypatch):
    """Every float32 convolution with a bias runs without it: the last
    convolution of each graph puts its bias into the pass of the op that
    reads it, or takes a pass of its own; the stem's (two readers) a pass
    of its own.  The planned model equals the ops one by one bit for bit,
    -0.0, NaN and inf planted in the convolutions' outputs and biases."""
    build, (how, at), passes, after = BIAS_PATTERNS[name]
    ir = _graph(build)
    m = convert_model(ir)
    convs = [i for i, op in enumerate(m._ops) if op.name == "CONV_2D"]
    stem, last = convs[0], convs[-1]
    assert m._bias_passes.get(stem, "none") is None
    assert len(m._epilogues) == passes and not m._op_by_op
    if how == "folded":
        assert last in m._bias_folded and last not in m._bias_passes
        ((i, ep),) = m._epilogues.items()
        assert m._ops[i].name == at
        assert ep.y == m._ops[last].outputs[0]
        assert ep.bias == m._ops[last].inputs[2]
    else:
        assert last not in m._bias_folded and m._bias_passes[last] == at
        assert all(ep.bias is None for ep in m._epilogues.values())
    live = [op.name for i, op in enumerate(m._ops) if i > stem and
            i not in m._epilogues and i not in m._absorbed and
            op.name != "CONV_2D"]
    assert sorted(live) == sorted(after)
    _plant_conv_outputs(monkeypatch)
    _check_planned_against_unplanned(ir, specials=True)


def test_bias_on_a_grid_and_at_a_bf16_tier():
    """A convolution whose output lies on an int8 grid takes a bias pass
    of its own (the snap follows it, as it follows the convolution); at a
    bf16 tier no convolution runs a bias pass (``conv2d`` adds the bias in
    float32 after the cast) while the PRELU and ADD passes stay."""
    ir = _graph(_bias_into_a_bare_add)
    conv_out = ir.ops[-1].inputs[1]
    m = convert_model(_on_grid(ir, [conv_out]))
    last = max(i for i, op in enumerate(m._ops) if op.name == "CONV_2D")
    assert m._bias_passes[last] is None and not m._bias_folded
    assert not m._epilogues
    _check_planned_against_unplanned(ir, specials=True)
    ir = _graph(_block(1, True, cin=16))
    m = convert_model(ir, precision="default")
    assert not m._bias_passes and not m._bias_folded
    assert [(m._ops[i].name, ep.bias) for i, ep in m._epilogues.items()] \
        == [("PRELU", None)]
    _check_planned_against_unplanned(ir)
    assert convert_model(ir, precision="high")._bias_folded


#: role -> (full-width, full-depth seeded graph, convolutions whose bias
#: a pass of another op takes, convolutions with a pass of their own, of
#: them with a fused RELU, the new passes' anchors, the depthwise
#: convolutions whose bias K7 adds, of them with the standalone RELU
#: after them).
BIAS_NETWORKS = {
    "detector": (lambda: random_init.blazeface_back_ir(5), 31, 6, 2, {},
                 32, 0),
    "mesh": (lambda: random_init.face_mesh_ir(5), 21, 2, 0, {}, 19, 0),
    "iris": (lambda: random_init.iris_landmark_ir(5), 35, 2, 0, {}, 34, 0),
    "multiclass_segmenter": (lambda: random_init.selfie_multiclass_ir(5),
                             23, 44, 15, {"RELU": 9, "ADD": 14}, 18, 9),
}


@pytest.mark.parametrize("role", sorted(BIAS_NETWORKS))
def test_plan_takes_the_biases_of_the_benchmark_networks(role):
    """On the seeded full-depth detector, mesh, iris net and multiclass
    segmenter every convolution's bias is planned: into the BlazeBlocks'
    passes (the 1x1 convolution before each ADD, the first before its
    PReLU), the segmenter's standalone RELUs and bare residual ADDs, a
    pass of its own (the heads, the stems) or K7 (every depthwise
    convolution, with the segmenter's standalone RELUs after them, whose
    passes go); no PRELU or RELU ADD runs op by op."""
    build, folded, alone, alone_relu, new, k7, k7_relu = BIAS_NETWORKS[role]
    m = convert_model(build())
    convs = {i for i, op in enumerate(m._ops)
             if op.name in ("CONV_2D", "DEPTHWISE_CONV_2D")}
    depthwise = {i for i in convs if m._ops[i].name == "DEPTHWISE_CONV_2D"}
    assert (len(m._bias_folded), len(m._bias_passes)) == (folded, alone)
    assert set(m._depthwise) == depthwise and len(depthwise) == k7
    assert all(dw.bias is not None for dw in m._depthwise.values())
    assert sum(dw.act == "RELU" for dw in m._depthwise.values()) == k7_relu
    assert set(m._bias_passes) | m._bias_folded | depthwise == convs
    assert sum(a == "RELU" for a in m._bias_passes.values()) == alone_relu
    assert not m._op_by_op
    producer = {t: i for i, op in enumerate(m._ops) for t in op.outputs}
    assert {producer[ep.y] for ep in m._epilogues.values()
            if ep.bias is not None} == set(m._bias_folded)
    names = [m._ops[i].name for i, ep in m._epilogues.items()
             if m._ops[i].name == "RELU" or ep.act is None]
    assert {k: names.count(k) for k in set(names)} == new


def test_multiclass_segmenter_planned_equals_unplanned():
    """The multiclass segmenter at a test size (its stages at two blocks
    and quarter width) with its RELU and bare-ADD passes equals the ops
    one by one bit for bit."""
    spec = dict(random_init.MULTICLASS_SEGMENTER)
    spec["stages"] = [(max(8, e // 4), max(8, c // 4), k, s, se, hs, 2)
                      for e, c, k, s, se, hs, _ in spec["stages"]]
    spec["stem"] = 8
    ir = random_init.selfie_multiclass_ir(6, spec=spec)
    m = convert_model(ir)
    assert any(m._ops[i].name == "RELU" for i in m._epilogues)
    assert any(ep.act is None for ep in m._epilogues.values())
    _check_planned_against_unplanned(ir, n=2, seed=4)


#: name -> (graph at one block a stage, passes, absorbed op names).
NETWORKS = {"detector": (lambda: random_init.blazeface_back_ir(5, 1), 7,
                         {"PAD": 2}),
            "mesh": (lambda: random_init.face_mesh_ir(5, 1), 15,
                     {"ADD": 13, "PAD": 3}),
            "iris": (lambda: random_init.iris_landmark_ir(5, 1), 14,
                     {"ADD": 13, "PAD": 1})}


@pytest.mark.parametrize("role", sorted(NETWORKS))
def test_planned_networks_match_the_jax_executor(role):
    """Every candidate of the full-width detector, mesh and iris nets
    fuses; the planned port equals the unplanned one bit for bit and the
    JAX executor within ``test_torch_executor.py``'s 2e-6 of the output's
    largest magnitude."""
    build, passes, absorbed = NETWORKS[role]
    ir = build()
    jm, tm = both_models(ir)
    assert len(tm._epilogues) == passes and not tm._op_by_op
    names = [tm._ops[i].name for i in tm._absorbed]
    assert {k: names.count(k) for k in set(names)} == absorbed
    x = np.random.default_rng(1).uniform(
        -1, 1, tuple(tm.input_shapes[0])).astype(np.float32)
    with torch.inference_mode():
        got = tm(torch.from_numpy(x))
    for out, want in zip(got, jm.fn(jm.params, x)):
        assert rel_err(out.numpy(), want) <= 2e-6
    _check_planned_against_unplanned(ir, n=2, seed=1)


def test_mobilefacenet_prelus_run_in_the_pass():
    """Each of MobileFaceNet's 50 convolutions runs without its bias and
    one pass on the NHWC output adds it: with the PReLU (33), with the
    bottleneck's residual (12 stride-1 projections) or alone (5).  Its
    stem takes a ``residual_act`` pass after ``executor.conv2d``; its 32
    1x1 convolutions take the pass inside ``ops.pointwise.pointwise_conv``
    (K6 on a card) and its 17 depthwise convolutions inside
    ``ops.depthwise.depthwise_conv`` (K7 on a card; gdconv's bias alone),
    both ``executor.conv2d`` and the plain pass here.  Its output equals
    the unfused ops (the bias add, the NCHW ``where``, ``h + x``) bit for
    bit, on seeded nonzero biases."""
    from face_detection_tflite_torch.convert.executor import conv2d
    net = embedding.build_mobilefacenet(seed=3)
    g = torch.Generator().manual_seed(4)
    for key, b in net.named_buffers():
        if key.endswith("_b"):
            b.copy_(0.1 * torch.randn(b.shape, generator=g))
    x = torch.from_numpy(np.random.default_rng(2).uniform(
        -1, 1, (2, 112, 112, 3)).astype(np.float32))
    calls = []
    real, real_pointwise = embedding.residual_act, embedding.pointwise_conv
    real_depthwise = embedding.depthwise_conv

    def counted(y, residual, act, alpha=None, bias=None, inplace=False):
        calls.append(("pass", tuple(y.shape), residual is not None, act,
                      bias is not None, inplace))
        return real(y, residual, act, alpha, bias, inplace)

    def counted_pointwise(x, w, bias, act=None, alpha=None, residual=None):
        calls.append(("pointwise", (*x.shape[:3], w.shape[1]),
                      residual is not None, act, bias is not None, False))
        return real_pointwise(x, w, bias, act, alpha, residual)

    def counted_depthwise(x, w, bias, *, stride, pads, act=None,
                          alpha=None):
        y = real_depthwise(x, w, bias, stride=stride, pads=pads, act=act,
                           alpha=alpha)
        calls.append(("depthwise", tuple(y.shape), False, act,
                      bias is not None, False))
        return y

    def unfused(y, residual, act, alpha=None, bias=None, inplace=False):
        y = y.permute(0, 3, 1, 2) + bias[:, None, None]
        if act == "PRELU":
            y = torch.where(y >= 0, y, y * alpha[:, None, None])
        if residual is not None:
            y = y + residual.permute(0, 3, 1, 2)
        return y.permute(0, 2, 3, 1)

    def unfused_pointwise(x, w, bias, act=None, alpha=None, residual=None):
        k, n = w.shape
        y, bias = conv2d(x, w.t().reshape(n, k, 1, 1), bias, stride=(1, 1),
                         pads=((0, 0), (0, 0)))
        return unfused(y, residual, act, alpha, bias)

    def unfused_depthwise(x, w, bias, *, stride, pads, act=None,
                          alpha=None):
        y, bias = conv2d(x, w, bias, stride=(stride, stride), pads=pads,
                         groups=x.shape[3])
        return unfused(y, None, act, alpha, bias)

    embedding.residual_act = counted
    embedding.pointwise_conv = counted_pointwise
    embedding.depthwise_conv = counted_depthwise
    try:
        (got,) = net(x)
        embedding.residual_act = unfused
        embedding.pointwise_conv = unfused_pointwise
        embedding.depthwise_conv = unfused_depthwise
        (want,) = net(x)
    finally:
        embedding.residual_act = real
        embedding.pointwise_conv = real_pointwise
        embedding.depthwise_conv = real_depthwise
    assert len(calls) == 50
    assert [c[0] for c in calls].count("pointwise") == 32
    assert [c[0] for c in calls].count("depthwise") == 17
    kinds = [c[2:5] for c in calls]
    assert kinds.count((False, "PRELU", True)) == 33
    assert kinds.count((True, None, True)) == 12
    assert kinds.count((False, None, True)) == 5
    assert [c for c in calls if c[0] == "pass"] == [
        ("pass", (2, 56, 56, 64), False, "PRELU", True, False)]
    assert ("depthwise", (2, 1, 1, 512), False, None, True, False) in calls
    assert torch.equal(_bits(got), _bits(want))


def test_memory_report_counts_the_passes_that_ran(monkeypatch):
    """``memory_report()`` gives the process's PRELUs and RELU ADDs run in
    K5 and op by op, and its convolutions' biases folded, alone and op by
    op, all 0 off a card; each counter takes what ``count_launch`` adds
    to it."""
    frames = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (2, 96, 144, 3), dtype=np.uint8))
    models, *_ = random_init.random_pipeline_models(
        frames, seed=2, detector_blocks=1, mesh_blocks=1, iris_blocks=1,
        mixer_blocks=1, per_image=12)
    det = FaceDetector(models=models, device="cpu")
    keys = {"epilogue_fused": epilogue.ran_fused,
            "epilogue_op_by_op": epilogue.ran_op_by_op,
            "bias_folded": epilogue.bias_folded,
            "bias_alone": epilogue.bias_alone,
            "bias_op_by_op": epilogue.bias_op_by_op}
    for counter in keys.values():
        monkeypatch.setattr(counter, "launches", 0)
    det.detect_faces_batch(frames.numpy())
    report = det.memory_report()
    assert {k: report[k] for k in keys} == dict.fromkeys(keys, 0)
    for j, counter in enumerate(keys.values()):
        for _ in range(j + 1):
            counter()
    monkeypatch.setattr(epilogue.ran_fused, "launches", 5)
    report = det.memory_report()
    assert [report[k] for k in keys] == [5, 2, 3, 4, 5]
