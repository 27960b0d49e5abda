"""The precision tiers of the port against the JAX package's, on the CPU.

XLA:CPU ignores ``precision`` (``"default"`` and ``"highest"`` give the
same conv and matmul there), so what the CPU can hold is:

* the per-op tier assignment: the port resolves ``"mixed"``, a
  ``mixed_precision`` callable at frac 0.4, 0.5 and 1.0 and a plain
  callable over the same pruned op list, called with the same
  ``(op_index, op_name)`` sequence, to the same tier per op as the JAX
  executor (read from the calls its traced function makes), on the seeded
  back detector and on the fp16 front detector (folded DEQUANTIZE ops);
* the detector's ``_precision``, the ``accelerator_report`` string and the
  precision each network is built at, against the JAX detector, for the
  ``"serving"`` preset, dicts and ``"mixed"``;
* the port's bf16 tier on the CPU: each tiered op against an explicit
  emulation (fp64 op on bf16-rounded operands, the result rounded to
  bf16, the bias in fp32) within one bf16 step of the result (2^-8 of
  its largest magnitude), and whole networks at ``"default"`` and
  ``"mixed"`` against the JAX output (fp32 on the CPU) within 2e-2 of
  the output's largest magnitude: a few bf16 steps (2^-8 = 3.9e-3) over
  the network, measured up to 4.5e-3 on these seeds;
* ``"high"``, which runs fp32 operands on this executor, equal to
  ``"highest"`` bit for bit and to the JAX executor within its 2e-6
  relative budget.
"""

import os
import types

import jax
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from face_detection_tflite_torch import (FaceBlendshapesModel, FaceDetection,
                                         FaceDetector, FaceLandmark,
                                         IrisLandmark)
from face_detection_tflite_torch.convert import executor as t_exec
from face_detection_tflite_torch.convert.tflite import (PADDING_SAME,
                                                        ModelIR, OpIR,
                                                        TensorIR)
from face_detection_tflite_torch.models import embedding as t_embedding
from face_detection_tflite_torch.models import random_init
from face_detection_tflite_torch.pipeline.programs import PipelineModels
from face_detection_tflite_tpu.convert import executor as j_exec
from face_detection_tflite_tpu.models import embedding as j_embedding
from face_detection_tflite_tpu.pipeline import detector as j_detector
from face_detection_tflite_tpu.pipeline.config import MODEL_FILES

from .torch_parity import MAX_FACES, jax_ir, rel_err, small_pipeline

#: Whole-network budget of a bf16 tier against fp32 (see the docstring).
NETWORK_BUDGET = 2e-2

_IRS = {"back": lambda: random_init.blazeface_back_ir(11, 1),
        "front_fp16": lambda: random_init.blazeface_front_ir(11, 1),
        "mesh": lambda: random_init.face_mesh_ir(12, 1),
        "iris": lambda: random_init.iris_landmark_ir(13, 1),
        "blendshapes": lambda: random_init.face_blendshapes_ir(14, 1)}
_SETUPS: dict = {}


def _setup(segmenter=None):
    if segmenter not in _SETUPS:
        _SETUPS[segmenter] = small_pipeline("back", segmenter=segmenter)
    return _SETUPS[segmenter]


def _input(model, n=1, seed=1):
    shp = model.input_shapes[0]
    return np.random.default_rng(seed).uniform(
        -1, 1, (n,) + tuple(shp[1:])).astype(np.float32)


def _jax_name(p) -> str:
    """A tier as the JAX executor resolves it."""
    return jax.lax.Precision(p.lower()).name.lower() if p else "default"


def _jax_calls(ir, spec, monkeypatch):
    """The ``(op_index, op_name, tier)`` calls the JAX executor's traced
    function makes to resolve ``spec`` (a tier callable, or "mixed",
    whose callable is wrapped where the executor makes it)."""
    calls = []

    def recording(f):
        def rec(oi, nm):
            calls.append((oi, nm, f(oi, nm)))
            return calls[-1][2]
        return rec

    if spec == "mixed":
        make = j_exec.mixed_precision

        def mixed(ops, *a, **kw):
            out = make(ops, *a, **kw)
            return recording(out) if callable(out) else recording(
                lambda oi, nm: out)
        monkeypatch.setattr(j_exec, "mixed_precision", mixed)
        precision = "mixed"
    else:
        precision = recording(spec)
    jm = j_exec.convert_model(jax_ir(ir), precision=precision)
    jm.fn(jm.params, *[np.zeros(s, np.float32) for s in jm.input_shapes])
    return calls


def _specs(names):
    """Tier specs over an op-name list: name -> callable or "mixed"."""
    ops = [types.SimpleNamespace(name=n) for n in names]
    return {"mixed": "mixed",
            "frac_0.4": j_exec.mixed_precision(ops, 0.4),
            "frac_1.0": j_exec.mixed_precision(ops, 1.0),
            "callable": lambda oi, nm: ("default", "high", None)[oi % 3]}


@pytest.mark.parametrize("spec", ["mixed", "frac_0.4", "frac_1.0",
                                  "callable"])
@pytest.mark.parametrize("net", ["back", "front_fp16"])
def test_tier_assignment_matches_jax(net, spec, monkeypatch):
    ir = _IRS[net]()
    names = [nm for _, nm, _ in _jax_calls(ir, lambda oi, nm: "highest",
                                           monkeypatch)]
    jspec = _specs(names)[spec]
    jcalls = _jax_calls(ir, jspec, monkeypatch)
    base = t_exec.convert_model(ir)
    assert [op.name for op in base._ops] == names
    if net == "front_fp16":
        # The folded DEQUANTIZE ops shift the pruned indices off ir.ops.
        assert len(names) < len(ir.ops)
    tspec = {"mixed": "mixed",
             "frac_0.4": t_exec.mixed_precision(base._ops, 0.4),
             "frac_1.0": t_exec.mixed_precision(base._ops, 1.0),
             "callable": jspec}[spec]
    tcalls = []
    if callable(tspec):
        inner = tspec

        def tspec(oi, nm):
            tcalls.append((oi, nm))
            return inner(oi, nm)
    model = base.with_precision(tspec)
    if callable(tspec):
        assert tcalls == [(oi, nm) for oi, nm, _ in jcalls]
    want = [_jax_name(p) if nm in t_exec._TIERED else None
            for _, nm, p in jcalls]
    assert list(model.tiers) == want
    assert {"default", "high"} & set(want)
    # Converting the IR at the tier directly resolves the same.
    assert t_exec.convert_model(ir, precision=tspec).tiers == model.tiers


def test_mixed_precision_is_the_jax_function():
    ops = [types.SimpleNamespace(name=n) for n in
           ["PAD", "CONV_2D", "DEPTHWISE_CONV_2D", "ADD", "CONV_2D",
            "CONV_2D", "FULLY_CONNECTED", "DEPTHWISE_CONV_2D"]]
    for frac in (0.0, 0.2, 0.4, 0.5, 0.75, 1.0):
        j, t = j_exec.mixed_precision(ops, frac), t_exec.mixed_precision(
            ops, frac)
        if not callable(j):
            assert t == j
            continue
        assert [t(i, op.name) for i, op in enumerate(ops)] == \
            [j(i, op.name) for i, op in enumerate(ops)]


@pytest.fixture
def jax_detector(monkeypatch, tmp_path):
    """The JAX FaceDetector on the seeded JAX networks (placeholder files
    in ``tmp_path``, so its existence checks pass), recording the
    precision it converts each file at."""
    monkeypatch.setenv("FDT_NO_COMPILE_CACHE", "1")
    got = {}

    def make(jmodels, jseg=None, **kw):
        by_file = {MODEL_FILES["back"]: jmodels.detector,
                   MODEL_FILES["face_landmark"]: jmodels.mesh,
                   MODEL_FILES["iris_landmark"]: jmodels.iris,
                   MODEL_FILES["face_blendshapes"]: jmodels.blendshapes,
                   MODEL_FILES["segmenter_general"]: jseg}
        for name in by_file:
            (tmp_path / name).write_bytes(b"")

        def convert_file(path, precision="highest"):
            got[os.path.basename(path)] = precision
            return by_file[os.path.basename(path)]
        monkeypatch.setattr(j_detector, "convert_file", convert_file)
        return j_detector.FaceDetector(model_dir=str(tmp_path),
                                       max_faces=MAX_FACES, **kw), got
    return make


_NETS = {"detector": "back", "mesh": "face_landmark", "iris": "iris_landmark",
         "blendshapes": "face_blendshapes"}


@pytest.mark.parametrize("precision", [
    "serving", "mixed", {"detector": "default", "mesh": "highest"},
    {"detector": "mixed", "iris": "default", "segmentation": "default"}],
    ids=["serving", "mixed", "dict", "dict_with_segmentation"])
def test_detector_precision_matches_jax(precision, jax_detector):
    """``_precision``, the report's string, and each network's precision
    (the segmenter's included: a dict without the key gives "high") equal
    the JAX detector's; each network's tiers are that precision's."""
    _, models, jmodels, jseg = _setup("general")
    jdet, jprecs = jax_detector(jmodels, jseg, precision=precision,
                                with_segmentation=True)
    det = FaceDetector(models=models, device="cpu", max_faces=MAX_FACES,
                       precision=precision, with_segmentation=True)
    assert det._precision == jdet._precision
    assert det.accelerator_report["precision"] == \
        jdet.accelerator_report["precision"]
    nets = dict(_NETS, segmentation="segmenter_general")
    for key, file_key in nets.items():
        model = (det._segmentation.model if key == "segmentation"
                 else getattr(det.models, key))
        want = jprecs[MODEL_FILES[file_key]]
        assert model.precision == want, key
        assert model.tiers == getattr(models, key).with_precision(want).tiers
    # The networks share the models' fp32 weights.
    for k in models.detector.state_dict():
        assert getattr(det.models.detector, k) is getattr(models.detector, k)
    det.dispose()


def test_pipeline_models_with_precision():
    """A dict's missing keys are "high"; the embedding network and the
    segmenter are carried as they are; unchanged tiers give the same
    models back; the weights are shared, not copied."""
    _, models, _, _ = _setup("general")
    assert models.with_precision("highest") is models
    tiered = models.with_precision({"detector": "mixed"})
    assert tiered.embedding is models.embedding
    assert tiered.segmentation is models.segmentation
    assert set(tiered.mesh.tiers) == {"high", None}
    assert "default" in tiered.detector.tiers
    for key in ("detector", "mesh", "iris", "blendshapes"):
        for name in getattr(models, key).state_dict():
            assert getattr(getattr(tiered, key), name) is \
                getattr(getattr(models, key), name)


def _one_op(name, x_shape, w, bias, out_shape, options, inputs=None):
    """A one-op graph: tensor 0 the input, 1 the weight, 2 the bias, 3 the
    output."""
    ts = [TensorIR(0, "x", x_shape, np.float32, None),
          TensorIR(1, "w", w.shape, np.float32, w),
          TensorIR(2, "b", bias.shape, np.float32, bias),
          TensorIR(3, "y", out_shape, np.float32, None)]
    return ModelIR(ts, [OpIR(name, inputs or [0, 1, 2], [3], options)],
                   [0], [3], name)


def _bf(t):
    return t.to(torch.bfloat16).double()


def _conv_opts(stride=1):
    return {"padding": PADDING_SAME, "stride_h": stride, "stride_w": stride,
            "dilation_h": 1, "dilation_w": 1, "activation": None,
            "depth_multiplier": 1}


_rng = np.random.default_rng(5)
_OPS = {
    "conv": (lambda: _one_op(
        "CONV_2D", (1, 9, 9, 5), _rng.normal(0, 0.5, (7, 3, 3, 5)),
        _rng.normal(0, 0.5, 7), (1, 5, 5, 7), _conv_opts(2)),
        lambda x, w, b: F.conv2d(
            F.pad(_bf(x).permute(0, 3, 1, 2), (1, 1, 1, 1)),
            _bf(w).permute(0, 3, 1, 2), stride=2).permute(0, 2, 3, 1)),
    "depthwise": (lambda: _one_op(
        "DEPTHWISE_CONV_2D", (1, 8, 8, 6), _rng.normal(0, 0.5, (1, 3, 3, 6)),
        _rng.normal(0, 0.5, 6), (1, 8, 8, 6), _conv_opts()),
        lambda x, w, b: F.conv2d(
            _bf(x).permute(0, 3, 1, 2), _bf(w).permute(3, 0, 1, 2),
            padding=1, groups=6).permute(0, 2, 3, 1)),
    "transpose_conv": (lambda: _one_op(
        "CUSTOM:Convolution2DTransposeBias", (1, 4, 5, 6),
        _rng.normal(0, 0.5, (3, 2, 2, 6)), _rng.normal(0, 0.5, 3),
        (1, 8, 10, 3), {"padding": PADDING_SAME, "stride_h": 2,
                        "stride_w": 2}),
        lambda x, w, b: F.conv_transpose2d(
            _bf(x).permute(0, 3, 1, 2), _bf(w).permute(3, 0, 1, 2),
            stride=2).permute(0, 2, 3, 1)),
    "fully_connected": (lambda: _one_op(
        "FULLY_CONNECTED", (1, 40), _rng.normal(0, 0.5, (12, 40)),
        _rng.normal(0, 0.5, 12), (1, 12),
        {"activation": None, "keep_num_dims": False}),
        lambda x, w, b: _bf(x) @ _bf(w).T),
    "batch_matmul": (lambda: _one_op(
        "BATCH_MATMUL", (1, 6, 40), _rng.normal(0, 0.5, (1, 40, 9)),
        np.zeros(1), (1, 6, 9), {"adj_x": False, "adj_y": False},
        inputs=[0, 1]),
        lambda x, w, b: _bf(x) @ _bf(w)),
}


@pytest.mark.parametrize("name", sorted(_OPS))
def test_default_tier_op_matches_bf16_emulation(name):
    """Each tiered op at "default" against the emulation of its bf16
    operands (the docstring's tolerance), and not equal to its fp32
    result; its bias is added in fp32 after the bf16 result."""
    build, emulate = _OPS[name]
    ir = build()
    for t in ir.tensors:
        if t.data is not None:
            t.data = t.data.astype(np.float32)
    fp32 = t_exec.convert_model(ir)
    low = t_exec.convert_model(ir, precision="default")
    x = torch.from_numpy(_rng.uniform(-1, 1, fp32.input_shapes[0]).astype(
        np.float32))
    w = torch.from_numpy(ir.tensors[1].data)
    b = torch.from_numpy(ir.tensors[2].data)
    with torch.inference_mode():
        (got,), (ref32,) = low(x), fp32(x)
    y = emulate(x, w, b).to(torch.bfloat16).float()
    want = y if name == "batch_matmul" else y + b
    assert got.dtype == torch.float32
    assert rel_err(got.numpy(), want.numpy()) <= 2.0 ** -8
    assert rel_err(got.numpy(), ref32.numpy()) > 0


@pytest.mark.parametrize("tier", ["default", "mixed"])
@pytest.mark.parametrize("net", sorted(_IRS))
def test_bf16_tiers_match_jax_within_budget(net, tier):
    """A whole network at a bf16 tier against the JAX executor's output
    at the same tier on the CPU (fp32 there) within NETWORK_BUDGET."""
    ir = _IRS[net]()
    jm = j_exec.convert_model(jax_ir(ir), precision=tier)
    tm = t_exec.convert_model(ir, precision=tier)
    x = _input(tm)
    refs = jm.fn(jm.params, x)
    with torch.inference_mode():
        gots = tm(torch.from_numpy(x))
    for g, r in zip(gots, refs):
        assert rel_err(g.numpy(), np.asarray(r)) <= NETWORK_BUDGET


@pytest.mark.parametrize("net", sorted(_IRS))
def test_high_is_highest_on_this_executor(net):
    """"high" runs fp32 operands: bit for bit "highest", and the JAX
    executor's "high" within the executor's 2e-6 budget."""
    ir = _IRS[net]()
    jm = j_exec.convert_model(jax_ir(ir), precision="high")
    tm = t_exec.convert_model(ir)
    high = tm.with_precision("high")
    assert high is not tm and set(high.tiers) <= {"high", None}
    x = _input(tm, n=2)
    with torch.inference_mode():
        a, b = tm(torch.from_numpy(x)), high(torch.from_numpy(x))
    for u, v in zip(a, b):
        assert torch.equal(u, v)
    for i in range(2):
        for u, r in zip(b, jm.fn(jm.params, x[i:i + 1])):
            assert rel_err(u[i:i + 1].numpy(), np.asarray(r)) <= 2e-6


def test_tiers_share_weights_and_leave_the_ir():
    """One parsed IR converts at several tiers and stays as it was; a
    re-tiered module shares the fp32 weights, holds bf16 copies only of
    its bf16 ops' operands, outside its state dict, and re-derives them
    when a state dict loads."""
    ir = _IRS["back"]()
    before = [None if t.data is None else t.data.copy() for t in ir.tensors]
    models = {p: t_exec.convert_model(ir, precision=p)
              for p in ("highest", "high", "default", "mixed")}
    for t, data in zip(ir.tensors, before):
        assert (t.data is None) == (data is None)
        if data is not None:
            assert np.array_equal(t.data, data)
    base = models["highest"]
    assert base.with_precision("highest") is base
    low = base.with_precision("default")
    assert low.state_dict().keys() == base.state_dict().keys()
    for k in base.state_dict():
        assert getattr(low, k) is getattr(base, k)
    copies = {k: v for k, v in low.named_buffers() if "_bf_" in k}
    assert copies and all(v.dtype == torch.bfloat16 for v in copies.values())
    n_tiered = sum(t is not None for t in low.tiers)
    assert len(copies) == n_tiered          # a filter each, no bias
    mixed = base.with_precision("mixed")
    assert 0 < sum("_bf_" in k for k, _ in mixed.named_buffers()) < n_tiered
    x = torch.from_numpy(_input(base))
    with torch.inference_mode():
        first = low(x)
        fresh = {k: torch.zeros_like(v) for k, v in low.state_dict().items()}
        low.load_state_dict(fresh)
        assert all(not v.any() for v in
                   (b for k, b in low.named_buffers() if "_bf_" in k))
        low.load_state_dict(models["default"].state_dict())
        assert all(torch.equal(u, v) for u, v in zip(low(x), first))


@pytest.mark.parametrize("tier", ["high", "default"])
def test_mobilefacenet_tiers(tier):
    """MobileFaceNet's convolutions at a tier: "high" equal to "highest"
    bit for bit; "default" (bf16 operands, fp32 bias and PReLU) within a
    cosine of 0.999 of the JAX package's fp32 embeddings."""
    x = _rng.uniform(-1, 1, (3, 112, 112, 3)).astype(np.float32)
    jm = j_embedding.build_mobilefacenet(5, precision=tier)
    ref = np.stack([np.asarray(jm.fn(jm.params, x[i:i + 1])[0][0])
                    for i in range(3)])
    net = t_embedding.build_mobilefacenet(5, precision=tier)
    with torch.inference_mode():
        (got,) = net(torch.from_numpy(x))
        (fp32,) = t_embedding.build_mobilefacenet(5)(torch.from_numpy(x))
    got = got.numpy()
    if tier == "high":
        assert np.array_equal(got, fp32.numpy())
    cos = (got * ref).sum(1) / np.linalg.norm(got, axis=1) / \
        np.linalg.norm(ref, axis=1)
    assert cos.min() >= 0.999
    assert net.state_dict().keys() == t_embedding.build_mobilefacenet(
        5).state_dict().keys()
    # Loading a state dict re-derives the bf16 copies, one per filter.
    net.load_state_dict(net.state_dict())
    n_filters = sum(k.endswith("_w") for k in net.state_dict())
    assert sum("_bf_" in k for k, _ in net.named_buffers()) == (
        n_filters if tier == "default" else 0)


@pytest.mark.parametrize("cls,key", [
    (FaceDetection, "detector"), (FaceLandmark, "mesh"),
    (IrisLandmark, "iris"), (FaceBlendshapesModel, "blendshapes")],
    ids=lambda v: getattr(v, "__name__", v))
def test_standalone_classes_take_a_tier(cls, key):
    """Each standalone class runs its network at its ``precision``, on the
    same fp32 weights as the network it was given."""
    _, models, _ = _setup()
    net = getattr(models, key)
    obj = cls(model=net, device="cpu", precision="mixed")
    assert obj.model.tiers == net.with_precision("mixed").tiers
    assert obj.model.state_dict().keys() == net.state_dict().keys()
    assert cls(model=net, device="cpu").model is net


def test_serving_preset_runs_within_budget_of_jax(jax_detector):
    """FULL at "serving" on the small pipeline: the same faces as the JAX
    detector (fp32 on the CPU), the boxes' corners and the mesh within
    NETWORK_BUDGET of the frame's width (px)."""
    frames, models, jmodels, jseg = _setup("general")
    jdet, _ = jax_detector(jmodels, jseg, precision="serving")
    det = FaceDetector(models=models, device="cpu", max_faces=MAX_FACES,
                       precision="serving")
    got, want = det.detect_faces_batch(frames), jdet.detect_faces_batch(
        frames)
    assert [len(f) for f in got] == [len(f) for f in want]
    width = frames.shape[2]
    for g_img, w_img in zip(got, want):
        for g, w in zip(g_img, w_img):
            assert np.abs(np.subtract(g.bounding_box_pixels,
                                      w.bounding_box_pixels)).max() <= \
                NETWORK_BUDGET * width
            assert np.abs(g.mesh.points - np.asarray(w.mesh.points)
                          )[:, :2].max() <= NETWORK_BUDGET * width
    det.dispose()


def test_pipeline_programs_accept_retiered_models():
    """PipelineModels built of networks at several tiers run the FULL
    program on the CPU with finite outputs of the fp32 programs' shapes."""
    from face_detection_tflite_torch.pipeline.programs import \
        build_pipeline_program
    frames, models, _ = _setup()
    tiered = models.with_precision("default")
    assert isinstance(tiered, PipelineModels)
    x = torch.from_numpy(frames)
    with torch.inference_mode():
        a = build_pipeline_program(models, *frames.shape[1:3],
                                   max_faces=MAX_FACES)(x)
        b = build_pipeline_program(tiered, *frames.shape[1:3],
                                   max_faces=MAX_FACES)(x)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].shape == b[k].shape
        if b[k].dtype.is_floating_point and k != "head_angles":
            assert torch.isfinite(b[k]).all(), k
