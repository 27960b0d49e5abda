"""ArcFace's iResNet as the embedding network: the port's executor on its
TFLite form (``tests/iresnet_reference.py::tflite_form``) against the
plain ``IResNet``, the folds at published widths, the network in
``FaceDetector``'s fused FULL stage at its 512-dim width, and K5's
affine pass (``ops.epilogue.residual_act_affine``), which takes the
blocks' pre-activation batch norm: its plain version against the two
graph ops, the executor's plan against the unplanned graph bit for bit,
and on a card (the ``cuda`` cases) the kernel against the plain version.
This file imports neither ``jax`` nor the JAX package."""

import numpy as np
import pytest
import torch

from face_detection_tflite_torch.convert.executor import (convert_model,
                                                          fp32_on_the_card)
from face_detection_tflite_torch.models import random_init
from face_detection_tflite_torch.models.embedding import FaceEmbedding
from face_detection_tflite_torch.ops import epilogue
from face_detection_tflite_torch.pipeline.config import FaceDetectionMode
from face_detection_tflite_torch.pipeline.detector import FaceDetector
from face_detection_tflite_torch.pipeline.programs import PipelineModels

from . import iresnet_reference as ref
from .iresnet_ir import to_ir

#: One block a stage at narrow widths (the CPU cases).
SMALL = {"layers": (1, 1, 1, 1), "widths": (8, 16, 16, 32),
         "num_features": 32}


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.int32)


def _small(seed, **kw):
    return ref.seeded(ref.IResNet(**{**SMALL, **kw}), seed)


def _crops(seed, n, size=112):
    return torch.from_numpy(np.random.default_rng(seed).uniform(
        -1, 1, (n, size, size, 3)).astype(np.float32))


def _rel(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_executor_on_the_tflite_form_equals_the_reference(seed):
    """The port's converted TFLite form equals ``IResNet``'s unfolded
    forward (NCHW, batch norms on their running statistics) within the
    float32 rounding of the folds (measured 4.8e-7 relative at most)."""
    net = _small(seed)
    m = convert_model(to_ir(ref.tflite_form(net)))
    x = _crops(seed + 10, 3)
    with torch.no_grad():
        want = net(x.permute(0, 3, 1, 2))
    (got,) = m(x)
    assert got.shape == (3, 32)
    assert _rel(got, want) <= 1e-5


def test_folds_and_fc_permutation_at_published_widths():
    """One block a stage at the published widths (64, 128, 256, 512; the
    512 x 7 x 7 flatten and the 512-dim BN1d): the folded convolutions,
    the MUL and ADD batch norms and the NHWC-permuted, BN1d-folded
    fully-connected layer give the reference's features (measured 1.3e-6
    relative); the rows left in NCHW order would not."""
    net = ref.seeded(ref.IResNet(layers=(1, 1, 1, 1)), 3)
    graph = ref.tflite_form(net)
    fc = next(op for op in graph.ops if op.name == "FULLY_CONNECTED")
    assert graph.tensors[fc.inputs[1]].shape == (512, 25088)
    x = _crops(4, 2)
    with torch.no_grad():
        want = net(x.permute(0, 3, 1, 2))
    (got,) = convert_model(to_ir(graph))(x)
    assert got.shape == (2, 512) and _rel(got, want) <= 1e-5
    w = graph.tensors[fc.inputs[1]].data
    graph.tensors[fc.inputs[1]].data = np.ascontiguousarray(w.reshape(
        512, 7, 7, 512).transpose(0, 3, 1, 2).reshape(512, -1))
    (wrong,) = convert_model(to_ir(graph))(x)
    assert _rel(wrong, want) > 1e-2


def test_iresnet50_counts():
    """iresnet50 at 112 px: 43,590,848 parameters (InsightFace's 43.6 M)
    and 24 blocks, four of them with a downsample."""
    net = ref.IResNet()
    assert sum(p.numel() for p in net.parameters()) == 43_590_848
    blocks = [b for layer in net.layers for b in layer]
    assert len(blocks) == 24
    assert sum(b.downsample is not None for b in blocks) == 4


def test_activations_stay_order_one_at_published_widths():
    """Under :func:`seeded`, the RMS at each stage's end stays between 0.3
    and 3 over the 24 blocks, as the benchmark's draws do."""
    net = ref.seeded(ref.IResNet(), 5)
    x = _crops(6, 1).permute(0, 3, 1, 2)
    rms = []
    with torch.no_grad():
        h = net.prelu(net.bn1(net.conv1(x)))
        for layer in net.layers:
            h = layer(h)
            rms.append(float(h.pow(2).mean().sqrt()))
    assert all(0.3 <= r <= 3.0 for r in rms), rms


# -- K5's affine pass -------------------------------------------------------


def _specials(shape, seed) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(shape, generator=g)
    flat = x.view(-1)
    picks = torch.randperm(flat.numel(), generator=g)[:5 * 7]
    for j, v in enumerate((-0.0, 0.0, float("nan"), float("inf"),
                           float("-inf"))):
        flat[picks[j::5]] = v
    return x


@pytest.mark.parametrize("act", [None, "PRELU", "RELU"])
@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("keep", [False, True])
def test_affine_plain_equals_the_graph_ops_bit_for_bit(act, residual, keep):
    y = _specials((2, 5, 6, 8), 1)
    r = _specials((2, 5, 6, 8), 2) if residual else None
    alpha = torch.rand(8) - 0.5 if act == "PRELU" else None
    bias = _specials((8,), 3) if act is None and not residual else None
    scale, shift = torch.randn(8), torch.randn(8)
    out = epilogue.residual_act_plain(y, r, act, alpha, bias)
    want = torch.add(torch.mul(out, scale.reshape(1, 1, 1, 8)), shift)
    before = epilogue.residual_act_affine.launches
    got_out, got = epilogue.residual_act_affine(y, r, act, alpha, bias,
                                                scale, shift, keep)
    assert epilogue.residual_act_affine.launches == before
    assert torch.equal(_bits(got), _bits(want))
    assert (got_out is None) != keep
    if keep:
        assert torch.equal(_bits(got_out), _bits(out))


def test_affine_wrapper_rejects_bad_arguments():
    y = torch.randn(1, 2, 2, 4)
    with pytest.raises(ValueError, match="scale must be"):
        epilogue.residual_act_affine(y, None, "RELU", None, None,
                                     torch.ones(3), torch.ones(4))
    with pytest.raises(ValueError, match="shift must be"):
        epilogue.residual_act_affine(y, None, "RELU", None, None,
                                     torch.ones(4), torch.ones(1, 4))
    with pytest.raises(ValueError, match="device"):
        epilogue.residual_act_affine(
            torch.empty((1, 2, 2, 4), device="meta"), None, "PRELU",
            *(torch.ones(4, device="meta") for _ in range(4)))


@pytest.mark.parametrize("act,residual,bias", [
    ("RELU", None, True), ("PRELU", 4, True), ("PRELU", None, False),
    (None, 4, False), (None, 2, True), (None, None, True)])
def test_affine_wrapper_off_the_cpu_takes_only_iresnets_passes(
        act, residual, bias):
    """Off the CPU the affine pass runs only where the kernel has an
    instance (``affine_pass``): a PReLU with the bias and no residual, or
    the bias and a same-width residual with no activation."""
    assert not epilogue.affine_pass(
        act, None if residual is None else "same" if residual == 4
        else "padded", bias)
    meta = {"device": "meta"}
    with pytest.raises(ValueError, match="the kernel has no pass"):
        epilogue.residual_act_affine(
            torch.empty((1, 2, 2, 4), **meta),
            None if residual is None else torch.empty((1, 2, 2, residual),
                                                      **meta),
            act, torch.ones(4, **meta) if act == "PRELU" else None,
            torch.ones(4, **meta) if bias else None,
            torch.ones(4, **meta), torch.ones(4, **meta))


def _unplan(m):
    m._epilogues, m._absorbed = {}, frozenset()
    m._bias_passes, m._bias_folded = {}, frozenset()
    m._affine_op_by_op = frozenset()


def test_plan_takes_every_batch_norm_into_the_pass_before_it():
    """Each block's BN1 joins the pass that writes the block's input (the
    stem's PReLU, or the previous block's residual ADD), which keeps its
    output for the identity or the downsample; the head's BN2d joins the
    last ADD, which then writes only the BN's output.  Nothing runs op by
    op; every convolution's bias is taken (the downsamples' in passes of
    their own)."""
    m = convert_model(to_ir(ref.tflite_form(_small(0))))
    affine = {i: ep for i, ep in m._epilogues.items() if ep.scale is not None}
    assert [m._ops[i].name for i in sorted(affine)] == ["PRELU"] + ["ADD"] * 4
    assert [affine[i].keep for i in sorted(affine)] == [True] * 4 + [False]
    absorbed = sorted(m._ops[i].name for i in m._absorbed)
    assert absorbed == ["ADD"] * 5 + ["MUL"] * 5
    assert not m._affine_op_by_op and not m._op_by_op
    assert len(m._epilogues) == 1 + 4 + 4
    assert sorted(m._bias_passes) == [
        i for i, op in enumerate(m._ops) if op.name == "CONV_2D"
        and op.inputs[2] not in {ep.bias for ep in m._epilogues.values()}]
    assert len(m._bias_passes) == 4


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_affine_plan_equals_the_unplanned_graph_bit_for_bit(seed):
    """On the CPU's plain path the planned network equals the same network
    with every op one by one, bit for bit, with -0.0, NaN and inf planted
    in the input."""
    m = convert_model(to_ir(ref.tflite_form(_small(seed))))
    x = _crops(seed, 2)
    sp = _specials(x.shape, seed)
    x = torch.where(sp.isfinite() & (sp != 0), x, sp)
    (got,) = m(x)
    _unplan(m)
    (want,) = m(x)
    assert torch.equal(_bits(got), _bits(want))


def _pair_after_a_convolution():
    """A per-channel MUL and ADD on a convolution's output (no pass writes
    it): the pair runs op by op."""
    g = random_init._Graph(np.random.default_rng(1))
    x = g.tensor((1, 6, 6, 3))
    y = g.conv(x, 8, 1)
    s = g.op("MUL", [y, g.const(np.full(8, 0.5, np.float32))], g.shape(y),
             activation=None)
    z = g.op("ADD", [g.const(np.full(8, 0.1, np.float32)), s], g.shape(y),
             activation=None)
    return g.ir([x], [z], "pair")


def test_a_pair_with_no_pass_before_it_runs_op_by_op():
    m = convert_model(_pair_after_a_convolution())
    assert [m._ops[i].name for i in m._affine_op_by_op] == ["ADD"]
    assert all(ep.scale is None for ep in m._epilogues.values())


def _pair_after_a_relu_pass():
    """A per-channel MUL and ADD after a standalone RELU that takes its
    convolution's bias: a pass the affine instance does not have."""
    g = random_init._Graph(np.random.default_rng(2))
    x = g.tensor((1, 6, 6, 3))
    y = g.op("RELU", [g.conv(x, 8, 1)], (1, 6, 6, 8))
    s = g.op("MUL", [y, g.const(np.full(8, 0.5, np.float32))], g.shape(y),
             activation=None)
    z = g.op("ADD", [s, g.const(np.full(8, 0.1, np.float32))], g.shape(y),
             activation=None)
    return g.ir([x], [z], "relu-pair")


def test_a_pair_after_a_pass_with_no_affine_instance_runs_op_by_op():
    m = convert_model(_pair_after_a_relu_pass())
    assert [ep.act for ep in m._epilogues.values()] == ["RELU"]
    assert all(ep.scale is None and ep.bias is not None
               for ep in m._epilogues.values())
    assert [m._ops[i].name for i in m._affine_op_by_op] == ["ADD"]
    x = _specials((2, 6, 6, 3), 4)
    (got,) = m(x)
    _unplan(m)
    (want,) = m(x)
    assert torch.equal(_bits(got), _bits(want))


def test_memory_report_counts_the_affine_pairs(monkeypatch):
    """``memory_report()`` gives the affine pairs run in K5 and op by op,
    0 off a card, each what ``count_launch`` adds to its counter."""
    frames = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (2, 96, 144, 3), dtype=np.uint8))
    models, *_ = random_init.random_pipeline_models(
        frames, seed=2, detector_blocks=1, mesh_blocks=1, iris_blocks=1,
        mixer_blocks=1, per_image=12)
    det = FaceDetector(models=models, device="cpu")
    for counter in (epilogue.affine_folded, epilogue.affine_op_by_op):
        monkeypatch.setattr(counter, "launches", 0)
    det.detect_faces_batch(frames.numpy())
    report = det.memory_report()
    assert (report["affine_folded"], report["affine_op_by_op"]) == (0, 0)
    epilogue.affine_folded()
    epilogue.affine_op_by_op()
    epilogue.affine_op_by_op()
    report = det.memory_report()
    assert (report["affine_folded"], report["affine_op_by_op"]) == (1, 2)


# -- the embedding role ----------------------------------------------------


@pytest.fixture(scope="module")
def arcface_models():
    """The small seeded pipeline (one block a network) on two 96x144
    frames, with a small iResNet of 512-dim output as its embedding."""
    frames = np.random.default_rng(0).integers(0, 256, (2, 96, 144, 3),
                                               dtype=np.uint8)
    models, *_ = random_init.random_pipeline_models(
        torch.from_numpy(frames), seed=3, detector_blocks=1, mesh_blocks=1,
        per_image=12, iris_blocks=1, mixer_blocks=1)
    emb = convert_model(to_ir(ref.tflite_form(_small(7, num_features=512))),
                        name="iresnet")
    return frames, PipelineModels(
        models.detector, models.variant, mesh=models.mesh, device="cpu",
        iris=models.iris, blendshapes=models.blendshapes, embedding=emb)


def test_full_with_iresnet_returns_unit_512_dim_embeddings(arcface_models):
    """``FaceDetector(FULL, embed_in_full=True)`` carries the network's
    512-dim width: every face's embedding is a unit 512-vector equal to
    ``get_face_embedding`` of the same face (fp32 readback; within 1e-4,
    the program aligning in float32 and the host in float64)."""
    frames, models = arcface_models
    det = FaceDetector(models=models, device="cpu", max_faces=4,
                       embed_in_full=True, quantized_readback=False,
                       allow_untrained_embeddings=True)
    faces = det.detect_faces_batch(frames, FaceDetectionMode.FULL)
    assert sum(len(f) for f in faces) > 0
    for i, per in enumerate(faces):
        for face in per:
            assert face.embedding.shape == (512,)
            assert abs(np.linalg.norm(face.embedding) - 1) <= 1e-5
            sep = det.get_face_embedding(face, frames[i])
            assert np.abs(face.embedding - sep).max() <= 1e-4
    assert det.embedding_model.embedding_dim == 512


def test_embed_batch_of_no_faces_has_the_networks_width(arcface_models):
    frames, models = arcface_models
    emb = FaceEmbedding(models.embedding, allow_untrained=True, device="cpu")
    out = emb.embed_batch(frames[0], [])
    assert out.shape == (0, 512) and out.dtype == np.float32


# -- on the card ------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    device = torch.device("cuda")
    fp32_on_the_card(device)
    return device


#: site -> (N, H, W, C, act, residual, bias, keep): iresnet50's affine
#: passes at 256 crops (the stem's PReLU and a stage-1 block's end, both
#: kept for the identity, and the head's BN2d after the last block,
#: written alone), and a block's end at an odd width on the scalar path.
AFFINE_SITES = {
    "stem_prelu": (256, 112, 112, 64, "PRELU", False, True, True),
    "block_end_56": (256, 56, 56, 64, None, True, True, True),
    "head_7": (256, 7, 7, 512, None, True, True, False),
    "odd_c": (3, 5, 7, 6, None, True, True, True),
}


@pytest.mark.cuda
@pytest.mark.parametrize("site", sorted(AFFINE_SITES))
def test_affine_kernel_matches_plain(cuda_device, site):
    """K5's affine instance equals its plain version (the pass, then the
    MUL and the ADD one by one on the card) bit for bit, -0.0, NaN and
    inf planted, one launch, counted as an affine pair in the pass."""
    n, h, w, c, act, res, has_bias, keep = AFFINE_SITES[site]
    g = torch.Generator(device=cuda_device).manual_seed(c)

    def draw(*shape):
        return _specials(shape, n * c).to(cuda_device)
    y = draw(n, h, w, c)
    r = draw(n, h, w, c) if res else None
    alpha = ((torch.rand(c, generator=g, device=cuda_device) - 0.5)
             if act == "PRELU" else None)
    bias = torch.randn(c, generator=g, device=cuda_device) if has_bias \
        else None
    scale = torch.randn(c, generator=g, device=cuda_device)
    shift = torch.randn(c, generator=g, device=cuda_device)
    want_out, want = epilogue.residual_act_affine_plain(
        y, r, act, alpha, bias, scale, shift)
    before = (epilogue.residual_act_affine.launches,
              epilogue.affine_folded.launches)
    got_out, got = epilogue.residual_act_affine(y, r, act, alpha, bias,
                                                scale, shift, keep)
    torch.cuda.synchronize()
    assert (epilogue.residual_act_affine.launches,
            epilogue.affine_folded.launches) == (before[0] + 1,
                                                 before[1] + 1)
    assert torch.equal(_bits(got), _bits(want))
    assert (got_out is not None) == keep
    if keep:
        assert torch.equal(_bits(got_out), _bits(want_out))


@pytest.mark.cuda
def test_iresnet_on_the_card_runs_every_pair_in_k5(cuda_device, monkeypatch):
    """The small iResNet on the card: one affine launch a pair (the stem
    and each block), none op by op, and outputs bit for bit those with
    the plain version at every pass."""
    from face_detection_tflite_torch.convert import executor
    m = convert_model(to_ir(ref.tflite_form(_small(9)))).to(cuda_device)
    x = _crops(9, 16).to(cuda_device)
    before = (epilogue.affine_folded.launches,
              epilogue.affine_op_by_op.launches)
    with torch.inference_mode():
        (got,) = m(x)
    torch.cuda.synchronize()
    assert (epilogue.affine_folded.launches - before[0],
            epilogue.affine_op_by_op.launches - before[1]) == (5, 0)
    monkeypatch.setattr(executor, "residual_act", epilogue.residual_act_plain)
    monkeypatch.setattr(executor, "residual_act_affine",
                        epilogue.residual_act_affine_plain)
    with torch.inference_mode():
        (want,) = m(x)
    assert torch.equal(_bits(got), _bits(want))
