"""The port's face embeddings against the JAX package's on the same seeds
and inputs: MobileFaceNet's weights and forward, the two alignment forms,
``FaceEmbedding``, the checkpoint files, the fused FULL stage
(``with_embeddings``) and the ``FaceDetector`` embedding surface.

MobileFaceNet runs at full width (1,026,176 weights; it has no depth knob
in either package).  Tolerances: weights bit for bit from one seed; the
raw forward within 1e-5 of the largest magnitude and unit vectors within
1e-5 absolute; alignment positions and size within 1 ulp of their
largest magnitude and the angle within 1 ulp of pi; ``FaceEmbedding`` within 1e-5; the fused program's
embeddings within 1e-4 of JAX's (upstream geometry already differs by an
ulp: the trigonometry of XLA and PyTorch), its other outputs as in
``test_torch_full.py``."""

import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from face_detection_tflite_torch import (FaceDetectionMode, FaceDetector,
                                         PipelineModels)
from face_detection_tflite_torch.convert import checkpoint as t_ckpt
from face_detection_tflite_torch.models import embedding as te
from face_detection_tflite_torch.pipeline import detector as t_detector
from face_detection_tflite_torch.pipeline.programs import \
    build_pipeline_program
from face_detection_tflite_torch.pipeline.types import Face
from face_detection_tflite_tpu.convert import checkpoint as j_ckpt
from face_detection_tflite_tpu.models import embedding as je
from face_detection_tflite_tpu.pipeline import detector as j_detector
from face_detection_tflite_tpu.pipeline import programs as j_programs
from face_detection_tflite_tpu.pipeline.config import \
    FaceDetectionMode as JMode

from .test_torch_full import _assert_full_match
from .torch_parity import B, H, MAX_FACES, W, rel_err, small_pipeline

#: The inputs of the JAX ``TestBatchedEmbedding``: a seeded 240x320 frame
#: and two eye pairs.
_FRAME = np.random.default_rng(0).integers(0, 255, (240, 320, 3),
                                           dtype=np.uint8)
_PAIRS = [((100.0, 100.0), (140.0, 102.0)), ((200.0, 120.0), (240.0, 118.0))]


@pytest.fixture(scope="module")
def nets():
    """(port MobileFaceNet, JAX MobileFaceNet) of seed 0."""
    return te.build_mobilefacenet(0), je.build_mobilefacenet(0)


@pytest.fixture(scope="module")
def embedders(nets):
    """(port FaceEmbedding on the CPU, JAX FaceEmbedding), untrained
    weights acknowledged."""
    return (te.FaceEmbedding(nets[0], allow_untrained=True, device="cpu"),
            je.FaceEmbedding(nets[1], allow_untrained=True))


@pytest.fixture(scope="module")
def setup():
    return small_pipeline()


def _unit(a):
    return a / np.linalg.norm(a, axis=-1, keepdims=True)


# -- the network -----------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 7])
def test_weights_are_bit_identical(seed):
    """The port draws the JAX package's weights from the same seed, and
    ``params_from_jax`` carries JAX params over unchanged."""
    mine = te.build_mobilefacenet(seed)
    ref = {k: np.asarray(v)
           for k, v in je.build_mobilefacenet(seed).params.items()}
    got = mine.jax_params()
    assert list(got) == list(ref)
    for k in ref:
        assert got[k].dtype == ref[k].dtype and got[k].shape == ref[k].shape
        np.testing.assert_array_equal(got[k], ref[k], k)
    state = mine.state_dict()
    for k, v in te.params_from_jax(ref).items():
        assert torch.equal(v, state[k]), k
    assert mine.name == "mobilefacenet-random-init"
    assert mine.num_params == 1_026_176


@pytest.mark.parametrize("n", [1, 5])
def test_network_matches_jax(nets, n):
    """The forward on seeded [N, 112, 112, 3] crops: raw outputs within
    1e-5 of the largest magnitude (the TF-style asymmetric SAME pads at
    stride 2; symmetric pads put the unit vectors 0.1 off), unit vectors
    within 1e-5."""
    tm, jm = nets
    x = np.random.default_rng(n).uniform(-1, 1, (n, 112, 112, 3)
                                         ).astype(np.float32)
    with torch.inference_mode():
        (got,) = tm(torch.from_numpy(x))
    ref = np.stack([np.asarray(jm.fn(jm.params, jnp.asarray(c[None]))[0][0])
                    for c in x])
    assert got.shape == (n, 192)
    assert rel_err(got.numpy(), ref) <= 1e-5
    assert np.abs(_unit(got.numpy()) - _unit(ref)).max() <= 1e-5


def test_network_refuses_other_shapes_and_precisions(nets):
    with pytest.raises(ValueError, match="112"):
        nets[0](torch.zeros(1, 96, 96, 3))
    # The tiers are ported; a name that is not a tier is refused, as
    # jax.lax.Precision refuses it ("mixed" is a converter's tier only).
    for bad in ("mixed", "bf16x3"):
        with pytest.raises(ValueError, match="precision"):
            te.build_mobilefacenet(precision=bad)


# -- alignment and comparisons ----------------------------------------------


def _eyes(n=64):
    rng = np.random.default_rng(31)
    le = rng.uniform(0, 1280, (n, 2))
    re = le + rng.uniform(-200, 200, (n, 2))
    return le.astype(np.float32), re.astype(np.float32)


@pytest.mark.parametrize("form", ["host_float64", "host_float32", "traced"])
def test_alignment_matches_jax(form):
    """Both forms: positions and size within 1 ulp of their largest
    magnitude (an ulp of sin or cos, times the offset, moves a centre
    that lands near 0 by several of its own ulps), the angle within 1 ulp
    of pi (2.38e-7 rad: atan2 of XLA and of PyTorch differ by an ulp for
    angles past 2)."""
    le, re = _eyes()
    if form == "traced":
        got = te.alignment_from_eyes(*(torch.from_numpy(a) for a in
                                       (le[:, 0], le[:, 1], re[:, 0],
                                        re[:, 1])))
        ref = je.alignment_from_eyes(*(jnp.asarray(a) for a in
                                       (le[:, 0], le[:, 1], re[:, 0],
                                        re[:, 1])))
        got = [g.numpy() for g in got]
        ref = [np.asarray(r) for r in ref]
        assert all(g.dtype == np.float32 for g in got)
    else:
        cast = (lambda p: tuple(map(float, p))) if form == "host_float64" \
            else (lambda p: p)
        pairs = [(cast(a), cast(b)) for a, b in zip(le, re)]
        got = np.asarray([te.compute_embedding_alignment(*p) for p in pairs],
                         np.float32).T
        ref = np.asarray([je.compute_embedding_alignment(*p) for p in pairs],
                         np.float32).T
    for g, r in zip(got[:3], ref[:3]):
        g, r = np.asarray(g, np.float32), np.asarray(r, np.float32)
        assert np.abs(g - r).max() <= np.spacing(np.abs(r).max())
    assert np.abs(np.asarray(got[3], np.float64) - ref[3]).max() <= \
        np.spacing(np.float32(np.pi))


def test_comparisons_match_jax():
    rng = np.random.default_rng(5)
    a, b = rng.normal(size=(2, 192)).astype(np.float32)
    for name in ("cosine_similarity", "euclidean_distance"):
        assert getattr(te, name)(a, b) == getattr(je, name)(a, b)
        with pytest.raises(ValueError, match="dimensions"):
            getattr(te, name)(a, b[:10])
    assert te.cosine_similarity(np.zeros(192), b) == 0.0
    assert FaceDetector.compare_faces(a, b) == \
        j_detector.FaceDetector.compare_faces(a, b)
    assert FaceDetector.face_distance(a, b) == \
        j_detector.FaceDetector.face_distance(a, b)


# -- FaceEmbedding -------------------------------------------------------------


def test_embed_matches_jax(embedders):
    """One face at a time, on the host frame and on a device tensor."""
    mine, ref = embedders
    for le, re in _PAIRS:
        got = mine.embed(_FRAME, le, re)
        want = ref.embed(_FRAME, le, re)
        assert got.shape == (192,) and got.dtype == np.float32
        assert np.abs(got - want).max() <= 1e-5
        assert abs(np.linalg.norm(got) - 1.0) <= 1e-5
        np.testing.assert_array_equal(
            mine.embed(torch.from_numpy(_FRAME), le, re), got)


def test_embed_batch_matches_jax(embedders):
    """All pairs in one crop launch and one network call, against the JAX
    batch (padded there to a power of two) and the port's single calls."""
    mine, ref = embedders
    pairs = _PAIRS + [((50.0, 60.0), (80.0, 75.0))]
    got = mine.embed_batch(_FRAME, pairs)
    want = ref.embed_batch(_FRAME, pairs)
    assert got.shape == (3, 192)
    assert np.abs(got - want).max() <= 1e-5
    for i, (le, re) in enumerate(pairs):
        assert np.abs(got[i] - mine.embed(_FRAME, le, re)).max() <= 1e-5
    assert mine.embed_batch(_FRAME, []).shape == (0, 192)


def test_embedding_contracts(nets, tmp_path):
    emb = te.FaceEmbedding(nets[0], allow_untrained=True, device="cpu")
    with pytest.raises(ValueError, match="aligned face crop"):
        emb.embed(_FRAME, (32.0, 32.0), (32.0, 32.0))
    with pytest.raises(ValueError, match="aligned face crop"):
        emb.embed_batch(_FRAME, [((10.0, 10.0), (40.0, 10.0)),
                                 ((32.0, 32.0), (32.1, 32.0))])
    with pytest.raises(ValueError, match="H, W, 3"):
        emb.embed(_FRAME[..., :2], (10.0, 10.0), (40.0, 10.0))
    with pytest.raises(FileNotFoundError):
        te.FaceEmbedding.load(str(tmp_path / "missing.tflite"), device="cpu")
    emb.dispose()
    with pytest.raises(RuntimeError, match="disposed"):
        emb.embed(_FRAME, *_PAIRS[0])
    with pytest.raises(RuntimeError, match="disposed"):
        emb.embed_batch(_FRAME, [])


def test_untrained_weights_warn(nets):
    loud = te.FaceEmbedding.load(device="cpu")
    assert not loud.is_pretrained
    assert loud.model.name == "mobilefacenet-random-init"
    with pytest.warns(te.UntrainedEmbeddingWarning):
        loud.embed(_FRAME, *_PAIRS[0])
    quiet = te.FaceEmbedding.load(allow_untrained=True, device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        quiet.embed_batch(_FRAME, _PAIRS)


def test_checkpoints_load_into_both_packages(nets, tmp_path):
    """A checkpoint the JAX package saves loads into the port (imported,
    so pretrained) with the same weights and embeddings, and one the port
    saves loads into the JAX package."""
    tm, jm = nets
    jpath = str(tmp_path / "jax.npz")
    j_ckpt.save_params_npz(jm, jpath)
    emb = te.FaceEmbedding.load(jpath, device="cpu")
    assert emb.model.name == "mobilefacenet-imported" and emb.is_pretrained
    want = tm.jax_params()
    loaded = t_ckpt.load_params_npz(jpath)
    assert all(isinstance(v, np.ndarray) for v in loaded.values())
    for k, v in emb.model.jax_params().items():
        np.testing.assert_array_equal(v, want[k])
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        got = emb.embed(_FRAME, *_PAIRS[0])
    ref = te.FaceEmbedding(tm, allow_untrained=True, device="cpu")
    np.testing.assert_array_equal(got, ref.embed(_FRAME, *_PAIRS[0]))
    tpath = str(tmp_path / "port.npz")
    t_ckpt.save_params_npz(tm, tpath)
    back = j_ckpt.swap_params(je.build_mobilefacenet(1),
                              j_ckpt.load_params_npz(tpath))
    for k, v in back.params.items():
        np.testing.assert_array_equal(np.asarray(v), want[k])


@pytest.mark.parametrize("fault", ["missing", "extra", "shape", "dtype"])
def test_checkpoint_mismatch_raises(nets, tmp_path, fault):
    params = nets[0].jax_params()
    if fault == "missing":
        del params["b2_3_d_a"]
    elif fault == "extra":
        params["b9_0_e_w"] = np.zeros(3, np.float32)
    elif fault == "shape":
        params["out_b"] = np.zeros(191, np.float32)
    else:
        params["head_w"] = params["head_w"].astype(np.float64)
    path = str(tmp_path / "bad.npz")
    np.savez(path, **params)
    match = {"missing": "missing=\\['b2_3_d_a'\\]", "extra": "b9_0_e_w",
             "shape": "shape mismatch for out_b",
             "dtype": "dtype mismatch for head_w"}[fault]
    with pytest.raises(ValueError, match=match):
        te.FaceEmbedding.load(path, device="cpu")


def test_converted_graph_checkpoint_round_trip(setup, tmp_path):
    """A converted graph's checkpoint holds the JAX keys and layouts: the
    port's file loads into the JAX model of the same IR and back."""
    _, models, jmodels = setup
    path = str(tmp_path / "mesh.npz")
    t_ckpt.save_params_npz(models.mesh, path)
    params = t_ckpt.load_params_npz(path)
    ref = {k: np.asarray(v) for k, v in jmodels.mesh.params.items()}
    assert set(params) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(params[k], ref[k])
    swapped = t_ckpt.swap_params(models.mesh, params, name="mesh-imported")
    assert swapped.name == "mesh-imported" and swapped is not models.mesh
    for k, v in models.mesh.state_dict().items():
        assert torch.equal(swapped.state_dict()[k], v)


# -- the fused FULL stage ---------------------------------------------------------


def _jax_full(jmodels, frames, **kw):
    fn = jax.jit(j_programs.build_pipeline_program(
        jmodels, H, W, JMode.FULL, max_faces=MAX_FACES, with_embeddings=True,
        **kw))
    return {k: np.asarray(v) for k, v in fn(jmodels.params, frames).items()}


@pytest.mark.parametrize("face_slab", [None, 2])
def test_fused_program_matches_jax(setup, face_slab):
    """Direct and speculative: every valid face's embedding within 1e-4 of
    the jitted JAX program's (measured: 1.33e-5) and of unit norm; the
    other outputs as ``test_full_program_matches_jax`` holds them."""
    frames, models, jmodels = setup
    prog = build_pipeline_program(models, H, W, FaceDetectionMode.FULL,
                                  max_faces=MAX_FACES, face_slab=face_slab,
                                  with_embeddings=True)
    with torch.inference_mode():
        got = {k: v.numpy() for k, v in prog(torch.from_numpy(frames)).items()}
    ref = _jax_full(jmodels, frames, face_slab=face_slab)
    emb, ref_emb = got.pop("embeddings"), ref.pop("embeddings")
    _assert_full_match(got, ref)
    v = got["valid"]
    assert emb.shape == (B, face_slab or MAX_FACES, 192) and v.any()
    assert np.abs(emb[v] - ref_emb[v]).max() <= 1e-4
    assert np.abs(np.linalg.norm(emb[v], axis=-1) - 1).max() <= 1e-5


def test_with_embeddings_needs_full_mode_and_the_model(setup):
    _, models, _ = setup
    with pytest.raises(ValueError, match="FULL"):
        build_pipeline_program(models, H, W, FaceDetectionMode.STANDARD,
                               with_embeddings=True)
    bare = PipelineModels(models.detector, "back", mesh=models.mesh,
                          device="cpu", iris=models.iris,
                          blendshapes=models.blendshapes)
    with pytest.raises(ValueError, match="embedding model"):
        build_pipeline_program(bare, H, W, with_embeddings=True)
    with pytest.raises(ValueError, match="embedding model"):
        FaceDetector(models=bare, device="cpu", embed_in_full=True)


# -- FaceDetector ---------------------------------------------------------------


def _detector(models, **kw):
    kw.setdefault("allow_untrained_embeddings", True)
    return FaceDetector(models=models, device="cpu", max_faces=MAX_FACES,
                        **kw)


def test_detector_fused_embeddings(setup):
    """With ``embed_in_full``, FULL faces carry unit-norm 192-dim
    embeddings that match ``get_face_embedding`` of the same face (fp32
    readback, so the eyes are the program's own: within 1e-4, measured
    7.3e-6; the program aligns in float32, the host in float64), the
    overflow re-run's included; STANDARD faces and a detector without
    ``embed_in_full`` carry None."""
    frames, models, _ = setup
    det = _detector(models, embed_in_full=True, quantized_readback=False)
    assert det.embed_in_full
    with pytest.raises(AttributeError):
        det.embed_in_full = False
    for _ in range(2):  # the first batch overflows the 1-face bucket
        faces = det.detect_faces_batch(frames)
        assert sum(len(f) for f in faces) >= B
        for i, per in enumerate(faces):
            for face in per:
                assert face.embedding.shape == (192,)
                assert abs(np.linalg.norm(face.embedding) - 1) <= 1e-5
                sep = det.get_face_embedding(face, frames[i])
                assert np.abs(face.embedding - sep).max() <= 1e-4
    assert any(k.startswith("face_stages[") for k in det.timings.calls)
    for face in det.detect_faces(frames[0], FaceDetectionMode.STANDARD):
        assert face.embedding is None
    for face in _detector(models).detect_faces(frames[0]):
        assert face.embedding is None


def test_detector_embeddings_null_per_face(setup):
    """get_face_embeddings([good, bad, good]) gives None for a face with
    coincident eyes, and the good ones match get_face_embedding and
    get_face_embedding_from_eyes."""
    frames, models, _ = setup
    det = _detector(models)
    good = det.detect_faces(frames[0], FaceDetectionMode.STANDARD)[0]
    kp = np.full((6, 2), 0.5, np.float32)
    bad = Face(dataclasses.replace(good.detection_data, keypoints_xy=kp),
               good.mesh, np.zeros((0, 3)), good.original_size)
    out = det.get_face_embeddings([good, bad, good], frames[0])
    assert out[1] is None
    np.testing.assert_allclose(out[0], out[2], atol=1e-6)
    single = det.get_face_embedding(good, frames[0])
    np.testing.assert_allclose(out[0], single, atol=1e-6)
    lm = good.landmarks
    np.testing.assert_array_equal(
        det.get_face_embedding_from_eyes(lm.left_eye[:2], lm.right_eye[:2],
                                         frames[0]), single)
    with pytest.raises(ValueError, match="aligned face crop"):
        det.get_face_embedding(bad, frames[0])
    assert det.get_face_embeddings([bad], frames[0]) == [None]


def test_detector_embedding_model_comes_from_the_models(setup):
    frames, models, _ = setup
    det = _detector(models)
    assert det.embedding_model.model is models.embedding
    assert not det.is_embedding_pretrained
    bare = PipelineModels(models.detector, "back", mesh=models.mesh,
                          device="cpu", iris=models.iris,
                          blendshapes=models.blendshapes)
    lazy = FaceDetector(models=bare, device="cpu",
                        allow_untrained_embeddings=True)
    assert lazy._embedding is None
    assert lazy.embedding_model.model.name == "mobilefacenet-random-init"
    with pytest.warns(te.UntrainedEmbeddingWarning):
        FaceDetector(models=models, device="cpu", embed_in_full=True)


def test_upload_cache_uploads_once(setup):
    """detect_faces then get_face_embedding on the same ndarray reuse one
    device frame; a mutated or different array uploads anew; a tensor
    passes through."""
    frames, models, _ = setup
    det = _detector(models)
    img = frames[0].copy()
    face = det.detect_faces(img)[0]
    cached = det._devput_cache[2]
    det.get_face_embedding(face, img)
    det.get_face_embeddings([face], img)
    assert det._devput_cache[2] is cached
    img[0, :50] = 255 - img[0, :50]
    assert det._device_put_cached(img) is not cached
    t = torch.from_numpy(frames[1])
    assert det._device_put_cached(t) is t


def test_dispose_frees_embedding_and_upload_cache(setup):
    frames, models, _ = setup
    det = _detector(models, embed_in_full=True)
    det.detect_faces(frames[0])
    emb = det._embedding
    assert det._devput_cache is not None and emb.model is not None
    det.dispose()
    assert det._devput_cache is None and det._embedding is None
    assert emb.model is None
    with pytest.raises(RuntimeError, match="dispose"):
        det.get_face_embedding_from_eyes((10.0, 10.0), (40.0, 10.0),
                                         frames[0])


def test_warmup_runs_every_mode(setup):
    """warmup builds the programs of the three modes and the overflow
    face-stage program of the adaptive ones; per-device warm-up is not
    ported."""
    _, models, _ = setup
    det = _detector(models, embed_in_full=True)
    det.warmup((H, W, 3), batch_size=3)
    keys = set(det._programs)
    for mode in FaceDetectionMode:
        assert (H, W, mode, 1) in keys
    for mode in (FaceDetectionMode.STANDARD, FaceDetectionMode.FULL):
        assert (H, W, mode, "stage") in keys
    with pytest.raises(NotImplementedError, match="ROADMAP §1 item 7"):
        det.warmup((H, W), devices=["cuda:0"])


@pytest.mark.parametrize("order", ["bgr", "rgb", "bgra", "rgba"])
def test_packed_bytes_match_jax(setup, order):
    """The packed-pixel decode equals the JAX package's, and detection and
    embedding through it equal those on the RGB frame."""
    frames, models, _ = setup
    rgb = frames[0]
    px = rgb[..., ::-1] if order.startswith("bgr") else rgb
    if len(order) == 4:
        px = np.concatenate([px, np.full((H, W, 1), 200, np.uint8)], -1)
    data = np.ascontiguousarray(px).tobytes()
    kw = dict(width=W, height=H, channels=len(order), channel_order=order)
    got = t_detector._image_from_packed_bytes(data, W, H, len(order), order)
    np.testing.assert_array_equal(
        got, j_detector._image_from_packed_bytes(data, W, H, len(order),
                                                 order))
    det = _detector(models)
    faces = det.detect_faces_from_packed_bytes(data, **kw)
    ref = det.detect_faces(rgb)
    assert len(faces) == len(ref) >= 1
    np.testing.assert_array_equal(faces[0].mesh.points, ref[0].mesh.points)
    if len(order) == 3:
        np.testing.assert_array_equal(
            det.get_face_embedding_from_packed_bytes(ref[0], data, **kw),
            det.get_face_embedding(ref[0], rgb))
    with pytest.raises(ValueError, match="needs"):
        det.detect_faces_from_packed_bytes(data[:-1], **kw)


def test_embedding_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        te.FaceEmbedding.load()
    emb = te.FaceEmbedding.load(device="cpu")
    assert emb.device.type == "cpu"
    assert next(emb.model.buffers()).device.type == "cpu"
