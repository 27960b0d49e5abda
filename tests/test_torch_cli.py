"""The port's command line (``face_detection_tflite_torch/cli.py``) on the
CPU, against the JAX package's CLI and the port's own API.

The trained ``.tflite`` files are not in the repository, so the commands
run the seeded networks of ``torch_parity.small_pipeline()`` through the
CLI's one detector seam (``_make_detector``, and ``_make_segmenter`` for
``segment``) under ``FDT_FORCE_CPU=1``.  ``detect --json`` is held to the
JAX program's slab with the pipeline tests' tolerances (boxes 1e-4, mesh
``max(1e-2, 1e-5·|mesh|)``); the other commands to the port's API on the
same decoded images (equal, same CPU and networks); the text output to
the JAX ``_print_faces_text`` on the same face values; the parser to the
JAX ``build_parser()``.  Without CUDA and without ``FDT_FORCE_CPU`` a
command exits 1 and runs nothing on the CPU."""

import io
import json
import os
import re
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch
from PIL import Image

from face_detection_tflite_torch import FaceDetector, cli
from face_detection_tflite_torch.convert import executor as t_exec
from face_detection_tflite_torch.models import random_init
from face_detection_tflite_torch.models.embedding import FaceEmbedding
from face_detection_tflite_torch.models.segmentation import \
    SelfieSegmentation
from face_detection_tflite_torch.pipeline import detector as t_detector
from face_detection_tflite_torch.pipeline.config import MODEL_FILES
from face_detection_tflite_torch.pipeline.smoothing import FaceSmoother
from face_detection_tflite_torch.utils import backend
from face_detection_tflite_torch.utils.render import annotate
from face_detection_tflite_tpu import cli as j_cli
from face_detection_tflite_tpu.pipeline import types as j_types

from .test_torch_full import _jax_full
from .test_torch_serving import _assert_faces_match
from .torch_parity import MAX_FACES, SMALL_SEGMENTER, small_pipeline

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAKE_DETECTOR = cli._make_detector
MAKE_SEGMENTER = cli._make_segmenter


@pytest.fixture(scope="module")
def setup():
    return small_pipeline()


@pytest.fixture(scope="module")
def pngs(setup, tmp_path_factory):
    """The setup's frames as PNG files."""
    d = tmp_path_factory.mktemp("cli")
    paths = []
    for i, f in enumerate(setup[0]):
        paths.append(str(d / f"frame{i}.png"))
        Image.fromarray(f).save(paths[-1])
    return paths


@pytest.fixture
def seeded(monkeypatch, setup):
    """``FDT_FORCE_CPU=1`` and the seam: every detector the commands build
    carries the seeded networks.  Returns the list of detectors built."""
    monkeypatch.setenv("FDT_FORCE_CPU", "1")
    made = []

    def make(args, **extra):
        made.append(MAKE_DETECTOR(args, models=setup[1], **extra))
        return made[-1]

    monkeypatch.setattr(cli, "_make_detector", make)
    return made


def _api(setup, **kw):
    return FaceDetector(models=setup[1], device="cpu", **kw)


def _run(capsys, argv):
    rc = cli.main(argv)
    cap = capsys.readouterr()
    return rc, cap.out, cap.err


def _json_lines(out):
    return [json.loads(line) for line in out.splitlines()
            if line.startswith("{")]


# -- the parser ------------------------------------------------------------


def _actions(parser):
    return {a.dest: (tuple(a.option_strings), a.choices and list(a.choices),
                     a.default, a.nargs, a.type, a.required)
            for a in parser._actions if a.dest != "help"}


def test_parser_matches_jax():
    """Subcommands, and each one's flags, choices, defaults and arity."""
    sub = cli.build_parser()._subparsers._group_actions[0]
    jsub = j_cli.build_parser()._subparsers._group_actions[0]
    assert set(sub.choices) == set(jsub.choices)
    for name, parser in sub.choices.items():
        assert _actions(parser) == _actions(jsub.choices[name]), name
    with pytest.raises(SystemExit):
        cli.build_parser().parse_args([])


def test_module_entry_point_and_version():
    """``python -m face_detection_tflite_torch --help`` and ``version``."""
    env = dict(os.environ, PYTHONPATH=REPO)
    helped = subprocess.run([sys.executable, "-m",
                             "face_detection_tflite_torch", "--help"],
                            capture_output=True, text=True, env=env,
                            cwd=REPO, timeout=120)
    assert helped.returncode == 0 and "fdt-torch" in helped.stdout
    for cmd in ("detect", "doctor", "import-weights"):
        assert cmd in helped.stdout
    version = subprocess.run([sys.executable, "-m",
                              "face_detection_tflite_torch", "version"],
                             capture_output=True, text=True, env=env,
                             cwd=REPO, timeout=120)
    from face_detection_tflite_torch import __version__
    assert version.returncode == 0 and version.stdout.strip() == __version__


# -- detect ----------------------------------------------------------------


def test_detect_json_matches_jax_program(setup, pngs, seeded, capsys):
    frames, _, jmodels = setup
    rc, out, _ = _run(capsys, ["detect", *pngs, "--json", "--mesh",
                               "--max-faces", str(MAX_FACES)])
    assert rc == 0
    lines = _json_lines(out)
    assert [d["image"] for d in lines] == pngs
    ref = _jax_full(jmodels, frames, min_score=0.5)
    tol = max(1e-2, 1e-5 * np.abs(ref["mesh"]).max())
    for i, d in enumerate(lines):
        assert (d["width"], d["height"]) == (frames.shape[2], frames.shape[1])
        keep = np.flatnonzero(ref["valid"][i] & (ref["mesh_scores"][i] >= 0.5))
        assert len(d["faces"]) == len(keep) >= 1
        for face, k in zip(d["faces"], keep):
            bb = face["bounding_box"]
            assert np.abs(np.asarray([bb["xmin"], bb["ymin"], bb["xmax"],
                                      bb["ymax"]]) - ref["boxes"][i, k]
                          ).max() <= 1e-4
            assert np.abs(np.asarray(face["mesh"]) - ref["mesh"][i, k]
                          ).max() <= tol
            assert "head_euler_angles" in face and "contours" not in face
    assert len(seeded) == 1 and seeded[0].device.type == "cpu"


def _jax_face(face):
    """The JAX package's Face on the same values as the port's ``face``."""
    det = face.detection_data
    b = det.bounding_box
    mesh = None if face.mesh is None else j_types.FaceMesh(
        face.mesh.points, face.mesh.score)
    a = face.head_euler_angles
    return j_types.Face(
        j_types.Detection(j_types.RectF(b.xmin, b.ymin, b.xmax, b.ymax),
                          det.score, det.keypoints_xy),
        mesh, face.iris_points, face.original_size, face._blendshape_scores,
        face.tracking_id,
        head_angles=None if a is None else np.asarray([a.x, a.y, a.z]))


@pytest.mark.parametrize("mode", ["full", "fast"])
def test_text_output_equals_jax_print(setup, pngs, seeded, capsys, mode):
    """The text lines equal the JAX ``_print_faces_text`` on the API's
    faces, and ``--annotate`` writes ``render.annotate`` of them."""
    out_png = os.path.join(os.path.dirname(pngs[0]), f"annotated-{mode}.png")
    rc, out, _ = _run(capsys, ["detect", pngs[0], "--mode", mode,
                               "--annotate", out_png])
    assert rc == 0
    img = np.asarray(Image.open(pngs[0]))
    from face_detection_tflite_torch import FaceDetectionMode
    faces = _api(setup).detect_faces(img, FaceDetectionMode(mode))
    want = io.StringIO()
    j_cli._print_faces_text(pngs[0], [_jax_face(f) for f in faces], out=want)
    lines = out.splitlines()
    assert lines[:-1] == want.getvalue().splitlines()
    assert lines[-1] == f"annotated image -> {out_png}"
    assert len(lines) == len(faces) + 2
    np.testing.assert_array_equal(np.asarray(Image.open(out_png)),
                                  annotate(img, faces))


@pytest.mark.parametrize("bad", ["garbage", "missing"])
def test_bad_image_is_a_clean_error(seeded, capsys, tmp_path, bad):
    path = str(tmp_path / "junk.jpg")
    if bad == "garbage":
        with open(path, "wb") as f:
            f.write(b"not an image at all")
    rc, _, err = _run(capsys, ["detect", path, "--mode", "fast"])
    assert rc == 1 and err.startswith("error:")


@pytest.mark.parametrize("cmd", ["serve", "video"])
def test_replicas_other_than_zero_name_item_7(seeded, capsys, tmp_path, cmd):
    """``--replicas`` takes the first N visible devices (the CPU's one
    here): a count below 0 or above them prints the JAX command's error,
    disposes the detector and exits 1; ``--replicas 1`` runs (the
    ``*_replicas_*`` tests below)."""
    args = [cmd] + ([str(tmp_path / "clip.mp4"), "--json"]
                    if cmd == "video" else ["--port", "0"])
    for n in (2, -1):
        rc, _, err = _run(capsys, args + ["--replicas", str(n)])
        assert rc == 1
        assert err.strip() == (f"error: --replicas {n} out of range "
                               "(0..1 device(s) visible)")
    assert len(seeded) == 2 and not any(d.is_ready for d in seeded)


# -- the backend guard -----------------------------------------------------


@pytest.mark.parametrize("cmd", ["detect", "info"])
def test_no_cuda_exits_without_running_on_the_cpu(setup, pngs, seeded,
                                                  monkeypatch, capsys, cmd):
    monkeypatch.delenv("FDT_FORCE_CPU")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc, out, err = _run(capsys, [cmd] + (pngs[:1] if cmd == "detect" else []))
    assert rc == 1 and out == ""
    assert err.startswith("error: CUDA start-up failed")
    assert "FDT_FORCE_CPU=1" in err
    assert seeded == []  # no detector was built: nothing ran on the CPU


def test_hung_start_up_exits_1():
    """A start-up that never returns exits 1 with the advice."""
    code = ("import time\n"
            "from face_detection_tflite_torch.utils import backend\n"
            "backend._probe = lambda: time.sleep(60)\n"
            "backend.ensure_backend(0.5)\n"
            "print('carried on')\n")
    env = {k: v for k, v in os.environ.items() if k != "FDT_FORCE_CPU"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, cwd=REPO, timeout=120)
    assert proc.returncode == 1 and "carried on" not in proc.stdout
    assert "FATAL" in proc.stderr and "FDT_FORCE_CPU=1" in proc.stderr


# -- doctor ----------------------------------------------------------------


@pytest.fixture
def placeholder_models(tmp_path):
    """A model directory holding every core file name (empty files)."""
    d = tmp_path / "models"
    d.mkdir()
    for key, name in MODEL_FILES.items():
        if key not in ("embedding", "segmenter_multiclass"):
            (d / name).write_bytes(b"")
    return str(d)


def test_doctor_json_has_jax_checks(placeholder_models, seeded, capsys,
                                    monkeypatch):
    """The JSON keys and check names are the JAX doctor's, with "kernel
    build" in place of "compile cache"."""
    rc, out, _ = _run(capsys, ["doctor", "--model-dir", placeholder_models,
                               "--json"])
    got = json.loads(out)
    monkeypatch.setenv("FDT_NO_COMPILE_CACHE", "1")
    j_cli.main(["doctor", "--model-dir", placeholder_models, "--json"])
    want = json.loads(capsys.readouterr().out)
    assert set(got) == set(want) == {"ok", "checks"}
    names = [c["check"] for c in got["checks"]]
    jnames = [c["check"] for c in want["checks"]]
    assert names == ["kernel build" if n == "compile cache" else n
                     for n in jnames]
    for c in got["checks"]:
        assert set(c) == {"check", "ok", "detail", "required"}
    checks = {c["check"]: c for c in got["checks"]}
    assert checks["model assets"]["ok"] and checks["device backend"]["ok"]
    assert "FDT_FORCE_CPU" in checks["device backend"]["detail"]
    # Under FDT_FORCE_CPU the kernel build is not required.
    assert not checks["kernel build"]["required"]
    assert got["ok"] is True and rc == 0


def test_doctor_reports_missing_kernels_without_building(
        placeholder_models, seeded, capsys, monkeypatch, tmp_path):
    """With ``nvcc`` found and the libraries absent, "kernel build" FAILs
    naming the fix; the self-check builds nothing."""
    from face_detection_tflite_torch.kernels import build

    def no_build():
        raise AssertionError("doctor must not build the kernels")

    monkeypatch.setattr(build, "_nvcc", lambda: "/opt/cuda/bin/nvcc")
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "kernels"))
    monkeypatch.setattr(build, "build", no_build)
    _, out, _ = _run(capsys, ["doctor", "--model-dir", placeholder_models,
                              "--json"])
    check = {c["check"]: c for c in json.loads(out)["checks"]}[
        "kernel build"]
    assert not check["ok"] and "not built" in check["detail"]
    assert "build.build()" in check["detail"]
    assert os.listdir(tmp_path / "kernels") == []


def test_doctor_model_dir_typo_fails(seeded, capsys):
    rc, out, _ = _run(capsys, ["doctor", "--model-dir", "/no/such/dir"])
    assert rc == 1
    assert "not a directory" in out and "/no/such/dir" in out
    assert "FAIL" in out


def test_doctor_recorded_start_up_error_fails(placeholder_models, seeded,
                                              monkeypatch, capsys):
    """A CUDA start-up error FAILs "device backend"; doctor runs nothing
    on the CPU (``--run`` is not run) and exits 1."""
    monkeypatch.delenv("FDT_FORCE_CPU")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc, out, _ = _run(capsys, ["doctor", "--model-dir", placeholder_models,
                               "--run", "--json"])
    checks = {c["check"]: c for c in json.loads(out)["checks"]}
    assert rc == 1
    dev = checks["device backend"]
    assert not dev["ok"] and dev["required"]
    assert "CUDA start-up FAILED" in dev["detail"]
    assert not checks["end-to-end detect"]["ok"]
    assert "not run" in checks["end-to-end detect"]["detail"]
    assert checks["kernel build"]["required"]
    assert seeded == [] and backend.backend_fallback_reason() is not None


# -- import-weights --------------------------------------------------------


def _checkpoint(tmp_path, poison=False):
    from face_detection_tflite_torch.convert.import_weights import \
        import_mobilefacenet_state_dict

    from .test_import_weights import _synthetic_state_dict
    params = import_mobilefacenet_state_dict(_synthetic_state_dict())
    if poison:
        key = next(k for k in params if params[k].ndim >= 2)
        params[key] = np.full_like(params[key], np.nan)
    src = str(tmp_path / ("nan.npz" if poison else "ckpt.npz"))
    np.savez_compressed(src, **params)
    return src


def test_import_weights_installs_and_verifies(placeholder_models, seeded,
                                              capsys, tmp_path):
    src = _checkpoint(tmp_path)
    rc, out, _ = _run(capsys, ["doctor", "--model-dir", placeholder_models,
                               "--json"])
    opt = next(c for c in json.loads(out)["checks"]
               if c["check"] == "optional models")
    assert not opt["ok"] and "RANDOM-INIT" in opt["detail"]
    rc, out, _ = _run(capsys, ["import-weights", "mobilefacenet", src,
                               "--model-dir", placeholder_models])
    assert rc == 0
    assert "BatchNorm folded" in out and "forward pass ok" in out
    dst = os.path.join(placeholder_models, "mobilefacenet.npz")
    assert os.path.isfile(dst) and not os.path.exists(dst + ".staging.npz")
    assert FaceEmbedding.load(dst, device="cpu").is_pretrained
    rc, out, _ = _run(capsys, ["doctor", "--model-dir", placeholder_models,
                               "--json"])
    opt = next(c for c in json.loads(out)["checks"]
               if c["check"] == "optional models")
    assert "mobilefacenet.tflite" not in opt["detail"]


@pytest.mark.parametrize("failure", ["nan weights", "load raises",
                                     "embed raises"])
def test_failed_verify_leaves_no_staged_file(seeded, capsys, tmp_path,
                                             monkeypatch, failure):
    """Every failure of the forward-pass check installs nothing and leaves
    no ``.staging.npz`` behind (the JAX command leaves it when the load or
    the embed raises)."""
    src = _checkpoint(tmp_path, poison=failure == "nan weights")
    dst = str(tmp_path / "out" / "w.npz")
    if failure == "load raises":
        def load(*a, **k):
            raise ValueError("checkpoint does not load")
        monkeypatch.setattr(FaceEmbedding, "load", load)
    elif failure == "embed raises":
        def embed(*a, **k):
            raise RuntimeError("embed failed")
        monkeypatch.setattr(FaceEmbedding, "embed", embed)
    argv = ["import-weights", "mobilefacenet", src, "--dst", dst]
    if failure == "embed raises":
        with pytest.raises(RuntimeError, match="embed failed"):
            cli.main(argv)
    else:
        rc, _, err = _run(capsys, argv)
        assert rc == 1 and err.startswith("error:")
    assert not os.path.exists(dst)
    assert not os.path.exists(dst + ".staging.npz")
    assert os.listdir(os.path.dirname(dst)) == []


# -- info and the cost report ----------------------------------------------


class _StubJaxDetector:
    """Enough of a JAX FaceDetector for its ``cost_report`` to run on a
    trivial program, to read the report's keys."""
    bucket_images = False
    _params = {}

    def _check_disposed(self):
        pass

    def _program(self, h, w, mode):
        import jax
        return jax.jit(lambda params, x: x.astype("float32").sum())


def test_info_reports_the_cpu_and_the_cost(setup, seeded, capsys):
    from face_detection_tflite_tpu.pipeline import detector as j_detector
    from face_detection_tflite_tpu.pipeline.config import \
        FaceDetectionMode as JMode
    rc, out, _ = _run(capsys, ["info", "--cost", "144x96"])
    info = json.loads(out)
    assert rc == 0 and info["backend"] == "cpu" and info["devices"] == ["cpu"]
    assert info["memory_report"]["total_weights"] > 0
    assert set(info["accelerator_report"]) >= {"detector", "mesh", "iris",
                                                "blendshapes", "precision"}
    cost = info["cost_analysis"]
    assert set(cost) == {"fast", "standard", "full"}
    want = j_detector.FaceDetector.cost_report(_StubJaxDetector(), (96, 144),
                                               JMode.FULL)
    for report in cost.values():
        assert set(report) == set(want)
        assert report["bytes_accessed"] is None and report["memory"] is None
        assert report["image_bucket"] == [96, 144]
    assert 0 < cost["fast"]["flops"] < cost["standard"]["flops"] \
        < cost["full"]["flops"]


def test_call_cost_counts_twice_the_convolution_macs():
    """On a one-convolution seeded graph (3x3, stride 2, SAME, 5 -> 7
    channels), the FLOPs are 2 x the multiply-adds counted from the IR."""
    from face_detection_tflite_torch.convert.tflite import (PADDING_SAME,
                                                            ModelIR, OpIR,
                                                            TensorIR)
    rng = np.random.default_rng(0)
    w = rng.normal(size=(7, 3, 3, 5)).astype(np.float32)
    tensors = [TensorIR(0, "x", (1, 16, 12, 5), np.float32, None),
               TensorIR(1, "w", w.shape, np.float32, w),
               TensorIR(2, "b", (7,), np.float32,
                        rng.normal(size=7).astype(np.float32)),
               TensorIR(3, "y", (1, 8, 6, 7), np.float32, None)]
    op = OpIR("CONV_2D", [0, 1, 2], [3],
              {"padding": PADDING_SAME, "stride_h": 2, "stride_w": 2,
               "dilation_h": 1, "dilation_w": 1, "activation": None})
    model = t_exec.convert_model(ModelIR(tensors, [op], [0], [3], "conv"))
    out_shape = tensors[3].shape
    macs = int(np.prod(out_shape)) * int(np.prod(w.shape[1:]))
    flops, peak = t_detector.call_cost(model, torch.zeros(1, 16, 12, 5))
    assert flops == 2 * macs and peak is None
    flops4, _ = t_detector.call_cost(model, torch.zeros(4, 16, 12, 5))
    assert flops4 == 4 * flops


# -- embed, segment, video, serve ------------------------------------------


def test_embed_equals_the_api(setup, pngs, seeded, capsys):
    rc, out, _ = _run(capsys, ["embed", *pngs, "--json",
                               "--allow-untrained"])
    assert rc == 0
    (got,) = _json_lines(out)
    det = _api(setup, allow_untrained_embeddings=True)
    from face_detection_tflite_torch import FaceDetectionMode
    embs = []
    for p in pngs:
        img = np.asarray(Image.open(p))
        face = det.detect_faces(img, FaceDetectionMode.STANDARD)[0]
        embs.append(det.get_face_embedding(face, img))
    assert got["images"] == pngs
    assert got["cosine_similarity"] == float(FaceDetector.compare_faces(*embs))
    assert got["euclidean_distance"] == float(
        FaceDetector.face_distance(*embs))
    rc, out, _ = _run(capsys, ["embed", pngs[0], "--json",
                               "--allow-untrained"])
    assert _json_lines(out)[0]["embedding"] == [float(v) for v in embs[0]]
    assert cli.main(["embed", *pngs, pngs[0], "--allow-untrained"]) == 2


@pytest.mark.parametrize("fmt", ["binary", "uint8"])
def test_segment_equals_the_api(pngs, monkeypatch, capsys, tmp_path, fmt):
    monkeypatch.setenv("FDT_FORCE_CPU", "1")
    seg_model = t_exec.convert_model(random_init.segmenter_ir(
        "general", seed=2, spec=SMALL_SEGMENTER))
    monkeypatch.setattr(cli, "_make_segmenter",
                        lambda args: MAKE_SEGMENTER(args, model=seg_model))
    out_png = str(tmp_path / "mask.png")
    rc, out, _ = _run(capsys, ["segment", pngs[0], "--out", out_png,
                               "--format", fmt, "--threshold", "0.6"])
    assert rc == 0 and "person coverage" in out
    img = np.asarray(Image.open(pngs[0]))
    mask = SelfieSegmentation(seg_model, device="cpu")(img[None])[0] \
        .upsample()
    want = mask.to_binary(0.6) if fmt == "binary" else mask.to_uint8()
    got = np.asarray(Image.open(out_png))
    assert got.shape == img.shape[:2]
    np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def clip(setup, tmp_path_factory):
    """The setup's frames, each twice, as a lossless 10 fps clip (PNG in
    AVI, so that the decoded frames are the frames the seeded networks
    were calibrated on)."""
    import cv2
    frames = setup[0]
    path = str(tmp_path_factory.mktemp("video") / "clip.avi")
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"png "), 10,
                             (frames.shape[2], frames.shape[1]))
    if not writer.isOpened():
        pytest.skip("cv2 cannot write PNG-in-AVI here")
    for f in np.repeat(frames, 2, axis=0):
        writer.write(np.ascontiguousarray(f[..., ::-1]))
    writer.release()
    return path


def test_video_json_equals_the_api(setup, clip, seeded, capsys):
    """``video --json`` lines are ``detect_faces_from_video``'s results
    after the One-Euro smoother, frame by frame."""
    rc, out, _ = _run(capsys, ["video", clip, "--json", "--batch-size", "3"])
    assert rc == 0
    got = _json_lines(out)
    det = _api(setup, enable_tracking=True, max_faces=16)
    smoother = FaceSmoother(alpha=0.5, method="one_euro")
    want = []
    for r in det.detect_faces_from_video(clip, batch_size=3, max_dim=1536):
        faces = smoother.smooth(r.faces, t_sec=r.timestamp_s)
        want.append({"frame": r.frame_index,
                     "timestamp_s": round(r.timestamp_s, 4),
                     "faces": [f.to_dict() for f in faces]})
    assert got == json.loads(json.dumps(want))
    assert len(got) == 4 and sum(len(g["faces"]) for g in got) >= 4
    assert all(f["tracking_id"] is not None for g in got for f in g["faces"])


def test_video_replicas_equal_the_api(setup, clip, seeded, capsys):
    """``video --replicas 1`` runs the batches through a one-replica
    ``ReplicaPool`` and prints the lines of the run without it."""
    argv = ["video", clip, "--json", "--batch-size", "3"]
    rc, plain, _ = _run(capsys, argv)
    assert rc == 0
    rc, out, _ = _run(capsys, argv + ["--replicas", "1"])
    assert rc == 0 and _json_lines(out) == _json_lines(plain)
    assert len(_json_lines(out)) == 4
    assert list(seeded[-1]._replica_params_cache) == [torch.device("cpu")]


def test_video_writes_an_annotated_clip(clip, seeded, capsys, tmp_path):
    out_mp4 = str(tmp_path / "annotated.mp4")
    rc, out, _ = _run(capsys, ["video", clip, "--out", out_mp4,
                               "--max-frames", "2", "--mode", "fast"])
    assert rc == 0 and os.path.getsize(out_mp4) > 0
    assert "2 frame(s)" in out


def test_serve_answers_with_the_detect_faces(setup, pngs, seeded, capsys):
    """``serve`` on port 0, stopped through ``_serve_stop``: one
    ``/v1/detect?mode=full`` answers 200 with the ``detect`` command's
    faces."""
    rc, out, _ = _run(capsys, ["detect", pngs[0], "--json"])
    want = _json_lines(out)[0]["faces"]
    box = {}
    th = threading.Thread(target=lambda: box.setdefault("rc", cli.main(
        ["serve", "--port", "0"])),
        daemon=True)
    th.start()
    seen, addr = "", None
    deadline = time.time() + 120
    while time.time() < deadline and addr is None:
        seen += capsys.readouterr().out
        m = re.search(r"http://([0-9.]+:\d+)", seen)
        addr = m and m.group(1)
        assert th.is_alive() or addr, f"serve exited early {box}"
        time.sleep(0.05)
    assert addr, "server never announced"
    try:
        with open(pngs[0], "rb") as f:
            req = urllib.request.Request(f"http://{addr}/v1/detect?mode=full",
                                         data=f.read(), method="POST")
        with urllib.request.urlopen(req, timeout=120) as r:
            status, payload = r.status, json.loads(r.read())
    finally:
        while cli._serve_stop is None and th.is_alive():
            time.sleep(0.01)
        cli._serve_stop.set()
        th.join(60)
    assert status == 200 and box["rc"] == 0 and not th.is_alive()
    # The server runs its micro-batches through the stream's full slab
    # where ``detect_faces`` re-runs an overflow: the serving tolerances.
    _assert_faces_match([payload["faces"]], [want])


def test_serve_replicas_report_their_devices(setup, pngs, seeded, capsys):
    """``serve --replicas 1 --mode-warmup``: the replica is warmed, a
    ``/v1/detect`` answers 200 through its ``ReplicaPool`` and
    ``/v1/info`` names the replica's device and its counters."""
    box = {}
    h, w = setup[0].shape[1:3]
    th = threading.Thread(target=lambda: box.setdefault("rc", cli.main(
        ["serve", "--port", "0", "--replicas", "1", "--mode-warmup",
         f"{w}x{h}"])), daemon=True)
    th.start()
    seen, addr = "", None
    deadline = time.time() + 120
    while time.time() < deadline and addr is None:
        seen += capsys.readouterr().out
        m = re.search(r"http://([0-9.]+:\d+)", seen)
        addr = m and m.group(1)
        assert th.is_alive() or addr, f"serve exited early {box}"
        time.sleep(0.05)
    assert addr, "server never announced"
    try:
        with open(pngs[0], "rb") as f:
            req = urllib.request.Request(
                f"http://{addr}/v1/detect?mode=fast", data=f.read(),
                method="POST")
        with urllib.request.urlopen(req, timeout=120) as r:
            status = r.status
        with urllib.request.urlopen(f"http://{addr}/v1/info",
                                    timeout=60) as r:
            info = json.loads(r.read())
    finally:
        while cli._serve_stop is None and th.is_alive():
            time.sleep(0.01)
        cli._serve_stop.set()
        th.join(60)
    assert status == 200 and box["rc"] == 0 and not th.is_alive()
    assert "1 replica devices" in seen and "[1 detect replicas]" in seen
    assert info["replica_devices"] == ["cpu"]
    assert info["replica_stats"] == {"FaceDetectionMode.FAST": [
        {"device": "cpu", "accepted": 1, "skipped_full": 0}]}
    assert info["memory_report"]["replica_copies"] == 1


def test_serve_alias_maps_the_legacy_model_name(seeded, capsys, monkeypatch):
    """``tools/serve_torch.py`` is ``serve`` with ``--model short`` read as
    ``short_range``."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "serve_torch", os.path.join(REPO, "tools", "serve_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    seen = {}

    def fake_main(argv):
        seen["argv"] = argv
        return 0

    monkeypatch.setattr(cli, "main", fake_main)
    assert mod.main(["--model", "short", "--port", "0"]) == 0
    assert seen["argv"] == ["serve", "--model", "short_range", "--port", "0"]
    assert cli.build_parser().parse_args(seen["argv"]).model == "short_range"


# -- the examples ----------------------------------------------------------


@pytest.fixture(scope="module")
def seg_models(setup):
    """The setup's networks with a narrow seeded general segmenter."""
    from face_detection_tflite_torch import PipelineModels
    m = setup[1]
    seg = t_exec.convert_model(random_init.segmenter_ir(
        "general", seed=2, spec=SMALL_SEGMENTER))
    return PipelineModels(m.detector, m.variant, mesh=m.mesh, device="cpu",
                          iris=m.iris, blendshapes=m.blendshapes,
                          embedding=m.embedding, segmentation=seg)


def _example(name):
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        f"torch_example_{name}",
        os.path.join(REPO, "examples", "torch", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", ["demo", "stream_demo", "video_demo",
                                  "lipstick_demo", "live_overlay",
                                  "replica_demo"])
def test_examples_run_on_seeded_networks(name, pngs, clip, seg_models,
                                         monkeypatch, capsys, tmp_path):
    """Each example under ``examples/torch`` runs on the seeded networks
    through the CLI's seam and writes its output; the demo's image is
    ``render.annotate`` of the API's faces and mask."""
    monkeypatch.setenv("FDT_FORCE_CPU", "1")
    made = []

    def make(args, **extra):
        made.append(MAKE_DETECTOR(args, models=seg_models, **extra))
        return made[-1]

    monkeypatch.setattr(cli, "_make_detector", make)
    out = str(tmp_path / ("out.mp4" if name == "video_demo" else
                          "out.gif" if name == "live_overlay" else
                          "out.png"))
    argv = {"demo": [pngs[0], "--out", out],
            "stream_demo": [pngs[0], "--frames", "6"],
            "video_demo": [clip, "--out", out, "--batch-size", "2"],
            "lipstick_demo": [pngs[0], "--out", out, "--color", "C02040"],
            "live_overlay": [pngs[0], "--out", out, "--frames", "2",
                             "--virtual-bg"],
            "replica_demo": [pngs[0], "--batches", "3"]}[name]
    assert _example(name).main(argv) == 0
    printed = capsys.readouterr().out
    assert len(made) == 1 and made[0].device.type == "cpu"
    if name == "stream_demo":
        assert "processed" in printed and "tracking ids" in printed
        return
    if name == "replica_demo":
        # Two replicas on the one visible device, batches round-robin.
        assert "'accepted': 2" in printed and "'accepted': 1" in printed
        assert "batch  2:" in printed
        return
    assert os.path.getsize(out) > 0
    if name == "demo":
        img = np.asarray(Image.open(pngs[0]))
        det = FaceDetector(models=seg_models, device="cpu",
                           with_segmentation=True)
        faces, mask = det.detect_faces_with_segmentation(img)
        assert faces
        np.testing.assert_array_equal(np.asarray(Image.open(out)),
                                      annotate(img, faces, mask))
