"""Command-line front-end: ``python -m face_detection_tflite_torch ...``.

The port's counterpart of the JAX package's ``fdt-tpu``, with the same
subcommands, flags and output formats:

    fdt-torch detect photo.jpg --mode full --json
    fdt-torch detect photo.jpg --annotate out.png
    fdt-torch segment photo.jpg --out mask.png --format binary
    fdt-torch embed a.jpg b.jpg            # similarity + distance
    fdt-torch video clip.mp4 --json        # tracked, smoothed faces
    fdt-torch serve --port 8080            # HTTP front-end (FaceServer)
    fdt-torch info [--cost WxH]            # backend / models / memory
    fdt-torch doctor [--run] [--json]      # deployment self-check
    fdt-torch import-weights mobilefacenet ckpt.pth

Every command runs on the CUDA card; ``FDT_FORCE_CPU=1`` asks for the
CPU.  Where CUDA does not start the command exits 1 naming the error
(``utils/backend.py``): nothing runs on the CPU unless it was asked for.

Every ``FaceDetector`` a command builds comes from :func:`_make_detector`
and every segmenter from :func:`_make_segmenter`; a caller that holds
networks of its own (seeded ones, for instance) replaces these two to pass
them as ``models=`` / ``model=``.  ``serve --replicas N`` and ``video
--replicas N`` run on the first N visible devices
(``parallel.sharding.visible_devices``), one weight copy each.

Heavy imports (torch, the detector) happen inside each subcommand, so
``--help`` stays light.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

__all__ = ["main", "build_parser"]


def _add_common_detect_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--model", default="back",
                   choices=["front", "back", "short_range", "full",
                            "full_sparse"],
                   help="BlazeFace variant (default: back)")
    p.add_argument("--model-dir", default=None,
                   help="directory holding the .tflite assets "
                        "(default: FDT_TPU_MODEL_DIR / the JAX package's "
                        "assets)")
    p.add_argument("--min-score", type=float, default=None,
                   help="detection score gate (default: model config)")
    p.add_argument("--max-faces", type=int, default=16)
    p.add_argument("--max-dim", type=int, default=1536,
                   help="downscale longer side to this before detection "
                        "(0 disables)")
    p.add_argument("--precision", default="highest",
                   choices=["highest", "high", "mixed", "serving",
                            "default"],
                   help="precision tier (default: highest = fp32)")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="fdt-torch",
        description="MediaPipe-style face pipeline on PyTorch and CUDA "
                    "(BlazeFace, FaceMesh, iris, blendshapes, "
                    "segmentation, embeddings).")
    sub = ap.add_subparsers(dest="cmd", required=True)

    d = sub.add_parser("detect", help="detect faces in image file(s)")
    d.add_argument("images", nargs="+", help="image file path(s)")
    d.add_argument("--mode", default="full",
                   choices=["fast", "standard", "full"])
    d.add_argument("--json", action="store_true",
                   help="emit one JSON object per image on stdout")
    d.add_argument("--mesh", action="store_true",
                   help="include the 468-pt mesh in --json output")
    d.add_argument("--contours", action="store_true",
                   help="include named contours in --json output")
    d.add_argument("--annotate", metavar="OUT",
                   help="write an annotated copy of the (first) image")
    _add_common_detect_args(d)

    s = sub.add_parser("segment", help="selfie-segmentation mask")
    s.add_argument("image", help="image file path")
    s.add_argument("--seg-model", default="general",
                   choices=["general", "landscape", "multiclass"])
    s.add_argument("--out", default=None, metavar="MASK_PNG",
                   help="write the mask as a grayscale PNG "
                        "(default: <image>.mask.png)")
    s.add_argument("--format", default="uint8",
                   choices=["uint8", "binary"],
                   help="mask pixel format (default: uint8 grayscale)")
    s.add_argument("--threshold", type=float, default=0.5,
                   help="binary threshold (with --format binary)")
    s.add_argument("--model-dir", default=None)
    s.add_argument("--max-dim", type=int, default=1536)

    e = sub.add_parser(
        "embed", help="face embedding for one image, or similarity for two")
    e.add_argument("images", nargs="+",
                   help="one image (print embedding) or two (compare)")
    e.add_argument("--json", action="store_true")
    e.add_argument("--allow-untrained", action="store_true",
                   help="acknowledge random-init MobileFaceNet weights "
                        "(when mobilefacenet.tflite/npz is not installed)")
    e.add_argument("--model-dir", default=None)
    e.add_argument("--max-dim", type=int, default=1536)

    vid = sub.add_parser(
        "video", help="detect (+track/smooth) over a video file")
    vid.add_argument("video", help="input video file")
    vid.add_argument("--out", default=None, metavar="OUT_MP4",
                     help="write an annotated copy "
                          "(default: <video>.annotated.mp4; use --json "
                          "to skip writing)")
    vid.add_argument("--mode", default="full",
                     choices=["fast", "standard", "full"])
    vid.add_argument("--json", action="store_true",
                     help="emit one JSON line per frame instead of an "
                          "annotated video")
    vid.add_argument("--stride", type=int, default=1,
                     help="process every Nth frame")
    vid.add_argument("--max-frames", type=int, default=None)
    vid.add_argument("--batch-size", type=int, default=8)
    vid.add_argument("--replicas", type=int, default=0, metavar="N",
                     help="spread frame batches over the first N cards "
                          "(per-card weight replicas; results stay in "
                          "frame order; 0 = the detector's card alone)")
    vid.add_argument("--smooth", default="one_euro",
                     choices=["one_euro", "ema", "none"],
                     help="temporal landmark smoothing (default: the "
                          "reference example app's One-Euro filter)")
    _add_common_detect_args(vid)

    v = sub.add_parser("serve", help="HTTP serving front-end (FaceServer)")
    v.add_argument("--host", default="127.0.0.1")
    v.add_argument("--port", type=int, default=8080)
    v.add_argument("--with-segmentation", action="store_true")
    v.add_argument("--batch-window-ms", type=float, default=4.0)
    v.add_argument("--max-batch", type=int, default=16)
    v.add_argument("--no-adaptive-batch", action="store_true",
                   help="always drain micro-batches to --max-batch "
                        "instead of adapting the cap to the measured "
                        "throughput-optimal size")
    v.add_argument("--replicas", type=int, default=0, metavar="N",
                   help="replicate detect serving over the first N cards "
                        "(per-card weight copies, round-robin batches; "
                        "0 = the detector's card alone)")
    v.add_argument("--mode-warmup", default=None, metavar="WxH",
                   help="build the kernels and run fast/standard/full once "
                        "for a WxH image before the socket opens")
    v.add_argument("--max-queue", type=int, default=128,
                   help="bound on requests waiting for the batcher; "
                        "beyond it detect/embed requests are shed with "
                        "503 + Retry-After (0 = unbounded)")
    v.add_argument("--recycle-after-batches", type=int, default=None,
                   metavar="N",
                   help="drain + rebuild the serving executors every N "
                        "batched executions (listener stays up)")
    v.add_argument("--max-rss-mb", type=float, default=None,
                   help="recycle the serving executors whenever process "
                        "RSS exceeds this many MB")
    _add_common_detect_args(v)

    iw = sub.add_parser(
        "import-weights",
        help="import trained MobileFaceNet weights from a user-supplied "
             "checkpoint (.pt/.pth state_dict or .npz) into the model "
             "discovery directory")
    iw.add_argument("model", choices=["mobilefacenet"],
                    help="which model's weights to import")
    iw.add_argument("src", help="checkpoint path (.pt/.pth/.bin/.npz; a "
                                ".tflite needs no import — drop it in the "
                                "model dir as mobilefacenet.tflite)")
    iw.add_argument("--dst", default=None,
                    help="output .npz (default: <model-dir>/"
                         "mobilefacenet.npz, where the detector "
                         "discovers it)")
    iw.add_argument("--model-dir", default=None,
                    help="discovery directory (default: "
                         "FDT_TPU_MODEL_DIR / the JAX package's assets)")
    iw.add_argument("--no-verify", action="store_true",
                    help="skip the forward-pass sanity check (loads the "
                         "network and embeds a test image)")

    i = sub.add_parser("info", help="backend, model and memory report")
    i.add_argument("--cost", default=None, metavar="WxH",
                   help="add the FLOPs (counted per operator) and peak "
                        "device memory of the fast/standard/full programs "
                        "for a WxH image")
    doc = sub.add_parser(
        "doctor",
        help="deployment self-check: model assets, device backend, "
             "kernel build, native decode (+ --run: tiny end-to-end "
             "detect)")
    doc.add_argument("--model-dir", default=None,
                     help="directory holding the .tflite assets "
                          "(default: FDT_TPU_MODEL_DIR / the JAX "
                          "package's assets)")
    doc.add_argument("--run", action="store_true",
                     help="also run one tiny end-to-end detect")
    doc.add_argument("--json", action="store_true",
                     help="machine-readable check list")
    sub.add_parser("version", help="print package version")
    return ap


def _device():
    """The device the commands' objects run on: the CPU under
    ``FDT_FORCE_CPU``, else the default (``cuda``)."""
    from .utils.backend import force_cpu
    return "cpu" if force_cpu() else None


def _make_detector(args, **extra):
    """Builds every ``FaceDetector`` of the commands from their flags
    (defaults where a command has none); ``extra`` overrides them.  The
    one seam for networks of the caller's own (``models=``)."""
    from .pipeline.config import FaceDetectionModel
    from .pipeline.detector import FaceDetector

    kw = dict(model=FaceDetectionModel(getattr(args, "model", "back")),
              max_faces=getattr(args, "max_faces", 16),
              precision=getattr(args, "precision", "highest"),
              model_dir=getattr(args, "model_dir", None), device=_device())
    if getattr(args, "min_score", None) is not None:
        kw["min_score"] = args.min_score
    kw.update(extra)
    return FaceDetector(**kw)


def _make_segmenter(args, model=None):
    """The ``segment`` command's ``SelfieSegmentation`` at "high": on
    ``model`` where given, else on the ``--seg-model`` file of the model
    directory."""
    from .models.segmentation import SelfieSegmentation

    if model is None:
        from .convert.executor import convert_file
        from .pipeline.config import MODEL_FILES
        from .pipeline.detector import resolve_model_dir
        path = os.path.join(resolve_model_dir(args.model_dir),
                            MODEL_FILES[f"segmenter_{args.seg_model}"])
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"segmentation model not found: {path} (the multiclass "
                "model ships out-of-repo in the reference too; see "
                "tools/fetch_models.py)")
        model = convert_file(path)
    return SelfieSegmentation(model.with_precision("high"),
                              multiclass=args.seg_model == "multiclass",
                              device=_device())


def _load_fitted(path: str, max_dim: int):
    from .utils.image import fit_max_dim, load_image
    img = load_image(path)
    if max_dim and max_dim > 0:
        img = fit_max_dim(img, max_dim)
    return img


def _print_faces_text(path: str, faces, out=None) -> None:
    out = out or sys.stdout  # resolved at call time (test capture works)
    print(f"{path}: {len(faces)} face(s)", file=out)
    for i, f in enumerate(faces):
        x0, y0, x1, y1 = f.bounding_box_pixels
        line = (f"  face {i}: score={f.score:.3f} "
                f"box=({x0:.0f},{y0:.0f})-({x1:.0f},{y1:.0f})px")
        if f.mesh_score is not None:
            line += f" mesh={f.mesh_score:.3f}"
        a = f.head_euler_angles
        if a is not None:
            line += f" pose=({a.x:.1f},{a.y:.1f},{a.z:.1f})deg"
        if f.smiling_probability is not None:
            line += f" smile={f.smiling_probability:.2f}"
        print(line, file=out)


def _cmd_detect(args) -> int:
    from .pipeline.config import FaceDetectionMode
    det = _make_detector(args)
    mode = FaceDetectionMode(args.mode)
    first_img = None
    first_faces = None
    for path in args.images:
        img = _load_fitted(path, args.max_dim)
        faces = det.detect_faces(img, mode)
        if first_img is None:
            first_img, first_faces = img, faces
        if args.json:
            payload = {"image": path,
                       "width": int(img.shape[1]),
                       "height": int(img.shape[0]),
                       "faces": [f.to_dict(include_mesh=args.mesh,
                                           include_contours=args.contours)
                                 for f in faces]}
            print(json.dumps(payload))
        else:
            _print_faces_text(path, faces)
    if args.annotate:
        from PIL import Image

        from .utils.render import annotate
        Image.fromarray(annotate(first_img, first_faces)).save(args.annotate)
        if not args.json:
            print(f"annotated image -> {args.annotate}")
    return 0


def _cmd_segment(args) -> int:
    seg = _make_segmenter(args)
    img = _load_fitted(args.image, args.max_dim)
    mask = seg(img[None])[0].upsample()
    arr = (mask.to_binary(args.threshold) if args.format == "binary"
           else mask.to_uint8())
    out = args.out or (os.path.splitext(args.image)[0] + ".mask.png")
    from PIL import Image
    Image.fromarray(arr, mode="L").save(out)
    cover = float((mask.data >= args.threshold).mean())
    print(f"{args.image}: person coverage {cover:.1%}, "
          f"mask {arr.shape[1]}x{arr.shape[0]} -> {out}")
    return 0


def _cmd_embed(args) -> int:
    if len(args.images) > 2:
        print("embed takes one or two images", file=sys.stderr)
        return 2
    from .pipeline.config import FaceDetectionMode
    from .pipeline.detector import FaceDetector
    det = _make_detector(args,
                         allow_untrained_embeddings=args.allow_untrained)

    def first_face_embedding(path):
        img = _load_fitted(path, args.max_dim)
        faces = det.detect_faces(img, FaceDetectionMode.STANDARD)
        if not faces:
            raise SystemExit(f"no face found in {path}")
        return det.get_face_embedding(faces[0], img)

    embs = [first_face_embedding(p) for p in args.images]
    if len(embs) == 1:
        if args.json:
            print(json.dumps({"image": args.images[0],
                              "embedding": [float(v) for v in embs[0]]}))
        else:
            print(f"{args.images[0]}: {len(embs[0])}-dim embedding, "
                  f"first 8 = {[round(float(v), 4) for v in embs[0][:8]]}")
        return 0
    sim = FaceDetector.compare_faces(embs[0], embs[1])
    dist = FaceDetector.face_distance(embs[0], embs[1])
    if args.json:
        print(json.dumps({"images": args.images,
                          "cosine_similarity": float(sim),
                          "euclidean_distance": float(dist)}))
    else:
        print(f"cosine similarity: {sim:.4f}")
        print(f"euclidean distance: {dist:.4f}")
    return 0


#: Sentinel: --replicas was out of range (the error printed, the detector
#: disposed); the command returns exit code 1.
_REPLICAS_ERROR = object()


def _resolve_replica_devices(args, det):
    """Maps ``--replicas N`` to the first N visible devices of the
    detector's kind (the serve and video commands).  Returns None for 0,
    the device list otherwise, or :data:`_REPLICAS_ERROR` after printing
    the range error and disposing ``det``."""
    if not args.replicas:
        return None
    from .parallel.sharding import visible_devices
    avail = visible_devices(det.device.type)
    if args.replicas < 0 or args.replicas > len(avail):
        print(f"error: --replicas {args.replicas} out of range "
              f"(0..{len(avail)} device(s) visible)", file=sys.stderr)
        det.dispose()
        return _REPLICAS_ERROR
    return avail[:args.replicas]


def _cmd_video(args) -> int:
    from .pipeline.config import FaceDetectionMode
    from .pipeline.smoothing import FaceSmoother
    det = _make_detector(args, enable_tracking=True)
    mode = FaceDetectionMode(args.mode)
    devices = _resolve_replica_devices(args, det)
    if devices is _REPLICAS_ERROR:
        return 1
    smoother = (None if args.smooth == "none"
                else FaceSmoother(alpha=0.5, method=args.smooth))

    writer = None
    cap = None
    out_path = None
    if not args.json:
        import cv2
        cap = cv2.VideoCapture(args.video)
        if not cap.isOpened():
            raise ValueError(f"cannot open video: {args.video}")
        fps = (cap.get(cv2.CAP_PROP_FPS) or 30.0) / max(args.stride, 1)
        out_path = args.out or (os.path.splitext(args.video)[0]
                                + ".annotated.mp4")

    frames = 0
    total_faces = 0
    try:
        frame_idx = -1
        frame = None

        def frame_at(i):
            # A second incremental pass over the container, in step with
            # the result stream (O(1) memory).
            nonlocal frame_idx, frame
            while frame_idx < i:
                ok, frame = cap.read()
                if not ok:
                    raise ValueError(f"frame {i} unreadable on second pass")
                frame_idx += 1
            return frame

        for res in det.detect_faces_from_video(
                args.video, mode, frame_stride=args.stride,
                batch_size=args.batch_size, max_frames=args.max_frames,
                max_dim=args.max_dim or None, devices=devices):
            faces = (smoother.smooth(res.faces, t_sec=res.timestamp_s)
                     if smoother else res.faces)
            frames += 1
            total_faces += len(faces)
            if args.json:
                print(json.dumps(
                    {"frame": res.frame_index,
                     "timestamp_s": round(res.timestamp_s, 4),
                     "faces": [f.to_dict() for f in faces]}))
                continue
            import cv2
            import numpy as np

            from .utils.image import fit_max_dim
            from .utils.render import annotate
            rgb = frame_at(res.frame_index)[..., ::-1]
            if args.max_dim:
                rgb = fit_max_dim(rgb, args.max_dim)
            if writer is None:
                h, w = rgb.shape[:2]
                writer = cv2.VideoWriter(
                    out_path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
                if not writer.isOpened():
                    raise ValueError(
                        f"cannot open video writer for {out_path}")
            out = annotate(np.ascontiguousarray(rgb), faces)
            writer.write(np.ascontiguousarray(out[..., ::-1]))
    finally:
        if writer is not None:
            writer.release()
        if cap is not None:
            cap.release()
    if not args.json:
        print(f"{args.video}: {frames} frame(s), {total_faces} face "
              f"detection(s) -> {out_path}")
    return 0


#: Set by tests (or another thread) to stop a blocking `serve` command.
_serve_stop = None


def _cmd_serve(args) -> int:
    import threading

    from .pipeline.server import FaceServer
    global _serve_stop
    det = _make_detector(args, with_segmentation=args.with_segmentation)
    devices = _resolve_replica_devices(args, det)
    if devices is _REPLICAS_ERROR:
        return 1
    if args.mode_warmup:
        w, h = (int(v) for v in args.mode_warmup.lower().split("x"))
        print(f"warming fast/standard/full programs for {w}x{h}"
              + (f" on {len(devices)} replica devices" if devices else "")
              + "...", flush=True)
        det.warmup((h, w, 3), batch_size=1, devices=devices)
    server = FaceServer(det, host=args.host, port=args.port,
                        batch_window_ms=args.batch_window_ms,
                        max_batch=args.max_batch, devices=devices,
                        max_queue=args.max_queue,
                        recycle_after_batches=args.recycle_after_batches,
                        max_rss_mb=args.max_rss_mb,
                        adaptive_batch=not args.no_adaptive_batch).start()
    print(f"serving on {server.address}  "
          f"(POST /v1/detect, /v1/segment, /v1/embed; GET /metrics)"
          + (f"  [{len(devices)} detect replicas]" if devices else ""),
          flush=True)
    _serve_stop = threading.Event()
    try:
        _serve_stop.wait()  # run until interrupted (or a test stops us)
    except KeyboardInterrupt:
        print("shutting down")
    finally:
        _serve_stop = None
        server.close()
        det.dispose()
    return 0


def _devices() -> list[str]:
    """The devices the commands run on, by name."""
    from .utils.backend import force_cpu
    if force_cpu():
        return ["cpu"]
    import torch
    return [f"cuda:{i} {torch.cuda.get_device_name(i)}"
            for i in range(torch.cuda.device_count())]


def _cmd_info(args) -> int:
    from . import __version__
    from .utils.backend import force_cpu
    info: dict = {"version": __version__}
    try:
        from .pipeline.detector import resolve_model_dir
        info["model_dir"] = resolve_model_dir()
    except FileNotFoundError as e:
        info["model_dir"] = None
        info["model_dir_error"] = str(e)
    info["backend"] = "cpu" if force_cpu() else "cuda"
    info["devices"] = _devices()
    try:
        det = _make_detector(args)
    except FileNotFoundError as e:  # no networks to report on
        info.setdefault("model_dir_error", str(e))
        det = None
    if det is not None:
        from .pipeline.config import FaceDetectionMode
        info["accelerator_report"] = det.accelerator_report
        info["memory_report"] = det.memory_report()
        if getattr(args, "cost", None):
            w, h = (int(v) for v in args.cost.lower().split("x"))
            info["cost_analysis"] = {
                m.value: det.cost_report((h, w), m)
                for m in FaceDetectionMode}
        det.dispose()
    print(json.dumps(info, indent=2))
    return 0


def _cmd_import_weights(args) -> int:
    """One-command trained-weight install: the converter-side importer
    (``convert/import_weights.py``: BN-fold, layout mapping and per-tensor
    shape validation against the MobileFaceNet template), then a
    forward-pass check through ``FaceEmbedding.load``, writing the .npz
    where the detector discovers it.

    The .npz is staged beside the destination and moved there only after
    the check; the staged file is removed on every failure path (the JAX
    command leaves it behind when the load or the embed raises)."""
    import numpy as np

    from .convert.import_weights import import_mobilefacenet

    dst = args.dst
    if dst is None:
        from .pipeline.detector import _JAX_ASSETS, resolve_model_dir
        try:
            dst = os.path.join(resolve_model_dir(args.model_dir),
                               "mobilefacenet.npz")
        except FileNotFoundError:
            # No model dir yet (weights-first setup): the checkpoint dir
            # is the detector's last discovery path.
            dst = os.path.join(_JAX_ASSETS, "checkpoints",
                               "mobilefacenet.npz")
    params = import_mobilefacenet(args.src)
    n_params = sum(int(np.prod(v.shape)) for v in params.values())
    n_bytes = sum(v.nbytes for v in params.values())
    print(f"import ok: {len(params)} tensors, {n_params:,} params "
          f"({n_bytes / 1e6:.1f} MB fp32) — BatchNorm folded, "
          "shapes validated against the MobileFaceNet template")
    os.makedirs(os.path.dirname(dst) or ".", exist_ok=True)
    staged = dst + ".staging.npz"  # np.savez appends .npz if absent
    np.savez_compressed(staged, **params)
    try:
        if not args.no_verify:
            from .models.embedding import FaceEmbedding
            emb = FaceEmbedding.load(staged, device=_device())
            img = np.random.default_rng(0).integers(
                0, 255, (200, 200, 3), dtype=np.uint8)
            vec = emb.embed(img, (60.0, 90.0), (140.0, 90.0))
            emb.dispose()
            norm = float(np.linalg.norm(vec))
            if not (np.isfinite(vec).all() and abs(norm - 1.0) < 1e-4):
                print(f"error: forward-pass check failed (norm={norm}, "
                      f"finite={bool(np.isfinite(vec).all())}); "
                      "nothing was installed", file=sys.stderr)
                return 1
            print(f"forward pass ok: {vec.size}-dim embedding, L2 norm "
                  f"{norm:.6f}")
        os.replace(staged, dst)
    finally:
        if os.path.exists(staged):
            os.remove(staged)
    print(f"wrote {dst}")
    print("embeddings are now identity-discriminative: the detector "
          "discovers this file automatically (doctor's optional-models "
          "check turns green; no UntrainedEmbeddingWarning)")
    return 0


def _kernel_build_check(add) -> None:
    """doctor's "kernel build": ``nvcc`` found, the build directory
    writable, both libraries built.  It only looks: the first kernel
    launch builds what is missing (``build.load()``).  Required unless
    ``FDT_FORCE_CPU`` asks for the CPU."""
    from .kernels import build
    from .utils.backend import force_cpu
    required = not force_cpu()
    try:
        nvcc = build._nvcc()
    except RuntimeError as e:
        add("kernel build", False, str(e), required=required)
        return
    try:
        os.makedirs(build.BUILD_DIR, exist_ok=True)
        writable = os.access(build.BUILD_DIR, os.W_OK)
    except OSError:
        writable = False
    if not writable:
        add("kernel build", False, f"{build.BUILD_DIR} not writable",
            required=required)
        return
    paths = build.library_paths()
    missing = [os.path.basename(p) for p in paths if not os.path.exists(p)]
    add("kernel build", not missing,
        f"{nvcc}; {build.BUILD_DIR}: "
        + ", ".join(os.path.basename(p) for p in paths) if not missing else
        f"{nvcc}; {build.BUILD_DIR}: not built ({', '.join(missing)}; "
        "the first command on the card builds them, or `python -c "
        "'from face_detection_tflite_torch.kernels import build; "
        "build.build()'`)",
        required=required)


def _cmd_doctor(args) -> int:
    """Fresh-deployment self-check: are the model assets installed, is
    the card up, can the kernels be built, is the native decode pool
    loaded.  Required failures exit 1 with the fix printed."""
    from .utils.backend import backend_fallback_reason, force_cpu
    checks: list = []

    def add(name, ok, detail, required=True):
        checks.append({"check": name, "ok": bool(ok), "detail": detail,
                       "required": required})

    # 1. model assets (required; embedding/multiclass ship out-of-repo
    #    upstream, so their absence is expected and optional).
    from .pipeline.config import MODEL_FILES
    from .pipeline.detector import resolve_model_dir
    optional_models = {"embedding", "segmenter_multiclass"}
    model_dir = None
    if args.model_dir and not os.path.isdir(args.model_dir):
        # resolve_model_dir falls through a nonexistent explicit dir to
        # the env/package defaults; a self-check must not validate a
        # different directory than the one it was given.
        add("model assets", False,
            f"--model-dir {args.model_dir}: not a directory")
    else:
        try:
            model_dir = resolve_model_dir(args.model_dir)
        except FileNotFoundError as e:
            add("model assets", False, str(e))
    if model_dir:
        missing = sorted(f for k, f in MODEL_FILES.items()
                         if k not in optional_models
                         and not os.path.isfile(os.path.join(model_dir, f)))
        add("model assets",
            not missing,
            f"{model_dir}: all core .tflite files present" if not missing
            else f"{model_dir}: missing {', '.join(missing)} — run "
                 "`python tools/fetch_models.py`")
        extras = sorted(
            f for k, f in MODEL_FILES.items() if k in optional_models
            and not os.path.isfile(os.path.join(model_dir, f)))
        npz = os.path.join(model_dir, "mobilefacenet.npz")
        if "mobilefacenet.tflite" in extras and os.path.isfile(npz):
            extras.remove("mobilefacenet.tflite")  # imported weights found
        embed_untrained = ("mobilefacenet.tflite" in extras
                           or "mobilefacenet.npz" in extras)
        add("optional models", not extras,
            "trained embedding/multiclass models present"
            if not extras else
            f"absent (expected; out-of-repo upstream): {', '.join(extras)}"
            " — import via tools/import_weights.py or drop the .tflite in"
            + ("; embeddings will run RANDOM-INIT (cannot discriminate "
               "identities)" if embed_untrained else ""),
            required=False)

    # 2. device backend (main() probed CUDA and recorded any error).
    failed_start = backend_fallback_reason()
    if failed_start:
        add("device backend", False,
            f"CUDA start-up FAILED: {failed_start}; nothing ran on the cpu "
            "(set FDT_FORCE_CPU=1 if the CPU is intended)")
    elif force_cpu():
        add("device backend", True, "cpu (FDT_FORCE_CPU)")
    else:
        add("device backend", True, "cuda: " + ", ".join(_devices()))

    # 3. the CUDA kernels' build (nvcc, the build directory, the libraries).
    _kernel_build_check(add)

    # 4. native decode pool (optional: PIL decodes otherwise).
    from .utils.native import native_available, runtime_status
    add("native decode", native_available(),
        "C++ JPEG/PNG/WebP pool loaded" if native_available() else
        f"not loaded ({runtime_status()}); PIL decodes instead",
        required=False)

    # 5. opt-in end-to-end smoke, on the card (or the CPU asked for).
    assets_ok = any(c["check"] == "model assets" and c["ok"] for c in checks)
    if args.run and failed_start:
        add("end-to-end detect", False, "not run: CUDA did not start")
    elif args.run and model_dir and assets_ok:
        import time

        import numpy as np

        from .pipeline.config import FaceDetectionMode
        det = None
        try:
            det = _make_detector(args, model_dir=model_dir, max_faces=2)
            img = np.zeros((64, 64, 3), np.uint8)
            t0 = time.perf_counter()
            faces = det.detect_faces(img, mode=FaceDetectionMode.FAST)
            ms = (time.perf_counter() - t0) * 1e3
            add("end-to-end detect", True,
                f"64x64 FAST: {len(faces)} faces in {ms:.0f} ms "
                "(includes the first call's set-up)")
        except Exception as e:  # any failure is the finding itself
            add("end-to-end detect", False, f"{type(e).__name__}: {e}")
        finally:
            if det is not None:
                det.dispose()

    failed = [c for c in checks if c["required"] and not c["ok"]]
    if args.json:
        print(json.dumps({"ok": not failed, "checks": checks}, indent=2))
    else:
        for c in checks:
            mark = "ok  " if c["ok"] else ("FAIL" if c["required"]
                                           else "warn")
            print(f"{mark}  {c['check']}: {c['detail']}")
        print("doctor: " + ("all required checks passed" if not failed
                            else f"{len(failed)} required check(s) FAILED"))
    return 0 if not failed else 1


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.cmd == "version":
        from . import __version__
        print(__version__)
        return 0
    # Every command goes through the CUDA start-up guard (a hang exits, an
    # error stops the command); doctor records the error to report it.
    from .utils.backend import BackendUnavailable, ensure_backend
    try:
        ensure_backend(record_only=args.cmd == "doctor")
    except BackendUnavailable as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    try:
        return {"detect": _cmd_detect, "segment": _cmd_segment,
                "embed": _cmd_embed, "video": _cmd_video,
                "serve": _cmd_serve, "info": _cmd_info,
                "import-weights": _cmd_import_weights,
                "doctor": _cmd_doctor}[args.cmd](args)
    except (ValueError, FileNotFoundError) as e:
        # Undecodable images, missing files and models: stderr and exit 1,
        # not a traceback (the reference's FormatException/ArgumentError,
        # face_detector.dart:497-499).
        print(f"error: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    raise SystemExit(main())
