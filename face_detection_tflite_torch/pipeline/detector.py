"""FaceDetector — the public orchestration API, on PyTorch.

Port of the FAST, STANDARD and FULL modes of the JAX package's
``pipeline/detector.py`` (the reference's `FaceDetector`,
`lib/src/face_detector.dart:53`): the constructor surface, ``detect_faces``
and ``detect_faces_batch`` (FULL by default, as there) with the adaptive
speculative dispatch, batch bucketing, the int16 quantized readback,
``_materialize``, ``warmup`` and ``dispose``; the asynchronous pinned
upload (``pipeline/upload.py``) and the software-pipelined
``detect_faces_batch_stream``; the face embeddings, fused into the FULL
program (``embed_in_full``) or standalone (``get_face_embedding*``,
``compare_faces``, ``face_distance``), with the one-entry upload cache;
the encoded-input entry points with the one-entry decode cache; the
packed-pixel entry points; temporal tracking (``enable_tracking``, the
generation counter, ``reset_tracking``) and the video and camera entry
points; selfie segmentation (``get_segmentation_mask*``) and the combined
``detect_faces_with_segmentation*`` calls, which queue the mask program
before the detection and wait for its readback last; and the
observability surface (``accelerator_report``, ``memory_report``,
``cost_report``, ``is_ready``).  Every detector variant runs: BACK_CAMERA
(256 px), FRONT_CAMERA and SHORT_RANGE (128 px), FULL and FULL_SPARSE
(192 px, 2304 anchors).

Runs on ``cuda`` unless the caller passes ``device="cpu"``; with no CUDA
and no explicit device the constructor raises.  Deliberate difference
from the JAX detector: a keyword-only ``models=`` may replace loading the
``.tflite`` files from ``model_dir``, the segmenter included
(``PipelineModels(segmentation=...)``); the detector's precision applies
to those networks as it does to the files it converts.

Scale-out, as in the JAX package: ``data_parallel=True`` splits each batch
over a mesh of the visible devices with the weights on each
(``parallel/sharding.py``; no mesh with one device); ``device=`` of
``_stream_dispatch`` pins a batch to one device's weight copy
(:meth:`FaceDetector._replica_params`), which ``ReplicaPool``,
``detect_faces_batch_stream(devices=)``, ``warmup(devices=)`` and
``process_video(devices=)`` build on; ``seg_device`` runs the segmenter on
its own device.  The visible devices come from
``parallel.sharding.visible_devices``.

``cost_report`` keeps the JAX detector's keys, but PyTorch has no XLA
cost analysis: ``flops`` is counted per operator over one call of the
program (``torch.utils.flop_counter``, before any fusion),
``bytes_accessed`` and ``transcendentals`` are None, and ``memory`` is
the call's peak of allocated device bytes (None on the CPU).

``precision`` is the JAX detector's: a tier of the executor
(``"highest"``, ``"high"``, ``"default"``, ``"mixed"`` or a per-op
callable) for every network, a dict per network ("detector", "mesh",
"iris", "blendshapes", "segmentation"; a missing key is "high"), or the
``"serving"`` preset: the detector at "mixed" and the landmark networks
at "high".  The tiers' counterparts on the card are the executor's
(``convert/executor.py``).
"""

from __future__ import annotations

import collections
import os
import threading
import zlib
from typing import Optional, Sequence

import numpy as np
import torch

from ..convert.executor import convert_file
from ..kernels import build as _build
from ..models.embedding import (FaceEmbedding, compute_embedding_alignment,
                                cosine_similarity, euclidean_distance, roi_ok)
from ..models.segmentation import SegmentationMask, SelfieSegmentation
from ..parallel import sharding as _sharding
from ..utils.camera import (CameraRotation, _plane_field,
                            camera_frame_from_planes, decode_camera_frame)
from .config import (DEFAULT_MAX_MISSED_FRAMES,
                     DEFAULT_MIN_FACE_PRESENCE_CONFIDENCE, MIN_SCORE,
                     MODEL_FILES, FaceDetectionMode, FaceDetectionModel,
                     SegmentationConfig, SegmentationModel)
from .gates import validate_face_gates
from .programs import (PipelineModels, build_pipeline_program,
                       network_precision, resolve_device)
from .timings import DetectTimings, stage_range
from .tracker import TemporalFaceTracker, validate_tracking_config
from .types import Detection, Face, FaceMesh, RectF
from .types import split_meshes_if_concatenated as _split_meshes
from .upload import download_async, upload
from .video import process_video
from ..utils.image import decode_image, decode_images, load_image, \
    normalize_channels, validate_batch_shape

__all__ = ["FaceDetector", "resolve_model_dir", "resolve_device",
           "call_cost"]

_JAX_ASSETS = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "face_detection_tflite_tpu", "assets")
_DEFAULT_MODEL_DIR = os.path.join(_JAX_ASSETS, "models")


def resolve_model_dir(model_dir: Optional[str] = None) -> str:
    """The directory holding the ``.tflite`` assets: ``model_dir``,
    ``$FDT_TPU_MODEL_DIR``, or the JAX package's ``assets/models``; the
    error names the directories it looked in."""
    looked = [c for c in (model_dir, os.environ.get("FDT_TPU_MODEL_DIR"),
                          _DEFAULT_MODEL_DIR) if c]
    for c in looked:
        if os.path.isdir(c):
            return c
    raise FileNotFoundError(
        f"No model directory found (looked in {', '.join(looked)}); run "
        "`python tools/fetch_models.py`, set FDT_TPU_MODEL_DIR, pass "
        "model_dir, or pass models=")


def _each(out, fn):
    """``fn`` of a slab dict, or the list of ``fn`` of each shard dict of a
    sharded program's output."""
    return [fn(o) for o in out] if isinstance(out, list) else fn(out)


def _image_from_packed_bytes(data, width: int, height: int, channels: int,
                             channel_order: str) -> np.ndarray:
    """Raw packed pixel buffer -> RGB(A) array (Mat-bytes convention).
    The array owns a writable copy of the bytes, so it can become a tensor
    without a copy."""
    buf = np.frombuffer(bytearray(data), np.uint8)
    expected = width * height * channels
    if buf.size != expected:
        raise ValueError(
            f"packed buffer holds {buf.size} bytes; {width}x{height}x"
            f"{channels} needs {expected}")
    img = buf.reshape(height, width, channels)
    order = channel_order.lower()
    if order not in ("bgr", "rgb", "bgra", "rgba"):
        raise ValueError(f"unknown channel_order {channel_order!r}")
    if len(order) != channels:
        raise ValueError(
            f"channel_order {channel_order!r} does not match "
            f"channels={channels}")
    if order.startswith("bgr"):
        img = (np.concatenate([img[..., 2::-1], img[..., 3:]], axis=-1)
               if channels == 4 else img[..., ::-1])
    return img


def call_cost(fn, *args) -> tuple[float, Optional[int]]:
    """(FLOPs, peak allocated device bytes) of one call ``fn(*args)``:
    the FLOPs ``torch.utils.flop_counter`` counts operator by operator
    (a convolution or matmul counts 2 per multiply-add), the bytes the
    peak of ``torch.cuda.max_memory_allocated`` over the call where the
    first tensor argument lies on a card, else None."""
    from torch.utils.flop_counter import FlopCounterMode
    dev = next((a.device for a in args if torch.is_tensor(a)), None)
    on_card = dev is not None and dev.type == "cuda"
    if on_card:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    with torch.inference_mode(), FlopCounterMode(display=False) as counter:
        fn(*args)
    peak = None
    if on_card:
        torch.cuda.synchronize(dev)
        peak = int(torch.cuda.max_memory_allocated(dev))
    return float(counter.get_total_flops()), peak


class FaceDetector:
    """MediaPipe-style face pipeline on one GPU (or the CPU on request).
    Detection is thread-safe: the programs are pure and the host-side
    caches are guarded by locks."""

    MODEL_VERSION = 1  # cache-invalidation analog of `modelVersion`

    def __init__(self,
                 model: FaceDetectionModel = FaceDetectionModel.BACK_CAMERA,
                 *,
                 min_score: float = MIN_SCORE,
                 min_face_size: float = 0.0,
                 min_face_presence_confidence: float =
                 DEFAULT_MIN_FACE_PRESENCE_CONFIDENCE,
                 enable_tracking: bool = False,
                 max_missed_frames: int = DEFAULT_MAX_MISSED_FRAMES,
                 max_faces: int = 16,
                 with_segmentation: bool = False,
                 segmentation_model: SegmentationModel =
                 SegmentationModel.GENERAL,
                 segmentation_config: Optional[SegmentationConfig] = None,
                 model_dir: Optional[str] = None,
                 precision: str = "highest",
                 adaptive: bool = True,
                 bucket_images: bool = False,
                 bucket_batches: bool = True,
                 data_parallel: bool = False,
                 num_candidates: Optional[int] = None,
                 quantized_readback: bool = True,
                 detailed_timings: bool = False,
                 allow_untrained_embeddings: bool = False,
                 embed_in_full: bool = False,
                 seg_device=None,
                 device=None,
                 models: Optional[PipelineModels] = None):
        validate_face_gates(min_score, min_face_size,
                            min_face_presence_confidence)
        validate_tracking_config(max_missed_frames)
        self.device = resolve_device(device)
        if precision == "serving":
            # The JAX package's throughput preset: the detector's early
            # convs in bf16, the landmark-bearing networks at "high".
            precision = {"detector": "mixed", "mesh": "high",
                         "iris": "high", "blendshapes": "high"}
        self._precision = precision
        self.model_variant = model
        self.min_score = min_score
        self.min_face_size = min_face_size
        self.min_face_presence_confidence = min_face_presence_confidence
        self.max_faces = max_faces
        self.adaptive = adaptive
        self.num_candidates = num_candidates
        self.bucket_images = bucket_images
        self.bucket_batches = bucket_batches
        self.quantized_readback = quantized_readback
        self.detailed_timings = detailed_timings
        self._disposed = False
        try:
            self._model_dir: Optional[str] = resolve_model_dir(model_dir)
        except FileNotFoundError:
            if models is None:
                raise
            self._model_dir = None
        self._embedding: Optional[FaceEmbedding] = None
        self._allow_untrained_embeddings = allow_untrained_embeddings
        #: Fuse MobileFaceNet into the FULL program: every FULL face comes
        #: back with its embedding from the same batch call.  Constructor
        #: only (read-only property): the program cache is built from it.
        self._embed_in_full = embed_in_full
        if models is None:
            def load(key, prec_key):
                return convert_file(os.path.join(self._model_dir,
                                                 MODEL_FILES[key]),
                                    precision=network_precision(
                                        precision, prec_key))

            models = PipelineModels(
                load(model.value, "detector"), model.value,
                mesh=load("face_landmark", "mesh"), device=self.device,
                iris=load("iris_landmark", "iris"),
                blendshapes=load("face_blendshapes", "blendshapes"),
                embedding=(self.embedding_model.model if embed_in_full
                           else None))
        elif models.device != self.device:
            raise ValueError(f"models live on {models.device}, the detector "
                             f"on {self.device}")
        elif models.variant != model.value:
            raise ValueError(f"models carry the {models.variant!r} detector, "
                             f"the detector was asked for {model.name}")
        elif models.embedding is not None:
            # The fused stage and the standalone calls share one network.
            self._embedding = FaceEmbedding(
                models.embedding, allow_untrained=allow_untrained_embeddings,
                device=self.device)
        elif embed_in_full:
            raise ValueError("embed_in_full needs an embedding model: pass "
                             "models=PipelineModels(..., embedding=...)")
        # Networks passed in carry their own tiers ("highest" as built):
        # the detector's precision applies to them as to converted files.
        self.models = models.with_precision(precision)
        if embed_in_full:
            # The fused stage bypasses FaceEmbedding's per-call check, so
            # the untrained-weights state is warned once, here.
            self.embedding_model._check_trained()
        #: Data-parallel serving: the weights on every device of a 1-D
        #: mesh, each batch padded to a multiple of the mesh and split into
        #: one shard a device (``parallel/sharding.py``).  With one visible
        #: device there is no mesh, as in the JAX detector.
        self._mesh = None
        self._mesh_models = None
        if data_parallel:
            visible = _sharding.visible_devices(self.device.type)
            if len(visible) > 1:
                self._mesh = _sharding.make_mesh(visible)
                self._mesh_models = _sharding.shard_params(self.models,
                                                           self._mesh)
        #: Per-device networks of replica (device-pinned) serving, made by
        #: _replica_params and dropped by dispose.
        self._replica_params_cache: dict = {}
        #: A score-less mesh graph's zero substitute must not gate on 0.5
        #: (face_detector_core.dart:101-103: a null meshScore passes).
        self._mesh_emits_score = any(
            int(np.prod(s)) == 1 for s in models.mesh.output_shapes)
        self._programs: dict[tuple, object] = {}
        self._programs_lock = threading.Lock()
        #: Sticky speculation bucket per (H, W, mode).
        self._spec_state: dict[tuple, dict] = {}
        self._spec_lock = threading.Lock()
        #: One-entry host-to-device upload cache (see _device_put_cached).
        self._devput_cache = None
        self._devput_lock = threading.Lock()
        #: One-entry decode cache (see _decode_cached).
        self._decode_cache = None
        self._decode_cache_lock = threading.Lock()
        self.timings = DetectTimings()
        self._tracking_enabled = enable_tracking
        self._tracker = TemporalFaceTracker(
            max_missed_frames=max_missed_frames)
        self._tracker_lock = threading.Lock()
        #: Bumped by reset_tracking; a result whose detection started
        #: under an older generation gets no IDs (see _attach_tracking).
        self._tracking_generation = 0
        #: Segmentation preset; when given, its ``model`` wins over
        #: ``segmentation_model``, which is remembered for a lazy load.
        self._segmentation_config = segmentation_config
        self._segmentation_model = (segmentation_config.model
                                    if segmentation_config is not None
                                    else segmentation_model)
        #: The segmenter's device: None for the detector's, "auto" for the
        #: second visible device where there is one, or a device.  On a
        #: device of its own the combined calls run the two programs on
        #: two devices at once.
        if seg_device == "auto":
            visible = _sharding.visible_devices(self.device.type)
            seg_device = visible[1] if len(visible) > 1 else None
        self._seg_device = (resolve_device(seg_device)
                            if seg_device is not None else None)
        self._segmentation: Optional[SelfieSegmentation] = None
        if with_segmentation or segmentation_config is not None:
            self._load_segmentation(self._segmentation_model)

    def _load_segmentation(self, seg_model: SegmentationModel) -> None:
        """Builds the segmenter: ``models.segmentation`` where the models
        carry one, else the ``.tflite`` file of ``seg_model`` from the model
        directory; checks its output channels (6 for MULTICLASS, else 1;
        `selfie_segmentation.dart:424-442`) unless the config turns the
        check off.  The segmenter runs at the config's precision, else at
        the detector's (a dict's "segmentation" entry, "high" where it has
        none)."""
        cfg = self._segmentation_config
        prec = cfg.precision if cfg is not None else network_precision(
            self._precision, "segmentation")
        if self.models.segmentation is not None:
            cm = self.models.segmentation.with_precision(prec)
            source = "models.segmentation"
        else:
            if self._model_dir is None:
                raise FileNotFoundError(
                    "no segmentation model: pass models=PipelineModels(..., "
                    "segmentation=...) or a model_dir")
            source = os.path.join(self._model_dir, MODEL_FILES[
                f"segmenter_{seg_model.value}"])
            if not os.path.exists(source):
                raise FileNotFoundError(
                    f"segmentation model not found: {source}")
            cm = convert_file(source, precision=prec)
        multiclass = seg_model == SegmentationModel.MULTICLASS
        if cfg is None or cfg.validate_model:
            want = 6 if multiclass else 1
            got = cm.output_shapes[0][-1]
            if got != want:
                raise ValueError(
                    f"segmentation model {source} emits {got} channels; "
                    f"{seg_model.value} expects {want}")
        self._segmentation = SelfieSegmentation(
            cm, multiclass=multiclass,
            mask_dtype=cfg.mask_dtype if cfg else "float32",
            max_output_size=cfg.max_output_size if cfg else 2048,
            device=self.device)
        if self._seg_device is not None:
            self._segmentation.place_on(self._seg_device)

    @property
    def is_tracking_enabled(self) -> bool:
        """Whether temporal tracking IDs are attached to results
        (`isTrackingEnabled`, face_detector.dart:170)."""
        return self._tracking_enabled

    @property
    def max_missed_frames(self) -> int:
        """Frames a track survives without a match before retirement
        (`maxMissedFrames`, face_detector.dart:177)."""
        return self._tracker.max_missed_frames

    @property
    def embed_in_full(self) -> bool:
        """Whether MobileFaceNet rides the fused FULL program (read-only:
        the programs are built from the constructor's value)."""
        return self._embed_in_full

    def _embedding_weight_path(self) -> Optional[str]:
        """The first trained-weight source for MobileFaceNet that exists,
        or None (random-init weights, which cannot tell identities
        apart)."""
        candidates = [os.path.join(_JAX_ASSETS, "checkpoints",
                                   "mobilefacenet.npz")]
        if self._model_dir is not None:
            candidates[:0] = [
                os.path.join(self._model_dir, MODEL_FILES["embedding"]),
                os.path.join(self._model_dir, "mobilefacenet.npz")]
        return next((c for c in candidates if os.path.exists(c)), None)

    @property
    def is_embedding_pretrained(self) -> bool:
        """Whether trained MobileFaceNet weights back the embeddings."""
        if self._embedding is not None:
            return self._embedding.is_pretrained
        return self._embedding_weight_path() is not None

    @property
    def embedding_model(self) -> FaceEmbedding:
        """The embedding network: ``models.embedding`` where the models
        carry one, else loaded at first use."""
        self._check_disposed()
        if self._embedding is None:
            self._embedding = FaceEmbedding.load(
                self._embedding_weight_path(),
                allow_untrained=self._allow_untrained_embeddings,
                device=self.device)
        return self._embedding

    # -- programs ----------------------------------------------------------

    def _program(self, img_h: int, img_w: int, mode: FaceDetectionMode,
                 face_slab: Optional[int] = None, device=None):
        """The pipeline program of one image size and mode on ``device``
        (the detector's own by default), sharded over the mesh under
        ``data_parallel``."""
        self._check_disposed()
        if face_slab is not None and face_slab >= self.max_faces:
            face_slab = None
        models, key = self._models_key(device,
                                       (img_h, img_w, mode, face_slab))
        # Bucketed frames defer the width gate to the host.
        mfs = 0.0 if self.bucket_images else self.min_face_size

        def build(m):
            return build_pipeline_program(
                m, img_h, img_w, mode, max_faces=self.max_faces,
                min_score=self.min_score, min_face_size=mfs,
                num_candidates=self.num_candidates, face_slab=face_slab,
                with_embeddings=self._with_embeddings(mode))
        with self._programs_lock:
            if key not in self._programs:
                self._programs[key] = self._sharded(build, models, 1)
            return self._programs[key]

    def _sharded(self, build, models, n_batch_args: int):
        """``build(models)``, or under ``data_parallel`` the program built
        on each mesh device's networks and run sharded
        (:func:`~..parallel.sharding.data_parallel`)."""
        if self._mesh is None:
            return build(models)
        mesh_models = self._mesh_models
        return _sharding.data_parallel(lambda d: build(mesh_models[d]),
                                       self._mesh, n_batch_args)

    def _models_key(self, device, key: tuple):
        """(the networks a dispatch on ``device`` runs, its programs' cache
        key): the detector's own for None or its own device, else the
        device's replica (:meth:`_replica_params`), keyed by device too."""
        if device is None or device == self.device:
            return self.models, key
        return self._replica_params(device), key + (device,)

    def _replica_params(self, device) -> PipelineModels:
        """The detector's networks on ``device``, cached: its own on its
        own device, else a copy of their weights there (a few MB), made
        once for a ``ReplicaPool`` or a pinned stream."""
        device = resolve_device(device)
        with self._programs_lock:
            # Checked under the lock: dispose() marks the detector first
            # and clears this cache under the same lock, so a racing call
            # either raises here or its entry is cleared.
            self._check_disposed()
            cache = self._replica_params_cache
            if device not in cache:
                cache[device] = self.models.replicate(device)
            return cache[device]

    def _with_embeddings(self, mode: FaceDetectionMode) -> bool:
        return self._embed_in_full and mode == FaceDetectionMode.FULL

    def _face_stage_program(self, img_h: int, img_w: int,
                            mode: FaceDetectionMode, device=None):
        """The overflow re-run's face stages on given detections; under
        ``data_parallel`` sharded like the main program (the images and
        the four detection slabs all split on the batch axis)."""
        models, key = self._models_key(device, (img_h, img_w, mode, "stage"))

        def build(m):
            return build_pipeline_program(
                m, img_h, img_w, mode, from_detections=True,
                with_embeddings=self._with_embeddings(mode))
        with self._programs_lock:
            if key not in self._programs:
                self._programs[key] = self._sharded(build, models, 5)
            return self._programs[key]

    # -- readback ------------------------------------------------------------

    _QUANT_KEYS = frozenset({"mesh", "iris"})

    def _readback_scale(self, img_h: int, img_w: int) -> Optional[float]:
        """px -> int16 scale for the landmark readback (0.08 px steps at
        1280 px), or None for fp32 readback (off, or frames past 4000 px)."""
        if not self.quantized_readback:
            return None
        scale = 32000.0 / (2.0 * max(img_h, img_w))
        return scale if scale >= 4.0 else None

    @staticmethod
    def _readback_encoding(name: str, dtype, quant_scale) -> str:
        if dtype == torch.bool:
            return "u8"
        if not dtype.is_floating_point:
            return "i32"
        if quant_scale and name in FaceDetector._QUANT_KEYS:
            return "i16"
        return "f32"

    def _fetch_async(self, out, quant_scale: Optional[float] = None):
        """Packs every output into one byte buffer on the device and starts
        its copy to (pinned) host memory; :meth:`_fetch_finish` waits.  A
        list of shard outputs (``data_parallel``) is fetched shard by
        shard, each from its own device."""
        if isinstance(out, list):
            return [self._fetch_async(o, quant_scale) for o in out]
        with stage_range("fdt.pack"):
            rank = {"f32": 0, "i32": 1, "i16": 2, "u8": 3}
            entries = sorted(
                ((self._readback_encoding(k, v.dtype, quant_scale), k, v)
                 for k, v in out.items()),
                key=lambda e: (rank[e[0]], e[1]))
            segs = []
            for enc, _, x in entries:
                x = x.reshape(x.shape[0], -1)
                if enc == "u8":
                    segs.append(x.to(torch.uint8))
                    continue
                if enc == "i16":
                    x = torch.clamp(torch.round(x * quant_scale), -32767.0,
                                    32767.0).to(torch.int16)
                elif enc == "i32":
                    x = x.to(torch.int32)
                else:
                    x = x.float()
                segs.append(x.contiguous().view(torch.uint8))
            buf, event = download_async(torch.cat(segs, dim=1))
            metas = [(k, tuple(v.shape), e) for e, k, v in entries]
            return buf, event, metas, quant_scale

    def _fetch_finish(self, handle) -> dict:
        if isinstance(handle, list):
            parts = [self._fetch_finish(h) for h in handle]
            return parts[0] if len(parts) == 1 else {
                k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
        buf, event, metas, quant_scale = handle
        if event is not None:
            event.synchronize()
        with stage_range("fdt.pack"):  # the host half of the readback
            host = buf.numpy()
            result = {}
            off = 0
            for k, shape, enc in metas:
                n = int(np.prod(shape[1:]))
                if enc == "u8":
                    result[k] = (host[:, off:off + n] > 0).reshape(shape)
                    off += n
                elif enc == "i16":
                    result[k] = (host[:, off:off + 2 * n].view(np.int16)
                                 .astype(np.float32) / quant_scale
                                 ).reshape(shape)
                    off += 2 * n
                elif enc == "i32":
                    result[k] = host[:, off:off + 4 * n].view(
                        np.int32).reshape(shape)
                    off += 4 * n
                else:
                    result[k] = host[:, off:off + 4 * n].view(
                        np.float32).reshape(shape)
                    off += 4 * n
        return result

    def _fetch(self, out, quant_scale: Optional[float] = None) -> dict:
        return self._fetch_finish(self._fetch_async(out, quant_scale))

    @staticmethod
    def _wait(handle) -> None:
        """Waits for the device-to-host copies of a fetch handle."""
        for h in handle if isinstance(handle, list) else (handle,):
            if h[1] is not None:
                h[1].synchronize()

    @staticmethod
    def _rows(out, rows: int):
        """``out`` (a slab dict, or the list of shard dicts of a sharded
        program) without its rows from ``rows`` on: the batch's pad rows,
        trimmed on the device before the readback (in the ``fdt.pack``
        range).  A shard left with no row is dropped, so its readback
        never starts."""
        with stage_range("fdt.pack"):
            if isinstance(out, list):
                n = next(iter(out[0].values())).shape[0]
                kept = [(o, min(max(rows - i * n, 0), n))
                        for i, o in enumerate(out)]
                return [o if r == n else {k: v[:r] for k, v in o.items()}
                        for o, r in kept if r]
            if rows < next(iter(out.values())).shape[0]:
                return {k: v[:rows] for k, v in out.items()}
            return out

    # -- speculative single-call dispatch ------------------------------------

    def _speculation_bucket(self, h: int, w: int,
                            mode: FaceDetectionMode) -> int:
        with self._spec_lock:
            st = self._spec_state.get((h, w, mode))
            return st["bucket"] if st else min(1, self.max_faces)

    def _note_face_count(self, h: int, w: int, mode: FaceDetectionMode,
                         n: int) -> None:
        """Sticky bucket: grow at once to cover ``n``, shrink only after 8
        consecutive batches at <= half the bucket."""
        want = 1
        while want < n:
            want *= 2
        want = min(want, self.max_faces)
        with self._spec_lock:
            st = self._spec_state.setdefault(
                (h, w, mode), {"bucket": min(1, self.max_faces), "low": 0})
            if want > st["bucket"]:
                st["bucket"] = want
                st["low"] = 0
            elif want <= st["bucket"] // 2:
                st["low"] += 1
                if st["low"] >= 8:
                    st["bucket"] = max(st["bucket"] // 2, 1)
                    st["low"] = 0
            else:
                st["low"] = 0

    def _shard(self, images):
        """``images`` split over the mesh under ``data_parallel``, else
        as they are."""
        if self._mesh is None:
            return images
        return _sharding.shard_batch(images, self._mesh)

    def _dispatch_speculative(self, images, mode: FaceDetectionMode,
                              real_b: Optional[int] = None, device=None):
        """Runs the speculative program (on ``device``'s networks, or
        sharded under ``data_parallel``) and starts the packed readback of
        everything but the device-resident det_* slab (det_count joins)."""
        b, h, w, _ = images.shape
        inputs = self._shard(images)
        bucket = self._speculation_bucket(h, w, mode)
        with self.timings.stage(f"dispatch[slab{bucket}]"):
            det = self._program(h, w, mode, face_slab=bucket,
                                device=device)(inputs)
        fetch = _each(det, lambda o: {
            k: v for k, v in o.items()
            if k == "det_count" or not k.startswith("det_")})
        fetch = self._rows(fetch, b if real_b is None else real_b)
        return (bucket, det, self._fetch_async(
            fetch, self._readback_scale(h, w)), real_b, inputs, (h, w),
            device)

    def _finish_speculative(self, handle, mode: FaceDetectionMode):
        """Waits for a speculative dispatch; re-runs the face stages on a
        wider prefix iff an image overflowed the speculated bucket (on the
        same device's networks, or sharded under ``data_parallel``)."""
        bucket, det, fetch, real_b, inputs, (h, w), device = handle
        if self.detailed_timings:
            with self.timings.stage("compute_wait"):
                self._wait(fetch)
            with self.timings.stage("readback"):
                out = self._fetch_finish(fetch)
        else:
            with self.timings.stage("compute_readback"):
                out = self._fetch_finish(fetch)
        if mode == FaceDetectionMode.FAST:
            return out
        if "det_count" in out:
            n = int(out["det_count"].max())
        else:  # bucket == max_faces: no overflow possible
            n = int(out["valid"].sum(axis=1).max())
        self._note_face_count(h, w, mode, n)
        if "det_count" not in out or n <= bucket:
            out.pop("det_count", None)
            return out
        nb = 1
        while nb < n:
            nb *= 2
        nb = min(nb, self.max_faces)
        with self.timings.stage(f"face_stages[{nb}]"):
            with stage_range("fdt.postprocess"):
                prefix = [_each(det, lambda o, k=k: o[k][:, :nb]) for k in (
                    "det_boxes", "det_raw_keypoints", "det_scores",
                    "det_valid")]
            out2 = self._face_stage_program(h, w, mode, device)(
                inputs, *prefix)
        if real_b is not None:
            out2 = self._rows(out2, real_b)
        with self.timings.stage("face_readback"):
            return self._fetch(out2, self._readback_scale(h, w))

    # -- public detection ----------------------------------------------------

    def detect_faces(self, image,
                     mode: FaceDetectionMode = FaceDetectionMode.FULL
                     ) -> list[Face]:
        """Detects faces in one RGB image ([H, W, 3], uint8 or 0..255
        float, numpy or tensor).  A follow-up embedding of the same
        ndarray reuses its upload (:meth:`_device_put_cached`).  With
        tracking enabled, the faces carry tracking IDs."""
        gen0 = self._tracking_generation  # read before the detection
        if not isinstance(image, torch.Tensor):
            image = np.asarray(image)
        if image.ndim == 3 and image.shape[-1] in (1, 3, 4):
            image = self._device_put_cached(image)
        with stage_range("fdt.upload"):
            batch = image[None]
        return self._attach_tracking(
            self.detect_faces_batch(batch, mode)[0], gen0)

    def _attach_tracking(self, faces: list[Face], gen_snapshot: int
                         ) -> list[Face]:
        """Feeds one frame's faces to the tracker and attaches their IDs.

        ``gen_snapshot`` is the tracking generation read before the
        detection started: a frame in flight when :meth:`reset_tracking`
        is called belongs to the discarded stream, so it neither carries
        IDs nor updates the fresh tracker (face_tracker.dart:211-214)."""
        if not self._tracking_enabled:
            return faces
        with self._tracker_lock:
            if gen_snapshot != self._tracking_generation:
                return faces
            ids = self._tracker.update(
                [[f.bounding_box.xmin, f.bounding_box.ymin,
                  f.bounding_box.xmax, f.bounding_box.ymax]
                 for f in faces])
            return [f.with_tracking_id(i) for f, i in zip(faces, ids)]

    def reset_tracking(self) -> None:
        """Drops the temporal state; results in flight lose their IDs
        (generation counter, `face_tracker.dart:211-214`)."""
        with self._tracker_lock:
            self._tracker.reset()
            self._tracking_generation += 1

    def detect_faces_batch(self, images,
                           mode: FaceDetectionMode = FaceDetectionMode.FULL,
                           *, _orig_sizes=None, _predispatched=None,
                           _prepared=None) -> list[list[Face]]:
        """Batched detection: [B, H, W, 3] -> per-image Face lists.

        ``_orig_sizes`` (internal) carries per-image (w, h) where the
        caller padded mixed-size images into one bucket; ``_predispatched``
        an already dispatched speculative handle of these exact images, so
        that multi-bucket callers overlap dispatches before the first
        readback; ``_prepared`` that caller's :meth:`_prepare_batch`
        output, so the images are not uploaded twice."""
        return self._stream_finish(self._stream_dispatch(
            images, mode, _orig_sizes, prepared=_prepared,
            predispatched=_predispatched), mode)

    def _prepare_batch(self, raw, device=None):
        """Uploads (:func:`upload`) to ``device`` (the detector's own by
        default), channel-normalizes and bucket-pads one batch.  Returns
        (images, b, (w, h)) with the pre-pad size, or None for an empty
        batch.  Pads go bottom/right, so pixel coordinates of the content
        are unchanged."""
        if not isinstance(raw, torch.Tensor):
            raw = np.asarray(raw)
        validate_batch_shape(raw.shape)   # before the upload
        if raw.shape[0] == 0:
            return None
        with stage_range("fdt.upload"):
            images = normalize_channels(raw, device or self.device)
            b, h, w, _ = images.shape
            pad_rows = self._batch_pad_target(b) - b
            hb, wb = ((self._bucket(h), self._bucket(w))
                      if self.bucket_images else (h, w))
            if (pad_rows, hb, wb) != (0, h, w):
                images = torch.nn.functional.pad(
                    images, (0, 0, 0, wb - w, 0, hb - h, 0, pad_rows))
        return images, b, (w, h)

    def detect_faces_batch_stream(self, batches,
                                  mode: FaceDetectionMode =
                                  FaceDetectionMode.FULL,
                                  *, depth: int = 1, devices=None):
        """Software-pipelined detection over an iterable of image batches.

        Yields one ``list[list[Face]]`` per input batch, in order, while
        up to ``depth`` later batches are in flight: batch N+1 is uploaded
        (pinned, on the upload stream) and its program queued before
        batch N's readback blocks the host.  Batches may be numpy or
        tensors of shape [B, H, W, C]; different batches may differ in
        shape.  Tracking is not applied, as in
        :meth:`detect_faces_batch`.

        ``devices`` rotates consecutive batches over per-device weight
        replicas (results stay in order; ``depth`` is raised to cover the
        rotation, so every device holds a batch in flight): the
        generator-shaped sibling of ``ReplicaPool``."""
        self._check_disposed()
        if depth < 1:
            raise ValueError("depth must be >= 1")
        if devices:
            if self._mesh is not None:
                raise ValueError(
                    "devices= replica rotation cannot be combined with "
                    "data_parallel=True (which shards each batch across "
                    "the mesh instead — pick one shape)")
            devices = [resolve_device(d) for d in devices]
            depth = max(depth, len(devices))
            for d in devices:
                self._replica_params(d)  # every replica before dispatching
        pending: collections.deque = collections.deque()
        for i, raw in enumerate(batches):
            pending.append(self._stream_dispatch(
                raw, mode, device=devices[i % len(devices)] if devices
                else None))
            if len(pending) > depth:
                yield self._stream_finish(pending.popleft(), mode)
        while pending:
            yield self._stream_finish(pending.popleft(), mode)

    def _stream_dispatch(self, raw, mode: FaceDetectionMode, orig_sizes=None,
                         *, prepared=None, predispatched=None, device=None):
        """Uploads and prepares a batch and queues its program and the
        start of its readback; nothing here waits for the device.  Returns
        the handle :meth:`_stream_finish` takes (None for an empty batch).
        ``orig_sizes`` carries per-image (w, h) where the caller padded
        mixed sizes into one bucket.  ``device`` pins the batch to that
        device's weight copy (:meth:`_replica_params`): the upload, the
        programs and the readback run there."""
        self._check_disposed()
        if device is not None:
            if self._mesh is not None:
                raise ValueError(
                    "device-pinned dispatch is incompatible with "
                    "data_parallel=True (one shards batches across "
                    "chips, the other replicates per chip)")
            device = resolve_device(device)
        with torch.inference_mode(), _sharding.on_device(device):
            prep = prepared if prepared is not None else \
                self._prepare_batch(raw, device)
            if prep is None:
                return None
            images, b, wh = prep
            bh, bw = images.shape[1], images.shape[2]
            if self.adaptive:
                det = predispatched if predispatched is not None else \
                    self._dispatch_speculative(images, mode, real_b=b,
                                               device=device)
            else:
                with self.timings.stage("dispatch"):
                    dev = self._program(bh, bw, mode, device=device)(
                        self._shard(images))
                det = self._fetch_async(self._rows(dev, b),
                                        self._readback_scale(bh, bw))
        sizes = list(orig_sizes) if orig_sizes is not None else [wh] * b
        return images, det, b, sizes, device

    def _stream_finish(self, item, mode: FaceDetectionMode
                       ) -> list[list[Face]]:
        """Waits for a :meth:`_stream_dispatch` handle and builds faces."""
        if item is None:
            return []
        images, det, b, orig_sizes, device = item
        with torch.inference_mode(), _sharding.on_device(device):
            out = (self._finish_speculative(det, mode)
                   if self.adaptive else self._fetch_finish(det))
        return self._postprocess_slab(out, b, images.shape[1],
                                      images.shape[2], orig_sizes, mode)

    def _postprocess_slab(self, out, b, bh, bw, orig_sizes, mode
                          ) -> list[list[Face]]:
        """Rescales normalized outputs from the (possibly padded) frame to
        each image's own size and builds Face objects."""
        out.setdefault("keypoints", out["raw_keypoints"])
        sx = np.asarray([bw / ow for ow, _ in orig_sizes], np.float32)
        sy = np.asarray([bh / oh for _, oh in orig_sizes], np.float32)
        if not (np.all(sx == 1.0) and np.all(sy == 1.0)):
            out["boxes"] = out["boxes"] * np.stack(
                [sx, sy, sx, sy], axis=1)[:, None, :]
            kp_scale = np.stack([sx, sy], axis=1)[:, None, None, :]
            for key in ("keypoints", "raw_keypoints"):
                out[key] = out[key] * kp_scale
        return [self._materialize(out, i, orig_sizes[i], mode)
                for i in range(b)]

    def _batch_pad_target(self, b: int) -> int:
        """The padded batch size: the ladder's (with ``bucket_batches``),
        rounded up to a multiple of the mesh under ``data_parallel``, so
        that every dispatch path gets a batch that splits evenly."""
        t = self._batch_bucket(b) if self.bucket_batches else b
        if self._mesh is not None:
            t += (-t) % len(self._mesh)
        return t

    @staticmethod
    def _batch_bucket(b: int) -> int:
        """Batch-size ladder: 1, 2, 4, 8, 16, then multiples of 16."""
        if b > 16:
            return -(-b // 16) * 16
        n = 1
        while n < b:
            n *= 2
        return n

    @staticmethod
    def _bucket(v: int, step: int = 256) -> int:
        return max(step, int(-(-v // step) * step))

    def _materialize(self, out, i: int, size_wh, mode) -> list[Face]:
        """Slab -> Face objects, applying the presence gate
        (face_detector_core.dart:331-353) and the late width gate
        (face_gates.dart:84), preserving slab order."""
        faces: list[Face] = []
        valid = out["valid"][i]
        full = mode == FaceDetectionMode.FULL
        has_mesh = mode != FaceDetectionMode.FAST
        for d in range(valid.shape[0]):
            if not valid[d]:
                continue
            mesh_score = (float(out["mesh_scores"][i, d])
                          if has_mesh and self._mesh_emits_score else None)
            if (mesh_score is not None
                    and self.min_face_presence_confidence > 0.0
                    and mesh_score < self.min_face_presence_confidence):
                continue
            det = Detection(
                bounding_box=RectF(*map(float, out["boxes"][i, d])),
                score=float(out["scores"][i, d]),
                keypoints_xy=out["keypoints"][i, d],
            )
            if self.min_face_size > 0.0:
                iw = float(size_wh[0])
                left = float(out["boxes"][i, d][0]) * iw
                right = float(out["boxes"][i, d][2]) * iw
                visible = min(right, iw) - max(left, 0.0)
                frac = visible / iw if (visible > 0 and iw > 0) else 0.0
                if frac < self.min_face_size:
                    continue
            mesh = (FaceMesh(out["mesh"][i, d], score=mesh_score)
                    if has_mesh else None)
            bs = None
            if full and bool(out["blendshapes_valid"][i, d]):
                bs = out["blendshapes"][i, d]
            faces.append(Face(
                detection=det, mesh=mesh,
                irises=out["iris"][i, d] if full else np.zeros((0, 3)),
                original_size=size_wh, blendshape_scores=bs,
                embedding=(out["embeddings"][i, d] if "embeddings" in out
                           else None),
                # The program solved the head pose (fp32 in the readback).
                head_angles=out["head_angles"][i, d] if full else None))
        return faces

    # -- uploads and warm-up ---------------------------------------------------

    def _device_put_cached(self, arr) -> torch.Tensor:
        """One-entry host-to-device upload cache: detect + embed on the
        SAME frame uploads it once (through :func:`upload`).  A tensor
        passes through :func:`upload` uncached.

        A hit needs the same ndarray object (the entry holds a reference,
        so its id cannot be recycled) and the same adler32 of a strided
        sample of its bytes (about 64 KB, roughly every 50th byte of an
        853x1280 frame), which catches most in-place reuse of a caller's
        buffer; an edit confined to unsampled bytes is not caught.  A
        checksum of the whole frame would tax every detection that never
        embeds.  The upload runs in the ``fdt.upload`` range."""
        with stage_range("fdt.upload"):
            if isinstance(arr, torch.Tensor):
                return upload(arr, self.device)
            arr = np.ascontiguousarray(arr)

            def sentinel(a: np.ndarray) -> int:
                flat = a.reshape(-1).view(np.uint8)
                step = max(1, flat.size // 65536)
                return zlib.adler32(np.ascontiguousarray(flat[::step]))

            with self._devput_lock:
                cached = self._devput_cache
                if (cached is not None and cached[0] is arr
                        and cached[1] == sentinel(arr)):
                    return cached[2]
            dev = upload(arr, self.device)
            with self._devput_lock:
                self._devput_cache = (arr, sentinel(arr), dev)
            return dev

    def warmup(self, image_shape: tuple, batch_size: int = 1,
               modes: Optional[Sequence[FaceDetectionMode]] = None,
               devices: Optional[Sequence] = None) -> None:
        """Builds the kernels, warms cuDNN and runs each mode once (all
        three by default) on a zero batch of ``image_shape``, so the first
        real request pays none of it; in the adaptive modes also the
        overflow face-stage program at its smallest reachable slab, 2 (a
        zero frame detects nothing, so a detection never reaches it).

        ``devices`` also warms the replica (device-pinned) path on each of
        them: the copy of the weights and each mode's dispatch and finish
        (the overflow re-run warms on the detector's own device only)."""
        self._check_disposed()
        h, w = image_shape[:2]
        if self.bucket_images:
            h, w = self._bucket(h), self._bucket(w)
        if self.device.type == "cuda":
            _build.load()
        dummy = torch.zeros((batch_size, h, w, 3), dtype=torch.uint8,
                            device=self.device)
        b = self._batch_pad_target(batch_size)
        nf = min(2, self.max_faces)
        for mode in modes or (FaceDetectionMode.FAST,
                              FaceDetectionMode.STANDARD,
                              FaceDetectionMode.FULL):
            self.detect_faces_batch(dummy, mode)
            if not self.adaptive or mode == FaceDetectionMode.FAST:
                continue
            dev = self.device
            boxes = torch.tensor([0.3, 0.3, 0.7, 0.7], device=dev
                                 ).expand(b, nf, 4)
            kp = torch.tensor([[0.4, 0.45], [0.6, 0.45], [0.5, 0.55],
                               [0.5, 0.62], [0.33, 0.46], [0.67, 0.46]],
                              device=dev).expand(b, nf, 6, 2)
            with torch.inference_mode():
                out = self._face_stage_program(h, w, mode)(
                    torch.zeros((b, h, w, 3), dtype=torch.uint8, device=dev),
                    boxes, kp, torch.full((b, nf), 0.9, device=dev),
                    torch.ones((b, nf), dtype=torch.bool, device=dev))
                self._fetch(out, self._readback_scale(h, w))
        for d in devices or ():
            self._replica_params(d)
            pinned = np.zeros((batch_size, h, w, 3), np.uint8)
            for mode in modes or (FaceDetectionMode.FAST,
                                  FaceDetectionMode.STANDARD,
                                  FaceDetectionMode.FULL):
                self._stream_finish(
                    self._stream_dispatch(pinned, mode, device=d), mode)

    # -- embeddings ------------------------------------------------------------

    def get_face_embedding(self, face: Face, image) -> np.ndarray:
        """192-dim L2-normalised embedding for a detected face
        (`face_detector.dart:685`): aligned on its two eye points,
        iris-refined in FULL mode."""
        lm = face.landmarks
        left, right = lm.left_eye, lm.right_eye
        if left is None or right is None:
            raise ValueError("Face must have left and right eye landmarks")
        return self.embedding_model.embed(
            self._device_put_cached(image), left[:2], right[:2])

    def get_face_embedding_from_eyes(self, left_eye, right_eye,
                                     image) -> np.ndarray:
        """Embedding from the two eye centres in absolute pixels
        (`getFaceEmbeddingFromEyesDirect`, face_detector_core.dart:419)."""
        return self.embedding_model.embed(
            self._device_put_cached(image), left_eye, right_eye)

    def get_face_embeddings(self, faces: Sequence[Face], image
                            ) -> list[Optional[np.ndarray]]:
        """Embeddings for many faces of one image, in one K2 launch and
        one network call.  As the reference's `getFaceEmbeddings`
        (face_detector.dart:786-816), a face whose eye landmarks are
        missing or degenerate (the aligned crop rounds to 0 px) comes back
        as ``None`` instead of failing the batch."""
        pairs, slots = [], []
        for i, f in enumerate(faces):
            lm = f.landmarks
            if lm.left_eye is None or lm.right_eye is None:
                continue
            le, re = lm.left_eye[:2], lm.right_eye[:2]
            if not roi_ok(compute_embedding_alignment(le, re)[2]):
                continue
            pairs.append((le, re))
            slots.append(i)
        result: list[Optional[np.ndarray]] = [None] * len(faces)
        if pairs:
            out = self.embedding_model.embed_batch(
                self._device_put_cached(image), pairs)
            for i, slot in enumerate(slots):
                result[slot] = out[i]
        return result

    @staticmethod
    def compare_faces(emb1, emb2) -> float:
        return cosine_similarity(emb1, emb2)

    @staticmethod
    def face_distance(emb1, emb2) -> float:
        return euclidean_distance(emb1, emb2)

    def detect_faces_from_packed_bytes(
            self, data, *, width: int, height: int, channels: int = 3,
            channel_order: str = "bgr",
            mode: FaceDetectionMode = FaceDetectionMode.FULL) -> list[Face]:
        """Detects faces in raw packed pixel bytes, the zero-decode path
        (`detectFacesFromMatBytes`, face_detector.dart:588): ``channels``
        3 (BGR/RGB) or 4 (BGRA/RGBA), ``channel_order`` names the layout."""
        return self.detect_faces(_image_from_packed_bytes(
            data, width, height, channels, channel_order), mode)

    def get_face_embedding_from_packed_bytes(
            self, face: Face, data, *, width: int, height: int,
            channels: int = 3, channel_order: str = "bgr") -> np.ndarray:
        """Embedding from raw packed pixel bytes
        (`getFaceEmbeddingFromMatBytes`, face_detector.dart:735), with the
        buffer convention of :meth:`detect_faces_from_packed_bytes`."""
        return self.get_face_embedding(face, _image_from_packed_bytes(
            data, width, height, channels, channel_order))

    # -- encoded and file inputs -----------------------------------------------

    def _decode_cached(self, data: bytes) -> np.ndarray:
        """One-entry decode cache: detect + embed on the SAME encoded bytes
        decodes once (`decodeSourceCached`, face_detector.dart:1390-1430)."""
        data = bytes(data)
        with self._decode_cache_lock:
            cached = self._decode_cache
            if cached is not None and cached[0] == data:
                return cached[1]
        img = decode_image(data)
        with self._decode_cache_lock:
            self._decode_cache = (data, img)
        return img

    def detect_faces_from_bytes(self, data: bytes,
                                mode: FaceDetectionMode =
                                FaceDetectionMode.FULL) -> list[Face]:
        return self.detect_faces(self._decode_cached(data), mode)

    def detect_faces_from_filepath(self, path: str,
                                   mode: FaceDetectionMode =
                                   FaceDetectionMode.FULL) -> list[Face]:
        return self.detect_faces(load_image(path), mode)

    def detect_faces_from_bytes_batch(
            self, datas: Sequence[bytes],
            mode: FaceDetectionMode = FaceDetectionMode.FULL
    ) -> list[list[Face]]:
        """Decodes (the native pool where available) and detects a batch.
        Same-size images run as one batch; mixed sizes as one batch per
        size, or with ``bucket_images`` one padded batch per size bucket.
        With several groups every group's speculative dispatch is queued
        before the first readback blocks."""
        imgs = decode_images(list(datas))
        by_size: dict[tuple, list[int]] = {}
        for i, im in enumerate(imgs):
            key = ((self._bucket(im.shape[0]), self._bucket(im.shape[1]))
                   if self.bucket_images else im.shape[:2])
            by_size.setdefault(key, []).append(i)
        groups = []
        for (kh, kw), idxs in by_size.items():
            sizes = None
            if self.bucket_images:
                batch = np.stack([np.pad(imgs[i], (
                    (0, kh - imgs[i].shape[0]), (0, kw - imgs[i].shape[1]),
                    (0, 0))) for i in idxs])
                sizes = [(imgs[i].shape[1], imgs[i].shape[0]) for i in idxs]
            else:
                batch = np.stack([imgs[i] for i in idxs])
            prep = pre = None
            if self.adaptive and len(by_size) > 1:
                with torch.inference_mode():
                    prep = self._prepare_batch(batch)
                    pre = self._dispatch_speculative(prep[0], mode,
                                                     real_b=prep[1])
            groups.append((idxs, batch, sizes, pre, prep))
        results: list = [None] * len(imgs)
        for idxs, batch, sizes, pre, prep in groups:
            for i, faces in zip(idxs, self.detect_faces_batch(
                    batch, mode, _orig_sizes=sizes, _predispatched=pre,
                    _prepared=prep)):
                results[i] = faces
        return results

    # -- camera frames and video ---------------------------------------------

    def detect_faces_from_camera_frame(
            self, frame, mode: FaceDetectionMode = FaceDetectionMode.FULL,
            *, max_dim: Optional[int] = None) -> list[Face]:
        """Decodes a packed camera frame (NV12/NV21/I420/BGRA/RGBA with
        rotation) on the host and detects, with tracking where enabled
        (`detectFacesFromCameraFrame`, face_detector.dart:620-633).
        ``max_dim`` downscales the longer side before the detection;
        results are in the downscaled frame's coordinates, as in the
        reference."""
        return self.detect_faces(decode_camera_frame(frame, max_dim), mode)

    def detect_faces_from_camera_image(
            self, camera_image, mode: FaceDetectionMode =
            FaceDetectionMode.FULL, *, rotation=None, is_bgra: bool = False,
            max_dim: Optional[int] = None) -> list[Face]:
        """The `detectFacesFromCameraImage` analog
        (face_detector.dart:651-666): ``camera_image`` is any object or
        mapping with ``width``, ``height`` and ``planes`` (each plane with
        ``bytes`` and optional ``bytes_per_row``/``bytesPerRow`` and
        ``bytes_per_pixel``/``bytesPerPixel``, Flutter's `CameraImage`
        shape).  Returns an empty list when the plane layout cannot be
        decoded, and raises TypeError when ``camera_image`` lacks that
        shape (face_detector.dart:641-643).  ``is_bgra`` selects BGRA over
        RGBA for one 4-byte plane."""
        width = _plane_field(camera_image, "width")
        height = _plane_field(camera_image, "height")
        planes = _plane_field(camera_image, "planes")
        if width is None or height is None or planes is None:
            raise TypeError(
                "camera_image must expose width, height and planes "
                f"(got {type(camera_image).__name__})")
        frame = camera_frame_from_planes(
            width, height, planes,
            rotation=rotation or CameraRotation.NONE, is_bgra=is_bgra)
        if frame is None:
            return []
        return self.detect_faces_from_camera_frame(frame, mode,
                                                   max_dim=max_dim)

    def detect_faces_from_video(self, path: str,
                                mode: FaceDetectionMode =
                                FaceDetectionMode.FULL,
                                *, frame_stride: int = 1,
                                batch_size: int = 8,
                                max_frames: Optional[int] = None,
                                max_dim: Optional[int] = None,
                                devices: Optional[Sequence] = None):
        """Iterates ``VideoFrameResult`` over a video file: frames decoded
        on a prefetch thread, ``batch_size`` of them a
        ``detect_faces_batch`` call, tracking applied in frame order
        (:func:`process_video`; the reference's `detectFacesFromVideo`).
        ``devices`` spreads the batches over a ``ReplicaPool`` of them."""
        return process_video(self, path, mode, frame_stride=frame_stride,
                             batch_size=batch_size, max_frames=max_frames,
                             max_dim=max_dim, devices=devices)

    def get_face_embedding_from_bytes(self, face: Face,
                                      data: bytes) -> np.ndarray:
        """Embedding from encoded image bytes; shares the one-entry decode
        cache with :meth:`detect_faces_from_bytes`."""
        return self.get_face_embedding(face, self._decode_cached(data))

    def get_face_embedding_from_filepath(self, face: Face,
                                         path: str) -> np.ndarray:
        with open(path, "rb") as f:
            return self.get_face_embedding_from_bytes(face, f.read())

    # -- segmentation ----------------------------------------------------------

    def initialize_segmentation(
            self, config: Optional[SegmentationConfig] = None) -> None:
        """Loads the segmenter on a built detector
        (`initializeSegmentation`, face_detector.dart:434-462); a no-op
        once it is loaded (with a warning where ``config`` asks for
        another).  A failed load keeps the earlier configuration."""
        self._check_disposed()
        if self._segmentation is not None:
            if config is not None and config != self._segmentation_config:
                import warnings
                warnings.warn(
                    "initialize_segmentation: segmentation is already "
                    "loaded; the new config is ignored (create a new "
                    "FaceDetector to switch model or mask format)",
                    UserWarning, stacklevel=2)
            return
        if config is None:
            self._load_segmentation(self._segmentation_model)
            return
        prev = (self._segmentation_config, self._segmentation_model)
        self._segmentation_config = config
        self._segmentation_model = config.model
        try:
            self._load_segmentation(config.model)
        except Exception:
            self._segmentation_config, self._segmentation_model = prev
            raise

    def _segmenter(self) -> SelfieSegmentation:
        self._check_disposed()
        if self._segmentation is None:
            self._load_segmentation(self._segmentation_model)
        return self._segmentation

    def get_segmentation_mask(self, image) -> SegmentationMask:
        """The segmentation mask of one RGB image ([H, W, C], numpy or
        tensor); the frame's upload is shared with a detection or
        embedding of the same ndarray (:meth:`_device_put_cached`)."""
        seg = self._segmenter()
        return seg(self._device_put_cached(image)[None])[0]

    def get_segmentation_mask_from_bytes(self, data: bytes
                                         ) -> SegmentationMask:
        """Segments encoded image bytes; shares the one-entry decode cache
        with :meth:`detect_faces_from_bytes`."""
        return self.get_segmentation_mask(self._decode_cached(data))

    def get_segmentation_mask_from_filepath(self, path: str
                                            ) -> SegmentationMask:
        with open(path, "rb") as f:
            return self.get_segmentation_mask_from_bytes(f.read())

    def get_segmentation_mask_from_camera_frame(
            self, frame, *, max_dim: Optional[int] = None
    ) -> SegmentationMask:
        """Decodes a packed camera frame and segments it
        (`getSegmentationMaskFromCameraFrame`, face_detector.dart:970)."""
        return self.get_segmentation_mask(decode_camera_frame(frame,
                                                              max_dim))

    def detect_faces_with_segmentation(
            self, image, mode: FaceDetectionMode = FaceDetectionMode.FULL
    ) -> tuple[list[Face], SegmentationMask]:
        """Combined detect + segment on one image: the mask program is
        queued first and its readback starts without blocking, then the
        detection runs, then the mask is read; on one card the device
        work of the two is serial, the host work overlaps.  With tracking
        enabled the faces carry tracking IDs (face_detector.dart:911)."""
        seg = self._segmenter()
        gen0 = self._tracking_generation
        if not isinstance(image, torch.Tensor):
            image = self._device_put_cached(np.asarray(image))
        images = normalize_channels(image[None], self.device)
        handle = seg.dispatch(images)
        faces = self._attach_tracking(
            self.detect_faces_batch(images, mode)[0], gen0)
        return faces, seg.materialize(handle)[0]

    def detect_faces_with_segmentation_from_bytes(
            self, data: bytes,
            mode: FaceDetectionMode = FaceDetectionMode.FULL
    ) -> tuple[list[Face], SegmentationMask]:
        """Combined detect + segment from encoded bytes
        (`detectFacesWithSegmentation`, face_detector.dart:904)."""
        return self.detect_faces_with_segmentation(
            self._decode_cached(data), mode)

    def detect_faces_with_segmentation_from_camera_frame(
            self, frame, mode: FaceDetectionMode = FaceDetectionMode.FULL,
            *, max_dim: Optional[int] = None
    ) -> tuple[list[Face], SegmentationMask]:
        """Combined detect + segment from a packed camera frame
        (face_detector.dart:998)."""
        return self.detect_faces_with_segmentation(
            decode_camera_frame(frame, max_dim), mode)

    def detect_faces_with_segmentation_batch(
            self, images, mode: FaceDetectionMode = FaceDetectionMode.FULL
    ) -> list[tuple[list[Face], SegmentationMask]]:
        """Combined detect + segment over a batch: one upload, the mask
        program queued before the detection, its readback waited on
        last.  Tracking is not applied, as in :meth:`detect_faces_batch`."""
        seg = self._segmenter()
        if not isinstance(images, torch.Tensor):
            images = np.asarray(images)
        images = normalize_channels(images, self.device)
        handle = seg.dispatch(images)
        faces = self.detect_faces_batch(images, mode)
        return list(zip(faces, seg.materialize(handle)))

    # -- observability ---------------------------------------------------------

    @property
    def accelerator_report(self) -> dict[str, str]:
        """The device each network runs on (``cuda:<card name>`` or
        ``cpu``; a segmenter on a device of its own adds ``#<index>``),
        and the precision as the JAX detector reports it."""
        def backend_of(d) -> str:
            return (f"cuda:{torch.cuda.get_device_name(d)}"
                    if d.type == "cuda" else d.type)

        backend = backend_of(self.device)
        report = {name: backend
                  for name in ("detector", "mesh", "iris", "blendshapes")}
        if self._segmentation is not None:
            sd = self._seg_device
            report["segmentation"] = (
                backend if sd is None else
                f"{backend_of(sd)}#{sd.index if sd.index is not None else 0}")
        if self._embedding is not None:
            report["embedding"] = backend
        report["precision"] = str(self._precision)
        return report

    def memory_report(self) -> dict:
        """Weight bytes per network (from the modules' tensors), their
        total and the count of built programs; where replicas were made
        (:meth:`_replica_params`), their count and the weight bytes of
        each replica's networks together."""
        self._check_disposed()

        def nbytes(module) -> int:
            return sum(t.numel() * t.element_size() for t in
                       (*module.parameters(), *module.buffers()))

        report: dict = {}
        for name in ("detector", "mesh", "iris", "blendshapes", "embedding"):
            m = getattr(self.models, name, None)
            if m is not None:
                report[name] = nbytes(m)
        if "embedding" not in report and self._embedding is not None:
            report["embedding"] = nbytes(self._embedding.model)
        if self._segmentation is not None:
            report["segmentation"] = nbytes(self._segmentation.model)
        report["total_weights"] = sum(report.values())
        report["compiled_programs"] = len(self._programs)
        with self._programs_lock:
            replicas = list(self._replica_params_cache.values())
        if replicas:
            report["replica_copies"] = len(replicas)
            report["replica_weights"] = sum(
                nbytes(m) for r in replicas for m in (
                    r.detector, r.mesh, r.iris, r.blendshapes, r.embedding)
                if m is not None)
        return report

    def cost_report(self, image_shape: tuple,
                    mode: FaceDetectionMode = FaceDetectionMode.FULL,
                    batch_size: int = 1) -> dict:
        """Cost of the program for one image bucket, with the JAX
        detector's keys: ``flops`` counted per operator over one call on a
        zero batch (:func:`call_cost`, before any fusion, where XLA counts
        after it), ``bytes_accessed`` and ``transcendentals`` None (no XLA
        cost analysis), the per-image derivations, and ``memory``, the
        call's peak of allocated device bytes (None on the CPU)."""
        self._check_disposed()
        h, w = int(image_shape[0]), int(image_shape[1])
        if self.bucket_images:
            h, w = self._bucket(h), self._bucket(w)
        prog = self._program(h, w, mode)
        if self.device.type == "cuda":
            _build.load()  # the build is not the call's
        flops, peak = call_cost(prog, torch.zeros(
            (batch_size, h, w, 3), dtype=torch.uint8, device=self.device))
        return {"image_bucket": (h, w), "mode": mode.value,
                "batch_size": batch_size, "flops": flops,
                "bytes_accessed": None, "transcendentals": None,
                "flops_per_image": flops / batch_size,
                "bytes_per_image": None, "memory": peak}

    @staticmethod
    def split_meshes_if_concatenated(mesh_pts) -> list[np.ndarray]:
        """Splits a concatenated ``[N*468, ...]`` mesh point array into
        per-face arrays (`splitMeshesIfConcatenated`,
        face_detector.dart:1047-1056)."""
        return _split_meshes(np.asarray(mesh_pts))

    @property
    def is_ready(self) -> bool:
        return not self._disposed

    @property
    def is_embedding_ready(self) -> bool:
        """All models load together, so this mirrors :attr:`is_ready`
        (`isEmbeddingReady`, face_detector.dart:215)."""
        return self.is_ready

    @property
    def is_segmentation_ready(self) -> bool:
        """True once the segmenter is loaded (`isSegmentationReady`,
        face_detector.dart:217)."""
        return self._segmentation is not None and not self._disposed

    # -- lifetime ------------------------------------------------------------

    def dispose(self) -> None:
        """Releases the programs, the models' device memory (the replicas'
        and the mesh's copies too), the embedding model, the segmenter,
        the cached device frame and the decode cache."""
        self._disposed = True
        with self._programs_lock:
            self._programs.clear()
            # After _disposed is set: a racing _replica_params either
            # inserted before this clear or raises.
            self._replica_params_cache.clear()
        self._mesh_models = None
        with self._spec_lock:
            self._spec_state.clear()
        with self._devput_lock:
            self._devput_cache = None
        with self._decode_cache_lock:
            self._decode_cache = None
        if self._embedding is not None:
            self._embedding.dispose()
            self._embedding = None
        if self._segmentation is not None:
            self._segmentation.dispose()
            self._segmentation = None
        self.models = None

    def _check_disposed(self):
        if self._disposed:
            raise RuntimeError("FaceDetector used after dispose()")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.dispose()
