"""FaceDetector — the public orchestration API, on PyTorch.

Port of the FAST, STANDARD and FULL modes of the JAX package's
``pipeline/detector.py`` (the reference's `FaceDetector`,
`lib/src/face_detector.dart:53`): the constructor surface, ``detect_faces``
and ``detect_faces_batch`` (FULL by default, as there) with the adaptive
speculative dispatch, batch bucketing, the int16 quantized readback,
``_materialize`` and ``dispose``.

Runs on ``cuda`` unless the caller passes ``device="cpu"``; with no CUDA
and no explicit device the constructor raises.  Deliberate difference
from the JAX detector: a keyword-only ``models=`` may replace loading the
``.tflite`` files from ``model_dir``.  Tracking, segmentation,
embeddings, data-parallel serving and detector variants other than
BACK_CAMERA raise ``NotImplementedError`` naming their ROADMAP item.
"""

from __future__ import annotations

import os
import threading
from typing import Optional

import numpy as np
import torch

from ..convert.executor import convert_file
from .config import (DEFAULT_MIN_FACE_PRESENCE_CONFIDENCE, MIN_SCORE,
                     MODEL_FILES, FaceDetectionMode, FaceDetectionModel)
from .gates import validate_face_gates
from .programs import PipelineModels, build_pipeline_program, resolve_device
from .timings import DetectTimings
from .types import Detection, Face, FaceMesh, RectF

__all__ = ["FaceDetector", "resolve_model_dir", "resolve_device"]

_DEFAULT_MODEL_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "face_detection_tflite_tpu", "assets", "models")


def resolve_model_dir(model_dir: Optional[str] = None) -> str:
    """The directory holding the ``.tflite`` assets: ``model_dir``,
    ``$FDT_TPU_MODEL_DIR``, or the JAX package's ``assets/models``."""
    for c in (model_dir, os.environ.get("FDT_TPU_MODEL_DIR"),
              _DEFAULT_MODEL_DIR):
        if c and os.path.isdir(c):
            return c
    raise FileNotFoundError(
        "No model directory found; run `python tools/fetch_models.py`, set "
        "FDT_TPU_MODEL_DIR, pass model_dir, or pass models=")


def _not_ported(what: str, item: str):
    return NotImplementedError(f"{what} is not ported yet (ROADMAP {item})")


def _normalize_channels(images, device: torch.device) -> torch.Tensor:
    """[B, H, W, {1, 3, 4}] or [B, H, W] (numpy or tensor) -> [B, H, W, 3]
    on ``device`` (BGRA drops alpha, grayscale replicates;
    `helpers.dart:377-398`)."""
    t = images if isinstance(images, torch.Tensor) else \
        torch.from_numpy(np.ascontiguousarray(images))
    if t.dim() == 3:
        if t.shape[-1] in (1, 3, 4):
            raise ValueError(
                f"ambiguous 3-D input {tuple(t.shape)}: looks like a single "
                "[H, W, C] image — add a batch axis (img[None]); a "
                "grayscale batch must be passed as [B, H, W, 1]")
        t = t[..., None]
    if t.dim() != 4:
        raise ValueError(
            f"expected [B, H, W, C] image batch, got shape {tuple(t.shape)}")
    c = t.shape[-1]
    if c not in (1, 3, 4):
        raise ValueError(f"unsupported channel count {c} (want 1, 3 or 4)")
    if t.dtype != torch.uint8:
        t = t.float()
    t = t.to(device)
    if c == 4:
        t = t[..., :3]
    elif c == 1:
        t = t.expand(*t.shape[:-1], 3)
    return t.contiguous()


class FaceDetector:
    """MediaPipe-style face pipeline on one GPU (or the CPU on request)."""

    def __init__(self,
                 model: FaceDetectionModel = FaceDetectionModel.BACK_CAMERA,
                 *,
                 min_score: float = MIN_SCORE,
                 min_face_size: float = 0.0,
                 min_face_presence_confidence: float =
                 DEFAULT_MIN_FACE_PRESENCE_CONFIDENCE,
                 enable_tracking: bool = False,
                 max_faces: int = 16,
                 with_segmentation: bool = False,
                 model_dir: Optional[str] = None,
                 precision: str = "highest",
                 adaptive: bool = True,
                 bucket_images: bool = False,
                 bucket_batches: bool = True,
                 data_parallel: bool = False,
                 num_candidates: Optional[int] = None,
                 quantized_readback: bool = True,
                 detailed_timings: bool = False,
                 embed_in_full: bool = False,
                 device=None,
                 models: Optional[PipelineModels] = None):
        validate_face_gates(min_score, min_face_size,
                            min_face_presence_confidence)
        if model != FaceDetectionModel.BACK_CAMERA:
            raise _not_ported(f"detector variant {model.name}", "§1 item 5")
        if enable_tracking:
            raise _not_ported("temporal tracking", "§1 item 7")
        if with_segmentation:
            raise _not_ported("segmentation", "§1 item 8")
        if embed_in_full:
            raise _not_ported("embeddings", "§1 item 8")
        if data_parallel:
            raise _not_ported("data-parallel serving", "§1 item 7")
        if precision != "highest":
            raise _not_ported(f"precision {precision!r}", "§1 item 2")
        self.device = resolve_device(device)
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
        if models is None:
            mdir = resolve_model_dir(model_dir)
            def load(key):
                return convert_file(os.path.join(mdir, MODEL_FILES[key]))

            models = PipelineModels(
                load(model.value), model.value, mesh=load("face_landmark"),
                device=self.device, iris=load("iris_landmark"),
                blendshapes=load("face_blendshapes"))
        elif models.device != self.device:
            raise ValueError(f"models live on {models.device}, the detector "
                             f"on {self.device}")
        self.models = models
        #: A score-less mesh graph's zero substitute must not gate on 0.5
        #: (face_detector_core.dart:101-103: a null meshScore passes).
        self._mesh_emits_score = any(
            int(np.prod(s)) == 1 for s in models.mesh.output_shapes)
        self._programs: dict[tuple, object] = {}
        self._programs_lock = threading.Lock()
        #: Sticky speculation bucket per (H, W, mode).
        self._spec_state: dict[tuple, dict] = {}
        self._spec_lock = threading.Lock()
        self._disposed = False
        self.timings = DetectTimings()

    # -- programs ----------------------------------------------------------

    def _program(self, img_h: int, img_w: int, mode: FaceDetectionMode,
                 face_slab: Optional[int] = None):
        self._check_disposed()
        if face_slab is not None and face_slab >= self.max_faces:
            face_slab = None
        key = (img_h, img_w, mode, face_slab)
        with self._programs_lock:
            if key not in self._programs:
                # Bucketed frames defer the width gate to the host.
                mfs = 0.0 if self.bucket_images else self.min_face_size
                self._programs[key] = build_pipeline_program(
                    self.models, img_h, img_w, mode,
                    max_faces=self.max_faces, min_score=self.min_score,
                    min_face_size=mfs, num_candidates=self.num_candidates,
                    face_slab=face_slab)
            return self._programs[key]

    def _face_stage_program(self, img_h: int, img_w: int,
                            mode: FaceDetectionMode):
        key = (img_h, img_w, mode, "stage")
        with self._programs_lock:
            if key not in self._programs:
                self._programs[key] = build_pipeline_program(
                    self.models, img_h, img_w, mode, from_detections=True)
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

    def _fetch_async(self, out: dict, quant_scale: Optional[float] = None):
        """Packs every output into one byte buffer on the device and starts
        its copy to (pinned) host memory; :meth:`_fetch_finish` waits."""
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
        buf = torch.cat(segs, dim=1)
        event = None
        if buf.is_cuda:
            host = torch.empty(buf.shape, dtype=torch.uint8, pin_memory=True)
            host.copy_(buf, non_blocking=True)
            event = torch.cuda.Event()
            event.record()
            buf = host
        metas = [(k, tuple(v.shape), e) for e, k, v in entries]
        return buf, event, metas, quant_scale

    def _fetch_finish(self, handle) -> dict:
        buf, event, metas, quant_scale = handle
        if event is not None:
            event.synchronize()
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

    def _fetch(self, out: dict, quant_scale: Optional[float] = None) -> dict:
        return self._fetch_finish(self._fetch_async(out, quant_scale))

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

    def _dispatch_speculative(self, images, mode: FaceDetectionMode,
                              real_b: Optional[int] = None):
        """Runs the speculative program and starts the packed readback of
        everything but the device-resident det_* slab (det_count joins)."""
        b, h, w, _ = images.shape
        bucket = self._speculation_bucket(h, w, mode)
        with self.timings.stage(f"dispatch[slab{bucket}]"):
            det = self._program(h, w, mode, face_slab=bucket)(images)
        fetch = {k: v for k, v in det.items()
                 if k == "det_count" or not k.startswith("det_")}
        if real_b is not None and real_b < b:
            fetch = {k: v[:real_b] for k, v in fetch.items()}
        return bucket, det, self._fetch_async(
            fetch, self._readback_scale(h, w)), real_b

    def _finish_speculative(self, images, handle, mode: FaceDetectionMode):
        """Waits for a speculative dispatch; re-runs the face stages on a
        wider prefix iff an image overflowed the speculated bucket."""
        bucket, det, fetch, real_b = handle
        _, h, w, _ = images.shape
        if self.detailed_timings:
            with self.timings.stage("compute_wait"):
                if fetch[1] is not None:
                    fetch[1].synchronize()
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
            out2 = self._face_stage_program(h, w, mode)(
                images, det["det_boxes"][:, :nb],
                det["det_raw_keypoints"][:, :nb], det["det_scores"][:, :nb],
                det["det_valid"][:, :nb])
        if real_b is not None and real_b < images.shape[0]:
            out2 = {k: v[:real_b] for k, v in out2.items()}
        with self.timings.stage("face_readback"):
            return self._fetch(out2, self._readback_scale(h, w))

    # -- public detection ----------------------------------------------------

    def detect_faces(self, image,
                     mode: FaceDetectionMode = FaceDetectionMode.FULL
                     ) -> list[Face]:
        """Detects faces in one RGB image ([H, W, 3], uint8 or 0..255
        float, numpy or tensor)."""
        return self.detect_faces_batch(image[None], mode)[0]

    def detect_faces_batch(self, images,
                           mode: FaceDetectionMode = FaceDetectionMode.FULL
                           ) -> list[list[Face]]:
        """Batched detection: [B, H, W, 3] -> per-image Face lists."""
        self._check_disposed()
        with torch.inference_mode():
            prep = self._prepare_batch(images)
            if prep is None:
                return []
            images, b, (w, h) = prep
            bh, bw = images.shape[1], images.shape[2]
            if self.adaptive:
                out = self._finish_speculative(
                    images, self._dispatch_speculative(images, mode,
                                                       real_b=b), mode)
            else:
                with self.timings.stage("dispatch"):
                    dev = self._program(bh, bw, mode)(images)
                dev = {k: v[:b] for k, v in dev.items()}
                out = self._fetch(dev, self._readback_scale(bh, bw))
        return self._postprocess_slab(out, b, bh, bw, [(w, h)] * b, mode)

    def _prepare_batch(self, raw):
        """Channel-normalizes, moves to the device and bucket-pads one
        batch.  Returns (images, b, (w, h)) with the pre-pad size, or None
        for an empty batch.  Pads go bottom/right, so pixel coordinates of
        the content are unchanged."""
        images = _normalize_channels(raw, self.device)
        b, h, w, _ = images.shape
        if b == 0:
            return None
        pad_rows = (self._batch_bucket(b) if self.bucket_batches else b) - b
        hb, wb = ((self._bucket(h), self._bucket(w)) if self.bucket_images
                  else (h, w))
        if (pad_rows, hb, wb) != (0, h, w):
            images = torch.nn.functional.pad(
                images, (0, 0, 0, wb - w, 0, hb - h, 0, pad_rows))
        return images, b, (w, h)

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
                # The program solved the head pose (fp32 in the readback).
                head_angles=out["head_angles"][i, d] if full else None))
        return faces

    # -- lifetime ------------------------------------------------------------

    def dispose(self) -> None:
        """Releases the programs and the models' device memory."""
        self._disposed = True
        with self._programs_lock:
            self._programs.clear()
        with self._spec_lock:
            self._spec_state.clear()
        self.models = None

    def _check_disposed(self):
        if self._disposed:
            raise RuntimeError("FaceDetector used after dispose()")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.dispose()
