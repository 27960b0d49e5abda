"""ctypes bindings of the native image decoder (``runtime/decode.cc``).

The port's own loader for the JAX package's unchanged C++ decode pool
(JPEG, PNG and WebP through libjpeg, libpng and libwebp, a pthread worker
pool).  It loads the committed ``runtime/build/libfdt_runtime.so``; where
that library does not load (a machine without the codec libraries it
links), it builds ``runtime/decode.cc`` with ``g++`` into the package's
``kernels/_build/``, under a name keyed by the source's hash.  It never
runs ``make -C runtime``, which would rewrite the committed library.  Where
neither works the decoder is unavailable and ``utils.image`` decodes
otherwise; :func:`runtime_status` says what happened.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Optional, Sequence

import numpy as np

__all__ = ["load_runtime", "runtime_status", "native_available",
           "ImageDecoderPool", "JpegDecoderPool"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_RUNTIME_DIR = os.path.join(os.path.dirname(_PKG), "runtime")
_SOURCE = os.path.join(_RUNTIME_DIR, "decode.cc")
_LIB_PATH = os.path.join(_RUNTIME_DIR, "build", "libfdt_runtime.so")
_BUILD_DIR = os.path.join(_PKG, "kernels", "_build")
_CXX_FLAGS = ("-O2", "-fPIC", "-std=c++17", "-shared")
_LIBS = ("-ljpeg", "-lpng", "-lwebp", "-lpthread")

_lib = None
_status = "not loaded yet"
_lock = threading.Lock()


def _build() -> str:
    """Compiles ``runtime/decode.cc`` into ``kernels/_build/`` (once per
    source hash) and returns the library's path; raises on failure."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("no g++ or c++ on PATH")
    with open(_SOURCE, "rb") as f:
        h = hashlib.sha256(" ".join(_CXX_FLAGS + _LIBS).encode() + f.read())
    path = os.path.join(_BUILD_DIR,
                        f"libfdt_runtime_{h.hexdigest()[:16]}.so")
    if not os.path.exists(path):
        os.makedirs(_BUILD_DIR, exist_ok=True)
        tmp = f"{path}.{os.getpid()}"
        proc = subprocess.run([cxx, *_CXX_FLAGS, _SOURCE, "-o", tmp, *_LIBS],
                              capture_output=True, text=True, timeout=300)
        if proc.returncode:
            raise RuntimeError(f"{cxx} failed: {proc.stderr.strip()[-400:]}")
        os.replace(tmp, path)
    return path


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.fdt_image_probe.restype = ctypes.c_int
    lib.fdt_image_probe.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    lib.fdt_image_decode.restype = ctypes.c_int
    lib.fdt_image_decode.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int]
    lib.fdt_pool_create.restype = ctypes.c_void_p
    lib.fdt_pool_create.argtypes = [ctypes.c_int]
    lib.fdt_pool_destroy.argtypes = [ctypes.c_void_p]
    lib.fdt_pool_decode_batch.restype = ctypes.c_int
    lib.fdt_pool_decode_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_char_p),
        ctypes.POINTER(ctypes.c_size_t), ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    return lib


def load_runtime() -> Optional[ctypes.CDLL]:
    """The native decoder library, or None where it neither loads nor
    builds.  The outcome is kept, so a failure is not retried."""
    global _lib, _status
    with _lock:
        if _lib is None:
            try:
                _lib = _bind(ctypes.CDLL(_LIB_PATH))
                _status = "loaded the committed runtime/build library"
            except (OSError, AttributeError) as e:
                load_error = e
                try:
                    path = _build()
                    _lib = _bind(ctypes.CDLL(path))
                    _status = (f"the committed library did not load "
                               f"({load_error}); built {os.path.basename(path)}"
                               f" with g++")
                except (OSError, AttributeError, RuntimeError,
                        subprocess.SubprocessError) as e2:
                    _lib = False
                    _status = (f"unavailable: the committed library did not "
                               f"load ({load_error}) and the build failed "
                               f"({e2})")
        return _lib or None


def runtime_status() -> str:
    """How the native decoder was (or was not) obtained."""
    load_runtime()
    return _status


def native_available() -> bool:
    return load_runtime() is not None


class ImageDecoderPool:
    """Threaded native image decoder (JPEG, PNG, WebP).  Inputs the native
    layer does not decode exactly (a 16-bit PNG, say) raise ValueError, so
    callers decode them otherwise."""

    def __init__(self, threads: int = 0):
        lib = load_runtime()
        if lib is None:
            raise RuntimeError(f"native decoder {runtime_status()}")
        self._lib = lib
        if threads <= 0:
            threads = min(16, os.cpu_count() or 4)
        self._pool = lib.fdt_pool_create(threads)
        self.threads = threads

    def probe(self, data: bytes) -> tuple[int, int]:
        """(width, height) of an encoded image without decoding it."""
        w, h = ctypes.c_int(), ctypes.c_int()
        rc = self._lib.fdt_image_probe(data, len(data), ctypes.byref(w),
                                       ctypes.byref(h))
        if rc != 0:
            raise ValueError(
                f"not natively decodable image bytes (status {rc})")
        return w.value, h.value

    def decode(self, data: bytes) -> np.ndarray:
        """One encoded image -> RGB uint8 [H, W, 3]."""
        w, h = self.probe(data)
        out = np.empty((h, w, 3), np.uint8)
        rc = self._lib.fdt_image_decode(
            data, len(data), out.ctypes.data_as(ctypes.c_void_p), w, h)
        if rc != 0:
            raise ValueError(f"native image decode failed (status {rc})")
        return out

    def decode_batch(self, datas: Sequence[bytes]) -> list[np.ndarray]:
        """Decodes many images (formats may be mixed) concurrently."""
        if not self._pool:
            raise RuntimeError("ImageDecoderPool is closed")
        n = len(datas)
        if n == 0:
            return []
        sizes = [self.probe(d) for d in datas]
        outs = [np.empty((h, w, 3), np.uint8) for w, h in sizes]
        rc = self._lib.fdt_pool_decode_batch(
            self._pool, n, (ctypes.c_char_p * n)(*datas),
            (ctypes.c_size_t * n)(*[len(d) for d in datas]),
            (ctypes.c_void_p * n)(*[o.ctypes.data for o in outs]),
            (ctypes.c_int * n)(*[w for w, _ in sizes]),
            (ctypes.c_int * n)(*[h for _, h in sizes]))
        if rc != 0:
            raise ValueError(f"batch image decode failed (status {rc})")
        return outs

    def close(self):
        if self._pool:
            self._lib.fdt_pool_destroy(self._pool)
            self._pool = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


#: The JAX package's name of the pool, from when it decoded only JPEG.
JpegDecoderPool = ImageDecoderPool
