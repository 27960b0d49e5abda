"""Builds and loads the package's hand-written CUDA kernels.

Every ``csrc/*.cu`` source is compiled by its own ``nvcc`` process for
Hopper (``sm_90a``), all started together, into a shared library of its
own with a plain C interface, loaded through ``ctypes``.  The build runs
at first use, into ``kernels/_build/`` inside the package, under a name
keyed by the source's hash, so an edited source rebuilds.  A missing ``nvcc`` or a failed build raises: there is no
fallback.  Each C entry point returns ``cudaGetLastError()`` after its
launch; :func:`check` raises on a non-zero code.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import types

import torch

__all__ = ["load", "build", "check", "build_log", "stream", "count_launch",
           "NVCC_FLAGS"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "kernels", "_build")

#: ``-fmad=false``: no multiply-add contraction, so the kernels round each
#: operation as their plain PyTorch versions do (the NMS kernel's strict
#: ``IoU > thr`` decisions and the warp's taps then match them exactly).
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xptxas", "-v", "-Xcompiler", "-fPIC")

_VP = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
#: C signatures: name -> argtypes (every entry returns a cudaError_t int).
_SIGNATURES = {
    # boxes, scores, valid, leader, blended, batch, k, thr, device, stream
    "fdt_nms_core": (_VP, _VP, _VP, _VP, _VP, _I, _I, _F, _I, _VP),
    # raw_boxes, raw_scores, anchors, out, batch, A, D, k, input_size, pl,
    # pt, sx, sy, thr, device, stream
    "fdt_detection_postprocess": (_VP, _VP, _VP, _VP, _I, _I, _I, _I, _F, _F,
                                  _F, _F, _F, _F, _I, _VP),
    # stream (an empty kernel: the launch floor)
    "fdt_empty_kernel": (_VP,),
    # frames, batch, h, w, cx, cy, size, cos, sin, flip, faces, out_size,
    # inv, out, device, stream
    "fdt_warp_normalize_u8": (_VP, _I, _I, _I, _VP, _VP, _VP, _VP, _VP, _VP,
                              _I, _I, _F, _VP, _I, _VP),
    "fdt_warp_normalize_f32": (_VP, _I, _I, _I, _VP, _VP, _VP, _VP, _VP,
                               _VP, _I, _I, _F, _VP, _I, _VP),
}

_lock = threading.Lock()
_count_lock = threading.Lock()
_lib: types.SimpleNamespace | None = None
_log = ""


def _sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin or "
                       "/usr/local/cuda/bin): the CUDA kernels cannot be "
                       "built")


def build() -> list[str]:
    """Compiles each source that is not built yet into its own shared
    library, one ``nvcc`` per source, all started together; returns the
    libraries' paths."""
    global _log
    srcs = _sources()
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    paths = []
    for src in srcs:
        with open(src, "rb") as f:
            h = hashlib.sha256(" ".join(NVCC_FLAGS).encode() + f.read())
        stem = os.path.splitext(os.path.basename(src))[0]
        paths.append(os.path.join(BUILD_DIR,
                                  f"libfdt_{stem}_{h.hexdigest()[:16]}.so"))
    todo = [(s, p) for s, p in zip(srcs, paths) if not os.path.exists(p)]
    if todo:
        os.makedirs(BUILD_DIR, exist_ok=True)
        nvcc = _nvcc()
        procs = [subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-shared", "-o", f"{p}.{os.getpid()}", s],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for s, p in todo]
        _log = "".join(proc.communicate()[0] for proc in procs)
        failed = [s for (s, _), proc in zip(todo, procs) if proc.returncode]
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{_log}")
        for _, p in todo:
            os.replace(f"{p}.{os.getpid()}", p)
    return paths


def load() -> types.SimpleNamespace:
    """The kernels' C entry points (attributes named as in ``csrc``),
    built at first use and loaded once."""
    global _lib
    with _lock:
        if _lib is None:
            libs = [ctypes.CDLL(p) for p in build()]
            fns = {}
            for name, argtypes in _SIGNATURES.items():
                fn = next(getattr(lib, name) for lib in libs
                          if hasattr(lib, name))
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
                fns[name] = fn
            _lib = types.SimpleNamespace(**fns)
        return _lib


def build_log() -> str:
    """nvcc's output (ptxas resource usage) of this process's build, or
    "" when the library was already built."""
    return _log


#: PyTorch's current CUDA stream on a device, as the raw handle a kernel is
#: launched on: the C accessor where this PyTorch has it (it skips building
#: a ``torch.cuda.Stream`` object, the larger part of a launch's host time).
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def stream(device_index: int) -> int:
    """The raw handle of PyTorch's current stream on CUDA device
    ``device_index``."""
    if _raw_stream is not None:
        return _raw_stream(device_index)
    return torch.cuda.current_stream(device_index).cuda_stream


def check(rc: int, what: str) -> None:
    """Raises when a C entry point reported a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")


def count_launch(wrapper, size=None) -> None:
    """Adds one to ``wrapper.launches`` (and, with ``size``, to
    ``wrapper.launches_by_size[size]``) under a lock, since two threads
    may launch one kernel at once (a server's batcher and a handler)."""
    with _count_lock:
        wrapper.launches += 1
        if size is not None:
            by_size = wrapper.launches_by_size
            by_size[size] = by_size.get(size, 0) + 1
