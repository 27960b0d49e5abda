"""Classes of the device activities' names in a trace on the H100.

* K1: the fused detection postprocess (``csrc/nms.cu``);
* K2: the ROI warp fused with the normalize (``csrc/warp.cu``), every
  site (192, 64 and 112 px);
* copies: the runtime's memory copies and sets;
* convolutions: cuDNN's convolution kernels (implicit GEMM ``fprop``,
  direct and depthwise kernels, Winograd and FFT variants) and their
  layout transposes between NCHW and NHWC;
* GEMMs: cuBLAS and CUTLASS matrix products (the fully-connected layers
  and the Mixer's token MLPs);
* elementwise: every other kernel (activations, residual adds, pads,
  pools, gathers, reductions, the geometry, the readback pack).
"""

from __future__ import annotations

import re

K1 = re.compile(r"detection_postprocess_kernel|nms_core_kernel")
K2 = re.compile(r"warp_normalize_kernel")
COPY = re.compile(r"^(Memcpy|Memset|memcpy|memset)")
CONV = re.compile(r"conv|fprop|dgrad|wgrad|implicit|winograd|fft|"
                  r"[Nn]chw[Tt]o[Nn]hwc|[Nn]hwc[Tt]o[Nn]chw|xmma_fprop",
                  re.IGNORECASE)
GEMM = re.compile(r"gemm|gemv|matmul|cutlass|cublas|splitK|sgemm|dot_kernel",
                  re.IGNORECASE)


def kind(name: str) -> str:
    """"k1", "k2", "copy", "conv", "gemm" or "eltwise"."""
    for label, pat in (("k1", K1), ("k2", K2), ("copy", COPY),
                       ("conv", CONV), ("gemm", GEMM)):
        if pat.search(name):
            return label
    return "eltwise"
