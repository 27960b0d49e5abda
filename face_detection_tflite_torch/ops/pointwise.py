"""A 1x1 convolution with its bias, residual add and activation in one
pass: the Hopper kernel (``csrc/pointwise.cu``, K6) and its plain PyTorch
version.

No TPU kernel corresponds to it (XLA fused each convolution with its
elementwise tail there).  The function, on NHWC float32 tensors::

    out[m, n] = act((sum_k x[m, k] * w[k, n] + bias[n]) + r[m, n])

over the rows ``m`` of ``x [B, H, W, K]``, with the filter ``w`` as
``[K, N]`` (the transpose of the OIHW filter's ``[N, K]``), ``bias`` and
the residual ``r`` (of the output's shape ``[B, H, W, N]``) optional, and
``act`` None, ReLU or PReLU(``alpha[n]``).  The plain version is the op sequence
MobileFaceNet ran before: ``executor.conv2d`` (cuDNN on a card), then
:func:`ops.epilogue.residual_act_plain`.  The kernel sums in float32 FFMA
in another order than the library, then adds the bias, the residual and
the activation rounded as K5 does; it equals the plain version within the
float32 rounding of the sum (:func:`rounding_bound`).

Counters (``kernels.build.count_launch``: a captured program's replays
add what its capture recorded), read by ``FaceDetector.memory_report()``:
``pointwise_conv.launches`` (every K6 launch, ``pointwise_kernel``) and
:data:`library_convs` (``pointwise_library``: a float32 convolution that
K6 could take, 1x1 with groups 1, stride 1 and no pad, run by
``F.conv2d`` on a card, counted in ``executor.conv2d``).  A bias K6 adds
counts as ``ops.epilogue.bias_folded``, and a PReLU, or a ReLU after its
residual, as ``ops.epilogue.ran_fused``.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..kernels import build as _build
from . import epilogue
from .epilogue import _ACT_CODE, ACTS, _Count

__all__ = ["library_convs", "pointwise_conv", "pointwise_conv_plain",
           "rounding_bound"]


def _check(x, w, bias, act, alpha, residual) -> None:
    """Shapes and arguments, on every device."""
    if act not in _ACT_CODE:
        raise ValueError(f"pointwise_conv: act must be None or one of "
                         f"{ACTS}, got {act!r}")
    if (alpha is None) != (act != "PRELU"):
        raise ValueError("pointwise_conv: alpha is given for PRELU and only "
                         "there")
    if x.dim() != 4:
        raise ValueError(f"pointwise_conv: x must be [B, H, W, K], got "
                         f"{tuple(x.shape)}")
    if w.dim() != 2 or w.shape[0] != x.shape[3]:
        raise ValueError(f"pointwise_conv: w must be the [K, N] filter of a "
                         f"1x1 convolution with groups 1, K = {x.shape[3]}, "
                         f"got {tuple(w.shape)}")
    n = w.shape[1]
    for name, t in (("alpha", alpha), ("bias", bias)):
        if t is not None and (t.dim() != 1 or t.shape[0] != n):
            raise ValueError(f"pointwise_conv: {name} must be [N] = [{n}], "
                             f"got {tuple(t.shape)}")
    if residual is not None and tuple(residual.shape) != (*x.shape[:3], n):
        raise ValueError(f"pointwise_conv: the residual must be the "
                         f"output's [B, H, W, {n}], got "
                         f"{tuple(residual.shape)}")
    for name, t in (("x", x), ("w", w), ("bias", bias), ("alpha", alpha),
                    ("residual", residual)):
        if t is None:
            continue
        if t.dtype != torch.float32:
            raise TypeError(f"pointwise_conv: {name} must be float32, got "
                            f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"pointwise_conv: {name} must be contiguous "
                             f"(NHWC, C innermost), got strides {t.stride()}")


def pointwise_conv_plain(x: torch.Tensor, w: torch.Tensor,
                         bias: Optional[torch.Tensor],
                         act: Optional[str] = None,
                         alpha: Optional[torch.Tensor] = None,
                         residual: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """Plain version of the kernel: ``executor.conv2d`` of the 1x1
    filter, then ``residual_act_plain`` of its bias, residual and
    activation (a new tensor)."""
    # Imported here: the executor imports this module's counter.
    from ..convert.executor import conv2d
    _check(x, w, bias, act, alpha, residual)
    k, n = w.shape
    y, bias = conv2d(x, w.t().reshape(n, k, 1, 1), bias, stride=(1, 1),
                     pads=((0, 0), (0, 0)))
    if bias is None and residual is None and act is None:
        return y
    return epilogue.residual_act_plain(y, residual, act, alpha, bias)


def pointwise_conv(x: torch.Tensor, w: torch.Tensor,
                   bias: Optional[torch.Tensor], act: Optional[str] = None,
                   alpha: Optional[torch.Tensor] = None,
                   residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``act((x @ w + bias) + residual)`` over the rows of NHWC ``x
    [B, H, W, K]``: a float32 1x1 convolution (groups 1, stride 1, no pad)
    with filter ``w [K, N]``, optional ``bias [N]``, optional
    ``residual [B, H, W, N]``, ``act`` None or one of
    ``ops.epilogue.ACTS`` and ``alpha [N]`` for PRELU; returns a new
    ``[B, H, W, N]`` tensor.  The kernel for CUDA tensors (one launch;
    ``pointwise_conv.launches`` counts them), the plain version for CPU
    tensors.  Every tensor must be float32 and contiguous (NHWC with C
    innermost), and on a card on ``x``'s device: anything else raises,
    nothing is copied."""
    if x.device.type == "cpu":
        return pointwise_conv_plain(x, w, bias, act, alpha, residual)
    _check(x, w, bias, act, alpha, residual)
    if x.device.type != "cuda":
        raise ValueError(f"pointwise_conv: unsupported device {x.device}")
    k, n = w.shape
    if not k or not n:
        raise ValueError(f"pointwise_conv: K and N must be positive on a "
                         f"card, got K = {k}, N = {n}")
    for name, t in (("x", x), ("w", w), ("bias", bias), ("alpha", alpha),
                    ("residual", residual)):
        if t is None:
            continue
        if t.device != x.device:
            raise ValueError(f"pointwise_conv: {name} is on {t.device}, x on "
                             f"{x.device}")
    out = torch.empty((*x.shape[:3], n), dtype=torch.float32,
                      device=x.device)
    rows = x.numel() // k
    if rows:
        index = (x.device.index if x.device.index is not None
                 else torch.cuda.current_device())
        rc = _build.load().fdt_pointwise_conv(
            x.data_ptr(), w.data_ptr(),
            None if bias is None else bias.data_ptr(),
            None if alpha is None else alpha.data_ptr(),
            None if residual is None else residual.data_ptr(),
            out.data_ptr(), rows, k, n, _ACT_CODE[act], index,
            _build.stream(index))
        _build.check(rc, "pointwise_conv")
        _build.count_launch(pointwise_conv)
        if act == "PRELU" or (act == "RELU" and residual is not None):
            epilogue.ran_fused()
        if bias is not None:
            epilogue.bias_folded()
    return out


pointwise_conv.launches = 0


def rounding_bound(x: torch.Tensor, w: torch.Tensor,
                   bias: Optional[torch.Tensor], alpha: Optional[torch.Tensor],
                   residual: Optional[torch.Tensor]) -> torch.Tensor:
    """The largest gap the kernel may show against its plain version at
    each output, float64 of the output's shape: both sum K float32
    products, each in its own order, so each sum lies within K u S of the
    exact one (u = 2^-24, S = sum |x w| over k); the bias and residual
    adds round each side once more, and a PReLU scales the gap by at
    most max(1, |alpha|)."""
    k = w.shape[0]
    mag = x.abs().reshape(-1, k).double() @ w.abs().double()
    if bias is not None:
        mag = mag + bias.abs().double()
    if residual is not None:
        mag = mag + residual.abs().reshape(mag.shape).double()
    scale = 1.0 if alpha is None else alpha.abs().double().clamp_min(1.0)
    return ((2 * k + 8) * 2.0 ** -24 * mag * scale).reshape(
        *x.shape[:3], w.shape[1])

#: A float32 1x1 convolution with groups 1, stride 1 and no pad that
#: ``F.conv2d`` ran on a card (``executor.conv2d``): with
#: ``pointwise_conv.launches``, the share of such convolutions K6 took.
library_convs = _Count()
