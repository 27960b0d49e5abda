"""A depthwise convolution with its bias and activation in one pass: the
Hopper kernel (``csrc/depthwise.cu``, K7) and its plain PyTorch version.

No TPU kernel corresponds to it (XLA fused each convolution with its
elementwise tail there).  The function, on NHWC float32 tensors::

    out[n, y, x, c] = act(sum_{dy, dx} pad(in)[n, y*s + dy, x*s + dx, c]
                          * w[c, 0, dy, dx] + bias[c])

with ``w`` the ``[C, 1, k, k]`` filter that ``executor.conv2d`` takes
(channel multiplier 1), ``pad`` the zeros of ``pads`` ((top, bottom),
(left, right)), asymmetric too, ``bias`` optional and ``act`` None, ReLU
or PReLU(``alpha[c]``).  K7 has every ``k`` of :data:`SIZES` at every
stride of :data:`STRIDES` with dilation 1 (:func:`takes`).  The plain
version is the op sequence the executor and MobileFaceNet ran before:
``executor.conv2d`` (cuDNN on a card, with an ``F.pad`` copy where the
pads are asymmetric), then :func:`ops.epilogue.residual_act_plain`.  The
kernel sums the k^2 taps in float32 FFMA in its own order, then adds the
bias and the activation rounded as K5 does; it equals the plain version
within the float32 rounding of the sum (:func:`rounding_bound`).

Counters (``kernels.build.count_launch``: a captured program's replays
add what its capture recorded), read by ``FaceDetector.memory_report()``:
``depthwise_conv.launches`` (every K7 launch, ``depthwise_kernel``) and
:data:`library_depthwise` (``depthwise_library``: a depthwise convolution
that ``F.conv2d`` ran on a card, at any tier and multiplier, counted in
``executor.conv2d``).  A bias K7 adds counts as
``ops.epilogue.bias_folded``, and a PReLU as ``ops.epilogue.ran_fused``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..kernels import build as _build
from . import epilogue
from .epilogue import _ACT_CODE, ACTS, _Count

__all__ = ["SIZES", "STRIDES", "depthwise_conv", "depthwise_conv_plain",
           "library_depthwise", "rounding_bound", "takes"]

#: The filter sizes (k x k) and strides K7 has.
SIZES = (3, 5, 7)
STRIDES = (1, 2)


def takes(channels: int, w_shape, stride, dilation=(1, 1)) -> bool:
    """Whether K7 has the depthwise convolution of an input with
    ``channels`` channels by a filter of ``w_shape`` (``[C*m, 1, kh, kw]``)
    at ``stride`` and ``dilation`` (pairs): multiplier 1, a square filter
    of :data:`SIZES`, equal strides of :data:`STRIDES`, dilation 1."""
    c, one, kh, kw = tuple(w_shape)
    sh, sw = stride
    return (c == channels and one == 1 and kh == kw and kh in SIZES
            and sh == sw and sh in STRIDES and tuple(dilation) == (1, 1))


def _check(x, w, bias, stride, pads, act, alpha) -> None:
    """Shapes and arguments, on every device."""
    if act not in _ACT_CODE:
        raise ValueError(f"depthwise_conv: act must be None or one of "
                         f"{ACTS}, got {act!r}")
    if (alpha is None) != (act != "PRELU"):
        raise ValueError("depthwise_conv: alpha is given for PRELU and only "
                         "there")
    if x.dim() != 4:
        raise ValueError(f"depthwise_conv: x must be [N, H, W, C], got "
                         f"{tuple(x.shape)}")
    c = x.shape[3]
    if w.dim() != 4 or not takes(c, w.shape, (stride, stride)):
        raise ValueError(f"depthwise_conv: w must be the [C, 1, k, k] filter "
                         f"of a depthwise convolution with C = {c}, k in "
                         f"{SIZES} and a stride in {STRIDES}, got "
                         f"{tuple(w.shape)} at stride {stride}")
    (pt, pb), (pl, pr) = pads
    if min(pt, pb, pl, pr) < 0:
        raise ValueError(f"depthwise_conv: pads must be >= 0, got {pads}")
    k = w.shape[2]
    if x.shape[1] + pt + pb < k or x.shape[2] + pl + pr < k:
        raise ValueError(f"depthwise_conv: the padded input "
                         f"{tuple(x.shape[1:3])} + {pads} is smaller than the "
                         f"{k}x{k} filter")
    for name, t in (("alpha", alpha), ("bias", bias)):
        if t is not None and (t.dim() != 1 or t.shape[0] != c):
            raise ValueError(f"depthwise_conv: {name} must be [C] = [{c}], "
                             f"got {tuple(t.shape)}")
    for name, t in (("x", x), ("w", w), ("bias", bias), ("alpha", alpha)):
        if t is None:
            continue
        if t.dtype != torch.float32:
            raise TypeError(f"depthwise_conv: {name} must be float32, got "
                            f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"depthwise_conv: {name} must be contiguous "
                             f"(NHWC, C innermost), got strides {t.stride()}")


def depthwise_conv_plain(x: torch.Tensor, w: torch.Tensor,
                         bias: Optional[torch.Tensor], *, stride: int, pads,
                         act: Optional[str] = None,
                         alpha: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """Plain version of the kernel: ``executor.conv2d`` of the depthwise
    filter, then ``residual_act_plain`` of its bias and activation (a new
    tensor)."""
    # Imported here: the executor imports this module's counter.
    from ..convert.executor import conv2d
    _check(x, w, bias, stride, pads, act, alpha)
    y, bias = conv2d(x, w, bias, stride=(stride, stride), pads=pads,
                     groups=x.shape[3])
    if bias is None and act is None:
        return y
    return epilogue.residual_act_plain(y, None, act, alpha, bias)


def depthwise_conv(x: torch.Tensor, w: torch.Tensor,
                   bias: Optional[torch.Tensor], *, stride: int, pads,
                   act: Optional[str] = None,
                   alpha: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``act(depthwise(pad(x), w) + bias)`` of NHWC ``x [N, H, W, C]``: a
    float32 depthwise convolution (multiplier 1, dilation 1) by the
    ``[C, 1, k, k]`` filter ``w`` (``k`` in :data:`SIZES`) at ``stride``
    (in :data:`STRIDES`) with the zero ``pads`` ((top, bottom), (left,
    right)), optional ``bias [C]``, ``act`` None or one of
    ``ops.epilogue.ACTS`` and ``alpha [C]`` for PRELU; returns a new
    ``[N, OH, OW, C]`` tensor.  The kernel for CUDA tensors (one launch;
    ``depthwise_conv.launches`` counts them), the plain version for CPU
    tensors.  Every tensor must be float32 and contiguous (NHWC with C
    innermost), and on a card on ``x``'s device: anything else raises,
    nothing is copied."""
    if x.device.type == "cpu":
        return depthwise_conv_plain(x, w, bias, stride=stride, pads=pads,
                                    act=act, alpha=alpha)
    _check(x, w, bias, stride, pads, act, alpha)
    if x.device.type != "cuda":
        raise ValueError(f"depthwise_conv: unsupported device {x.device}")
    for name, t in (("w", w), ("bias", bias), ("alpha", alpha)):
        if t is not None and t.device != x.device:
            raise ValueError(f"depthwise_conv: {name} is on {t.device}, x on "
                             f"{x.device}")
    n, h, wd, c = x.shape
    k = w.shape[2]
    (pt, pb), (pl, pr) = pads
    oh = (h + pt + pb - k) // stride + 1
    ow = (wd + pl + pr - k) // stride + 1
    out = torch.empty((n, oh, ow, c), dtype=torch.float32, device=x.device)
    if out.numel():
        index = (x.device.index if x.device.index is not None
                 else torch.cuda.current_device())
        rc = _build.load().fdt_depthwise_conv(
            x.data_ptr(), w.data_ptr(),
            None if bias is None else bias.data_ptr(),
            None if alpha is None else alpha.data_ptr(), out.data_ptr(),
            n, h, wd, c, k, stride, pt, pl, oh, ow, _ACT_CODE[act], index,
            _build.stream(index))
        _build.check(rc, "depthwise_conv")
        _build.count_launch(depthwise_conv)
        if act == "PRELU":
            epilogue.ran_fused()
        if bias is not None:
            epilogue.bias_folded()
    return out


depthwise_conv.launches = 0


def rounding_bound(x: torch.Tensor, w: torch.Tensor,
                   bias: Optional[torch.Tensor], alpha: Optional[torch.Tensor],
                   *, stride: int, pads) -> torch.Tensor:
    """The largest gap the kernel may show against its plain version at
    each output, float64 of the output's shape: both sum the k^2 float32
    products, each in its own order, so each sum lies within k^2 u S of
    the exact one (u = 2^-24, S = sum |x w| over the taps); the bias add
    rounds each side once more, and a PReLU scales the gap by at most
    max(1, |alpha|)."""
    (pt, pb), (pl, pr) = pads
    k = w.shape[2]
    mag = F.conv2d(F.pad(x.abs().double().permute(0, 3, 1, 2),
                         (pl, pr, pt, pb)), w.abs().double(), stride=stride,
                   groups=x.shape[3]).permute(0, 2, 3, 1)
    if bias is not None:
        mag = mag + bias.abs().double()
    scale = 1.0 if alpha is None else alpha.abs().double().clamp_min(1.0)
    return (2 * k * k + 4) * 2.0 ** -24 * mag * scale


#: A depthwise convolution (groups equal to the input's channels) that
#: ``F.conv2d`` ran on a card (``executor.conv2d``), at any tier and
#: multiplier: with ``depthwise_conv.launches``, the share of the
#: depthwise convolutions K7 took.
library_depthwise = _Count()
