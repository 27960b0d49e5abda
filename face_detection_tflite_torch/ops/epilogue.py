"""A convolution's elementwise tail in one pass: the residual add (its
channel pad included) and the ReLU or PReLU after it.  The Hopper kernel
(``csrc/epilogue.cu``, K5) and its plain PyTorch version.

No TPU kernel corresponds to it (XLA fused these ops into the
convolution's fusion there).  The function, on NHWC float32 tensors::

    out = act(y + pad(r))      act: ReLU or PReLU(alpha[c])

where ``r`` (optional) has ``C_r <= C`` channels and ``pad`` zero-pads
its last axis at the end to ``C``, as TFLite's channel PAD before a
BlazeBlock's ADD does.  The plain version is the op sequence the executor
ran before: ``F.pad``, ``torch.add``, then ``torch.relu`` or
``torch.where(x >= 0, x, x * alpha)``; the kernel equals it bit for bit.
The executor (``convert/executor.py``) plans which of a graph's ADD, RELU,
PRELU and PAD ops run here; MobileFaceNet (``models/embedding.py``) runs
its PReLUs here.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..kernels import build as _build

__all__ = ["ACTS", "ran_op_by_op", "residual_act", "residual_act_plain"]

#: The activations the pass takes: ReLU, PReLU.  A bare add is one
#: launch already and is never planned here.
ACTS = ("RELU", "PRELU")
_ACT_CODE = {"RELU": 1, "PRELU": 2}


def _check(y, residual, act, alpha) -> None:
    """Shapes and arguments, on every device."""
    if act not in _ACT_CODE:
        raise ValueError(f"residual_act: act must be one of {ACTS}, got "
                         f"{act!r}")
    if (alpha is None) != (act != "PRELU"):
        raise ValueError("residual_act: alpha is given for PRELU and only "
                         "there")
    if y.dim() != 4:
        raise ValueError(f"residual_act: y must be [N, H, W, C], got "
                         f"{tuple(y.shape)}")
    c = y.shape[3]
    if residual is not None and (
            residual.dim() != 4 or residual.shape[:3] != y.shape[:3]
            or not 1 <= residual.shape[3] <= c):
        raise ValueError(f"residual_act: the residual must be [N, H, W, C_r]"
                         f" with y's N, H, W and 1 <= C_r <= C, got "
                         f"{tuple(residual.shape)} for y {tuple(y.shape)}")
    if alpha is not None and (alpha.dim() != 1 or alpha.shape[0] != c):
        raise ValueError(f"residual_act: alpha must be [C] = [{c}], got "
                         f"{tuple(alpha.shape)}")


def residual_act_plain(y: torch.Tensor, residual: Optional[torch.Tensor],
                       act: str, alpha: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """Plain version of the kernel: the unfused op sequence."""
    _check(y, residual, act, alpha)
    x = y
    if residual is not None:
        if residual.shape[3] < y.shape[3]:
            residual = F.pad(residual, (0, y.shape[3] - residual.shape[3]))
        x = torch.add(x, residual)
    if act == "RELU":
        return torch.relu(x)
    return torch.where(x >= 0, x, x * alpha)


def residual_act(y: torch.Tensor, residual: Optional[torch.Tensor], act: str,
                 alpha: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``act(y + pad(residual))``: ``y [N, H, W, C]`` float32, optional
    ``residual [N, H, W, C_r]`` (``C_r <= C``, zero-padded to ``C``),
    ``act`` one of :data:`ACTS`, ``alpha [C]`` for PRELU.  The kernel for
    CUDA tensors (one launch; ``residual_act.launches`` counts them), the
    plain version for CPU tensors.  On a card every tensor must be float32,
    contiguous (NHWC with C innermost) and on ``y``'s device: anything else
    raises, nothing is copied."""
    if y.device.type == "cpu":
        return residual_act_plain(y, residual, act, alpha)
    _check(y, residual, act, alpha)
    if y.device.type != "cuda":
        raise ValueError(f"residual_act: unsupported device {y.device}")
    for name, t in (("y", y), ("residual", residual), ("alpha", alpha)):
        if t is None:
            continue
        if t.device != y.device:
            raise ValueError(f"residual_act: {name} is on {t.device}, y on "
                             f"{y.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"residual_act: {name} must be float32, got "
                            f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"residual_act: {name} must be contiguous "
                             f"(NHWC, C innermost), got strides {t.stride()}")
    out = torch.empty(y.shape, dtype=torch.float32, device=y.device)
    c = y.shape[3]
    rows = y.numel() // c if c else 0
    if rows:
        index = (y.device.index if y.device.index is not None
                 else torch.cuda.current_device())
        rc = _build.load().fdt_residual_act(
            y.data_ptr(), None if residual is None else residual.data_ptr(),
            None if alpha is None else alpha.data_ptr(), out.data_ptr(),
            rows, c, 0 if residual is None else residual.shape[3],
            _ACT_CODE[act], index, _build.stream(index))
        _build.check(rc, "residual_act")
        _build.count_launch(residual_act)
    return out


residual_act.launches = 0


def ran_op_by_op() -> None:
    """Counts one PRELU or ADD with a fused RELU that ran op by op on a
    card, where no plan put it in :func:`residual_act`
    (``ran_op_by_op.launches``; a captured program's replays count it as
    they count the kernels' launches).  With ``residual_act.launches``
    it gives the share of these activations that ran in the pass
    (``FaceDetector.memory_report()``)."""
    _build.count_launch(ran_op_by_op)


ran_op_by_op.launches = 0
