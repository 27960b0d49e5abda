"""A convolution's elementwise tail in one pass: its bias, the residual
add (its channel pad included) and the ReLU or PReLU after it.  The
Hopper kernel (``csrc/epilogue.cu``, K5) and its plain PyTorch version.

No TPU kernel corresponds to it (XLA fused these ops into the
convolution's fusion there).  The function, on NHWC float32 tensors::

    out = act((y + bias) + pad(r))      act: none, ReLU or PReLU(alpha[c])

where ``bias`` (optional) has one value a channel, ``r`` (optional) has
``C_r <= C`` channels and ``pad`` zero-pads its last axis at the end to
``C``, as TFLite's channel PAD before a BlazeBlock's ADD does.  The
plain version is the op sequence the executor ran before: the
convolution's bias add, ``F.pad``, ``torch.add``, then ``torch.relu``
or ``torch.where(x >= 0, x, x * alpha)``; the kernel equals it bit for
bit.  The executor (``convert/executor.py``) plans which convolutions
run without their bias and which of a graph's ADD, RELU, PRELU and PAD
ops run here; MobileFaceNet (``models/embedding.py``) runs each
convolution's bias here, with its PReLU or its residual.

:func:`residual_act_affine` is the same pass with a batch norm that the
graph keeps after it as a per-channel MUL and ADD (iResNet's
pre-activation batch norm, before a zero-padded convolution)::

    z = (out * scale) + shift      scale, shift: one value a channel

rounded as ``torch.mul`` then ``torch.add``; it returns ``z`` and, where
the caller keeps it, ``out``.  The kernel has it only for the passes
:func:`affine_pass` names, those iResNet has.

Counters (``kernels.build.count_launch``: a captured program's replays
add what its capture recorded), read by ``FaceDetector.memory_report()``:
``residual_act.launches`` (every K5 launch), :data:`ran_fused` (passes
that took a PRELU or an ADD with a fused RELU), :data:`ran_op_by_op`
(such an activation that ran op by op), :data:`bias_folded` (a
convolution's bias added in a pass that also did the op after it),
:data:`bias_alone` (a bias pass alone), :data:`bias_op_by_op` (a
float32 convolution's bias added by PyTorch on a card),
``residual_act_affine.launches`` (every launch of the affine instance),
:data:`affine_folded` (a per-channel MUL and ADD pair run in a pass) and
:data:`affine_op_by_op` (such a pair run op by op on a card).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..kernels import build as _build

__all__ = ["ACTS", "affine_folded", "affine_op_by_op", "affine_pass",
           "bias_alone", "bias_folded", "bias_op_by_op", "ran_fused", "ran_op_by_op",
           "residual_act", "residual_act_affine",
           "residual_act_affine_plain", "residual_act_plain"]

#: The activations the pass takes besides none (``act=None``): ReLU,
#: PReLU.  A pass with no activation carries a bias, a residual or both.
ACTS = ("RELU", "PRELU")
_ACT_CODE = {None: 0, "RELU": 1, "PRELU": 2}


def _check(y, residual, act, alpha, bias, inplace) -> None:
    """Shapes and arguments, on every device."""
    if act not in _ACT_CODE:
        raise ValueError(f"residual_act: act must be None or one of {ACTS},"
                         f" got {act!r}")
    if act is None and residual is None and bias is None:
        raise ValueError(f"residual_act: act must be one of {ACTS} in a "
                         f"pass with no bias and no residual")
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
    for name, t in (("alpha", alpha), ("bias", bias)):
        if t is not None and (t.dim() != 1 or t.shape[0] != c):
            raise ValueError(f"residual_act: {name} must be [C] = [{c}], got "
                             f"{tuple(t.shape)}")
    if inplace and (bias is None or residual is not None or act == "PRELU"):
        raise ValueError("residual_act: in place only for a bias pass with "
                         "no residual and act None or RELU")


def residual_act_plain(y: torch.Tensor, residual: Optional[torch.Tensor],
                       act: Optional[str],
                       alpha: Optional[torch.Tensor] = None,
                       bias: Optional[torch.Tensor] = None,
                       inplace: bool = False) -> torch.Tensor:
    """Plain version of the kernel: the unfused op sequence (a new
    tensor, also where ``inplace`` asks the kernel to write into ``y``)."""
    _check(y, residual, act, alpha, bias, inplace)
    x = y if bias is None else torch.add(y, bias)
    if residual is not None:
        if residual.shape[3] < y.shape[3]:
            residual = F.pad(residual, (0, y.shape[3] - residual.shape[3]))
        x = torch.add(x, residual)
    if act == "RELU":
        return torch.relu(x)
    if act == "PRELU":
        return torch.where(x >= 0, x, x * alpha)
    return x


def _check_card(**tensors) -> None:
    """On a card every tensor given must be float32, contiguous (NHWC with
    C innermost) and on ``y``'s device: anything else raises."""
    y = tensors["y"]
    if y.device.type != "cuda":
        raise ValueError(f"residual_act: unsupported device {y.device}")
    for name, t in tensors.items():
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


def _count_pass(act, residual, bias) -> None:
    """The counters of one pass that ran on a card."""
    if act == "PRELU" or (act == "RELU" and residual is not None):
        ran_fused()
    if bias is not None:
        (bias_alone if act is None and residual is None
         else bias_folded)()


def _index(y: torch.Tensor) -> int:
    return (y.device.index if y.device.index is not None
            else torch.cuda.current_device())


def residual_act(y: torch.Tensor, residual: Optional[torch.Tensor],
                 act: Optional[str], alpha: Optional[torch.Tensor] = None,
                 bias: Optional[torch.Tensor] = None,
                 inplace: bool = False) -> torch.Tensor:
    """``act((y + bias) + pad(residual))``: ``y [N, H, W, C]`` float32,
    optional ``bias [C]``, optional ``residual [N, H, W, C_r]``
    (``C_r <= C``, zero-padded to ``C``), ``act`` None or one of
    :data:`ACTS`, ``alpha [C]`` for PRELU; a pass with no act has a bias
    or a residual.  ``inplace`` (a bias pass with no residual and act None
    or RELU): on a card the output is written over ``y`` and ``y`` is
    returned, so the caller must hold no other reader of ``y``.  The
    kernel for CUDA tensors (one launch; ``residual_act.launches`` counts
    them, and the module's counters what the pass did), the plain version
    for CPU tensors.  On a card every tensor must be float32, contiguous
    (NHWC with C innermost) and on ``y``'s device: anything else raises,
    nothing is copied."""
    if y.device.type == "cpu":
        return residual_act_plain(y, residual, act, alpha, bias, inplace)
    _check(y, residual, act, alpha, bias, inplace)
    _check_card(y=y, residual=residual, alpha=alpha, bias=bias)
    out = y if inplace else torch.empty(y.shape, dtype=torch.float32,
                                        device=y.device)
    c = y.shape[3]
    rows = y.numel() // c if c else 0
    if rows:
        index = _index(y)
        rc = _build.load().fdt_residual_act(
            y.data_ptr(), None if residual is None else residual.data_ptr(),
            None if alpha is None else alpha.data_ptr(),
            None if bias is None else bias.data_ptr(), out.data_ptr(),
            rows, c, 0 if residual is None else residual.shape[3],
            _ACT_CODE[act], index, _build.stream(index))
        _build.check(rc, "residual_act")
        _build.count_launch(residual_act)
        _count_pass(act, residual, bias)
    return out


residual_act.launches = 0


def _check_affine(y, scale, shift) -> None:
    c = y.shape[3] if y.dim() == 4 else -1
    for name, t in (("scale", scale), ("shift", shift)):
        if t is None or t.dim() != 1 or t.shape[0] != c:
            raise ValueError(f"residual_act_affine: {name} must be [C] = "
                             f"[{c}], got "
                             f"{None if t is None else tuple(t.shape)}")


def affine_pass(act: Optional[str], residual: Optional[str],
                bias: bool) -> bool:
    """Whether K5's affine instance has the pass of ``act``, ``residual``
    (None, ``"same"`` width as ``y`` or ``"padded"``) and ``bias`` (given
    or not): a PReLU with the bias and no residual (iResNet's stem), or
    the bias and a same-width residual with no activation (its blocks'
    ends)."""
    return bias and (act, residual) in (("PRELU", None), (None, "same"))


def residual_act_affine_plain(y: torch.Tensor,
                              residual: Optional[torch.Tensor],
                              act: Optional[str],
                              alpha: Optional[torch.Tensor],
                              bias: Optional[torch.Tensor],
                              scale: torch.Tensor, shift: torch.Tensor,
                              keep: bool = True
                              ) -> tuple[Optional[torch.Tensor],
                                         torch.Tensor]:
    """Plain version of the affine pass: :func:`residual_act_plain`, then
    ``torch.add(torch.mul(out, scale), shift)``, the graph's MUL and ADD;
    returns ``(out if keep else None, z)``."""
    _check_affine(y, scale, shift)
    out = residual_act_plain(y, residual, act, alpha, bias)
    return (out if keep else None), torch.add(torch.mul(out, scale), shift)


def residual_act_affine(y: torch.Tensor, residual: Optional[torch.Tensor],
                        act: Optional[str], alpha: Optional[torch.Tensor],
                        bias: Optional[torch.Tensor], scale: torch.Tensor,
                        shift: torch.Tensor, keep: bool = True
                        ) -> tuple[Optional[torch.Tensor], torch.Tensor]:
    """The pass of :func:`residual_act` (never in place) and the
    per-channel affine pair after it, ``z = (out * scale) + shift`` with
    ``scale`` and ``shift`` ``[C]``: ``(out, z)``, ``out`` None where
    ``keep`` is false (the pair was its only reader; the kernel then
    writes ``z`` alone).  One launch of K5's affine instance on a card
    (``residual_act_affine.launches``; the pass's counters as in
    :func:`residual_act`, and :data:`affine_folded`), the plain version
    for CPU tensors, with the same refusals as :func:`residual_act`; off
    the CPU, a pass that :func:`affine_pass` does not name raises."""
    if y.device.type == "cpu":
        return residual_act_affine_plain(y, residual, act, alpha, bias,
                                         scale, shift, keep)
    _check(y, residual, act, alpha, bias, False)
    _check_affine(y, scale, shift)
    width = None if residual is None else (
        "same" if residual.shape[3] == y.shape[3] else "padded")
    if not affine_pass(act, width, bias is not None):
        raise ValueError(f"residual_act_affine: the kernel has no pass of "
                         f"act {act!r}, residual {width!r} and bias "
                         f"{bias is not None}")
    _check_card(y=y, residual=residual, alpha=alpha, bias=bias, scale=scale,
                shift=shift)
    out = (torch.empty(y.shape, dtype=torch.float32, device=y.device)
           if keep else None)
    z = torch.empty(y.shape, dtype=torch.float32, device=y.device)
    c = y.shape[3]
    rows = y.numel() // c if c else 0
    if rows:
        index = _index(y)
        rc = _build.load().fdt_residual_act_affine(
            y.data_ptr(), None if residual is None else residual.data_ptr(),
            None if alpha is None else alpha.data_ptr(),
            None if bias is None else bias.data_ptr(), scale.data_ptr(),
            shift.data_ptr(), None if out is None else out.data_ptr(),
            z.data_ptr(), rows, c,
            0 if residual is None else residual.shape[3], _ACT_CODE[act],
            index, _build.stream(index))
        _build.check(rc, "residual_act_affine")
        _build.count_launch(residual_act_affine)
        _count_pass(act, residual, bias)
        affine_folded()
    return out, z


residual_act_affine.launches = 0
residual_act.launches = 0


class _Count:
    """A count kept as a kernel's launches are (``.launches``, through
    ``kernels.build.count_launch``, so a captured program's replays add
    what its capture recorded); calling it adds one."""

    def __init__(self):
        self.launches = 0

    def __call__(self) -> None:
        _build.count_launch(self)


#: A PRELU, or an ADD with a fused RELU, that ran in the pass on a card:
#: a pass with a PReLU, or with a ReLU after its residual.
ran_fused = _Count()
#: A PRELU or an ADD with a fused RELU that ran op by op on a card, where
#: no plan put it in :func:`residual_act` (with :data:`ran_fused`, the
#: share of these activations that ran in the pass).
ran_op_by_op = _Count()
#: A convolution's bias added in a pass that also did the op after the
#: convolution (its fused or standalone activation, the residual add).
bias_folded = _Count()
#: A convolution's bias added in a pass of its own.
bias_alone = _Count()
#: A float32 convolution's bias added by PyTorch on a card, where no plan
#: gave it to :func:`residual_act`.
bias_op_by_op = _Count()
#: A 4-D MUL by one constant a channel and the ADD of one constant a
#: channel after it, run in a pass of :func:`residual_act_affine`.
affine_folded = _Count()
#: Such a pair that ran op by op on a card, where no plan put it in a
#: pass (with :data:`affine_folded`, the share of the pairs that ran in
#: the pass).
affine_op_by_op = _Count()
