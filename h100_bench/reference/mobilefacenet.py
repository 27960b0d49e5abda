"""MobileFaceNet-112 in plain PyTorch (Chen et al. 2018, Table 1, batch
norm folded away), from a parameter dict in the JAX package's layout
(HWIO filters keyed ``stem_w``, ``b0_0_e_a``, ...).

TF-style SAME padding (asymmetric at stride 2), PReLU as
``where(y >= 0, y, a * y)``, a residual add where a bottleneck keeps its
stride at 1 and its channels, a 7x7 VALID global depthwise convolution,
then a 1x1 projection to the embedding.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .interp import _same_pads

BLOCKS = [(2, 64, 5, 2), (4, 128, 1, 2), (2, 128, 6, 1),
          (4, 128, 1, 2), (2, 128, 2, 1)]


class MobileFaceNet:
    def __init__(self, params: dict, device):
        self.p = {k: torch.as_tensor(v).to(device) for k, v in params.items()}

    def _conv(self, name, x, stride=1, groups=1, prelu=True, same=True,
              operands=None):
        w = self.p[f"{name}_w"].permute(3, 2, 0, 1)        # HWIO -> OIHW
        if same:
            pt, pb = _same_pads(x.shape[2], stride, w.shape[2])
            pl, pr = _same_pads(x.shape[3], stride, w.shape[3])
            x = F.pad(x, (pl, pr, pt, pb))
        if operands is not None:
            x, w = operands(x), operands(w)
        y = F.conv2d(x.contiguous(), w.contiguous(), self.p[f"{name}_b"],
                     stride=stride, groups=groups)
        if prelu:
            a = self.p[f"{name}_a"][:, None, None]
            y = torch.where(y >= 0, y, y * a)
        return y

    def _forward(self, x, operands):
        h = x.permute(0, 3, 1, 2)
        h = self._conv("stem", h, stride=2, operands=operands)
        h = self._conv("stem_dw", h, groups=64, operands=operands)
        for bi, (t, c, n, stride) in enumerate(BLOCKS):
            for ri in range(n):
                name = f"b{bi}_{ri}"
                s = stride if ri == 0 else 1
                c_in = h.shape[1]
                y = self._conv(f"{name}_e", h, operands=operands)
                y = self._conv(f"{name}_d", y, stride=s, groups=c_in * t,
                               operands=operands)
                y = self._conv(f"{name}_p", y, prelu=False, operands=operands)
                h = y + h if s == 1 and c_in == c else y
        h = self._conv("head", h, operands=operands)
        h = self._conv("gdconv", h, groups=512, prelu=False, same=False,
                       operands=operands)
        h = self._conv("out", h, prelu=False, operands=operands)
        return h.reshape(h.shape[0], -1)

    def __call__(self, x, operands=None, block: int = 256):
        """``x [N, 112, 112, 3]`` in [-1, 1] -> ``[N, D]``."""
        d = self.p["out_b"].shape[0]
        if x.shape[0] == 0:
            return torch.zeros((0, d), device=x.device)
        return torch.cat([self._forward(x[i:i + block], operands)
                          for i in range(0, x.shape[0], block)])
