"""The selfie segmentation program in plain PyTorch and NumPy: the
reference of the ``masks`` check.

Semantics (MediaPipe's selfie segmentation as the port documents it,
written out here without any of the port's code):

1. letterbox each frame to the segmenter's input (``H x W``): the cv2
   INTER_LINEAR-exact resize of the face pipeline, [-1, 1], black (-1)
   padding split evenly; the padding, normalised (top and bottom over
   ``H``, left and right over ``W``), goes with the mask;
2. the segmenter (``reference/interp.py``);
3. for MULTICLASS the softmax over the six class logits of each pixel;
   otherwise the network's one plane, the person probability that its
   own LOGISTIC gives.

A frame's answer: ``planes`` ``[H, W, C]`` float32, ``size`` ``(W, H)``,
``original`` ``(width, height)`` of the frame and ``padding``.
"""

from __future__ import annotations

import torch

from .interp import Network
from .pipeline import letterbox, letterbox_geometry


class Reference:
    """The plain segmentation program over the benchmark's segmenter."""

    def __init__(self, nets: dict, device, config: dict):
        graph = nets["segmentation"]
        self.net = Network(graph, device)
        _, self.h, self.w, _ = graph.tensors[graph.inputs[0]].shape
        self.multiclass = config["segmentation"]["model"] == "MULTICLASS"

    def __call__(self, frames: torch.Tensor, operands=None,
                 block: int = 16) -> list[dict]:
        n, fh, fw, _ = frames.shape
        _, _, pt, pb, pl, pr = letterbox_geometry(fh, fw, self.h, self.w)
        padding = (pt / self.h, pb / self.h, pl / self.w, pr / self.w)
        out = []
        for i in range(0, n, block):
            (raw,) = self.net(letterbox(frames[i:i + block], self.h, self.w),
                              operands)
            planes = (torch.softmax(raw, dim=-1) if self.multiclass
                      else raw[..., :1])
            out += [{"planes": p, "size": (self.w, self.h),
                     "original": (fw, fh), "padding": padding}
                    for p in planes.cpu().numpy()]
        return out
