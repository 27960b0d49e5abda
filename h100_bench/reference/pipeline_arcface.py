"""The FULL face pipeline of ``reference/pipeline.py`` with a graph as its
embedding network: the plain reference of configurations whose
``embedding`` role is a TFLite-form graph (ArcFace's iResNet,
``networks/iresnet.py``) rather than MobileFaceNet's parameter dict.

Steps 1-7 are ``pipeline.Reference``'s; step 7's network is
``interp.Network`` over the same graph the program converts, its one
output the embedding before the L2 normalisation.  ``operands`` reaches
its convolutions and its fully-connected layer as every other
network's.
"""

from __future__ import annotations

from .interp import Network
from .pipeline import Reference as FaceReference


class _GraphEmbedding:
    """``interp.Network`` called as ``pipeline.Reference`` calls its
    embedding: ``(crops [N, S, S, 3], operands) -> [N, D]``."""

    def __init__(self, graph, device):
        self.net = Network(graph, device)

    def __call__(self, x, operands=None):
        (e,) = self.net(x, operands)
        return e


class Reference(FaceReference):
    """The plain FULL pipeline with a graph embedding network."""

    def __init__(self, nets: dict, device, max_faces: int,
                 detector_size: int = 256):
        faces = {k: v for k, v in nets.items() if k != "embedding"}
        super().__init__(faces, device, max_faces, detector_size)
        if "embedding" in nets:
            self.embedding = _GraphEmbedding(nets["embedding"], device)
