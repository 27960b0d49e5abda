"""Scale-out over several devices: data-parallel batch sharding.

Port of the JAX package's ``parallel/sharding.py``.  The networks are small
(0.1-2.6 M weights each) and a batch's time is set by its throughput, so
the parallelism is pure data parallelism: every device holds a copy of the
weights, the image batch is split along its leading axis into one equal
chunk per mesh entry, and each device runs the whole pipeline program on
its chunk, with no communication between devices.

Where JAX partitions one jitted program over a ``Mesh``, here a mesh is a
tuple of ``torch.device`` and :func:`data_parallel` queues the program once
per entry, on that entry's device with that device's weights, before
anything waits.  A device may repeat (``(cuda:0, cuda:0)`` runs two shards
on one card; ``(cpu,) * 8`` is the tests' counterpart of the JAX tests'
8-device CPU mesh).

    mesh = make_mesh()                          # every visible card
    weights = shard_params(models, mesh)        # {device: PipelineModels}
    run = data_parallel(lambda d: build_pipeline_program(weights[d], h, w),
                        mesh)
    shards = run(images)                        # one output dict a shard

``FaceDetector(data_parallel=True)`` builds each entry's program as a
captured one (``pipeline/graphs.py``): a CUDA graph a key in the graph
memory pool of the entry's device, whose lock orders the replays of
entries that share a device.  ``ReplicaPool`` needs nothing of its own:
its workers dispatch through ``FaceDetector._stream_dispatch(device=)``,
whose programs are captured on that device the same way.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Optional, Sequence

import torch

from ..convert.executor import resolve_device

__all__ = ["visible_devices", "make_mesh", "shard_params", "shard_batch",
           "data_parallel", "on_device"]


def visible_devices(kind: str = "cuda") -> list[torch.device]:
    """The devices of ``kind`` this process sees: every CUDA card, or the
    CPU's one device.  The detector's mesh, ``seg_device="auto"``,
    ``ReplicaPool``'s default devices and the command line's
    ``--replicas`` all read them here, so replacing this function (as the
    tests and the smoke run do, with a device repeated) changes them
    all."""
    if kind == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device(kind)]


def make_mesh(devices: Optional[Sequence] = None, kind: str = "cuda"
              ) -> tuple[torch.device, ...]:
    """A 1-D mesh: ``devices`` (every visible device of ``kind`` by
    default) as a tuple of resolved ``torch.device`` (``cuda`` names the
    current card's index)."""
    devices = list(devices) if devices is not None else \
        visible_devices(kind)
    if not devices:
        raise ValueError("a mesh needs at least one device")
    return tuple(resolve_device(d) for d in devices)


def shard_params(models, mesh: Sequence[torch.device]) -> dict:
    """One ``PipelineModels`` per distinct device of ``mesh``: ``models``
    itself on its own device, a copy of its weights on any other
    (:meth:`~..pipeline.programs.PipelineModels.replicate`)."""
    return {d: models.replicate(d) for d in dict.fromkeys(mesh)}


def shard_batch(batch: torch.Tensor, mesh: Sequence[torch.device]
                ) -> list[torch.Tensor]:
    """``batch`` split along its leading axis into ``len(mesh)`` equal
    chunks, chunk ``i`` on ``mesh[i]`` (a view where it is already
    there)."""
    n = len(mesh)
    if batch.shape[0] % n:
        raise ValueError(f"a batch of {batch.shape[0]} does not split into "
                         f"{n} equal shards")
    rows = batch.shape[0] // n
    return [batch[i * rows:(i + 1) * rows].to(d, non_blocking=True)
            for i, d in enumerate(mesh)]


def on_device(device: Optional[torch.device]):
    """``torch.cuda.device(device)`` for a card, so that work without an
    explicit device goes there; nothing for the CPU or None."""
    return (torch.cuda.device(device)
            if device is not None and device.type == "cuda"
            else contextlib.nullcontext())


def data_parallel(program_for_device: Callable, mesh: Sequence[torch.device],
                  n_batch_args: int = 1) -> Callable:
    """A callable that runs a batched pipeline program sharded over
    ``mesh``.

    ``program_for_device(device)`` returns the program bound to that
    device's weights; it is called once per distinct device.  The callable
    takes ``n_batch_args`` batch arguments (1 for the fused image program,
    5 for the face-stage program of images and the four detection slabs),
    each a tensor whose leading axis divides by ``len(mesh)`` (split with
    :func:`shard_batch`) or a list that is already one shard per entry.
    It queues every shard's program, on the shard's device, before it
    returns, and returns the outputs per shard (a list, one per mesh
    entry), so that a readback pulls only the shards it reads."""
    mesh = tuple(mesh)
    programs = {d: program_for_device(d) for d in dict.fromkeys(mesh)}

    def run(*batch_args):
        if len(batch_args) != n_batch_args:
            raise TypeError(f"expected {n_batch_args} batch argument(s), "
                            f"got {len(batch_args)}")
        shards = [list(a) if isinstance(a, (list, tuple))
                  else shard_batch(a, mesh) for a in batch_args]
        if any(len(s) != len(mesh) for s in shards):
            raise ValueError(f"expected {len(mesh)} shards an argument")
        outs = []
        for i, d in enumerate(mesh):
            with on_device(d):
                outs.append(programs[d](*(s[i] for s in shards)))
        return outs

    return run
