"""One run of one cell: set-up, warm-up, the measured window, the
correctness check.

The traffic mix names its ``loop`` (``h100_bench/loops/<loop>.py``),
which calls the program's entry on units of ``batch`` frames (1 where
the mix gives none) cycled through the pool; the configuration names
its ``reference`` (``h100_bench/reference/<reference>.py``), the face
pipeline that calibrates the detector, and its checks
(``harness/check.py``).
"""

from __future__ import annotations

import gc
import random
import time

import numpy as np
import torch

from h100_bench.checks import faces

from . import check, netspec, system
from .frames import make_frames
from .manifest import plugin

#: Passes over the frame pool the warm-up may take to capture every key
#: the traffic reaches (the sticky slab settles within two).
WARM_CYCLES = 6


def fp32(device) -> None:
    """No TF32 anywhere in the process: the configurations state fp32, and
    the reference runs in it."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class Setup:
    """The cell's weights, frames and program, made from the seed."""

    def __init__(self, config: dict, mix: dict, seed: int, device,
                 program: bool = True):
        fp32(device)
        self.config, self.mix, self.seed, self.device = (config, mix, seed,
                                                         device)
        #: Host seconds of each part of the set-up.
        self.parts = {}
        t = time.perf_counter()
        self.nets = netspec.build_networks(config, seed, device)
        t = self._part("weights", t)
        self.frames = make_frames(mix["frames"], seed, device)
        t = self._part("frames", t)
        # The reference's share of set-up: ``setup_s`` leaves it out.
        ref = calibrate(self.nets, self.frames, config, mix, device)
        if "faces_cycle" in mix:
            self.frames = select_frames(ref, self.frames, mix, device)
        t = self._part("calibration", t)
        del ref
        if torch.device(device).type == "cuda":
            # The peak from here on is the program's: the calibration's
            # reference runs before it.
            torch.cuda.reset_peak_memory_stats(device)
        self.detector = None
        if program:
            if torch.device(device).type == "cuda":
                system.load_kernels()
                t = self._part("kernels", t)
            self.detector = system.make_detector(self.nets, config, device)
            self._part("program", t)
        self.mode = system.mode(config)
        self.loop = plugin("loops", mix["loop"])

    def _part(self, name: str, t: float) -> float:
        now = time.perf_counter()
        self.parts[name] = now - t
        return now

    def warm(self) -> dict:
        """Runs the traffic over the whole pool under ``capture_now`` until
        no program key is left uncaptured; returns the memory report."""
        t = time.perf_counter()
        b = self.mix.get("batch", 1)
        per_cycle = -(-len(self.frames) // b)
        for _ in range(WARM_CYCLES):
            with system.capture_now():
                drive(self, per_cycle, deadline=None)
            report = self.detector.memory_report()
            if report["pending_keys"] == 0:
                self._part("warm-up", t)
                return report
        raise RuntimeError(f"warm-up left program keys uncaptured: {report}")


#: Halvings of the log interval of passing anchors a frame in the search
#: for a mix's ``calibrate_faces``.
FACE_STEPS = 8


def calibrate(nets, frames: np.ndarray, config: dict, mix: dict, device):
    """The detector's score bias set on the pool's frames, with the
    reference's detector: so that about the mix's ``calibrate_anchors``
    anchors a frame pass, or, where the mix gives ``calibrate_faces``, so
    that the frames give that many detections a frame on average (the
    passing anchors a frame found by bisection; the seed's weights set
    how many detections an anchor count gives).  Returns the calibrated
    reference over the face roles alone (detector, mesh, iris,
    blendshapes)."""
    ref = faces.reference(config, nets, device, faces.FACE_ROLES)
    blocks = [torch.from_numpy(frames[i:i + 16]).to(device)
              for i in range(0, len(frames), 16)]
    with torch.inference_mode():
        logits = torch.cat([ref.detector_logits(x) for x in blocks])
    logits = logits.double().cpu().numpy()
    det = nets["detector"]
    if "calibrate_faces" not in mix:
        netspec.calibrate_score_bias(det, logits, mix["calibrate_anchors"])
        return faces.reference(config, nets, device, faces.FACE_ROLES)
    target = mix["calibrate_faces"]
    biases = {t: det.tensors[t].data.copy()
              for t in netspec.score_bias_tensors(det)}

    def faces_a_frame(log_anchors: float) -> float:
        for t, data in biases.items():
            det.tensors[t].data = data.copy()
        netspec.calibrate_score_bias(det, logits, float(np.exp(log_anchors)))
        ref = faces.reference(config, nets, device, faces.FACE_ROLES)
        with torch.inference_mode():
            return float(np.mean([n for x in blocks
                                  for n in ref.count_faces(x)]))

    lo, hi, best = 0.0, float(np.log(logits.shape[1])), None
    for _ in range(FACE_STEPS):
        mid = 0.5 * (lo + hi)
        mean = faces_a_frame(mid)
        if best is None or abs(mean - target) < best[0]:
            best = (abs(mean - target), mid)
        lo, hi = (mid, hi) if mean < target else (lo, mid)
    faces_a_frame(best[1])
    return faces.reference(config, nets, device, faces.FACE_ROLES)


def select_frames(ref, frames: np.ndarray, mix: dict,
                  device) -> np.ndarray:
    """A pool of ``pool`` frames whose detections a frame follow the mix's
    ``faces_cycle`` (repeated to fill the pool): each position takes the
    next unused frame, in order, with that many detections.  Every seed
    then gives the same face counts in the same order, so the same
    program keys in the same order.  Where no frame with a position's
    count is left, the next unused frame of the nearest count that has
    one stands in (the lower of two), so that a seed whose frames fall
    short still runs."""
    with torch.inference_mode():
        counts = ref.count_faces(torch.from_numpy(frames).to(device))
    pattern = mix["faces_cycle"]
    free: dict[int, list[int]] = {}
    for i, c in enumerate(counts):
        free.setdefault(c, []).append(i)
    picks = []
    for pos in range(mix["pool"]):
        n = pattern[pos % len(pattern)]
        left = [c for c, idx in free.items() if idx]
        if not left:
            raise RuntimeError(f"{len(frames)} frames are too few for the "
                               f"mix's pool of {mix['pool']}")
        picks.append(free[min(left, key=lambda c: (abs(c - n), c))].pop(0))
    return np.ascontiguousarray(frames[picks])


def pool_units(frames: np.ndarray, batch: int, start: int = 0):
    """Host units of ``batch`` frames cycling through the pool from unit
    ``start`` on, with their frames' pool indices."""
    n = len(frames)
    k = start
    while True:
        idx = [(k * batch + j) % n for j in range(batch)]
        if idx == list(range(idx[0], idx[0] + batch)):
            x = frames[idx[0]:idx[0] + batch]
        else:
            x = frames[idx]
        yield x, idx
        k += 1


def drive(setup: Setup, count, deadline, sample=None, start: int = 0
          ) -> dict:
    """Runs ``count`` units (or until ``deadline`` on the host clock, the
    units in flight then finished) through the mix's loop, offering
    each unit's (pool indices, faces) to ``sample``."""

    def due(k):
        return (count is None or k < count) and (
            deadline is None or time.perf_counter() < deadline)

    return setup.loop.run(setup, due, pool_units(
        setup.frames, setup.mix.get("batch", 1), start), sample)


class Sample:
    """A seeded uniform sample of ``size`` units of a run of unknown
    length (Algorithm R), and the run's last unit: the answers the check
    compares."""

    def __init__(self, size: int, seed: int):
        self.size = size
        self.rng = random.Random(seed)
        self.slots: list[int] = []
        self.items: dict = {}
        self.last = None

    def offer(self, k: int, value) -> None:
        self.last = (k, value)
        if k < self.size:
            self.slots.append(k)
        else:
            j = self.rng.randrange(k + 1)
            if j >= self.size:
                return
            del self.items[self.slots[j]]
            self.slots[j] = k
        self.items[k] = value

    def chosen(self) -> dict:
        out = dict(self.items)
        if self.last is not None:
            out[self.last[0]] = self.last[1]
        return out


def check_outputs(setup: Setup, chosen: dict, limits: dict,
                  operands=None, whole_pool: bool = False) -> dict:
    """Each check's reference over the chosen units' frames ({unit: (pool
    indices, answers a frame)}; over every frame of the pool with
    ``whole_pool``), and the comparisons.  Runs after the program's state
    is freed.  ``ref`` is the face reference's answer by pool index."""
    frames = setup.frames
    pool = sorted({i for idx, _ in chosen.values() for i in idx})
    if whole_pool:
        pool = list(range(len(frames)))
    hw = frames.shape[1:3]
    results, by_faces = {}, None
    for name, mod in check.modules(setup.config):
        ref = mod.reference(setup.config, setup.nets, setup.device)
        with torch.inference_mode():
            out = ref(torch.from_numpy(frames[pool]).to(setup.device),
                      operands)
        del ref
        by_frame = dict(zip(pool, out))
        pairs = [(mod.port_answer(check.frame_answer(got), setup.config),
                  by_frame[i])
                 for idx, answers in chosen.values()
                 for i, got in zip(idx, answers)]
        results[name] = mod.compare(pairs, hw, setup.config)
        if name == "faces":
            by_faces = by_frame
    ok, shown = check.judge(results, limits, setup.config)
    bad = set().union(*(r["bad"] for r in results.values()))
    return {"correct": ok, "checks": shown, "failed": len(bad),
            "counts": {name: r["counts"] for name, r in results.items()},
            "ref": by_faces}


def free(setup: Setup) -> None:
    """Disposes the program and returns its device memory."""
    setup.detector.dispose()
    setup.detector = None
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
