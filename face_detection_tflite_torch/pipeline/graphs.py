"""Captured programs: a CUDA graph per program key, replayed per call.

The JAX package compiles each pipeline program once per key with
``jax.jit`` and then dispatches it as one executable.  The counterpart on
a card is a CUDA graph: the eager program (a plain function of tensors,
``pipeline/programs.py``) is captured once per input signature and then
replayed with one ``cudaGraphLaunch`` in place of its ~150-1,200 op-by-op
launches from the host.  This module has no JAX counterpart, as
``pipeline/upload.py`` has none.

:class:`CapturedProgram` wraps one eager program on one device:

* **Key.**  The owner's :class:`ProgramSet` keys the program by what its
  closure fixes (image size, mode, face slab, device); the program keys
  its graphs by the shapes and dtypes of its inputs, which carry the
  padded batch and the overflow width ``nb`` of the face-stage re-run.
* **Schedule.**  A key's calls are counted (under the program's lock).
  Calls 1 to ``CAPTURE_AT_CALL - 1`` run the eager program on the
  caller's stream and hold no graph memory; they also warm what a capture
  must not do itself (cuDNN's first calls, the kernels' build and load,
  K1's shared-memory opt-in, the per-device index tables).  Call
  ``CAPTURE_AT_CALL`` copies its inputs into the graph's static inputs,
  captures the program (``capture_error_mode="thread_local"``, so that
  another thread's event synchronise does not abort it) and takes its
  result from the graph's first replay, which so checks the capture;
  where the calling thread has not run the key before, it runs the
  eager program first (its result the call's), since a thread's own
  cuBLAS and cuDNN handles must not be created under capture.
  Later calls copy their inputs in, replay and clone the outputs out of
  the graph's memory, all on the caller's current stream.  The clone is
  needed: a result that a caller still holds (the speculative ``det_*``
  slab, a depth-2 stream's batch in flight) would otherwise be
  overwritten by the next replay.  The JAX package compiles a key on its
  first call but keeps the executable in a disk cache; a CUDA graph
  cannot be kept on disk, so a key that is called only a few times is
  not worth its capture.  Inside :func:`capture_now`
  (``FaceDetector.warmup``) a key is captured on its first call, after
  one eager run that is the call's result.  Two threads that reach the
  capture together capture once: the capture takes a process-wide lock
  and finds the other's graph.
* **Capture cost.**  ``capture_s`` is a key's host seconds from the
  static clone to ``capture_end``; ``capture_parts`` splits it: the
  pool's :meth:`GraphPool.adopt` (``renewed`` where it started a new pool
  after ``torch.cuda.empty_cache``), the program's host run under
  capture, ``capture_end`` (the graph's instantiation), the bytes the
  card's reservations grew by (the key's new pool segments), and the host
  seconds of the key's first replay (the capturing call's own, or under
  :func:`capture_now` the next call's).
* **Memory.**  One graph memory pool (:class:`GraphPool`) per device,
  shared by every captured program of the process there.  A key's graph
  holds the eager program's whole working set (4.5 GB for FULL at
  B = 16 on an H100), so a pool per detector would hold one working set
  per detector; in one shared pool each later capture reuses the blocks
  earlier captures freed, and the pool stays about one working set.  Sharing is safe only while its replays never
  overlap, so the pool's lock orders each copy-in, replay and clone
  across threads and owners, and the next caller's stream waits on the
  event recorded after the last clone.  An owner's ``dispose`` releases
  its graphs (:meth:`CapturedProgram.release`); once no graph is left in
  the pool, the next capture hands its memory back to the card and
  starts a new pool (:meth:`GraphPool.adopt`).
* **Launch counts.**  A replay enters no kernel wrapper, so the launches
  a capture records (``kernels.build.tally_launches``) are added to the
  wrappers' counts at each replay (``kernels.build.add_launches``); a
  capture itself launches nothing and counts nothing.
* **Eager calls.**  Inside ``pipeline.timings.trace`` (on every thread)
  and inside :func:`eager` (on the calling thread) a call runs the eager
  program and does not count toward the capture: the trace's ``fdt.*``
  stage ranges are host ranges entered op by op, which a replay does not
  enter.  Any other ``torch.profiler`` window sees the replays, and in
  them the host spans (``pipeline/timings.py``) ``replay`` (the copy-in,
  the graph's launch and the clone), ``eager`` (an eager call) and
  ``capture``, which record into the detector whose span encloses the
  call.  Inside a replay the detector's programs still mark their stage
  groups: the stage stamps they launch from their ranges are captured
  into the graph and write the card's clock at every replay
  (``pipeline/timings.py``, "Stage stamps").
* **Counts.**  Per key, the eager calls (forced ones included), the
  replays and the captures are counted (:meth:`CapturedProgram.counts`;
  the replays under the pool's lock, the rest under the call counts'
  lock), so that a key that runs eagerly is seen
  (``FaceDetector.memory_report()``'s ``eager_calls`` and ``replays``).
* **Failures.**  A failed capture or replay raises; nothing falls back to
  the eager program on the card.

Graphs are made through :func:`graph_maker`, the one seam: a CUDA graph on
a card and none on the CPU, where the owners run the eager program.  The
tests replace it with a stand-in that re-runs the program into the same
static outputs at each replay, so results alias as a real graph's do.

Every owner of programs (``FaceDetector``, ``SelfieSegmentation``,
``FaceEmbedding`` and the standalone model classes) holds them in one
:class:`ProgramSet`: a key's program is made once, its eager closure
wrapped here with the fp32 guard of the networks it runs, and the set
frees every graph it made on the owner's ``dispose``.
"""

from __future__ import annotations

import contextlib
import functools
import threading
import time
import weakref
from typing import Callable, Optional

import torch

from ..convert.executor import _check_fp32
from ..kernels import build as _build
from . import timings

__all__ = ["CapturedProgram", "GraphPool", "ProgramSet", "graph_maker",
           "pool_for", "program", "eager", "capture_now", "thread_flags",
           "flags_set", "CAPTURE_AT_CALL"]

#: The call of an input signature that captures it; the calls before it
#: run the eager program.  A key is captured once its eager calls have
#: lost, against replays, about what its capture costs: on an H100 a
#: capture's host run and ``capture_end`` cost about three times what an
#: eager call loses against a replay at B = 1 (PERF.md, section 6).
CAPTURE_AT_CALL = 4

_local = threading.local()
#: One capture at a time in the process: a new pool's ``empty_cache``
#: (:meth:`GraphPool.adopt`) must not free memory under another capture.
_capture_lock = threading.Lock()


@contextlib.contextmanager
def _set(flag: str):
    saved = getattr(_local, flag, False)
    setattr(_local, flag, True)
    try:
        yield
    finally:
        setattr(_local, flag, saved)


def eager():
    """Within the block, on this thread, captured programs run their eager
    program and do not count the call toward a capture (as inside
    ``timings.trace`` on every thread): what counts a call's operators
    (``FaceDetector.cost_report``) or marks a network's calls needs the
    ops run one by one."""
    return _set("eager")


def capture_now():
    """Within the block, on this thread, a captured program captures a key
    on its first call, after one eager run that is the call's result,
    instead of at call :data:`CAPTURE_AT_CALL`: what warms a process
    (``FaceDetector.warmup``) pays the captures up front.  :func:`eager`
    takes precedence."""
    return _set("capture_now")


def thread_flags() -> tuple:
    """The flags of :func:`eager` and :func:`capture_now` set on this
    thread, for a worker thread that runs this thread's calls
    (:func:`flags_set`)."""
    return tuple(f for f in ("eager", "capture_now")
                 if getattr(_local, f, False))


@contextlib.contextmanager
def flags_set(flags: tuple):
    """Within the block, on this thread, the flags ``flags`` of another
    thread (:func:`thread_flags`) are set too."""
    with contextlib.ExitStack() as stack:
        for flag in flags:
            stack.enter_context(_set(flag))
        yield


def _runs_eager() -> bool:
    return timings.tracing() or getattr(_local, "eager", False)


def _ran_here(program: "CapturedProgram") -> set:
    """The keys of ``program`` this thread has run eagerly (kept while the
    program lives)."""
    ran = getattr(_local, "ran", None)
    if ran is None:
        ran = _local.ran = weakref.WeakKeyDictionary()
    return ran.setdefault(program, set())


def _map(fn, tree):
    """``fn`` of each tensor of a pytree of dicts, lists and tuples; a leaf
    that is no tensor (the detector's readback layout) passes as it is."""
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree) if isinstance(tree, torch.Tensor) else tree


#: One capture stream a card (a graph cannot be captured on the legacy
#: default stream).
_capture_streams: dict[int, "torch.cuda.Stream"] = {}


def _cuda_graph(fn: Callable, static_inputs: list, pool: "GraphPool"):
    """Captures ``fn(*static_inputs)`` into a CUDA graph in ``pool``'s
    memory, on a side stream; returns (replay, static outputs, the
    capture's parts: host seconds of the pool's ``adopt`` and whether it
    renewed the pool, of the program's run under capture and of
    ``capture_end``, and the bytes the card's reservations grew by).  The
    capture calls ``CUDAGraph.capture_begin``/``capture_end`` itself: the
    ``torch.cuda.graph`` context would also synchronise the card and
    empty PyTorch's device and pinned-host caches on entry, under every
    other thread's feet (a server's batcher, a replica's worker).  A host
    synchronise inside ``fn`` (``.item()``, ``.cpu()``, a pageable copy)
    makes the capture fail, and that raises."""
    device = pool.device
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    renewals = pool.renewals
    t0 = time.perf_counter()
    held = _Graph(torch.cuda.CUDAGraph(), pool)
    t1 = time.perf_counter()
    reserved = torch.cuda.memory_reserved(index)
    graph = held.graph
    with torch.cuda.device(index):
        stream = _capture_streams.get(index)
        if stream is None:
            stream = _capture_streams[index] = torch.cuda.Stream(index)
        try:
            with torch.cuda.stream(stream):
                graph.capture_begin(pool=held.handle,
                                    capture_error_mode="thread_local")
                try:
                    out = fn(*static_inputs)
                except BaseException:
                    try:
                        graph.capture_end()
                    except RuntimeError:
                        pass  # the capture is invalid; fn's error says why
                    raise
                t2 = time.perf_counter()
                graph.capture_end()
                t3 = time.perf_counter()
        except RuntimeError as e:
            raise RuntimeError(
                f"capturing a program on {device} failed: {e} (a host "
                f"synchronise inside the program, such as .item(), .cpu() "
                f"or a pageable host-to-device copy, cannot be "
                f"captured)") from e
    return held.replay, out, {
        "adopt_s": t1 - t0, "renewed": pool.renewals != renewals,
        "run_s": t2 - t1, "end_s": t3 - t2,
        "pool_bytes": torch.cuda.memory_reserved(index) - reserved}


class _Graph:
    """A captured graph, counted live in its pool (:meth:`GraphPool.adopt`)
    until it is freed."""

    def __init__(self, graph, pool: "GraphPool"):
        self.graph = graph
        self.handle = pool.adopt(self)

    def replay(self) -> None:
        self.graph.replay()


def graph_maker(device: torch.device) -> Optional[Callable]:
    """The function that captures a program on ``device``: a CUDA graph's
    on a card, None elsewhere (the owners then run the eager program).
    ``maker(fn, static_inputs, pool)`` returns ``(replay, static
    outputs, parts)``: ``replay()`` recomputes the outputs in place from
    the static inputs' current values, and ``parts`` is a dict of the
    capture's cost by part (:func:`_cuda_graph`).  The tests replace this
    function with one that returns a stand-in, so the captured path runs
    on the CPU."""
    return _cuda_graph if device.type == "cuda" else None


class GraphPool:
    """The graph memory of one device, shared by the process's captured
    programs there, and the lock and event that keep their replays from
    overlapping (:func:`pool_for`)."""

    def __init__(self, device: torch.device):
        self.device = device
        self.lock = threading.Lock()
        self._handle = None
        self._live = 0
        self._live_lock = threading.Lock()
        self._done: Optional["torch.cuda.Event"] = None
        #: How many times :meth:`adopt` started a new CUDA memory pool
        #: after the last one's graphs were freed.
        self.renewals = 0

    def adopt(self, graph: object):
        """Counts ``graph`` live in this pool until it is freed, and
        returns the handle to capture it with: a new CUDA memory pool
        where no graph of the last one is left, since PyTorch frees a
        graph pool with its last graph and cannot take it back.  Before
        a new pool, the last one's memory is handed back to the card
        (``torch.cuda.empty_cache``): PyTorch releases a freed graph
        pool's blocks only there or on running out of memory outside a
        capture, never during one, so the old pool would otherwise stay
        reserved beside the new one."""
        with self._live_lock:
            if self._live == 0:
                if self._handle is not None:
                    torch.cuda.empty_cache()
                    self.renewals += 1
                self._handle = torch.cuda.graph_pool_handle()
            self._live += 1
        weakref.finalize(graph, self._freed)
        return self._handle

    def _freed(self) -> None:
        with self._live_lock:
            self._live -= 1

    def wait(self, stream) -> None:
        """Orders ``stream`` after the last clone out of this pool."""
        if self._done is not None:
            stream.wait_event(self._done)

    def record(self, stream) -> None:
        """Marks the end of a clone out of this pool on ``stream``."""
        if self.device.type == "cuda":
            self._done = torch.cuda.Event()
            self._done.record(stream)

    def nbytes(self) -> int:
        """The device bytes of this pool's segments (0 before a capture,
        and off a card)."""
        if self._handle is None or self.device.type != "cuda":
            return 0
        want = tuple(self._handle)
        return sum(s["total_size"] for s in torch.cuda.memory_snapshot()
                   if s.get("device") == self.device.index
                   and tuple(s.get("segment_pool_id") or ()) == want)


_pools: dict[torch.device, GraphPool] = {}
_pools_lock = threading.Lock()


def pool_for(device) -> GraphPool:
    """The graph pool of ``device`` (a card's index made explicit)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    with _pools_lock:
        pool = _pools.get(device)
        if pool is None:
            pool = _pools[device] = GraphPool(device)
        return pool


class CapturedProgram:
    """An eager program ``fn(*tensors) -> pytree of tensors`` on one device,
    captured per input signature at its :data:`CAPTURE_AT_CALL`-th call
    and replayed after (module docstring).  ``guard`` runs on every call,
    eager or replayed (the executor's fp32 check, which a replay does not
    enter)."""

    def __init__(self, fn: Callable, pool: GraphPool, maker: Callable,
                 guard: Optional[Callable[[], None]] = None):
        self.fn = fn
        self.pool = pool
        self._maker = maker
        self._guard = guard
        self._graphs: dict[tuple, tuple] = {}
        #: Counted calls of each input signature, up to its capture.
        self._calls: dict[tuple, int] = {}
        self._calls_lock = threading.Lock()
        #: Host seconds of each key's capture, from the static clone to
        #: ``capture_end`` (the first replay not included).
        self.capture_s: dict[tuple, float] = {}
        #: Each key's capture by part (module docstring, "Capture cost").
        self.capture_parts: dict[tuple, dict] = {}
        #: Per key: eager calls and captures (under ``_calls_lock``),
        #: replays (under the pool's lock).
        self._eager: dict[tuple, int] = {}
        self._captures: dict[tuple, int] = {}
        self._replays: dict[tuple, int] = {}

    def keys(self) -> list[tuple]:
        """The input signatures (shape and dtype of each input) captured
        so far."""
        return list(self._graphs)

    def pending(self) -> dict[tuple, int]:
        """The input signatures called but not captured yet, with their
        counted calls."""
        with self._calls_lock:
            return {k: n for k, n in self._calls.items()
                    if k not in self._graphs}

    def counts(self) -> dict[tuple, dict[str, int]]:
        """Per input signature, its ``eager`` calls, ``replays`` and
        ``captures`` so far (since the last :meth:`release`)."""
        with self._calls_lock:
            eager, captures = dict(self._eager), dict(self._captures)
        with self.pool.lock:
            replays = dict(self._replays)
        return {k: {"eager": eager.get(k, 0), "replays": replays.get(k, 0),
                    "captures": captures.get(k, 0)}
                for k in set(eager) | set(captures) | set(replays)}

    def release(self) -> None:
        """Frees this program's graphs and forgets its call counts (a
        later call counts toward a capture anew) and :meth:`counts`."""
        with self.pool.lock:
            self._graphs.clear()
            self.capture_s.clear()
            self.capture_parts.clear()
            self._replays.clear()
        with self._calls_lock:
            self._calls.clear()
            self._eager.clear()
            self._captures.clear()

    def __call__(self, *args):
        if self._guard is not None:
            self._guard()
        key = tuple((tuple(a.shape), a.dtype) for a in args)
        if _runs_eager():
            with self._calls_lock:
                self._eager[key] = self._eager.get(key, 0) + 1
            with timings.span("eager"):
                return self.fn(*args)
        with torch.inference_mode():
            entry = self._graphs.get(key)
            if entry is None:
                ran = _ran_here(self)
                with self._calls_lock:
                    calls = self._calls[key] = self._calls.get(key, 0) + 1
                    capture = calls >= CAPTURE_AT_CALL or getattr(
                        _local, "capture_now", False)
                    eager = not capture or key not in ran
                    if eager:
                        self._eager[key] = self._eager.get(key, 0) + 1
                if eager:
                    # An eager call.  Before a capture it warms what the
                    # capture must not do, in this thread too (its cuBLAS
                    # and cuDNN handles), and is the call's result.
                    with timings.span("eager"):
                        out = self.fn(*args)
                    ran.add(key)
                    if capture:
                        self._capture(key, args)
                    return out
                entry = self._capture(key, args)
            return self._replay(key, entry, args)

    def _capture(self, key: tuple, args) -> tuple:
        """The graph of ``key``, captured on ``args`` unless another
        thread's call captured it first."""
        with _capture_lock, self.pool.lock:
            entry = self._graphs.get(key)
            if entry is not None:
                return entry
            with timings.span("capture"):
                t0 = time.perf_counter()
                # The call's values: a stand-in capture runs on them.
                static = [a.clone(memory_format=torch.contiguous_format)
                          for a in args]
                with _build.tally_launches() as tally:
                    replay, out, parts = self._maker(self.fn, static,
                                                     self.pool)
                entry = self._graphs[key] = (static, replay, out, tally)
                self.capture_s[key] = time.perf_counter() - t0
                self.capture_parts[key] = parts
            with self._calls_lock:
                self._captures[key] = self._captures.get(key, 0) + 1
            return entry

    def _replay(self, key: tuple, entry, args):
        static, replay, out, tally = entry
        pool = self.pool
        t0 = time.perf_counter()
        with timings.span("replay"), pool.lock:
            self._replays[key] = self._replays.get(key, 0) + 1
            stream = (torch.cuda.current_stream(pool.device)
                      if pool.device.type == "cuda" else None)
            if stream is not None:
                pool.wait(stream)
            for s, a in zip(static, args):
                s.copy_(a)
            replay()
            result = _map(torch.clone, out)
            if stream is not None:
                pool.record(stream)
        parts = self.capture_parts.get(key)
        if parts is not None and "replay_s" not in parts:
            parts["replay_s"] = time.perf_counter() - t0
        _build.add_launches(tally)
        return result


def program(fn: Callable, device,
            guard: Optional[Callable[[], None]] = None):
    """``fn`` as a :class:`CapturedProgram` in ``device``'s pool where
    :func:`graph_maker` has a maker for ``device``, else ``fn`` itself
    (the CPU runs the eager program)."""
    pool = pool_for(device)
    maker = graph_maker(pool.device)
    if maker is None:
        return fn
    return CapturedProgram(fn, pool, maker, guard)


class ProgramSet:
    """The programs of one owner, one a key, under one lock (module
    docstring).  :meth:`get` makes a key's program at its first use from
    a ``make`` that wraps its eager closure (:meth:`wrap`; the detector's
    wraps one a shard under ``data_parallel``).  Every
    :class:`CapturedProgram` the set wrapped is kept for the owner's
    report (:meth:`captured`) and freed by :meth:`release`."""

    def __init__(self):
        #: Held while a key's program is made; re-entrant, since ``make``
        #: calls :meth:`wrap`.
        self._lock = threading.RLock()
        self._programs: dict = {}
        self._captured: list[CapturedProgram] = []

    def get(self, key, make: Callable[[], Callable]) -> Callable:
        """The program of ``key``, ``make()`` at its first use."""
        with self._lock:
            prog = self._programs.get(key)
            if prog is None:
                prog = self._programs[key] = make()
            return prog

    def wrap(self, fn: Callable, device, nets) -> Callable:
        """``fn`` as a program on ``device`` (:func:`program`), with the
        executor's fp32 check on every call, for bf16 products too where
        one of the networks ``nets`` it runs has a bf16 tier."""
        device = torch.device(device)
        bf16 = any(net.runs_bf16 for net in nets)
        prog = program(fn, device, functools.partial(_check_fp32, device,
                                                     bf16=bf16))
        if isinstance(prog, CapturedProgram):
            with self._lock:
                self._captured.append(prog)
        return prog

    def keys(self) -> list:
        with self._lock:
            return list(self._programs)

    def items(self) -> list:
        with self._lock:
            return list(self._programs.items())

    def __len__(self) -> int:
        with self._lock:
            return len(self._programs)

    def captured(self) -> list[CapturedProgram]:
        """The captured programs the set made (none off a card), the
        shards of a ``data_parallel`` key each."""
        with self._lock:
            return list(self._captured)

    def release(self) -> None:
        """Frees every captured program's graphs and forgets the keys."""
        with self._lock:
            for prog in self._captured:
                prog.release()
            self._captured.clear()
            self._programs.clear()
