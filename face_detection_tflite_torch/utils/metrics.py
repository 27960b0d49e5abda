"""Serving metrics: counters, gauges and histograms with Prometheus text
exposition.

A copy of the JAX package's ``utils/metrics.py`` (the port imports nothing
of that package): the stdlib-only registry that the HTTP front end
(``pipeline/server.py``) exposes at ``GET /metrics``.

Thread-safe (one lock per metric family; the render pass snapshots under
each family's lock).  No label cardinality guards beyond a hard cap:
callers control label values.
"""

from __future__ import annotations

import math
import threading
from typing import Optional, Sequence

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry"]

# Latency buckets in milliseconds, from a millisecond to ten seconds.
DEFAULT_BUCKETS_MS = (1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0,
                      500.0, 1000.0, 2500.0, 10000.0)

_MAX_LABEL_SETS = 1000  # runaway-cardinality backstop


def _fmt(v: float) -> str:
    """Prometheus float formatting: integers render bare, +Inf as +Inf."""
    if v == math.inf:
        return "+Inf"
    if float(v).is_integer():
        return str(int(v))
    return repr(float(v))


def _label_str(names: Sequence[str], values: Sequence[str]) -> str:
    if not names:
        return ""
    inner = ",".join(f'{n}="{_escape(v)}"' for n, v in zip(names, values))
    return "{" + inner + "}"


def _escape(v: str) -> str:
    return str(v).replace("\\", "\\\\").replace('"', '\\"').replace(
        "\n", "\\n")


class _Metric:
    kind = "untyped"

    def __init__(self, name: str, help_text: str = "",
                 label_names: Sequence[str] = ()):
        self.name = name
        self.help = help_text
        self.label_names = tuple(label_names)
        self._lock = threading.Lock()
        self._children: dict[tuple, object] = {}

    def labels(self, *values, **kv):
        """Child metric for a label-value tuple (positional or by name)."""
        if kv:
            if values:
                raise ValueError("pass label values positionally OR by name")
            values = tuple(kv[n] for n in self.label_names)
        values = tuple(str(v) for v in values)
        if len(values) != len(self.label_names):
            raise ValueError(
                f"{self.name}: expected labels {self.label_names}, "
                f"got {values}")
        with self._lock:
            child = self._children.get(values)
            if child is None:
                if len(self._children) >= _MAX_LABEL_SETS:
                    raise ValueError(
                        f"{self.name}: label cardinality cap "
                        f"({_MAX_LABEL_SETS}) exceeded")
                child = self._make_child()
                self._children[values] = child
            return child

    def _make_child(self):
        raise NotImplementedError

    def _self_child(self):
        """The implicit no-label child (metrics used without .labels())."""
        if self.label_names:
            raise ValueError(
                f"{self.name} has labels {self.label_names}; call "
                f".labels(...) first")
        with self._lock:
            if () not in self._children:
                self._children[()] = self._make_child()
            return self._children[()]

    def render(self) -> str:
        lines = []
        if self.help:
            lines.append(f"# HELP {self.name} {_escape(self.help)}")
        lines.append(f"# TYPE {self.name} {self.kind}")
        with self._lock:
            items = sorted(self._children.items())
        for values, child in items:
            lines.extend(child.render_lines(self.name, self.label_names,
                                            values))
        return "\n".join(lines) + "\n"


class _CounterChild:
    def __init__(self):
        self._lock = threading.Lock()
        self.value = 0.0

    def inc(self, amount: float = 1.0):
        if amount < 0:
            raise ValueError("counters only go up")
        with self._lock:
            self.value += amount

    def render_lines(self, name, label_names, values):
        return [f"{name}{_label_str(label_names, values)} "
                f"{_fmt(self.value)}"]


class Counter(_Metric):
    kind = "counter"

    def _make_child(self):
        return _CounterChild()

    def inc(self, amount: float = 1.0):
        self._self_child().inc(amount)

    @property
    def value(self) -> float:
        return self._self_child().value


class _GaugeChild:
    def __init__(self):
        self._lock = threading.Lock()
        self.value = 0.0

    def set(self, v: float):
        with self._lock:
            self.value = float(v)

    def inc(self, amount: float = 1.0):
        with self._lock:
            self.value += amount

    def dec(self, amount: float = 1.0):
        self.inc(-amount)

    def render_lines(self, name, label_names, values):
        return [f"{name}{_label_str(label_names, values)} "
                f"{_fmt(self.value)}"]


class Gauge(_Metric):
    kind = "gauge"

    def _make_child(self):
        return _GaugeChild()

    def set(self, v: float):
        self._self_child().set(v)

    def inc(self, amount: float = 1.0):
        self._self_child().inc(amount)

    def dec(self, amount: float = 1.0):
        self._self_child().dec(amount)

    @property
    def value(self) -> float:
        return self._self_child().value


class _HistogramChild:
    def __init__(self, buckets: Sequence[float]):
        self._lock = threading.Lock()
        self.buckets = tuple(buckets)
        self.counts = [0] * (len(self.buckets) + 1)  # +1 for +Inf
        self.total = 0.0
        self.n = 0

    def observe(self, v: float):
        with self._lock:
            self.total += v
            self.n += 1
            for i, b in enumerate(self.buckets):
                if v <= b:
                    self.counts[i] += 1
                    return
            self.counts[-1] += 1

    def render_lines(self, name, label_names, values):
        lines = []
        cum = 0
        with self._lock:
            counts = list(self.counts)
            total, n = self.total, self.n
        for b, c in zip(list(self.buckets) + [math.inf], counts):
            cum += c
            le = _label_str(list(label_names) + ["le"],
                            list(values) + [_fmt(b)])
            lines.append(f"{name}_bucket{le} {cum}")
        base = _label_str(label_names, values)
        lines.append(f"{name}_sum{base} {_fmt(total)}")
        lines.append(f"{name}_count{base} {n}")
        return lines


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, name: str, help_text: str = "",
                 label_names: Sequence[str] = (),
                 buckets: Sequence[float] = DEFAULT_BUCKETS_MS):
        super().__init__(name, help_text, label_names)
        if list(buckets) != sorted(buckets):
            raise ValueError("histogram buckets must be sorted")
        self._buckets = tuple(buckets)

    def _make_child(self):
        return _HistogramChild(self._buckets)

    def observe(self, v: float):
        self._self_child().observe(v)


class MetricsRegistry:
    """Holds metric families; ``render()`` emits Prometheus text format."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: dict[str, _Metric] = {}

    def _register(self, m: _Metric) -> _Metric:
        with self._lock:
            if m.name in self._metrics:
                raise ValueError(f"duplicate metric {m.name}")
            self._metrics[m.name] = m
        return m

    def counter(self, name: str, help_text: str = "",
                label_names: Sequence[str] = ()) -> Counter:
        return self._register(Counter(name, help_text, label_names))

    def gauge(self, name: str, help_text: str = "",
              label_names: Sequence[str] = ()) -> Gauge:
        return self._register(Gauge(name, help_text, label_names))

    def histogram(self, name: str, help_text: str = "",
                  label_names: Sequence[str] = (),
                  buckets: Sequence[float] = DEFAULT_BUCKETS_MS
                  ) -> Histogram:
        return self._register(Histogram(name, help_text, label_names,
                                        buckets))

    def get(self, name: str) -> Optional[_Metric]:
        with self._lock:
            return self._metrics.get(name)

    def render(self) -> str:
        with self._lock:
            metrics = sorted(self._metrics.values(), key=lambda m: m.name)
        return "".join(m.render() for m in metrics)
