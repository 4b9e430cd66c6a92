"""Typed metrics registry with Prometheus text-format exposition.

The serving stack's counters were born as per-model snapshot dicts
(``ModelTelemetry.snapshot()``), which answers "what happened" for a
test but not "what is happening" for an ops stack: no standard
exposition format, no label dimensions, no histogram buckets. This
module is the missing substrate:

  * ``Counter`` / ``Gauge`` / ``Histogram`` — the three Prometheus
    instrument types, each a *family* keyed by a label-name tuple;
    ``family.labels(**values)`` returns the child for one label-value
    combination (created on first use, cached after).
  * ``MetricsRegistry`` — a thread-safe collection of families with
    ``render()`` producing the Prometheus text format (``# HELP`` /
    ``# TYPE`` headers, one sample line per child, histogram
    ``_bucket``/``_sum``/``_count`` expansion with an ``+Inf`` bucket).
  * ``render_prometheus()`` — module-level exposition of the process
    default registry, the single string an HTTP front door serves on
    ``/metrics``.

``ModelTelemetry`` binds its counters onto a registry via
``bind_obs``: every existing ``record_*`` site then feeds both the
snapshot dict (back-compat) and the typed instruments, dimensioned by
(model_digest, alias, family, dtype) plus per-metric extra labels
(replica, bucket, verdict). The conservation identity the runtime
property-tests (served + shed + failed + expired + closed ==
submitted) therefore holds in this rendering too — it is the same
``record_*`` call feeding both sides.

Instruments are deliberately minimal: monotonic ``inc`` for counters,
``set`` for gauges, ``observe`` for histograms with explicit bucket
bounds. No default-registry magic inside instruments — a family
belongs to exactly the registry that created it.
"""

from __future__ import annotations

import bisect
import threading

_BAD_LABEL_CHARS = {"\\": "\\\\", '"': '\\"', "\n": "\\n"}  # backslash first


def _escape_label_value(value: str) -> str:
    out = str(value)
    for raw, esc in _BAD_LABEL_CHARS.items():
        out = out.replace(raw, esc)
    return out


def _format_value(value: float) -> str:
    value = float(value)
    if value == int(value) and abs(value) < 1e15:
        return str(int(value))
    return repr(value)


def _sample_line(name: str, labels: dict, value: float) -> str:
    if labels:
        body = ",".join(f'{k}="{_escape_label_value(v)}"' for k, v in labels.items())
        return f"{name}{{{body}}} {_format_value(value)}"
    return f"{name} {_format_value(value)}"


class _Child:
    """One label-value combination of a family; holds the value(s)."""

    __slots__ = ("labels", "_lock", "_value", "_buckets", "_sum", "_count")

    def __init__(self, labels: dict, bounds: tuple | None):
        self.labels = labels
        self._lock = threading.Lock()
        self._value = 0.0
        if bounds is not None:
            self._buckets = [0] * (len(bounds) + 1)
            self._sum = 0.0
            self._count = 0
        else:
            self._buckets = None
            self._sum = 0.0
            self._count = 0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError(f"counter increment must be >= 0, got {amount}")
        with self._lock:
            self._value += amount

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class _HistogramChild(_Child):
    __slots__ = ()

    def observe(self, value: float, bounds: tuple) -> None:
        value = float(value)
        # bisect (C-implemented) keeps this off the GIL for the serving
        # hot path; lands in _buckets[len(bounds)] (the +Inf bucket)
        # when value exceeds every bound
        idx = bisect.bisect_left(bounds, value)
        with self._lock:
            self._buckets[idx] += 1
            self._sum += value
            self._count += 1


class _Family:
    """One named metric family: fixed label names, children per values."""

    kind = "untyped"

    def __init__(self, name: str, help_text: str, labelnames: tuple):
        self.name = name
        self.help = help_text
        self.labelnames = tuple(labelnames)
        self._children: dict[tuple, _Child] = {}
        self._lock = threading.Lock()

    def _make_child(self, labels: dict) -> _Child:
        return _Child(labels, None)

    def labels(self, **values: str) -> _Child:
        if set(values) != set(self.labelnames):
            raise ValueError(
                f"{self.name}: expected labels {self.labelnames}, "
                f"got {tuple(sorted(values))}"
            )
        key = tuple(str(values[k]) for k in self.labelnames)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._make_child(dict(zip(self.labelnames, key)))
                self._children[key] = child
            return child

    def children(self) -> list[_Child]:
        with self._lock:
            return list(self._children.values())

    def render(self) -> list[str]:
        lines = [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} {self.kind}"]
        for child in self.children():
            lines.append(_sample_line(self.name, child.labels, child.value))
        return lines


class Counter(_Family):
    kind = "counter"


class Gauge(_Family):
    kind = "gauge"


DEFAULT_BUCKETS = (
    0.0005,
    0.001,
    0.0025,
    0.005,
    0.01,
    0.025,
    0.05,
    0.1,
    0.25,
    0.5,
    1.0,
)


class Histogram(_Family):
    kind = "histogram"

    def __init__(
        self,
        name: str,
        help_text: str,
        labelnames: tuple,
        buckets: tuple = DEFAULT_BUCKETS,
    ):
        super().__init__(name, help_text, labelnames)
        bounds = tuple(sorted(float(b) for b in buckets))
        if not bounds:
            raise ValueError("histogram needs at least one bucket bound")
        self.buckets = bounds

    def _make_child(self, labels: dict) -> _Child:
        return _HistogramChild(labels, self.buckets)

    def labels(self, **values: str) -> "_BoundHistogram":
        child = super().labels(**values)
        return _BoundHistogram(child, self.buckets)

    def render(self) -> list[str]:
        lines = [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} {self.kind}"]
        for child in self.children():
            with child._lock:
                counts = list(child._buckets)
                total = child._count
                acc_sum = child._sum
            cumulative = 0
            for bound, n in zip(self.buckets, counts):
                cumulative += n
                labels = dict(child.labels)
                labels["le"] = _format_value(bound)
                lines.append(_sample_line(f"{self.name}_bucket", labels, cumulative))
            labels = dict(child.labels)
            labels["le"] = "+Inf"
            lines.append(_sample_line(f"{self.name}_bucket", labels, total))
            lines.append(_sample_line(f"{self.name}_sum", child.labels, acc_sum))
            lines.append(_sample_line(f"{self.name}_count", child.labels, total))
        return lines


class _BoundHistogram:
    """A histogram child bound to its family's bucket bounds."""

    __slots__ = ("_child", "_bounds")

    def __init__(self, child: _HistogramChild, bounds: tuple):
        self._child = child
        self._bounds = bounds

    def observe(self, value: float) -> None:
        self._child.observe(value, self._bounds)

    @property
    def value(self) -> float:
        return self._child.value


class MetricsRegistry:
    """Thread-safe collection of metric families with text exposition."""

    def __init__(self):
        self._families: dict[str, _Family] = {}
        self._lock = threading.Lock()

    def _get_or_create(self, cls, name: str, help_text: str, labelnames, **kw):
        with self._lock:
            family = self._families.get(name)
            if family is None:
                family = cls(name, help_text, tuple(labelnames), **kw)
                self._families[name] = family
                return family
        if not isinstance(family, cls):
            raise ValueError(f"metric {name!r} already registered as {family.kind}")
        if family.labelnames != tuple(labelnames):
            raise ValueError(
                f"metric {name!r} already registered with labels "
                f"{family.labelnames}, got {tuple(labelnames)}"
            )
        return family

    def counter(self, name: str, help_text: str, labelnames=()) -> Counter:
        return self._get_or_create(Counter, name, help_text, labelnames)

    def gauge(self, name: str, help_text: str, labelnames=()) -> Gauge:
        return self._get_or_create(Gauge, name, help_text, labelnames)

    def histogram(
        self,
        name: str,
        help_text: str,
        labelnames=(),
        buckets: tuple = DEFAULT_BUCKETS,
    ) -> Histogram:
        return self._get_or_create(
            Histogram, name, help_text, labelnames, buckets=buckets
        )

    def families(self) -> list[_Family]:
        with self._lock:
            return [self._families[k] for k in sorted(self._families)]

    def collect(self) -> dict:
        """``{name: {label_tuple: value}}`` — the test-friendly view."""
        out: dict = {}
        for family in self.families():
            series = {}
            for child in family.children():
                key = tuple(sorted(child.labels.items()))
                series[key] = child.value
            out[family.name] = series
        return out

    def render(self) -> str:
        lines: list[str] = []
        for family in self.families():
            lines.extend(family.render())
        return "\n".join(lines) + ("\n" if lines else "")


DEFAULT_REGISTRY = MetricsRegistry()


def render_prometheus(registry: MetricsRegistry | None = None) -> str:
    """Prometheus text exposition of ``registry`` (default: the process
    default registry every ``Runtime`` binds to unless given its own)."""
    return (registry if registry is not None else DEFAULT_REGISTRY).render()
