"""Prometheus counters, gauges and histograms, and their text format.

The JAX package gets these from ``prometheus_client``; the machine with
the card does not have it, so the port keeps this small copy of the
part it uses: labelled ``Counter``, ``Gauge`` and ``Histogram`` families
in a ``Registry`` that renders the text exposition format 0.0.4 as
``prometheus_client.generate_latest`` does: the same family and sample
names (a counter's ``_total``, a histogram's cumulative ``_bucket`` with
``le`` and its ``_count`` and ``_sum``), labels sorted by name and
escaped, values formatted as Go formats floats (``1.0``, ``+Inf``), and
an unlabelled family's sample present before its first update. The
``_created`` samples are left out. No multiprocess mode, no push
gateway.
"""

from __future__ import annotations

import math
import threading

CONTENT_TYPE_LATEST = "text/plain; version=0.0.4; charset=utf-8"

INF = float("inf")
# prometheus_client's default histogram buckets.
DEFAULT_BUCKETS = (
    0.005, 0.01, 0.025, 0.05, 0.075, 0.1, 0.25, 0.5, 0.75, 1.0, 2.5, 5.0,
    7.5, 10.0, INF,
)


def format_float(d: float) -> str:
    """A sample value or bucket bound as Go prints it (prometheus_client's
    ``floatToGoString``)."""
    d = float(d)
    if d == INF:
        return "+Inf"
    if d == -INF:
        return "-Inf"
    if math.isnan(d):
        return "NaN"
    s = repr(d)
    dot = s.find(".")
    if d > 0 and dot > 6:
        mantissa = f"{s[0]}.{s[1:dot]}{s[dot + 1:]}".rstrip("0.")
        return f"{mantissa}e+0{dot - 1}"
    return s


def _escape_label(v: str) -> str:
    return v.replace("\\", r"\\").replace("\n", r"\n").replace('"', r"\"")


def _escape_help(v: str) -> str:
    return v.replace("\\", r"\\").replace("\n", r"\n")


def _sample(name: str, labels: dict[str, str], value: float) -> str:
    if labels:
        inner = ",".join(f'{k}="{_escape_label(v)}"' for k, v in sorted(labels.items()))
        return f"{name}{{{inner}}} {format_float(value)}\n"
    return f"{name} {format_float(value)}\n"


class Registry:
    """The families of one process part, rendered in registration order."""

    def __init__(self):
        self._families: list[_Family] = []
        self._names: set[str] = set()
        self._lock = threading.Lock()

    def register(self, family: "_Family") -> None:
        with self._lock:
            if family.name in self._names:
                raise ValueError(f"duplicated timeseries in Registry: {family.name}")
            self._names.add(family.name)
            self._families.append(family)

    def families(self) -> list["_Family"]:
        with self._lock:
            return list(self._families)

    def render(self) -> bytes:
        return "".join(f.render() for f in self.families()).encode("utf-8")


class _Family:
    """One metric family: its children by label values (insertion order),
    or a single child when it has no labels."""

    type = ""

    def __init__(self, name: str, documentation: str, labelnames=(), registry=None):
        self.name = name
        self.documentation = documentation
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()
        self._children: dict[tuple[str, ...], object] = {}
        if not self.labelnames:
            self._children[()] = self._new_child()
        if registry is not None:
            registry.register(self)

    def _new_child(self):
        raise NotImplementedError

    def labels(self, *values):
        """The child of these label values, in ``labelnames`` order (made
        at first use)."""
        if not self.labelnames or len(values) != len(self.labelnames):
            raise ValueError(f"{self.name}: expected labels {self.labelnames}, got {values}")
        key = tuple(str(v) for v in values)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._children[key] = self._new_child()
            return child

    def remove(self, *values) -> None:
        """Drop the child of these label values (absent: nothing)."""
        with self._lock:
            self._children.pop(tuple(str(v) for v in values), None)

    def clear(self) -> None:
        """Drop every labelled child."""
        with self._lock:
            if self.labelnames:
                self._children.clear()

    def _only(self):
        if self.labelnames:
            raise ValueError(f"{self.name} has labels {self.labelnames}: call labels() first")
        return self._children[()]

    def _items(self) -> list[tuple[dict[str, str], object]]:
        with self._lock:
            items = list(self._children.items())
        return [(dict(zip(self.labelnames, key)), child) for key, child in items]

    def _head(self, mname: str) -> str:
        return (f"# HELP {mname} {_escape_help(self.documentation)}\n"
                f"# TYPE {mname} {self.type}\n")


class _Value:
    def __init__(self):
        self._lock = threading.Lock()
        self.value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self.value += amount

    def set(self, value: float) -> None:
        with self._lock:
            self.value = float(value)

    def get(self) -> float:
        with self._lock:
            return self.value


class _CounterChild(_Value):
    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError("counters can only be incremented by non-negative amounts")
        super().inc(amount)


class Counter(_Family):
    """A monotonic counter; a trailing ``_total`` in ``name`` is part of
    the sample name only, as in prometheus_client."""

    type = "counter"

    def __init__(self, name, documentation, labelnames=(), registry=None):
        super().__init__(name.removesuffix("_total"), documentation, labelnames, registry)

    def _new_child(self):
        return _CounterChild()

    def inc(self, amount: float = 1.0) -> None:
        self._only().inc(amount)

    def render(self) -> str:
        mname = self.name + "_total"
        return self._head(mname) + "".join(
            _sample(mname, labels, child.get()) for labels, child in self._items()
        )


class _GaugeChild(_Value):
    def dec(self, amount: float = 1.0) -> None:
        self.inc(-amount)


class Gauge(_Family):
    type = "gauge"

    def _new_child(self):
        return _GaugeChild()

    def set(self, value: float) -> None:
        self._only().set(value)

    def render(self) -> str:
        return self._head(self.name) + "".join(
            _sample(self.name, labels, child.get()) for labels, child in self._items()
        )


class _HistogramChild:
    def __init__(self, bounds: tuple[float, ...]):
        self._lock = threading.Lock()
        self.bounds = bounds
        self.counts = [0.0] * len(bounds)  # per bucket, not cumulative
        self.sum = 0.0

    def observe(self, amount: float) -> None:
        amount = float(amount)
        with self._lock:
            self.sum += amount
            for i, bound in enumerate(self.bounds):
                if amount <= bound:
                    self.counts[i] += 1
                    break

    def snapshot(self) -> tuple[list[float], float]:
        with self._lock:
            return list(self.counts), self.sum


class Histogram(_Family):
    """Observations in cumulative buckets (``+Inf`` appended when the
    edges lack it), with their count and sum."""

    type = "histogram"

    def __init__(self, name, documentation, labelnames=(), registry=None,
                 buckets=DEFAULT_BUCKETS):
        if "le" in labelnames:
            raise ValueError("histograms cannot use the label 'le'")
        bounds = [float(b) for b in buckets]
        if bounds != sorted(bounds):
            raise ValueError("buckets not in sorted order")
        if not bounds or bounds[-1] != INF:
            bounds.append(INF)
        self.bounds = tuple(bounds)
        super().__init__(name, documentation, labelnames, registry)

    def _new_child(self):
        return _HistogramChild(self.bounds)

    def observe(self, amount: float) -> None:
        self._only().observe(amount)

    def render(self) -> str:
        out = [self._head(self.name)]
        for labels, child in self._items():
            counts, total = child.snapshot()
            acc = 0.0
            for bound, n in zip(self.bounds, counts):
                acc += n
                out.append(_sample(f"{self.name}_bucket",
                                   {**labels, "le": format_float(bound)}, acc))
            out.append(_sample(f"{self.name}_count", labels, acc))
            out.append(_sample(f"{self.name}_sum", labels, total))
        return "".join(out)
