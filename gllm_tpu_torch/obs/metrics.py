"""Minimal Prometheus-style metrics registry, stdlib only (counterpart of
``gllm_tpu/obs/metrics.py``, a copy: the same bucket tuples, the same
exposition text).

A small, thread-safe implementation of the subset the engine needs:
Counter / Gauge / Histogram with fixed buckets, label support, and the
text exposition format (version 0.0.4) that Prometheus scrapes.

- **Off the device path.** Every operation is a dict update under a lock;
  nothing here touches a tensor. Call sites pass plain Python numbers
  they already had.
- **Idempotent registration.** Modules call ``counter(...)`` at import;
  re-registering the same (name, type, labelnames) returns the existing
  metric, while a conflicting re-registration raises.
- **One registry a process.** Engines in one process share its samples:
  read deltas (``Histogram.snapshot``, ``Counter.get``) to observe one.
"""

from __future__ import annotations

import bisect
import math
import threading
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

__all__ = [
    "Counter", "Gauge", "Histogram", "Registry", "REGISTRY",
    "counter", "gauge", "histogram", "render", "percentile",
    "LATENCY_BUCKETS", "FAST_LATENCY_BUCKETS",
]

# Request-scale latency buckets (seconds): TTFT / e2e / queue time.
LATENCY_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                   0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0)
# Step-scale latency buckets (seconds): per-iteration collect / RTT / ITL
# — decode steps land in the 1-100 ms decades, so that range is dense.
FAST_LATENCY_BUCKETS = (0.0005, 0.001, 0.002, 0.005, 0.01, 0.02, 0.035,
                        0.05, 0.075, 0.1, 0.15, 0.25, 0.5, 1.0, 2.5, 10.0)


def _escape_help(s: str) -> str:
    return s.replace("\\", "\\\\").replace("\n", "\\n")


def _escape_label(s: str) -> str:
    return (s.replace("\\", "\\\\").replace("\n", "\\n")
            .replace('"', '\\"'))


def _fmt(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    if isinstance(v, float) and v.is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v)) if isinstance(v, float) else str(v)


def _label_str(labelnames: Sequence[str], values: Tuple[str, ...],
               extra: Tuple[Tuple[str, str], ...] = ()) -> str:
    pairs = [(n, v) for n, v in zip(labelnames, values)] + list(extra)
    if not pairs:
        return ""
    return ("{" + ",".join(f'{n}="{_escape_label(str(v))}"'
                           for n, v in pairs) + "}")


class _Metric:
    kind = "untyped"

    def __init__(self, name: str, help: str,
                 labelnames: Sequence[str] = ()):
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()
        self._values: Dict[Tuple[str, ...], object] = {}

    def _key(self, labels: dict) -> Tuple[str, ...]:
        if set(labels) != set(self.labelnames):
            raise ValueError(
                f"metric {self.name} expects labels {self.labelnames}, "
                f"got {tuple(labels)}")
        return tuple(str(labels[n]) for n in self.labelnames)

    def labels(self, **labels) -> "_Child":
        return _Child(self, self._key(labels))

    # subclasses implement _zero() and render-sample iteration

    def _cell(self, key: Tuple[str, ...]):
        v = self._values.get(key)
        if v is None:
            v = self._values[key] = self._zero()
        return v

    def clear(self) -> None:
        with self._lock:
            self._values.clear()


class _Child:
    """Bound (metric, label-values) pair; forwards the write API."""

    def __init__(self, metric: _Metric, key: Tuple[str, ...]):
        self._m = metric
        self._k = key

    def inc(self, amount: float = 1.0) -> None:
        self._m._inc(self._k, amount)

    def set(self, value: float) -> None:
        self._m._set(self._k, value)

    def observe(self, value: float) -> None:
        self._m._observe(self._k, value)

    def get(self):
        return self._m._get(self._k)


class Counter(_Metric):
    kind = "counter"

    def _zero(self):
        return 0.0

    def inc(self, amount: float = 1.0, **labels) -> None:
        self._inc(self._key(labels), amount)

    def _inc(self, key, amount: float) -> None:
        if amount < 0:
            raise ValueError("counters only go up")
        with self._lock:
            self._values[key] = self._cell(key) + amount

    def get(self, **labels) -> float:
        return self._get(self._key(labels))

    def _get(self, key) -> float:
        with self._lock:
            return self._values.get(key, 0.0)

    def samples(self):
        with self._lock:
            items = list(self._values.items())
        for key, v in items:
            yield self.name, _label_str(self.labelnames, key), v


class Gauge(Counter):
    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        self._set(self._key(labels), value)

    def _set(self, key, value: float) -> None:
        with self._lock:
            self._values[key] = float(value)

    def _inc(self, key, amount: float) -> None:
        with self._lock:
            self._values[key] = self._cell(key) + amount

    def dec(self, amount: float = 1.0, **labels) -> None:
        self._inc(self._key(labels), -amount)


class _HistCell:
    __slots__ = ("counts", "sum", "count")

    def __init__(self, n_buckets: int):
        self.counts = [0] * n_buckets   # per-bucket (non-cumulative)
        self.sum = 0.0
        self.count = 0


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, name: str, help: str,
                 labelnames: Sequence[str] = (),
                 buckets: Sequence[float] = LATENCY_BUCKETS):
        super().__init__(name, help, labelnames)
        b = tuple(sorted(float(x) for x in buckets))
        if not b or any(b[i] >= b[i + 1] for i in range(len(b) - 1)):
            raise ValueError(f"bad buckets for {name}: {buckets}")
        self.buckets = b                 # upper bounds, +Inf implicit

    def _zero(self):
        return _HistCell(len(self.buckets) + 1)

    def observe(self, value: float, **labels) -> None:
        self._observe(self._key(labels), value)

    def _observe(self, key, value: float) -> None:
        i = bisect.bisect_left(self.buckets, value)
        with self._lock:
            cell = self._cell(key)
            cell.counts[i] += 1
            cell.sum += value
            cell.count += 1

    def snapshot(self, **labels):
        """(bucket_counts, sum, count) copy — diff two snapshots to get
        the observations of a bounded window (bench measured pass)."""
        key = self._key(labels)
        with self._lock:
            cell = self._values.get(key)
            if cell is None:
                return ([0] * (len(self.buckets) + 1), 0.0, 0)
            return (list(cell.counts), cell.sum, cell.count)

    def samples(self):
        with self._lock:
            items = [(k, list(c.counts), c.sum, c.count)
                     for k, c in self._values.items()]
        for key, counts, total, count in items:
            cum = 0
            for ub, n in zip(self.buckets + (math.inf,), counts):
                cum += n
                yield (self.name + "_bucket",
                       _label_str(self.labelnames, key,
                                  (("le", _fmt(ub)),)), cum)
            yield (self.name + "_sum",
                   _label_str(self.labelnames, key), total)
            yield (self.name + "_count",
                   _label_str(self.labelnames, key), count)


def percentile(hist: Histogram, q: float, before=None, **labels
               ) -> Optional[float]:
    """Estimate the q-quantile (0..1) from bucket counts, linearly
    interpolated within the winning bucket. ``before`` subtracts an
    earlier ``snapshot()`` so the estimate covers only the window since.
    Returns None when the window holds no observations; the top bucket
    clamps to its lower bound (open-ended +Inf)."""
    counts, _, count = hist.snapshot(**labels)
    if before is not None:
        bcounts, _, bcount = before
        counts = [a - b for a, b in zip(counts, bcounts)]
        count -= bcount
    if count <= 0:
        return None
    target = q * count
    cum = 0
    bounds = (0.0,) + hist.buckets
    for i, n in enumerate(counts):
        if cum + n >= target and n > 0:
            lo = bounds[i]
            hi = hist.buckets[i] if i < len(hist.buckets) else bounds[i]
            frac = (target - cum) / n
            return lo + (hi - lo) * frac
        cum += n
    return bounds[-1]


class Registry:
    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, _Metric] = {}

    def register(self, metric: _Metric) -> _Metric:
        with self._lock:
            cur = self._metrics.get(metric.name)
            if cur is not None:
                if (type(cur) is not type(metric)
                        or cur.labelnames != metric.labelnames
                        or (isinstance(cur, Histogram)
                            and cur.buckets != metric.buckets)):
                    raise ValueError(
                        f"metric {metric.name!r} already registered with "
                        f"a different type/labels/buckets ({cur.kind} "
                        f"{cur.labelnames} vs {metric.kind} "
                        f"{metric.labelnames})")
                return cur
            self._metrics[metric.name] = metric
            return metric

    def get(self, name: str) -> Optional[_Metric]:
        with self._lock:
            return self._metrics.get(name)

    def metrics(self) -> List[_Metric]:
        with self._lock:
            return sorted(self._metrics.values(), key=lambda m: m.name)

    def render(self) -> str:
        """Prometheus text exposition (format version 0.0.4)."""
        out: List[str] = []
        for m in self.metrics():
            out.append(f"# HELP {m.name} {_escape_help(m.help)}")
            out.append(f"# TYPE {m.name} {m.kind}")
            for sname, lbl, value in m.samples():
                out.append(f"{sname}{lbl} {_fmt(float(value))}")
        return "\n".join(out) + "\n"

    def reset(self) -> None:
        """Zero every metric's samples (registrations survive) — test
        isolation and bench window bracketing."""
        for m in self.metrics():
            m.clear()


REGISTRY = Registry()


def counter(name: str, help: str, labelnames: Sequence[str] = (),
            registry: Registry = None) -> Counter:
    return (registry or REGISTRY).register(Counter(name, help, labelnames))


def gauge(name: str, help: str, labelnames: Sequence[str] = (),
          registry: Registry = None) -> Gauge:
    return (registry or REGISTRY).register(Gauge(name, help, labelnames))


def histogram(name: str, help: str, labelnames: Sequence[str] = (),
              buckets: Sequence[float] = LATENCY_BUCKETS,
              registry: Registry = None) -> Histogram:
    return (registry or REGISTRY).register(
        Histogram(name, help, labelnames, buckets))


def render(registry: Registry = None) -> str:
    return (registry or REGISTRY).render()


def parse_exposition(text: str):
    """Parse exposition text back into {(sample_name, label_str): value}
    plus the set of TYPEd metric names. Used by the smoke check to assert
    every sample belongs to a declared metric and no (name, labels) pair
    repeats — not a general-purpose parser."""
    typed: Dict[str, str] = {}
    samples: Dict[Tuple[str, str], float] = {}
    dupes: List[Tuple[str, str]] = []
    for line in text.splitlines():
        if not line.strip():
            continue
        if line.startswith("# TYPE "):
            _, _, rest = line.partition("# TYPE ")
            name, _, kind = rest.partition(" ")
            typed[name] = kind
            continue
        if line.startswith("#"):
            continue
        body, _, value = line.rpartition(" ")
        brace = body.find("{")
        if brace >= 0:
            name, lbl = body[:brace], body[brace:]
        else:
            name, lbl = body, ""
        key = (name, lbl)
        if key in samples:
            dupes.append(key)
        samples[key] = float(value)
    return typed, samples, dupes
