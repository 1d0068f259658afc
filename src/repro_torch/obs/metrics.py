"""Host-side metrics primitives: counters, gauges, latency histograms.

A copy of ``repro.obs.metrics``.  Everything in ``repro_torch.obs`` is
**pure stdlib Python**: no numpy, no torch.  Observability code cannot
grow a device sync, because it never holds a device value in the first
place; the engine feeds it plain ints/floats/lists from its host mirrors.

Percentiles
-----------

:class:`Histogram` keeps two views of the same stream:

* fixed cumulative buckets (Prometheus ``le`` semantics: a sample lands
  in every bucket whose upper bound is ``>= value``), cheap to export;
* the raw samples, so :meth:`Histogram.percentile` is **exact** — it
  reproduces ``numpy.percentile``'s default linear interpolation
  (``pos = (n-1) * q/100``) bit-for-bit, which the tests assert against
  a NumPy reference.  Past ``max_samples`` the raw view degrades to a
  deterministic reservoir (seeded ``random.Random``), so percentiles
  become approximate but the process stays O(1) memory and replayable.

:class:`RollingWindow` is the rolling-median live-rate idiom: push the
per-tick tokens/s, read the median — robust to the one slow tick that
would wreck a mean.
"""
from __future__ import annotations

import dataclasses
import math
import random
import re
import threading
from bisect import bisect_left, insort
from collections import deque
from typing import Any, Callable, Deque, Dict, Iterable, List, Optional, Sequence, Tuple

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "RollingWindow",
    "MetricsRegistry",
    "percentile",
    "percentile_summary",
    "DEFAULT_LATENCY_BUCKETS",
]

# Seconds.  Engine ticks on the reduced CPU configs sit in the 1ms-250ms
# band; real serving TTFTs reach seconds under overload.
DEFAULT_LATENCY_BUCKETS: Tuple[float, ...] = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
    0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")


def percentile(values: Sequence[float], q: float) -> float:
    """``numpy.percentile(values, q)`` (default linear interpolation),
    reimplemented in pure Python so this package never imports numpy.

    Raises ``ValueError`` on an empty sequence — callers that want a
    soft answer use :func:`percentile_summary` or
    :meth:`Histogram.percentile`, which return ``None`` instead.
    """
    if not values:
        raise ValueError("percentile() of empty sequence")
    if not 0.0 <= q <= 100.0:
        raise ValueError(f"percentile q must be in [0, 100], got {q}")
    s = sorted(values)
    n = len(s)
    if n == 1:
        return s[0]
    pos = (n - 1) * (q / 100.0)
    lo = int(math.floor(pos))
    hi = min(lo + 1, n - 1)
    frac = pos - lo
    # numpy's _lerp flips the formula at frac >= 0.5 to keep the rounding
    # error symmetric; match it so the parity test is exact, not approx
    if frac >= 0.5:
        return s[hi] - (s[hi] - s[lo]) * (1.0 - frac)
    return s[lo] + (s[hi] - s[lo]) * frac


def percentile_summary(values: Iterable[Optional[float]],
                       qs: Sequence[float] = (50, 90, 99),
                       scale: float = 1.0) -> Dict[str, Any]:
    """Percentile report of a latency stream.

    Filters ``None`` entries (requests that shed before a first token
    have no TTFT), scales (e.g. ``scale=1e3`` for ms), and returns
    ``{"count": n, "p50": ..., "p99": ...}`` with ``None`` values when
    the stream is empty, so callers can always ``json.dump`` the result.
    """
    vals = [v for v in values if v is not None]
    out: Dict[str, Any] = {"count": len(vals)}
    for q in qs:
        key = f"p{q:g}"
        out[key] = percentile(vals, q) * scale if vals else None
    return out


class Counter:
    """Monotonic counter.  Single-writer (the engine tick loop) with
    lock-free reads from the exporter thread — a read races at worst into
    a one-update-stale value, never a torn one."""

    kind = "counter"
    __slots__ = ("_value",)

    def __init__(self) -> None:
        self._value = 0.0

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError(f"counter increment must be >= 0, got {n}")
        self._value += n

    @property
    def value(self) -> float:
        return self._value


class Gauge:
    """Instantaneous value (queue depth, free pages)."""

    kind = "gauge"
    __slots__ = ("_value",)

    def __init__(self) -> None:
        self._value = 0.0

    def set(self, v: float) -> None:
        self._value = float(v)

    def inc(self, n: float = 1.0) -> None:
        self._value += n

    @property
    def value(self) -> float:
        return self._value


class Histogram:
    """Fixed-bucket latency histogram with exact percentiles.

    ``bounds`` are the finite upper bucket edges; an implicit ``+Inf``
    bucket always closes the set.  ``observe`` is O(log buckets) plus an
    amortised O(1) reservoir update.
    """

    kind = "histogram"

    def __init__(self, buckets: Sequence[float] = DEFAULT_LATENCY_BUCKETS,
                 max_samples: int = 100_000, seed: int = 0) -> None:
        bounds = tuple(float(b) for b in buckets if math.isfinite(b))
        if not bounds:
            raise ValueError("histogram needs at least one finite bucket")
        if list(bounds) != sorted(set(bounds)):
            raise ValueError(
                f"histogram buckets must be strictly increasing: {bounds}")
        if max_samples < 1:
            raise ValueError(f"max_samples must be >= 1, got {max_samples}")
        self.bounds = bounds
        self._bucket_counts = [0] * (len(bounds) + 1)   # last = +Inf
        self._sum = 0.0
        self._count = 0
        self._samples: List[float] = []
        self._max_samples = max_samples
        self._rng = random.Random(seed)

    def observe(self, v: float) -> None:
        v = float(v)
        # Prometheus `le` semantics: first bound >= v owns the sample
        # (exact edge values land in the bucket they bound).
        self._bucket_counts[bisect_left(self.bounds, v)] += 1
        self._sum += v
        self._count += 1
        if len(self._samples) < self._max_samples:
            self._samples.append(v)
        else:  # Vitter reservoir: deterministic, uniform over the stream
            j = self._rng.randrange(self._count)
            if j < self._max_samples:
                self._samples[j] = v

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    @property
    def exact(self) -> bool:
        """False once the reservoir has started dropping samples."""
        return self._count <= self._max_samples

    def percentile(self, q: float) -> Optional[float]:
        if not self._samples:
            return None
        return percentile(self._samples, q)

    def cumulative_buckets(self) -> List[Tuple[float, int]]:
        """``[(le_bound, cumulative_count), ...]`` ending at
        ``(inf, count)`` — the Prometheus ``_bucket`` series."""
        out: List[Tuple[float, int]] = []
        acc = 0
        for bound, c in zip(self.bounds, self._bucket_counts):
            acc += c
            out.append((bound, acc))
        out.append((math.inf, self._count))
        return out

    def snapshot(self) -> Dict[str, Any]:
        return {
            "count": self._count,
            "sum": self._sum,
            "p50": self.percentile(50),
            "p90": self.percentile(90),
            "p99": self.percentile(99),
        }


class RollingWindow:
    """Fixed-size window with O(log n) rolling median — the live-rate
    idiom: ``push(tokens/dur)`` each tick, report ``median()``."""

    def __init__(self, size: int = 64) -> None:
        if size < 1:
            raise ValueError(f"window size must be >= 1, got {size}")
        self._size = size
        self._window: Deque[float] = deque()
        self._sorted: List[float] = []

    def push(self, v: float) -> None:
        v = float(v)
        self._window.append(v)
        insort(self._sorted, v)
        if len(self._window) > self._size:
            old = self._window.popleft()
            del self._sorted[bisect_left(self._sorted, old)]

    def __len__(self) -> int:
        return len(self._window)

    def median(self) -> Optional[float]:
        s = self._sorted
        n = len(s)
        if n == 0:
            return None
        mid = n // 2
        return s[mid] if n % 2 else (s[mid - 1] + s[mid]) / 2.0

    def mean(self) -> Optional[float]:
        if not self._window:
            return None
        return sum(self._window) / len(self._window)


@dataclasses.dataclass
class Family:
    """One metric name: a kind, help text, and labelled series."""
    name: str
    kind: str
    help: str
    series: Dict[Tuple[Tuple[str, str], ...], Any]


class MetricsRegistry:
    """Name -> family -> labelled series store.

    ``counter`` / ``gauge`` / ``histogram`` are get-or-create: calling
    them again with the same name+labels returns the same object, so the
    engine can resolve series lazily (per finish reason, per fault site)
    without bookkeeping.  Registration takes a lock (exporter thread may
    be iterating); metric updates are plain attribute writes under the
    single-writer model.
    """

    def __init__(self) -> None:
        self._families: Dict[str, Family] = {}
        self._lock = threading.Lock()

    def _series(self, name: str, kind: str, help: str,
                labels: Dict[str, Any], ctor: Callable[[], Any]) -> Any:
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name: {name!r}")
        for k in labels:
            if not _LABEL_RE.match(k):
                raise ValueError(f"invalid label name: {k!r}")
        key = tuple(sorted((k, str(v)) for k, v in labels.items()))
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = Family(name, kind, help, {})
                self._families[name] = fam
            elif fam.kind != kind:
                raise ValueError(
                    f"metric {name!r} already registered as {fam.kind}, "
                    f"not {kind}")
            if help and not fam.help:
                fam.help = help
            series = fam.series.get(key)
            if series is None:
                series = ctor()
                fam.series[key] = series
            return series

    def counter(self, name: str, help: str = "", **labels: Any) -> Counter:
        return self._series(name, "counter", help, labels, Counter)

    def gauge(self, name: str, help: str = "", **labels: Any) -> Gauge:
        return self._series(name, "gauge", help, labels, Gauge)

    def histogram(self, name: str, help: str = "",
                  buckets: Sequence[float] = DEFAULT_LATENCY_BUCKETS,
                  **labels: Any) -> Histogram:
        return self._series(name, "histogram", help, labels,
                            lambda: Histogram(buckets))

    def families(self) -> List[Family]:
        """Stable-ordered shallow copy for exporters."""
        with self._lock:
            return [dataclasses.replace(f, series=dict(f.series))
                    for f in sorted(self._families.values(),
                                    key=lambda f: f.name)]

    def snapshot(self) -> Dict[str, Any]:
        """Flat ``{series_key: value}`` dict.  Counters/gauges map to a
        number; histograms to ``{count, sum, p50, p90, p99}``."""
        out: Dict[str, Any] = {}
        for fam in self.families():
            for key, series in sorted(fam.series.items()):
                label_s = ",".join(f'{k}="{v}"' for k, v in key)
                full = f"{fam.name}{{{label_s}}}" if label_s else fam.name
                if fam.kind == "histogram":
                    out[full] = series.snapshot()
                else:
                    out[full] = series.value
        return out
