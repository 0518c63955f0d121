"""Telemetry plane: counters, gauges, and bounded latency histograms.

The node's five hardened planes (governor, sim, chaos, snapshots, lint)
were observable only through flat counters and point-in-time ``status()``
dicts — no latency distributions, no per-stage timing, no export
surface.  This module is the measurement substrate the multi-core
pipeline split and the wallet-plane SLOs are
scoped against: Bitcoin Core's ``-debug=bench`` lineage (per-stage
block-connect timing) rebuilt on this repo's clock-seam discipline.

Design rules, in priority order:

- **Observers, not participants.**  Recording a metric must never
  change what the node does: no RNG, no set iteration, no feedback into
  any decision path.  The sim determinism pair (tests/test_telemetry.py)
  pins it — a 200-node scenario produces the SAME trace digest with
  telemetry enabled and disabled.
- **Clock-injectable.**  Every duration is read through the registry's
  injected clock (the node passes ``Node.clock.monotonic``), so the same
  instrumentation measures wall time on a live node and *virtual* time
  under ``SimLoop`` — and this module ships with ZERO wall-clock lint
  grants (tests/test_simlint.py pins that too).  The ``time.monotonic``
  spellings below are injectable *defaults*, never calls.
- **Bounded.**  Histograms are fixed-bucket (geometric, factor √2, one
  microsecond to ~two virtual minutes) plus a small ring buffer of
  recent raw samples; a long-lived node's telemetry memory is a
  constant.

Export surfaces: the ``GETMETRICS`` wire frame (protocol v12,
governor-admitted, SHED-droppable, served by `p1 serve` replicas too),
`p1 metrics` (human table / ``--json`` / ``--prom`` Prometheus text
exposition), and per-scenario telemetry sections in sim/chaos reports
(virtual-time propagation histograms scenarios assert p95 bounds on).

The port's copy of ``p1_tpu/node/telemetry.py``.
"""

from __future__ import annotations

import collections
import logging
import math
import time
from array import array as _array
from bisect import bisect_left as _bisect_left

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "LATENCY_BUCKETS",
    "MetricsRegistry",
    "NodeLogAdapter",
    "format_prometheus",
    "format_table",
    "merge_histograms",
    "propagation_summary_ms",
]

#: Geometric bucket upper bounds for latency histograms, seconds: factor
#: √2 from 1 µs up to ~134 s (54 buckets).  Fixed and shared so any two
#: histograms merge bucket-for-bucket (the scenario reports merge one
#: per node), and so a percentile estimate is never more than one √2
#: step above the true sample (the property test's bound).
_BUCKET_FACTOR = math.sqrt(2.0)
LATENCY_BUCKETS: tuple[float, ...] = tuple(
    1e-6 * _BUCKET_FACTOR**i for i in range(54)
)

#: Raw recent samples kept per histogram (debugging/exactness window —
#: the percentile math runs on the buckets, which never forget).
RECENT_WINDOW = 256


class Counter:
    """A monotonic-by-convention named value.  Plain assignment is
    allowed (NodeMetrics' attribute compatibility needs ``+=``), so the
    registry never enforces monotonicity — it just holds the number."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n


class Gauge:
    """A named point-in-time value (float)."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def set(self, value: float) -> None:
        self.value = value


class Histogram:
    """Fixed-bucket latency histogram with a bounded recent window.

    ``observe`` clamps at zero (a latency is never negative; a clock
    that steps backward under test must not corrupt the buckets) and is
    O(log buckets).  ``percentile`` returns the upper edge of the bucket
    holding the requested rank, clamped into ``[min, max]`` observed —
    an estimate that is always >= the true sample and at most one
    bucket factor above it (property-tested against a sorted-list
    oracle in tests/test_telemetry.py).
    """

    __slots__ = (
        "name",
        "bounds",
        "counts",
        "overflow",
        "count",
        "total",
        "vmin",
        "vmax",
        "recent",
        "_append_recent",
        "_nbuckets",
    )

    def __init__(self, name: str, bounds: tuple[float, ...] = LATENCY_BUCKETS):
        self.name = name
        self.bounds = bounds
        # An unboxed array, not a list of ints: observe() runs on the
        # node's per-frame hot path, and a boxed-int counts list costs
        # an int allocation per increment plus a cache line per touched
        # box (benchmarks/telemetry_overhead.py is the receipt).
        self.counts = _array("Q", [0]) * len(bounds)
        self.overflow = 0  # samples above the last bound
        self.count = 0
        self.total = 0.0
        self.vmin: float | None = None
        self.vmax: float | None = None
        self.recent: collections.deque = collections.deque(
            maxlen=RECENT_WINDOW
        )
        self._append_recent = self.recent.append
        self._nbuckets = len(bounds)

    def observe(self, value: float) -> None:
        v = value if value > 0.0 else 0.0
        i = _bisect_left(self.bounds, v)
        if i < self._nbuckets:
            self.counts[i] += 1
        else:
            self.overflow += 1
        self.count += 1
        self.total += v
        vmin = self.vmin
        if vmin is None or v < vmin:
            self.vmin = v
        vmax = self.vmax
        if vmax is None or v > vmax:
            self.vmax = v
        self._append_recent(v)

    def percentile(self, p: float) -> float | None:
        """Bucket-estimate of the ``p``-th percentile (0 < p <= 100),
        None when empty."""
        if self.count == 0:
            return None
        rank = max(1, math.ceil(self.count * p / 100.0))
        cum = 0
        for i, c in enumerate(self.counts):
            cum += c
            if cum >= rank:
                upper = self.bounds[i]
                break
        else:
            upper = self.vmax  # the rank lives in the overflow bucket
        est = min(upper, self.vmax)
        return max(est, self.vmin)

    def merge(self, other: "Histogram") -> None:
        """Fold ``other``'s buckets into this histogram (the scenario
        reports' cross-node aggregation).  Bucket layouts must match;
        the recent window is NOT merged (it is per-source by design)."""
        if other.bounds != self.bounds:
            raise ValueError("histogram bucket layouts differ")
        for i, c in enumerate(other.counts):
            self.counts[i] += c
        self.overflow += other.overflow
        self.count += other.count
        self.total += other.total
        if other.vmin is not None and (
            self.vmin is None or other.vmin < self.vmin
        ):
            self.vmin = other.vmin
        if other.vmax is not None and (
            self.vmax is None or other.vmax > self.vmax
        ):
            self.vmax = other.vmax

    def summary(self) -> dict:
        """{count, sum, min, max, p50, p95, p99} — the JSON-ready shape."""
        if self.count == 0:
            return {
                "count": 0,
                "sum": 0.0,
                "min": None,
                "max": None,
                "p50": None,
                "p95": None,
                "p99": None,
            }
        return {
            "count": self.count,
            "sum": self.total,
            "min": self.vmin,
            "max": self.vmax,
            "p50": self.percentile(50),
            "p95": self.percentile(95),
            "p99": self.percentile(99),
        }

    def snapshot(self) -> dict:
        """``summary()`` plus the sparse cumulative bucket table the
        Prometheus exposition needs: [[le, cumulative], ...] rows only
        where a bucket holds samples, plus the +Inf total."""
        out = self.summary()
        buckets = []
        cum = 0
        for le, c in zip(self.bounds, self.counts):
            if c:
                cum += c
                buckets.append([le, cum])
        buckets.append(["+Inf", self.count])
        out["buckets"] = buckets
        return out


def merge_histograms(hists) -> Histogram | None:
    """A fresh histogram holding the union of ``hists`` (None when the
    iterable is empty) — the cross-node aggregation primitive."""
    merged = None
    for h in hists:
        if merged is None:
            merged = Histogram(h.name, h.bounds)
        merged.merge(h)
    return merged


def propagation_summary_ms(
    registries, name: str = "block.propagation_s"
) -> dict | None:
    """Merge one named histogram across many registries and summarize in
    milliseconds — the sim/chaos reports' propagation section.  None
    when no registry holds samples (e.g. telemetry disabled)."""
    merged = merge_histograms(
        h
        for reg in registries
        for h in (reg.histograms.get(name),)
        if h is not None and h.count
    )
    if merged is None:
        return None
    return {
        "samples": merged.count,
        "p50_ms": round(1e3 * merged.percentile(50), 3),
        "p95_ms": round(1e3 * merged.percentile(95), 3),
        "p99_ms": round(1e3 * merged.percentile(99), 3),
        "max_ms": round(1e3 * merged.vmax, 3),
    }


class _Span:
    """One timed region: enter reads the clock, exit records the delta."""

    __slots__ = ("_hist", "_clock", "_t0")

    def __init__(self, hist: Histogram, clock):
        self._hist = hist
        self._clock = clock

    def __enter__(self):
        self._t0 = self._clock()
        return self

    def __exit__(self, *exc):
        self._hist.observe(self._clock() - self._t0)
        return False


class _NullSpan:
    """The disabled-telemetry span: no clock read, no record."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class MetricsRegistry:
    """One process-visible metrics namespace: counters, gauges, and
    histograms in insertion order (deterministic rendering).

    ``enabled`` gates only the *latency* surface (``observe``/``span``):
    counters and gauges stay live regardless, because ``status()`` and
    the existing dashboards are built on them.  Disabling therefore
    removes every clock read telemetry would otherwise perform — the
    knob the determinism pair flips.
    """

    __slots__ = ("enabled", "counters", "gauges", "histograms", "_clock")

    def __init__(self, clock=time.monotonic, enabled: bool = True):
        self.enabled = enabled
        self._clock = clock
        self.counters: dict[str, Counter] = {}
        self.gauges: dict[str, Gauge] = {}
        self.histograms: dict[str, Histogram] = {}

    # -- construction (get-or-create, idempotent) -------------------------

    def counter(self, name: str) -> Counter:
        c = self.counters.get(name)
        if c is None:
            c = self.counters[name] = Counter(name)
        return c

    def gauge(self, name: str) -> Gauge:
        g = self.gauges.get(name)
        if g is None:
            g = self.gauges[name] = Gauge(name)
        return g

    def histogram(
        self, name: str, bounds: tuple[float, ...] = LATENCY_BUCKETS
    ) -> Histogram:
        h = self.histograms.get(name)
        if h is None:
            h = self.histograms[name] = Histogram(name, bounds)
        return h

    # -- recording --------------------------------------------------------

    def now(self) -> float:
        """One injected-clock read (callers that time a region across
        early returns and cannot use ``span``)."""
        return self._clock()

    def observe(self, name: str, value: float) -> None:
        if self.enabled:
            self.histogram(name).observe(value)

    def span(self, name: str):
        """``with registry.span("stage.validate_s"): ...`` — times the
        region into the named histogram; a no-op (zero clock reads)
        when the registry is disabled.  Hot path: one dict get + one
        small allocation per call (a fresh _Span per region keeps
        overlapping regions safe — relay spans hold across awaits)."""
        if not self.enabled:
            return _NULL_SPAN
        h = self.histograms.get(name)
        if h is None:
            h = self.histogram(name)
        return _Span(h, self._clock)

    # -- export -----------------------------------------------------------

    def snapshot(self) -> dict:
        """JSON-ready dump: {"counters": {...}, "gauges": {...},
        "histograms": {name: summary+buckets}} — the METRICS wire
        payload and the input to both renderers below."""
        return {
            "counters": {n: c.value for n, c in self.counters.items()},
            "gauges": {n: g.value for n, g in self.gauges.items()},
            "histograms": {
                n: h.snapshot() for n, h in self.histograms.items()
            },
        }


# -- renderers (pure functions of a snapshot: the CLI runs them on the
#    wire payload, with no registry of its own) ---------------------------


def _fmt_seconds(v: float | None) -> str:
    if v is None:
        return "-"
    if v >= 1.0:
        return f"{v:.3f}s"
    if v >= 1e-3:
        return f"{v * 1e3:.3f}ms"
    return f"{v * 1e6:.1f}us"


def format_table(snapshot: dict) -> str:
    """The `p1 metrics` human rendering: counters, gauges, then the
    histogram latency table (p50/p95/p99/max)."""
    lines = []
    counters = snapshot.get("counters", {})
    if counters:
        width = max(len(n) for n in counters)
        lines.append("counters:")
        for name, value in counters.items():
            lines.append(f"  {name:<{width}}  {value}")
    gauges = snapshot.get("gauges", {})
    if gauges:
        width = max(len(n) for n in gauges)
        lines.append("gauges:")
        for name, value in gauges.items():
            lines.append(f"  {name:<{width}}  {value:.6g}")
    hists = snapshot.get("histograms", {})
    if hists:
        width = max(len(n) for n in hists)
        lines.append("histograms:")
        lines.append(
            f"  {'name':<{width}}  {'count':>8}  {'p50':>10}  "
            f"{'p95':>10}  {'p99':>10}  {'max':>10}"
        )
        for name, h in hists.items():
            lines.append(
                f"  {name:<{width}}  {h['count']:>8}  "
                f"{_fmt_seconds(h['p50']):>10}  "
                f"{_fmt_seconds(h['p95']):>10}  "
                f"{_fmt_seconds(h['p99']):>10}  "
                f"{_fmt_seconds(h['max']):>10}"
            )
    return "\n".join(lines) if lines else "(no metrics)"


def _prom_name(name: str) -> str:
    """Metric name -> Prometheus-legal: dots to underscores, the house
    ``_s`` seconds suffix spelled out, ``p1_`` namespace prefix."""
    out = name.replace(".", "_").replace("-", "_")
    if out.endswith("_s"):
        out = out[:-2] + "_seconds"
    return "p1_" + out


def format_prometheus(snapshot: dict) -> str:
    """Prometheus text exposition (0.0.4) of a registry snapshot.
    Histogram buckets are emitted sparsely (only the ``le`` rows where
    samples landed, plus +Inf) — cumulative values stay correct for
    every emitted row, which is all the format requires."""
    lines = []
    for name, value in snapshot.get("counters", {}).items():
        pname = _prom_name(name)
        lines.append(f"# TYPE {pname} counter")
        lines.append(f"{pname} {value}")
    for name, value in snapshot.get("gauges", {}).items():
        pname = _prom_name(name)
        lines.append(f"# TYPE {pname} gauge")
        lines.append(f"{pname} {value}")
    for name, h in snapshot.get("histograms", {}).items():
        pname = _prom_name(name)
        lines.append(f"# TYPE {pname} histogram")
        for le, cum in h.get("buckets", []):
            le_s = "+Inf" if le == "+Inf" else repr(float(le))
            lines.append(f'{pname}_bucket{{le="{le_s}"}} {cum}')
        lines.append(f"{pname}_sum {h['sum']}")
        lines.append(f"{pname}_count {h['count']}")
    return "\n".join(lines) + "\n"


class NodeLogAdapter(logging.LoggerAdapter):
    """Log attribution for multi-node processes: prefixes every record
    with the node's identity (sim host / listen port), so `p1 net`,
    netharness, and simulator logs stop interleaving anonymously.

    ``ident`` is a zero-arg callable, not a string: a node knows its
    bound port only after ``start()``, and the adapter must follow it.
    """

    def __init__(self, logger: logging.Logger, ident):
        super().__init__(logger, {})
        self._ident = ident

    def process(self, msg, kwargs):
        return f"[{self._ident()}] {msg}", kwargs
