"""Minimal Prometheus-text-format metrics registry.

A copy of the ``Metrics`` registry of ``tpu_dra/infra/metrics.py``
(framework-free; the port imports nothing of the JAX package): counters,
gauges and summary-style timings with quantiles over a recent window,
rendered as ``text/plain; version=0.0.4``. The fabric benches give one
registry to the Router, the autoscaler and the replicas, which take it
duck-typed. The HTTP endpoint (``MetricsServer``) is not copied: the
port's benches read the registry in-process.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional, Tuple


# Observations kept per timing series for quantile estimation; enough for
# stable p50/p90/p99 over the recent window without unbounded memory.
TIMING_WINDOW = 1000

QUANTILES = (0.5, 0.9, 0.99)


def _quantile_from_sorted(recent: list, q: float) -> Optional[float]:
    """Nearest-rank quantile over an ascending-sorted sample."""
    if not recent:
        return None
    idx = min(len(recent) - 1, max(0, round(q * (len(recent) - 1))))
    return recent[idx]


# Per-name series cap (cardinality guard): past this many label sets
# for ONE metric name, new series are refused and counted instead of
# allocated. Unbounded label values (claim names under churn) become a visible counter, never an OOM.
DEFAULT_SERIES_CAP = 1000

# The guard's own counter (one series per capped NAME — bounded by the
# number of distinct metric names, so it is exempt from the cap).
SERIES_CAPPED_COUNTER = "metrics_series_capped_total"


class Metrics:
    def __init__(self, prefix: str = "tpu_dra",
                 series_cap: int = DEFAULT_SERIES_CAP):
        self.prefix = prefix
        self.series_cap = series_cap
        self._lock = threading.Lock()
        self._counters: Dict[Tuple[str, Tuple[Tuple[str, str], ...]], float] = {}
        self._gauges: Dict[Tuple[str, Tuple[Tuple[str, str], ...]], float] = {}
        self._timing_sum: Dict[str, float] = {}
        self._timing_count: Dict[str, int] = {}
        self._timing_recent: Dict[str, list] = {}
        self._series_count: Dict[str, int] = {}
        self._collectors: list = []

    def register_collector(self, fn) -> None:
        """Register a scrape-time hook: called (best-effort) at the top of
        every render() so externally-owned state — e.g. per-claim control
        daemons reachable only over their sockets — can refresh gauges."""
        self._collectors.append(fn)

    def unregister_collector(self, fn) -> None:
        """Remove a scrape-time hook (no-op if absent): a component
        whose registry outlives it — a stopped monitor on a shared
        fleet registry — must not keep running its collector on every
        render forever."""
        try:
            self._collectors.remove(fn)
        except ValueError:
            pass

    @staticmethod
    def _key(name: str, labels: Optional[Dict[str, str]]):
        return (name, tuple(sorted((labels or {}).items())))

    def _admit_locked(self, store: dict, k) -> bool:
        """Cardinality guard (call under the lock): an existing series
        always updates; a NEW series allocates only while its name is
        under ``series_cap`` label sets. Past the cap the write is
        dropped and ``metrics_series_capped_total{name=}`` bumps —
        the hard backstop behind per-entity series cleanup
        (``remove_gauges``): a label explosion becomes a visible
        counter, never unbounded registry growth."""
        if k in store:
            return True
        name = k[0]
        if self._series_count.get(name, 0) >= self.series_cap:
            ck = (SERIES_CAPPED_COUNTER, (("name", name),))
            # Direct insert: the guard's own counter is exempt (one
            # series per capped NAME, bounded by the name universe).
            self._counters[ck] = self._counters.get(ck, 0.0) + 1.0
            return False
        self._series_count[name] = self._series_count.get(name, 0) + 1
        return True

    def inc(self, name: str, value: float = 1.0, labels: Optional[Dict[str, str]] = None):
        k = self._key(name, labels)
        with self._lock:
            if self._admit_locked(self._counters, k):
                self._counters[k] = self._counters.get(k, 0.0) + value

    def set_gauge(self, name: str, value: float, labels: Optional[Dict[str, str]] = None):
        k = self._key(name, labels)
        with self._lock:
            if self._admit_locked(self._gauges, k):
                self._gauges[k] = value

    def _forget_series_locked(self, name: str) -> None:
        n = self._series_count.get(name, 0)
        if n <= 1:
            self._series_count.pop(name, None)
        else:
            self._series_count[name] = n - 1

    def remove_gauge(self, name: str, labels: Optional[Dict[str, str]] = None):
        """Drop one gauge series (collectors use this when the entity
        behind a labeled series disappears)."""
        with self._lock:
            if self._gauges.pop(self._key(name, labels), None) is not None:
                self._forget_series_locked(name)

    def remove_gauges(self, name: str, match_labels: Dict[str, str]):
        """Drop EVERY series of ``name`` whose labels contain
        ``match_labels`` — the cleanup for families that carry extra
        labels the caller cannot enumerate (histogram buckets'
        ``le``): an exact-key remove_gauge would leave those series
        behind forever as their entity churns."""
        want = set(match_labels.items())
        with self._lock:
            for k in [
                k for k in self._gauges
                if k[0] == name and want <= set(k[1])
            ]:
                self._gauges.pop(k, None)
                self._forget_series_locked(name)

    def observe(self, name: str, seconds: float, labels: Optional[Dict[str, str]] = None):
        # Timings key like counters/gauges: (name, labels) — a sharded
        # workqueue's per-shard service times must not fold into one
        # aggregate series, or a slow callback on one shard hides
        # behind the other shards' healthy work.
        k = self._key(name, labels)
        with self._lock:
            if not self._admit_locked(self._timing_sum, k):
                return
            self._timing_sum[k] = self._timing_sum.get(k, 0.0) + seconds
            self._timing_count[k] = self._timing_count.get(k, 0) + 1
            recent = self._timing_recent.setdefault(k, [])
            recent.append(seconds)
            if len(recent) > TIMING_WINDOW:
                del recent[: len(recent) - TIMING_WINDOW]

    def get_counter(self, name: str, labels: Optional[Dict[str, str]] = None) -> float:
        """Current value of one counter series (0.0 if never bumped) —
        harness/test probe, no text-format parsing needed."""
        with self._lock:
            return self._counters.get(self._key(name, labels), 0.0)

    def get_gauge(self, name: str, labels: Optional[Dict[str, str]] = None) -> Optional[float]:
        """Current value of one gauge series (None if never set)."""
        with self._lock:
            return self._gauges.get(self._key(name, labels))

    def quantile(
        self, name: str, q: float, labels: Optional[Dict[str, str]] = None
    ) -> Optional[float]:
        """q-quantile over the recent observation window (None if empty)."""
        with self._lock:
            recent = sorted(
                self._timing_recent.get(self._key(name, labels), [])
            )
        return _quantile_from_sorted(recent, q)

    def render(self) -> str:
        for fn in list(self._collectors):
            try:
                fn()  # outside the lock: collectors call set_gauge
            except Exception:  # noqa: BLE001 — scrape must never 500
                pass
        out = []
        # ONE `# TYPE` line per metric NAME (the exposition format
        # forbids repeating it per labeled series): a scraper classifies
        # counter/gauge/summary from these lines, and a repeated TYPE
        # header would make the output malformed for any family with
        # more than one label set.
        typed = None
        with self._lock:
            for (name, labels), v in sorted(self._counters.items()):
                if name != typed:
                    out.append(f"# TYPE {self.prefix}_{name} counter")
                    typed = name
                out.append(f"{self.prefix}_{name}{self._fmt(labels)} {v}")
            typed = None
            for (name, labels), v in sorted(self._gauges.items()):
                if name != typed:
                    out.append(f"# TYPE {self.prefix}_{name} gauge")
                    typed = name
                out.append(f"{self.prefix}_{name}{self._fmt(labels)} {v}")
            typed = None
            for key in sorted(self._timing_sum):
                name, labels = key
                if name != typed:
                    out.append(f"# TYPE {self.prefix}_{name} summary")
                    typed = name
                recent = sorted(self._timing_recent.get(key, []))
                for q in QUANTILES:
                    v = _quantile_from_sorted(recent, q)
                    if v is not None:
                        out.append(
                            f"{self.prefix}_{name}"
                            f"{self._fmt(labels + (('quantile', str(q)),))}"
                            f" {v}"
                        )
                out.append(
                    f"{self.prefix}_{name}_sum{self._fmt(labels)} "
                    f"{self._timing_sum[key]}"
                )
                out.append(
                    f"{self.prefix}_{name}_count{self._fmt(labels)} "
                    f"{self._timing_count[key]}"
                )
        return "\n".join(out) + "\n"

    @staticmethod
    def _esc(value) -> str:
        """Prometheus exposition label-value escaping: backslash,
        double-quote, and newline must be escaped or a hostile value
        (a claim name carrying ``"`` or ``\\``) emits a malformed
        line that poisons the whole scrape."""
        return (
            str(value)
            .replace("\\", "\\\\")
            .replace('"', '\\"')
            .replace("\n", "\\n")
        )

    @staticmethod
    def _fmt(labels) -> str:
        if not labels:
            return ""
        inner = ",".join(f'{k}="{Metrics._esc(v)}"' for k, v in labels)
        return "{" + inner + "}"
