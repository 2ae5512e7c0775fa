"""The process-wide metrics plane: counters, gauges and histograms
(torch counterpart of presto_tpu/obs/metrics.py, the same registry and
the same Prometheus text).

The engine's stats silos (the caches, the exchange and wire stats, the
scheduler, the kernel profile) export into one registry per process,
rendered in Prometheus text exposition format 0.0.4 at `/v1/metrics` on
both server roles and queryable as `system.runtime.metrics`.

Two export styles:

* push: hot paths fold deltas with `counter()` / `observe()` (the
  exchange at task end, query completions);
* pull: process-wide snapshot owners (the caches, the kernel profile)
  register a producer evaluated at scrape time, so serving paths never
  pay for gauge upkeep.

Histograms use fixed log2 buckets (0.25 ms to ~2 min), so two
processes' scrapes aggregate without bucket negotiation.
"""

from __future__ import annotations

import logging
import threading
from typing import Callable, Dict, List, Optional, Tuple

log = logging.getLogger("presto_tpu_torch.obs")

# (name, type, labels, value): the unit every surface consumes, the
# Prometheus renderer, system.runtime.metrics and producer callbacks.
Sample = Tuple[str, str, Tuple[Tuple[str, str], ...], float]

# log2 ladder: 0.25ms doubling to ~2 minutes (20 bounds + +Inf)
BUCKET_BOUNDS: Tuple[float, ...] = tuple(
    0.00025 * (2.0 ** i) for i in range(20)
)


def _labels_key(labels: Optional[Dict[str, str]]):
    if not labels:
        return ()
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _escape(value: str) -> str:
    return (
        value.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")
    )


def _fmt_labels(labels) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{_escape(v)}"' for k, v in labels)
    return "{" + inner + "}"


def _fmt_value(value: float) -> str:
    if value == float("inf"):
        return "+Inf"
    f = float(value)
    if f.is_integer() and abs(f) < 2 ** 53:
        return str(int(f))
    return repr(f)


class _Histogram:
    __slots__ = ("counts", "total", "count")

    def __init__(self):
        self.counts = [0] * len(BUCKET_BOUNDS)
        self.total = 0.0
        self.count = 0

    def observe(self, seconds: float) -> None:
        self.count += 1
        self.total += seconds
        # per-bucket counts: one bucket per observation; collect() does
        # the cumulative accumulation the exposition format requires
        for i, bound in enumerate(BUCKET_BOUNDS):
            if seconds <= bound:
                self.counts[i] += 1
                break


class MetricsRegistry:
    """All mutation and iteration under one registry lock; producers run
    outside it at scrape time (a producer may take its silo's own lock,
    and must never deadlock against a concurrent exporter holding ours)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._help: Dict[str, str] = {}
        self._counters: Dict[str, Dict[tuple, float]] = {}
        self._gauges: Dict[str, Dict[tuple, float]] = {}
        self._hists: Dict[str, _Histogram] = {}
        self._producers: Dict[str, Callable[[], List[Sample]]] = {}
        self._scrape_errors = 0

    # -- push API --

    def counter(self, name: str, value: float = 1.0,
                labels: Optional[Dict[str, str]] = None,
                help: str = "") -> None:
        key = _labels_key(labels)
        with self._lock:
            if help and name not in self._help:
                self._help[name] = help
            series = self._counters.setdefault(name, {})
            series[key] = series.get(key, 0.0) + value

    def declare_counter(self, name: str, help: str = "",
                        labels: Optional[Dict[str, str]] = None) -> None:
        """Ensure the series exists (at 0) so scrapes have a stable
        schema before the first increment."""
        self.counter(name, 0.0, labels, help)

    def gauge(self, name: str, value: float,
              labels: Optional[Dict[str, str]] = None,
              help: str = "") -> None:
        key = _labels_key(labels)
        with self._lock:
            if help and name not in self._help:
                self._help[name] = help
            self._gauges.setdefault(name, {})[key] = float(value)

    def observe(self, name: str, seconds: float, help: str = "") -> None:
        with self._lock:
            if help and name not in self._help:
                self._help[name] = help
            hist = self._hists.get(name)
            if hist is None:
                hist = self._hists[name] = _Histogram()
            hist.observe(seconds)

    # -- pull API --

    def register_producer(
        self, key: str, fn: Callable[[], List[Sample]]
    ) -> None:
        with self._lock:
            self._producers[key] = fn

    def unregister_producer(self, key: str) -> None:
        with self._lock:
            self._producers.pop(key, None)

    # -- scrape --

    def _run_producers(self) -> List[Sample]:
        with self._lock:
            producers = list(self._producers.items())
        out: List[Sample] = []
        for key, fn in producers:
            try:
                out.extend(fn())
            except Exception:  # noqa: BLE001 - a scrape must not fail
                log.warning("metrics producer %r failed", key, exc_info=True)
                with self._lock:
                    self._scrape_errors += 1
        return out

    def collect(self) -> List[Sample]:
        """Every sample, push + pull, as flat rows (system.runtime.metrics
        and the Prometheus renderer share this)."""
        from .export import ensure_default_exports

        ensure_default_exports()
        produced = self._run_producers()
        out: List[Sample] = []
        with self._lock:
            for name, series in self._counters.items():
                for key, value in series.items():
                    out.append((name, "counter", key, value))
            for name, series in self._gauges.items():
                for key, value in series.items():
                    out.append((name, "gauge", key, value))
            for name, hist in self._hists.items():
                acc = 0
                for bound, n in zip(BUCKET_BOUNDS, hist.counts):
                    acc += n
                    out.append((
                        name + "_bucket", "histogram",
                        (("le", _fmt_value(bound)),), float(acc),
                    ))
                out.append((
                    name + "_bucket", "histogram", (("le", "+Inf"),),
                    float(hist.count),
                ))
                out.append((name + "_sum", "histogram", (), hist.total))
                out.append((
                    name + "_count", "histogram", (), float(hist.count)
                ))
            out.append((
                "presto_scrape_errors_total", "counter", (),
                float(self._scrape_errors),
            ))
        out.extend(produced)
        return out

    def render(self) -> str:
        """Prometheus text exposition format 0.0.4."""
        samples = self.collect()
        with self._lock:
            helps = dict(self._help)
        # group samples under their family (histogram suffixes share one
        # TYPE header) preserving first-seen family order
        families: Dict[str, Tuple[str, List[Sample]]] = {}
        order: List[str] = []
        for name, typ, labels, value in samples:
            family = name
            if typ == "histogram":
                for suffix in ("_bucket", "_sum", "_count"):
                    if name.endswith(suffix):
                        family = name[: -len(suffix)]
                        break
            if family not in families:
                families[family] = (typ, [])
                order.append(family)
            families[family][1].append((name, typ, labels, value))
        lines: List[str] = []
        for family in order:
            typ, rows = families[family]
            help_txt = helps.get(family, "")
            if help_txt:
                lines.append(f"# HELP {family} {_escape(help_txt)}")
            lines.append(f"# TYPE {family} {typ}")
            for name, _typ, labels, value in rows:
                lines.append(
                    f"{name}{_fmt_labels(labels)} {_fmt_value(value)}"
                )
        return "\n".join(lines) + "\n"

    def reset(self) -> None:
        """Test hook: drop every series and producer."""
        with self._lock:
            self._help.clear()
            self._counters.clear()
            self._gauges.clear()
            self._hists.clear()
            self._producers.clear()
            self._scrape_errors = 0
        from . import export

        export.reset_defaults()


# process-wide: one metrics plane per interpreter, shared by the
# coordinator and any in-process workers (separate processes each expose
# their own /v1/metrics)
METRICS = MetricsRegistry()
