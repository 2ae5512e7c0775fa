"""Bridges from the port's stats silos into the MetricsRegistry (torch
counterpart of presto_tpu/obs/export.py, the same series names).

The silos: the plan, result and history caches (exec/qcache.py), the
feedback store (plan/history.py), per-node stats (exec/stats.py), the
exchange (server/exchange.py), the hierarchical exchange
(server/hier.py), the wire (server/serde.py), the scheduler
(server/cluster.py), resource groups, queries, and the kernel profile.
The port has no breaker, so the JAX package's breaker series are not
exported, and the hierarchical exchange exports the fields the port's
HierExchangeStats keeps (its wire bytes, not pad-row counts).

Naming: `presto_<subsystem>_<what>`, `_total` for counters and the units
`_seconds` / `_bytes` spelled out; labels are low-cardinality only
(cache, kernel, group, outcome, role), never query ids or SQL.
"""

from __future__ import annotations

import threading
from typing import TYPE_CHECKING, Dict, Iterable, List, Optional

from .metrics import METRICS, Sample

if TYPE_CHECKING:  # annotations only: avoids exec/server import cycles
    from ..exec.qcache import CacheStats
    from ..exec.stats import NodeStats
    from ..plan.history import FeedbackStats
    from ..server.cluster import SchedulerStats
    from ..server.exchange import ExchangeStats
    from ..server.hier import HierExchangeStats
    from ..server.resource_groups import GroupStats
    from ..server.serde import WireStats

_defaults_lock = threading.Lock()
_defaults_done = False


def reset_defaults() -> None:
    global _defaults_done
    with _defaults_lock:
        _defaults_done = False


def ensure_default_exports() -> None:
    """Idempotent: declare the core series (stable scrape schema before
    the first increment) and register the process-global snapshot
    producers. Called by every scrape/collect."""
    global _defaults_done
    with _defaults_lock:
        if _defaults_done:
            return
        _defaults_done = True
    METRICS.declare_counter(
        "presto_queries_total", "Queries executed", {"outcome": "ok"}
    )
    METRICS.declare_counter(
        "presto_queries_total", labels={"outcome": "error"}
    )
    METRICS.declare_counter(
        "presto_exchange_pages_total", "Exchange pages pulled"
    )
    METRICS.declare_counter(
        "presto_exchange_wire_bytes_total", "Exchange bytes off the wire"
    )
    METRICS.declare_counter(
        "presto_exchange_hidden_seconds_total",
        "Exchange wire wall hidden behind device compute",
    )
    METRICS.declare_counter(
        "presto_hier_exchanges_total",
        "Output batches regrouped by the hierarchical exchange",
        {"role": "task"},
    )
    METRICS.declare_counter(
        "presto_wire_encode_seconds_total", "Page serialization wall"
    )
    METRICS.declare_counter(
        "presto_wire_decode_seconds_total", "Page deserialization wall"
    )
    METRICS.declare_counter(
        "presto_worker_tasks_total", "Worker tasks run", {"state": "FINISHED"}
    )
    METRICS.declare_counter(
        "presto_worker_tasks_total", labels={"state": "FAILED"}
    )
    METRICS.register_producer("qcache", _metrics_qcache_producer)
    METRICS.register_producer("kernel_profile", _metrics_kernel_producer)
    METRICS.register_producer("feedback", _metrics_feedback_producer)


# ---------------------------------------------------------------------------
# pull producers: process-global snapshot owners, evaluated at scrape
# ---------------------------------------------------------------------------


def export_cache_stats(cache: str, stats: "CacheStats") -> List[Sample]:
    """One qcache LRU's CacheStats as counter/gauge samples."""
    snap = stats.snapshot()
    label = (("cache", cache),)
    out: List[Sample] = []
    for field in ("hits", "misses", "stores", "evictions",
                  "invalidations", "patches"):
        out.append((
            f"presto_qcache_{field}_total", "counter", label,
            float(snap[field]),
        ))
    out.append((
        "presto_qcache_bytes", "gauge", label, float(snap["bytes"])
    ))
    return out


def _metrics_qcache_producer() -> List[Sample]:
    from ..exec.qcache import HISTORY_CACHE, PLAN_CACHE, RESULT_CACHE

    out: List[Sample] = []
    for name, cache in (
        ("plan", PLAN_CACHE), ("result", RESULT_CACHE),
        ("history", HISTORY_CACHE),
    ):
        out.extend(export_cache_stats(name, cache.stats))
    return out


def export_feedback_stats(stats: "FeedbackStats") -> List[Sample]:
    """The adaptive-execution plane's FeedbackStats (plan/history.py) as
    `presto_feedback_*` samples: store traffic, estimate quality, and
    mid-query replans."""
    snap = stats.snapshot()
    out: List[Sample] = []
    for field in ("hits", "misses", "records", "invalidations",
                  "decays", "mispredictions", "replans"):
        out.append((
            f"presto_feedback_{field}_total", "counter", (),
            float(snap[field]),
        ))
    err = snap.get("mean_abs_rel_err")
    if err is not None:
        out.append((
            "presto_feedback_estimate_rel_error", "gauge", (), float(err)
        ))
    return out


def _metrics_feedback_producer() -> List[Sample]:
    from ..plan.history import HISTORY

    return export_feedback_stats(HISTORY.stats)


def _metrics_kernel_producer() -> List[Sample]:
    from .kernelprof import KERNEL_PROFILE

    snap = KERNEL_PROFILE.snapshot()
    return [
        ("presto_kernel_compiles_total", "counter", (),
         float(snap["compiles"])),
        ("presto_kernel_compile_seconds_total", "counter", (),
         snap["compile_s"]),
        ("presto_kernel_executions_total", "counter", (),
         float(snap["executions"])),
        ("presto_kernel_execute_seconds_total", "counter", (),
         snap["execute_s"]),
    ] + [
        # the port's kernels by name: launches and their device seconds
        (f"presto_kernel_{what}", "counter", (("kernel", name),), float(k[field]))
        for name, k in sorted(snap["kernels"].items())
        for what, field in (("launches_total", "launches"),
                            ("device_seconds_total", "device_s"))
    ]


def export_group_stats(groups: Iterable["GroupStats"]) -> List[Sample]:
    out: List[Sample] = []
    for g in groups:
        label = (("group", g.name),)
        out.append((
            "presto_resource_group_running", "gauge", label,
            float(g.running),
        ))
        out.append((
            "presto_resource_group_queued", "gauge", label, float(g.queued)
        ))
        out.append((
            "presto_resource_group_cpu_used_seconds", "gauge", label,
            float(g.cpu_used_s),
        ))
    return out


def register_resource_groups(manager) -> None:
    """Scrape-time producer over the coordinator's resource-group tree
    (fixed key: a re-created QueryManager replaces, never accumulates)."""
    METRICS.register_producer(
        "resource_groups", lambda: export_group_stats(manager.stats())
    )


# ---------------------------------------------------------------------------
# push exporters: per-query / per-task folds at the silo's own fold point
# ---------------------------------------------------------------------------


def export_node_stats(by_node: Dict[int, "NodeStats"]) -> None:
    """Fold one resolved StatsCollector (EXPLAIN ANALYZE run) into the
    exec series."""
    calls = wall = rows = out_bytes = 0
    for s in by_node.values():
        calls += s.calls
        wall += s.wall_s
        rows += max(0, s.rows_out)
        out_bytes += s.out_bytes_total
    METRICS.counter("presto_exec_node_calls_total", calls,
                    help="Plan-node dispatches (EXPLAIN ANALYZE runs)")
    METRICS.counter("presto_exec_node_wall_seconds_total", wall)
    METRICS.counter("presto_exec_rows_total", rows)
    METRICS.counter("presto_exec_output_bytes_total", out_bytes)


def export_exchange_stats(pull: "ExchangeStats") -> None:
    """Fold one gather's pull-side accounting (each ExchangeStats lives
    for one gather and is folded exactly once, at _record_exchange)."""
    snap = pull.snapshot()
    METRICS.counter("presto_exchange_pages_total", snap.get("pages", 0))
    METRICS.counter(
        "presto_exchange_wire_bytes_total", snap.get("wire_bytes", 0)
    )
    METRICS.counter(
        "presto_exchange_responses_total", snap.get("responses", 0)
    )
    METRICS.counter(
        "presto_exchange_pull_seconds_total",
        (snap.get("pull_ms") or 0) / 1e3,
    )
    METRICS.counter(
        "presto_exchange_decode_seconds_total",
        (snap.get("decode_ms") or 0) / 1e3,
    )
    # overlap plane (hierarchical exchange): wire wall split into the
    # part the consumer actually waited for vs the part its device
    # compute hid behind prefetching pullers
    METRICS.counter(
        "presto_exchange_consumer_wait_seconds_total",
        (snap.get("consumer_wait_ms") or 0) / 1e3,
    )
    METRICS.counter(
        "presto_exchange_hidden_seconds_total",
        (snap.get("hidden_ms") or 0) / 1e3,
    )


def export_hier_stats(stats: "HierExchangeStats",
                      role: str = "task") -> None:
    """Fold one endpoint's hierarchical-exchange accounting into the
    metrics plane, once when the endpoint retires. `role`
    labels the fold point ("task" = a worker's own producer regroup,
    "gather" = the coordinator's per-exchange fold over its producers'
    status payloads) so an in-process fleet sharing one registry never
    double-counts one series."""
    snap = stats.snapshot()
    label = {"role": role}
    METRICS.counter(
        "presto_hier_exchanges_total", snap.get("exchanges", 0), label,
        help="Output batches regrouped by the hierarchical exchange",
    )
    METRICS.counter(
        "presto_hier_collective_exchanges_total",
        snap.get("collective_exchanges", 0), label,
    )
    METRICS.counter("presto_hier_rows_total", snap.get("rows", 0), label)
    METRICS.counter(
        "presto_hier_collective_seconds_total",
        (snap.get("collective_ms") or 0) / 1e3, label,
    )
    METRICS.counter(
        "presto_hier_wire_pages_total", snap.get("wire_pages", 0), label
    )
    METRICS.counter(
        "presto_hier_wire_bytes_total", snap.get("wire_bytes", 0), label
    )


def export_wire_stats(role: str, stats: "WireStats") -> None:
    """Fold one endpoint's serde accounting (a task's output serializer
    or a pull client's decoder), once when the endpoint retires."""
    snap = stats.snapshot() if hasattr(stats, "snapshot") else {}
    label = {"role": role}
    METRICS.counter(
        "presto_wire_pages_total", snap.get("pages", 0), label
    )
    METRICS.counter(
        "presto_wire_bytes_total", snap.get("wire_bytes", 0), label
    )
    METRICS.counter(
        "presto_wire_encode_seconds_total",
        (snap.get("encode_ms") or 0) / 1e3, label,
    )
    METRICS.counter(
        "presto_wire_decode_seconds_total",
        (snap.get("decode_ms") or 0) / 1e3, label,
    )


def export_scheduler_stats(stats: "SchedulerStats") -> None:
    """Publish the scheduler's cumulative counters as gauges (the
    SchedulerStats object is itself cumulative; re-publishing is
    idempotent). Caller holds the scheduler lock."""
    import dataclasses

    for field, value in dataclasses.asdict(stats).items():
        if isinstance(value, (int, float)):
            METRICS.gauge(f"presto_scheduler_{field}", float(value))


def export_query(outcome: str, wall_s: float,
                 phase_ms: Optional[Dict[str, float]] = None) -> None:
    """One query completion (single-process or cluster execution layer)."""
    METRICS.counter(
        "presto_queries_total", 1, {"outcome": outcome},
        help="Queries executed",
    )
    METRICS.observe(
        "presto_query_seconds", wall_s, help="Query wall time"
    )
    for phase, ms in (phase_ms or {}).items():
        METRICS.observe(f"presto_query_phase_{phase}_seconds", ms / 1e3)
