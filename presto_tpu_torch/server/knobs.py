"""The single parse site of the port's PRESTO_TPU_* server knobs (torch
counterpart of presto_tpu/server/knobs.py), with the JAX package's
defaults and variables.

Knobs are read per call, not cached at import: tests and harnesses set
and restore the environment around single runs."""

from __future__ import annotations

import os


def _int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, str(default)))
    except ValueError:
        return default


def _float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, str(default)))
    except ValueError:
        return default


def _on(name: str, default: str) -> bool:
    return os.environ.get(name, default) not in ("0", "false", "")


def task_deadline_s() -> float:
    """Progress deadline (seconds) of any one task results stream: the wall
    time between pages before a puller declares the producer wedged and
    fails retryably. The coordinator's pull, the exchange client and the
    worker share it."""
    return float(os.environ.get("PRESTO_TPU_TASK_DEADLINE_S", "600"))


def trace_enabled() -> bool:
    """Switch of the observability plane's per-query span trees and the
    kernel profile (obs/). On by default, as in the JAX package, whose
    bench gate holds the overhead to 5 % of a warm query;
    PRESTO_TPU_TRACE=0 sheds even that."""
    return _on("PRESTO_TPU_TRACE", "1")


def trace_keep() -> int:
    """Completed traces the in-process TraceStore keeps for
    `system.runtime.tasks` and EXPLAIN ANALYZE's `-- trace:` footer; the
    oldest go first."""
    return _int("PRESTO_TPU_TRACE_KEEP", 64)


def trace_topk() -> int:
    """Spans (ranked by exclusive wall) the `-- trace:` critical path
    lists."""
    return _int("PRESTO_TPU_TRACE_TOPK", 5)


def hier_exchange_enabled() -> bool:
    """Switch of the hierarchical exchange (server/hier.py): partitioned
    task output regroups its rows in one device step and ships ragged
    pages. Off (PRESTO_TPU_HIER_EXCHANGE=0), producers take the flat
    per-partition loop. It gates producers only: consumers decode both."""
    return _on("PRESTO_TPU_HIER_EXCHANGE", "1")


def hier_exchange_min_devices() -> int:
    """Visible devices needed before the regroup runs as a collective over
    them; below it (one card included) it is one stable sort on the
    producer's device."""
    return _int("PRESTO_TPU_HIER_EXCHANGE_MIN_DEVICES", 2)


def hier_exchange_min_rows() -> int:
    """Rows below which the collective regroup is not worth scattering a
    batch over the devices: small batches take the single-device sort."""
    return _int("PRESTO_TPU_HIER_EXCHANGE_MIN_ROWS", 8192)


def hier_exchange_prefetch() -> int:
    """Responses of `max_response_bytes` each puller may keep staged ahead
    of the consumer, so the next tranche is on the wire while the current
    one is computed on."""
    return _int("PRESTO_TPU_HIER_EXCHANGE_PREFETCH", 2)


def feedback_enabled() -> bool:
    """Master switch for history-based feedback (plan/history.py): record
    observed per-plan-node row counts at query end and feed them back into
    join ordering, hybrid-join sizing, the matview delta decision and the
    cluster's mid-query replan. Off by default; PRESTO_TPU_FEEDBACK=1
    turns it on."""
    return _on("PRESTO_TPU_FEEDBACK", "0")


def feedback_replan_factor() -> float:
    """Observed-over-estimated row factor at an exchange boundary past
    which the coordinator abandons the attempt and re-plans the fragments
    downstream on the observation (server/cluster.py)."""
    return _float("PRESTO_TPU_FEEDBACK_REPLAN_FACTOR", 8.0)


def feedback_replan_min_rows() -> int:
    """Observed rows below which a misestimate is never worth a replan."""
    return _int("PRESTO_TPU_FEEDBACK_REPLAN_MIN_ROWS", 4096)


def revoke_watermark() -> float:
    """Fraction of a worker's memory limit at which its pool asks executors
    to revoke (offload, then spill), before anything blocks long enough
    for the cluster memory manager's killer."""
    return float(os.environ.get("PRESTO_TPU_REVOKE_WATERMARK", "0.8"))
