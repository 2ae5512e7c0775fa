"""Incrementally maintained materialized views (torch counterpart of
presto_tpu/matview/; reference raptor's materialized-view shadowing and
Presto's REFRESH MATERIALIZED VIEW).

Three layers:

  maintenance.py — classifies a view plan as delta-patchable or
      recompute-only, and runs the delta/merge pipeline over connector
      `scan_delta()` pages on the session's device.
  patch.py — the result cache's "patch" verdict: a stale entry is brought
      up to date in place from base-table deltas instead of evicted.
  manager.py — the session-facing registry: CREATE/REFRESH/DROP
      MATERIALIZED VIEW and the interval-driven auto refresh.

The JAX package's system.runtime.materialized_views table waits for
connectors/system.py (ROADMAP queue 1 item 9); MatViewManager.rows()
gives its rows.
"""

from .maintenance import MaintenancePlan, classify  # noqa: F401
from .manager import MatViewManager, MatViewStats  # noqa: F401
from .patch import patch_entry  # noqa: F401
