"""Materialized-view registry and refresh engine (torch counterpart of
presto_tpu/matview/manager.py; reference execution/
CreateMaterializedViewTask.java + RefreshMaterializedViewTask;
re-designed: the stored representation is a plain connector table written
through the session's writable catalog, and a refresh swaps it with one
replace(), so readers always see one consistent snapshot).

Concurrency: `_lock` guards the registry and every view's bookkeeping
(reads and writes); `_refresh_lock` serializes refresh and drop bodies so
two refreshers cannot interleave their read-compute-swap windows. A delta
refresh validates the base tables' version vector again after running
over the delta: a racing writer forces a retry, never a torn merge.

Every executor runs on the session's device.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Dict, Optional, Tuple

from ..connectors.spi import DeltaUnavailable
from ..exec import qcache
from ..exec.executor import Executor
from ..page import Page
from ..plan import nodes as N
from . import maintenance


class MatViewStats:
    """Process-lifetime counters of the matview subsystem (EXPLAIN
    ANALYZE's `-- matview:` footer, `snapshot()`)."""

    __slots__ = ("refreshes", "delta_refreshes", "full_refreshes", "rows_patched", "errors")

    def __init__(self):
        self.refreshes = 0  # REFRESH statements (manual + interval)
        self.delta_refreshes = 0  # refreshes served from scan_delta
        self.full_refreshes = 0  # full recomputes (fallbacks included)
        self.rows_patched = 0  # delta rows folded into stored views
        self.errors = 0  # refresh bodies that raised

    def snapshot(self) -> Dict[str, int]:
        return {k: getattr(self, k) for k in self.__slots__}


@dataclasses.dataclass
class MatView:
    """One registered view. `plan` is the optimized Output tree; `mplan`
    is None for recompute-only views, `reason` saying why. versions/tokens
    are the base-table snapshot the stored table reflects; tokens=None
    disables delta refresh until the next full refresh records a clean
    cursor."""

    name: str
    sql: str
    plan: N.PlanNode
    tables: Tuple[str, ...]
    mplan: Optional[maintenance.MaintenancePlan]
    reason: str
    storage_names: Tuple[str, ...] = ()
    versions: Optional[Tuple[int, ...]] = None
    tokens: Optional[Tuple[Any, ...]] = None
    last_refresh_at: float = 0.0
    last_mode: str = "init"  # init | delta | full
    last_reason: str = ""
    rows_patched: int = 0
    refreshes: int = 0


class MatViewManager:
    def __init__(self, session):
        self._session = session
        self._lock = threading.Lock()
        self._refresh_lock = threading.Lock()
        self.views: Dict[str, MatView] = {}
        self.stats = MatViewStats()
        self._auto_thread: Optional[threading.Thread] = None
        self._auto_stop = threading.Event()

    # -- planning --

    def _plan(self, sql: str):
        """(plan, tables) of the view query, optimized; refresh runs it
        on a local executor."""
        from ..plan.optimizer import optimize
        from ..sql import tree as t
        from ..sql.parser import parse
        from ..sql.planner import Planner

        ast = parse(sql)
        if not isinstance(ast, t.Query):
            raise ValueError("CREATE MATERIALIZED VIEW requires a SELECT query")
        s = self._session
        rp = Planner(s.catalog, views=s.views).plan_query(ast, outer=None, ctes={})
        channels = tuple(f.channel for f in rp.scope.fields)
        titles = tuple(f.name for f in rp.scope.fields)
        plan = optimize(N.Output(rp.node, channels, titles))
        return plan, qcache.plan_tables(plan)

    def _run_consistent(self, plan):
        """Execute `plan` on the session's device and return (page,
        versions, tokens) with the page consistent with the recorded
        snapshot. Retries when a writer races the run; after 3 tries keeps
        the page but nulls the tokens (delta refresh off until a quiet
        full refresh records a cursor again)."""
        s = self._session
        tables = qcache.plan_tables(plan)
        versions = tokens = None
        page = None
        for _attempt in range(3):
            versions = qcache.table_versions(s.catalog, tables)
            tokens = qcache.delta_tokens(s.catalog, tables)
            page = Executor(s.catalog, device=s.device).run(plan)
            if versions is None:
                return page, None, None
            if qcache.table_versions(s.catalog, tables) == versions:
                return page, versions, tokens
        return page, qcache.table_versions(s.catalog, tables), None

    # -- DDL entry points (session.py dispatch) --

    def create(self, name: str, sql: str, if_not_exists: bool = False):
        s = self._session
        name = name.lower()
        with self._refresh_lock:
            with self._lock:
                exists = name in self.views
            if exists:
                if if_not_exists:
                    return
                raise ValueError(f"materialized view {name!r} already exists")
            if name in s.views:
                raise ValueError(f"view {name!r} already exists")
            if name in s.catalog.table_names():
                raise ValueError(f"table {name!r} already exists")
            plan, tables = self._plan(sql)
            mplan, reason = maintenance.classify(plan)
            storage = tuple(tl.lower() for tl in plan.titles)
            if len(set(storage)) != len(storage):
                raise ValueError("CREATE MATERIALIZED VIEW requires unique column names")
            page, versions, tokens = self._run_consistent(plan)
            s._writable().create_table_from_page(name, Page(page.blocks, storage, page.count))
            mv = MatView(
                name=name, sql=sql, plan=plan, tables=tables, mplan=mplan, reason=reason,
                storage_names=storage, versions=versions, tokens=tokens,
                last_refresh_at=time.time(), last_mode="full", last_reason="initial build",
                refreshes=1,
            )
            with self._lock:
                self.views[name] = mv
                self.stats.refreshes += 1
                self.stats.full_refreshes += 1

    def drop(self, name: str, if_exists: bool = False):
        name = name.lower()
        with self._refresh_lock:
            with self._lock:
                mv = self.views.pop(name, None)
            if mv is None:
                if if_exists:
                    return
                raise ValueError(f"materialized view {name!r} does not exist")
            cat = self._session._writable()
            if name in cat.table_names():
                cat.drop_table(name)

    def refresh(self, name: str, full: bool = False) -> str:
        """Refresh one view; returns the mode used ('delta' | 'full').
        `full=True` forces a recompute (REFRESH ... FULL)."""
        name = name.lower()
        with self._refresh_lock:
            with self._lock:
                mv = self.views.get(name)
            if mv is None:
                raise ValueError(f"materialized view {name!r} does not exist")
            try:
                return self._refresh_inner(mv, full)
            except Exception:
                with self._lock:
                    self.stats.errors += 1
                raise

    def refresh_all(self) -> None:
        """Refresh every view (the auto-refresh tick). A view whose
        refresh raises is counted in stats.errors and the others still
        refresh; the first error is raised at the end."""
        with self._lock:
            names = list(self.views)
        first = None
        for name in names:
            try:
                self.refresh(name)
            except Exception as e:  # noqa: BLE001 — raised after the others
                first = first or e
        if first is not None:
            raise first

    # -- refresh internals (the caller holds _refresh_lock) --

    def _refresh_inner(self, mv: MatView, full: bool) -> str:
        if not full and mv.mplan is not None and mv.tokens is not None \
                and mv.versions is not None:
            try:
                mode = self._refresh_delta(mv)
            except DeltaUnavailable as e:
                mode = None
                fallback = f"delta unavailable: {e}"
            else:
                fallback = "delta not applicable (rewrite/large delta/race)"
            if mode is not None:
                return mode
        else:
            fallback = (
                "forced full" if full
                else (mv.reason if mv.mplan is None else "no delta cursor")
            )
        self._refresh_full(mv, fallback)
        return "full"

    def _refresh_delta(self, mv: MatView) -> Optional[str]:
        """Delta refresh; 'delta' on success, None when the caller should
        refresh in full (a rewrite, racing writers past the retry budget,
        or a delta too large). Raises DeltaUnavailable when compaction
        swallowed the cursor."""
        s = self._session
        cat = s.catalog
        scan_delta = getattr(cat, "scan_delta", None)
        if scan_delta is None:
            return None
        for _attempt in range(3):
            versions = qcache.table_versions(cat, mv.tables)
            new_tokens = qcache.delta_tokens(cat, mv.tables)
            if versions is None or new_tokens is None:
                return None
            for old_tok, new_tok in zip(mv.tokens, new_tokens):
                # rewrites (upsert/replace/delete) are no append delta
                if new_tok[2] != old_tok[2] or new_tok[0] < old_tok[0]:
                    return None
            if versions == mv.versions:
                # nothing changed: bookkeeping only. The tokens were read
                # after the versions: a write between the two reads would
                # be skipped for good if these tokens were kept (the JAX
                # package keeps them), so the versions must still hold
                if qcache.table_versions(cat, mv.tables) != versions:
                    continue
                with self._lock:
                    mv.tokens = new_tokens
                    mv.last_refresh_at = time.time()
                    mv.last_mode = "delta"
                    mv.last_reason = "no-op (base unchanged)"
                    mv.refreshes += 1
                    self.stats.refreshes += 1
                    self.stats.delta_refreshes += 1
                return "delta"
            deltas = {}
            total = 0
            base_rows = 0
            for tb, old_tok, new_tok in zip(mv.tables, mv.tokens, new_tokens):
                deltas[tb] = scan_delta(tb, old_tok[0], new_tok[0])
                total += int(deltas[tb].count)
                base_rows += int(cat.row_count(tb))
            if not total:
                continue  # versions moved with no row in the range: a rewrite raced
            if not self._delta_worthwhile(mv, total, base_rows):
                return None
            wcat = s._writable()
            t0 = time.perf_counter()
            delta = maintenance.run_core(cat, mv.mplan, deltas, s.device)
            if qcache.table_versions(cat, mv.tables) != versions:
                continue  # a writer raced the delta run: retry
            if mv.mplan.kind == "append" and not mv.mplan.terminals:
                # the stored table stays append-only, so result-cache
                # entries scanning the view itself stay patchable too
                if int(delta.count):
                    wcat.append(mv.name, Page.from_blocks(
                        list(delta.blocks), list(mv.storage_names), count=delta.count))
            else:
                # the stored table is written under _refresh_lock only
                # (held here), so this read is a consistent snapshot
                old_stored = cat.page(mv.name)
                old = Page.from_blocks(list(old_stored.blocks), list(mv.plan.channels),
                                       count=old_stored.count)
                merged = maintenance.merge_pages(mv.mplan, old, delta, s.device)
                wcat.replace(mv.name, Page.from_blocks(
                    list(merged.blocks), list(mv.storage_names), count=merged.count))
            self._record_refresh_wall(
                mv, delta_per_row_s=(time.perf_counter() - t0) / max(total, 1))
            with self._lock:
                mv.versions = versions
                mv.tokens = new_tokens
                mv.last_refresh_at = time.time()
                mv.last_mode = "delta"
                mv.last_reason = f"{total} delta rows"
                mv.rows_patched += total
                mv.refreshes += 1
                self.stats.refreshes += 1
                self.stats.delta_refreshes += 1
                self.stats.rows_patched += total
            return "delta"
        return None

    def _delta_worthwhile(self, mv: MatView, total: int, base_rows: int) -> bool:
        """Delta-vs-full break-even. With feedback on (plan/history.py) and
        BOTH refresh modes measured for this view, the decision is the
        measured one — predicted delta wall against the last full wall —
        instead of the PRESTO_TPU_MATVIEW_DELTA_MAX_FRAC row-ratio cap
        (the rule when feedback is off or a mode is unmeasured)."""
        from ..plan.history import HISTORY, feedback_on

        if feedback_on():
            ent = HISTORY.lookup(f"mv:{mv.name}", self._session.catalog)
            if ent is not None and ent.delta_per_row_s is not None \
                    and ent.full_wall_s is not None:
                return ent.delta_per_row_s * total < ent.full_wall_s
        return not (base_rows and total > maintenance.DELTA_MAX_FRAC * base_rows)

    def _record_refresh_wall(self, mv: MatView, delta_per_row_s=None,
                             full_wall_s=None) -> None:
        """Feed observed refresh walls into the history store, keyed per
        view with NO table-version dependency: walls measure the refresh
        pipeline, not a data snapshot, and base-table writes are exactly
        when the next refresh needs them."""
        from ..plan.history import HISTORY, feedback_on

        if feedback_on():
            HISTORY.record(f"mv:{mv.name}", catalog=self._session.catalog, tables=(),
                           kind="MatView", delta_per_row_s=delta_per_row_s,
                           full_wall_s=full_wall_s)

    def _refresh_full(self, mv: MatView, reason: str) -> None:
        s = self._session
        t0 = time.perf_counter()
        page, versions, tokens = self._run_consistent(mv.plan)
        self._record_refresh_wall(mv, full_wall_s=time.perf_counter() - t0)
        s._writable().replace(mv.name, Page.from_blocks(
            list(page.blocks), list(mv.storage_names), count=page.count))
        with self._lock:
            mv.versions = versions
            mv.tokens = tokens
            mv.last_refresh_at = time.time()
            mv.last_mode = "full"
            mv.last_reason = reason
            mv.refreshes += 1
            self.stats.refreshes += 1
            self.stats.full_refreshes += 1

    # -- interval-driven refresh --

    def start_auto_refresh(self, interval_s: Optional[float] = None) -> bool:
        """Start the background refresh thread; False when the interval
        is 0 (off) or a thread already runs."""
        iv = maintenance.REFRESH_INTERVAL_S if interval_s is None else float(interval_s)
        if iv <= 0:
            return False
        with self._lock:
            if self._auto_thread is not None and self._auto_thread.is_alive():
                return False
            self._auto_stop.clear()
            th = threading.Thread(target=self._auto_loop, args=(iv,),
                                  name="matview-refresh", daemon=True)
            self._auto_thread = th
        th.start()
        return True

    def stop_auto_refresh(self) -> None:
        with self._lock:
            th = self._auto_thread
            self._auto_thread = None
        self._auto_stop.set()
        if th is not None:
            th.join(timeout=5.0)

    def _auto_loop(self, interval_s: float) -> None:
        """One refresh_all per tick. A failed refresh is counted in
        stats.errors (its views keep their last good rows) and the loop
        goes on, so one bad view cannot stop the others' maintenance."""
        while not self._auto_stop.wait(interval_s):
            try:
                self.refresh_all()
            except Exception:  # noqa: BLE001 — counted in stats.errors
                pass

    # -- observability --

    def _staleness(self, mv: MatView) -> int:
        """Versions the view lags its base tables by (0 = fresh)."""
        cat = self._session.catalog
        toks = qcache.delta_tokens(cat, mv.tables)
        if toks is not None and mv.tokens is not None:
            return sum(max(int(n[1]) - int(o[1]), 0) for o, n in zip(mv.tokens, toks))
        cur = qcache.table_versions(cat, mv.tables)
        if cur is None or mv.versions is None:
            return 0
        return sum(1 for a, b in zip(mv.versions, cur) if a != b)

    def rows(self):
        """One dict per view: the rows of the JAX package's
        system.runtime.materialized_views."""
        with self._lock:
            views = list(self.views.values())
        return [{
            "name": mv.name,
            "base_tables": ",".join(mv.tables),
            "incremental": mv.mplan is not None,
            "reason": mv.reason,
            "staleness_versions": self._staleness(mv),
            "last_refresh_at": mv.last_refresh_at,
            "last_mode": mv.last_mode,
            "last_reason": mv.last_reason,
            "rows_patched": mv.rows_patched,
            "refreshes": mv.refreshes,
        } for mv in views]

    def format_summary(self) -> str:
        """The body of EXPLAIN ANALYZE's one-line `-- matview:` footer."""
        with self._lock:
            views = list(self.views.values())
        parts = []
        for mv in views:
            kind = mv.mplan.kind if mv.mplan is not None else f"full({mv.reason})"
            parts.append(f"{mv.name} {kind} mode={mv.last_mode} "
                         f"staleness={self._staleness(mv)} patched={mv.rows_patched:,}")
        return "; ".join(parts)

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {"stats": self.stats.snapshot(), "views": len(self.views)}
