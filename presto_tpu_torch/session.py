"""Session: SQL in, rows out (torch counterpart of presto_tpu/session.py).

The single-process equivalent of the reference's LocalQueryRunner
(presto-main/.../testing/LocalQueryRunner.java:204 — full
parse->plan->execute in one process), on one device: "cuda" unless the
caller passes device="cpu". Every result page, row counts, SHOW and
EXPLAIN included, is built on the session's device.

Ported: SELECT through the plan and result caches (exec/qcache.py), the
statement layer (DDL and DML on writable connectors, transactions, views,
schemas, PREPARE/EXECUTE over plan skeletons, session properties, ALTER
TABLE, GRANT/REVOKE under security.py, SHOW and DESCRIBE), EXPLAIN,
EXPLAIN (TYPE VALIDATE | IO) and EXPLAIN ANALYZE (exec/stats.py), and the
streaming executor under a device budget (exec/stream.py: `streaming`,
`batch_rows`, `memory_budget`, as arguments or SET SESSION properties).
USE catalog.schema over a CatalogStore (server/catalog_store.py) makes
the used catalog the first resolver of bare names. CREATE, REFRESH
[FULL] and DROP MATERIALIZED VIEW run through matview/manager.py, and
with PRESTO_TPU_FEEDBACK=1 a query whose plan has a frame the history
store lacks runs once observed and records its row counts
(plan/history.py). With a `mesh` (parallel/mesh.py) every plan is
fragmented (plan/fragment.py) and runs over the mesh's workers
(exec/dist.py), the single-process counterpart of the reference's
DistributedQueryRunner; EXPLAIN (TYPE DISTRIBUTED) prints the fragmented
plan and EXPLAIN ANALYZE adds an `-- exchange:` footer. Not ported,
raising NotPortedError: the matmul group-by property; the JAX package's
observability spans have no counterpart here.
"""

from __future__ import annotations

import time
from typing import List, Optional

import numpy as np
import torch

from . import types as T
from .exec.executor import Executor
from .expr.functions import NotPortedError
from .page import Block, Page
from .plan import nodes as N
from .sql import tree as t
from .sql.parser import parse
from .sql.planner import Planner


class QueryResult:
    def __init__(self, page, titles):
        self.page = page
        self.titles = list(titles)
        # set by the JAX package's traced dispatch; None here, as there
        # with tracing off
        self.trace_id: Optional[str] = None
        self.phase_ms: Optional[dict] = None

    def rows(self) -> List[tuple]:
        return self.page.to_pylist()

    def row_count(self) -> int:
        return int(self.page.count)


def resolve_device(device) -> torch.device:
    """The device a session runs on; "cuda" needs a card (there is no
    silent fall back to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return dev


# system session properties: per-query engine overrides (reference
# SystemSessionProperties), the same ten names as the JAX package so SHOW
# SESSION matches. Each entry: parser from string.
def _parse_bool(v: str) -> bool:
    if str(v).lower() in ("true", "1", "yes"):
        return True
    if str(v).lower() in ("false", "0", "no"):
        return False
    raise ValueError(f"invalid boolean {v!r}")


SESSION_PROPERTIES = {
    "broadcast_threshold": int,   # join build-side broadcast cutover (rows)
    "streaming": _parse_bool,     # paged scans through the streaming driver
    "batch_rows": int,            # streaming scan batch size
    "memory_budget": int,         # device-memory budget (bytes)
    "query_priority": int,        # resource-group query_priority policy
    "pallas_groupby": _parse_bool,  # the dense group-by kernel strategy
    "matmul_groupby": _parse_bool,  # dense-key aggregation via matmuls
    "dynamic_filtering": _parse_bool,  # build-side runtime filters on probes
    "plan_cache": _parse_bool,    # serve plans from exec/qcache.PLAN_CACHE
    "result_cache": _parse_bool,  # serve results from exec/qcache.RESULT_CACHE
}


def parse_session_properties(text: str) -> dict:
    """Parse 'k=v,k=v' (the X-Presto-Session header format,
    presto-client/.../PrestoHeaders.java) with type checking."""
    props = {}
    for part in text.split(","):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise ValueError(f"invalid session property {part!r}")
        k, v = part.split("=", 1)
        k = k.strip().lower()
        parser = SESSION_PROPERTIES.get(k)
        if parser is None:
            raise ValueError(f"unknown session property {k!r}")
        props[k] = parser(v.strip())
    return props


def _check_ported_properties(props: dict) -> None:
    """The matmul group-by is not ported: turning it on raises."""
    if props.get("matmul_groupby"):
        raise NotPortedError("not ported yet: SET SESSION matmul_groupby = true")


def memory_line(ex) -> str:
    """EXPLAIN ANALYZE's `-- memory:` footer of a streaming run: every rung
    of the ladder the query touched (offload events, the disk tier, hybrid
    partitions and recursion, the ragged layout, the aggregate sink's
    kernel batches, revocations), plus over-frees; empty when none."""
    st = ex.spill_stats
    pool = ex.pool
    parts = []
    if ex.spill_events:
        parts.append("spill " + ",".join(sorted(set(ex.spill_events))))
    if st["disk_bytes"]:
        parts.append(f"disk {st['disk_bytes']:,}B")
    if st["hybrid_parts"]:
        parts.append(f"hybrid parts={st['hybrid_parts']} depth={st['hybrid_depth']}")
    if st["ragged_pages"]:
        parts.append(f"ragged pages={st['ragged_pages']} occ={st['ragged_occupancy_pct']}%")
    if st["agg_hash_batches"]:
        parts.append(f"agg_hash_batches={st['agg_hash_batches']}")
    if st["agg_dense_batches"]:
        parts.append(f"agg_dense_batches={st['agg_dense_batches']}")
    if st["chunk_fallbacks"]:
        parts.append(f"chunk_fallbacks={st['chunk_fallbacks']}")
    if pool.revocations:
        parts.append(f"revocations={pool.revocations}")
    if pool.over_frees:
        parts.append(f"over_frees={pool.over_frees}")
    if not parts:
        return ""
    parts.append(f"pool peak {pool.peak:,}B")
    return "\n-- memory: " + ", ".join(parts)


def exchange_line(ex) -> str:
    """EXPLAIN ANALYZE's `-- exchange:` footer of a mesh run: the
    repartitions (their rows, and their host time up to each count read)
    and the bucketed joins' peak exchanged bytes per worker; empty when
    there were none."""
    events = ex.exchange_events
    reparts = [e for e in events if e.get("kind") == "repartition"]
    parts = []
    if reparts:
        parts.append(f"{len(reparts)} repartitions over {reparts[0]['shards']} workers, "
                     f"{sum(e['rows'] for e in reparts):,} rows, "
                     f"{sum(e['collective_ms'] for e in reparts):,.1f}ms to the count reads")
    for e in events:
        if "buckets" in e:
            parts.append(f"grouped join buckets={e['buckets']} "
                         f"peak {e['per_shard_bytes']:,}B/worker")
    return "\n-- exchange: " + "; ".join(parts) if parts else ""


def _opt_f64(values, device) -> Block:
    """Optional-float column for Page.from_dict."""
    data = np.array([0.0 if v is None else float(v) for v in values], np.float64)
    valid = np.array([v is not None for v in values], bool)
    return Block.from_numpy(data, T.DOUBLE, valid=None if valid.all() else valid,
                            device=device)


# the statement kinds _execute_statement runs (the reference's dispatch)
_STATEMENTS = (
    t.CreateTable, t.DropTable, t.Insert, t.Delete, t.ShowTables,
    t.ShowColumns, t.StartTransaction, t.Commit, t.Rollback,
    t.CreateView, t.DropView, t.ShowCreateView, t.CreateSchema,
    t.DropSchema, t.ShowSchemas, t.Prepare, t.ExecutePrepared,
    t.Deallocate, t.DescribeInput, t.DescribeOutput, t.SetSession,
    t.ResetSession, t.ShowSession, t.RenameTable, t.RenameColumn,
    t.AddColumn, t.DropColumn, t.Grant, t.Revoke,
    t.ShowFunctions, t.ShowCatalogs, t.ShowCreateTable,
    t.ShowStats, t.Use, t.Analyze, t.ShowGrants,
    t.CreateMaterializedView, t.RefreshMaterializedView,
    t.DropMaterializedView,
)


# DELETE's row-number column (_NumberedTable); `$` keeps it from any SQL name
_ROW_NUMBER = "$row_number"


class _NumberedTable:
    """`base` with one table's page widened by a row-number column, for
    planning and running DELETE's victim query; everything else is
    `base`'s."""

    def __init__(self, base, table: str, page: Page):
        self.base, self.table, self.numbered = base, table, page

    def __getattr__(self, attr):
        return getattr(self.base, attr)

    def schema(self, table: str):
        if table != self.table:
            return self.base.schema(table)
        return {n: b.type for n, b in zip(self.numbered.names, self.numbered.blocks)}

    def page(self, table: str) -> Page:
        return self.numbered if table == self.table else self.base.page(table)

    def page_columns(self, table: str, columns):
        from .connectors.spi import read_columns

        return self.numbered if table == self.table else read_columns(self.base, table, columns)

    def column_stats(self, table: str, column: str):
        if table == self.table and column == _ROW_NUMBER:
            from .plan.stats import ColumnStats

            cap = self.numbered.capacity
            return ColumnStats(ndv=float(cap), null_fraction=0.0, min=0.0, max=float(cap - 1))
        return self.base.column_stats(table, column)


# the session properties that change how this package plans or runs a
# query (broadcast_threshold: a mesh session's join distribution); the
# other, query_priority, is accepted and shown by SHOW SESSION, and read by
# the JAX package's admission control, not ported
_ENGINE_PROPERTIES = ("pallas_groupby", "dynamic_filtering", "plan_cache", "result_cache",
                      "streaming", "batch_rows", "memory_budget", "broadcast_threshold")


class Session:
    """A SQL session on one device ("cuda" unless `device` says otherwise),
    or over a mesh of workers (`mesh`, parallel/mesh.py; the session's
    device is then worker 0's). `pallas_groupby` None means on, on every
    device. With `streaming`, queries run through the streaming executor
    (exec/stream.py) in batches of `batch_rows` under `memory_budget`
    device bytes (None: no budget); a mesh takes precedence over it. Over a
    mesh, `broadcast_threshold` picks the join distribution (None: by
    cost, else the build rows up to which a join broadcasts) and
    `exchange_budget` bounds a repartitioned join's exchanged bytes per
    worker."""

    def __init__(
        self,
        catalog,
        device=None,
        access_control=None,
        user: str = "user",
        pallas_groupby=None,
        dynamic_filtering: bool = True,
        plan_cache: bool = True,
        result_cache: bool = True,
        streaming: bool = False,
        batch_rows: int = 1 << 20,
        memory_budget: Optional[int] = None,
        mesh=None,
        broadcast_threshold: Optional[int] = None,
        exchange_budget: Optional[int] = None,
    ):
        self.catalog = catalog
        if mesh is not None:
            if device is not None and torch.device(device) != mesh.devices[0]:
                raise ValueError(f"device {device!r} is not the mesh's worker 0 "
                                 f"({mesh.devices[0]})")
            device = mesh.devices[0]
        self.device = resolve_device("cuda" if device is None else device)
        self.mesh = mesh
        self.broadcast_threshold = broadcast_threshold
        self.exchange_budget = exchange_budget
        self.streaming = bool(streaming)
        self.batch_rows = int(batch_rows)
        self.memory_budget = memory_budget
        self.access_control = access_control
        self.user = user
        self.pallas_groupby = True if pallas_groupby is None else bool(pallas_groupby)
        self.dynamic_filtering = dynamic_filtering
        self.plan_cache = plan_cache
        self.result_cache = result_cache
        self.executor = self._new_executor()
        # statement-layer state (shared BY REFERENCE with derived
        # property-override sessions, see with_properties)
        self.views: dict = {}  # name -> view query SQL
        self.prepared: dict = {}  # name -> prepared statement SQL
        self.schemas = {"default"}
        self._session_overrides: dict = {}  # SET SESSION k = v
        self._prop_sessions: dict = {}  # property set -> derived Session
        self._txn = None
        self._txn_base = None
        from .matview.manager import MatViewManager

        self.matviews_mgr = MatViewManager(self)

    def _new_executor(self, collector=None):
        """The engine the session runs: the distributed executor over the
        session's mesh, else the streaming executor when the session
        streams, else the materializing one."""
        if self.mesh is not None:
            from .exec.dist import DistributedExecutor

            ex = DistributedExecutor(self.catalog, self.mesh, collector=collector,
                                     exchange_budget=self.exchange_budget,
                                     pallas_groupby=self.pallas_groupby)
        elif self.streaming:
            from .exec.stream import StreamingExecutor

            ex = StreamingExecutor(self.catalog, device=self.device,
                                   batch_rows=self.batch_rows,
                                   memory_budget=self.memory_budget, collector=collector,
                                   pallas_groupby=self.pallas_groupby)
        else:
            ex = Executor(self.catalog, device=self.device, collector=collector,
                          pallas_groupby=self.pallas_groupby)
        ex.dynamic_filtering = self.dynamic_filtering
        return ex

    def _swap_catalog(self, catalog) -> None:
        """Point the session AND its executor at a different catalog
        (transaction overlay enter/exit)."""
        self.catalog = catalog
        self.executor.catalog = catalog

    def with_properties(self, props: dict) -> "Session":
        """A sibling session with per-query property overrides applied
        (reference: Session.withSystemProperty); only _ENGINE_PROPERTIES
        change how it runs. Derived sessions are cached per property set."""
        _check_ported_properties(props)
        engine = {k: v for k, v in props.items() if k in _ENGINE_PROPERTIES}
        if not engine:
            return self
        key = tuple(sorted(engine.items()))
        cache = self._prop_sessions
        derived = cache.get(key)
        if derived is not None and derived.catalog is not self.catalog:
            # the base session's catalog moved (transaction overlay
            # enter/exit) after this derived session was cached — repoint
            # it or reads would miss the transaction's own writes
            derived._swap_catalog(self.catalog)
        if derived is None:
            if len(cache) >= 16:  # bound memory: FIFO-evict
                cache.pop(next(iter(cache)))
            derived = Session(
                self.catalog,
                device=self.device,
                access_control=self.access_control,
                user=self.user,
                pallas_groupby=engine.get("pallas_groupby", self.pallas_groupby),
                dynamic_filtering=engine.get("dynamic_filtering", self.dynamic_filtering),
                plan_cache=engine.get("plan_cache", self.plan_cache),
                result_cache=engine.get("result_cache", self.result_cache),
                streaming=engine.get("streaming", self.streaming),
                batch_rows=engine.get("batch_rows", self.batch_rows),
                memory_budget=engine.get("memory_budget", self.memory_budget),
                mesh=self.mesh,
                broadcast_threshold=engine.get("broadcast_threshold",
                                               self.broadcast_threshold),
                exchange_budget=self.exchange_budget,
            )
            # statement-layer state is session-wide, not per-override
            derived.views = self.views
            derived.prepared = self.prepared
            derived.schemas = self.schemas
            derived.matviews_mgr = self.matviews_mgr
            cache[key] = derived
        return derived

    def plan(self, sql: str) -> N.PlanNode:
        ast = parse(sql)
        if isinstance(ast, t.Explain):
            ast = ast.query
        if not isinstance(ast, t.Query):
            raise ValueError("only SELECT queries supported here")
        return self._plan_query_cached(ast)

    # -- plan cache (exec/qcache.py) --

    def _plan_env_key(self):
        """Planning-relevant session state: plans keyed by the same AST
        are only interchangeable within one catalog object, mesh width
        and join-distribution setting (a mesh session's plan is
        fragmented, a local one's is not), view set and feedback-store
        generation (plan/history.py: a recorded observation or an
        invalidation must re-plan, never reuse a plan built on superseded
        history)."""
        from .plan.history import plan_env_token

        mesh_n = self.mesh.size if self.mesh is not None else 0
        views_fp = tuple(sorted(self.views.items())) if self.views else ()
        return (id(self.catalog), mesh_n, self.broadcast_threshold, views_fp,
                plan_env_token())

    def _engine_env_key(self):
        """Execution-engine identity, part of the RESULT cache key: two
        sessions only share result pages when they would execute the same
        way on the same device (or mesh)."""
        return (type(self.executor).__name__, str(self.device),
                None if self.mesh is None else self.mesh.devices, self.exchange_budget,
                self.pallas_groupby, self.dynamic_filtering, self.streaming, self.batch_rows,
                self.memory_budget)

    def _plan_query_uncached(self, ast: t.Query) -> N.PlanNode:
        planner = Planner(self.catalog, views=self.views)
        rp = planner.plan_query(ast, outer=None, ctes={})
        channels = tuple(f.channel for f in rp.scope.fields)
        titles = tuple(f.name for f in rp.scope.fields)
        from .plan.optimizer import optimize

        return self._fragmented(optimize(N.Output(rp.node, channels, titles)), self.catalog)

    def _fragmented(self, node: N.PlanNode, catalog) -> N.PlanNode:
        """A mesh session's plan, fragmented for its workers
        (plan/fragment.py); any other session's as it is."""
        if self.mesh is None:
            return node
        from .plan.fragment import fragment_plan

        return fragment_plan(node, catalog, self.broadcast_threshold,
                             num_workers=self.mesh.size)

    def _plan_query_cached(self, ast: t.Query) -> N.PlanNode:
        """Plan via the process-wide plan cache. Entries are validated
        against the catalog object AND every referenced table's connector
        snapshot version, so a write replans; unversioned connectors are
        never cached."""
        from .exec import qcache

        if not self.plan_cache:
            return self._plan_query_uncached(ast)
        key = ("q", ast, self._plan_env_key())
        ent = qcache.PLAN_CACHE.lookup(key, self.catalog)
        if ent is not None:
            return ent.plan
        node = self._plan_query_uncached(ast)
        qcache.PLAN_CACHE.store(key, node, self.catalog)
        return node

    def explain(self, sql: str) -> str:
        from .plan.stats import StatsDeriver

        return N.plan_tree_str(
            self.plan(sql), stats_of=StatsDeriver(self.catalog).stats
        )

    def query(self, sql: str, user: Optional[str] = None) -> QueryResult:
        ast = parse(sql)
        # explicit empty-string identity must NOT fall back to the
        # (possibly privileged) session default
        effective = self.user if user is None else user
        if self.access_control is not None:
            from .security import enforce

            enforce(self.access_control, effective, ast, views=self.views)
        if isinstance(ast, _STATEMENTS):
            # the user travels as an argument, not as session state
            return self._execute_statement(ast, effective)
        if self._session_overrides:
            # SET SESSION overrides route plain queries through the
            # derived-session cache (reference: Session.withSystemProperty)
            return self.with_properties(dict(self._session_overrides))._dispatch_query(sql, ast)
        return self._dispatch_query(sql, ast)

    def _plan_lines(self, text: str) -> QueryResult:
        return self._strings_result({"Query Plan": text.split("\n")}, ("Query Plan",))

    def _dispatch_query(self, sql, ast):
        if not isinstance(ast, t.Explain):
            return self._execute_plan_cached(self.plan(sql))
        node = self.plan(sql)
        etype = getattr(ast, "etype", "logical")
        if ast.analyze:
            return self._plan_lines(self.explain_analyze_plan(node))
        if etype == "validate":
            # reference ExplainTask TYPE VALIDATE: analysis+planning
            # succeeded if we got here
            pg = Page.from_dict({"Valid": [True]}, device=self.device)
            return QueryResult(pg, ("Valid",))
        if etype == "io":
            # reference IOPlanPrinter: the tables/columns the plan reads
            scans = []

            def walk(n):
                if isinstance(n, N.TableScan):
                    cols = ", ".join(c for _, c, _ in n.columns)
                    scans.append(f"{n.table} [{cols}]")
                for c in n.children:
                    walk(c)

            walk(node)
            return self._strings_result({"Table": scans}, ("Table",))
        if etype == "distributed":
            # reference PlanPrinter.textDistributedPlan: a mesh session's
            # plan is fragmented already (the JAX package fragments it a
            # second time and raises); a local one is fragmented for 2
            # workers, as there
            if self.mesh is None:
                from .plan.fragment import fragment_plan

                node = fragment_plan(node, self.catalog, self.broadcast_threshold,
                                     num_workers=2)
        return self._plan_lines(N.plan_tree_str(node))

    def _execute_plan_cached(self, node) -> QueryResult:
        """Execute a planned query through the result cache: a hit serves
        the cached page itself without touching the executor; a miss
        executes and stores under the snapshot versions read BEFORE
        execution (a concurrent writer can only waste the entry, never
        stale it). Plans over unversioned connectors, TABLESAMPLE, or
        nondeterministic functions bypass the cache entirely."""
        from .exec import qcache

        if not self.result_cache:
            return QueryResult(self._run_observed(node), node.titles)
        key = ("r", node, self._plan_env_key(), self._engine_env_key())
        hit = qcache.RESULT_CACHE.lookup(key, self.catalog)
        if hit is not None:
            return QueryResult(hit.page, hit.titles)
        pre = qcache.RESULT_CACHE.preversions(node, self.catalog)
        page = self._run_observed(node)
        if pre is not None and qcache.plan_is_deterministic(node):
            qcache.RESULT_CACHE.store(key, page, node.titles, self.catalog, pre)
        return QueryResult(page, node.titles)

    def _run_observed(self, node):
        """Observe-once execution for history-based feedback
        (plan/history.py): when feedback is on AND the store lacks a live
        entry for some frame of this plan, run through a new
        collector-attached executor (the EXPLAIN ANALYZE construction) and
        fold the observed row counts in at the end. Plans whose frames are
        all remembered take the plain path: the warm cost is one store
        walk. Unlike the JAX package, a session without the result cache
        observes too."""
        from .plan import history as H

        if not (H.feedback_on() and H.HISTORY.wants_observation(node, self.catalog)):
            return self.executor.run(node)
        from .exec.stats import StatsCollector

        collector = StatsCollector()
        page = self._new_executor(collector).run(node)
        H.HISTORY.record_plan(node, collector, self.catalog)
        return page

    # -- DDL / DML tasks (reference execution/CreateTableTask.java,
    # CreateTableAsSelect via TableWriter/TableFinish operators,
    # operator/TableWriterOperator.java, operator/DeleteOperator.java;
    # re-designed: the task runs the source plan through the session's
    # executor and hands final pages to the writable connector) --

    def _writable(self):
        from .connectors.spi import WritableConnector, WriteError

        # unwrap routing catalogs (a `wrapped` chain)
        cat = self.catalog
        probe = cat
        while probe is not None and not isinstance(probe, WritableConnector):
            probe = getattr(probe, "wrapped", None)
        if probe is None:
            raise WriteError(f"catalog {getattr(cat, 'name', '?')!r} is read-only")
        return cat

    def _run_query_ast(self, ast: t.Query):
        """Plan + execute a Query AST; returns (page, titles). Plans come
        from the snapshot-validated plan cache; results are NOT
        result-cached here (DML sources execute fresh)."""
        node = self._plan_query_cached(ast)
        return self.executor.run(node), node.titles

    @staticmethod
    def _table_schema(cat, name: str):
        if name not in cat.table_names():
            raise ValueError(f"table {name!r} does not exist")
        return cat.schema(name)

    def _row_count_result(self, n: int) -> QueryResult:
        pg = Page.from_dict({"rows": np.array([n], dtype=np.int64)}, device=self.device)
        return QueryResult(pg, ("rows",))

    def _strings_result(self, columns: dict, titles) -> QueryResult:
        """A page of string columns (None = NULL); zero rows when the
        columns are empty."""
        n = len(next(iter(columns.values())))
        pg = Page.from_dict({k: (list(v) if n else [None]) for k, v in columns.items()},
                            device=self.device)
        if not n:
            pg = Page(pg.blocks, pg.names, torch.zeros((), dtype=torch.int32,
                                                       device=self.device))
        return QueryResult(pg, titles)

    @staticmethod
    def _like_filter(names, pat):
        """SQL LIKE pattern over a name list (SHOW ... LIKE 'x%')."""
        if pat is None:
            return names
        import re

        rx = re.compile(
            "^" + re.escape(pat).replace("%", ".*").replace("_", ".") + "$",
            re.IGNORECASE,
        )
        return [n for n in names if rx.match(n)]

    def _execute_statement(self, ast, user: Optional[str] = None) -> QueryResult:
        if user is None:
            user = self.user
        # -- materialized views (matview/manager.py; reference
        # execution/CreateMaterializedViewTask.java) --
        if isinstance(ast, t.CreateMaterializedView):
            self.matviews_mgr.create(ast.name, ast.query_sql, ast.if_not_exists)
            return self._row_count_result(0)
        if isinstance(ast, t.RefreshMaterializedView):
            self.matviews_mgr.refresh(ast.name, full=ast.full)
            return self._row_count_result(0)
        if isinstance(ast, t.DropMaterializedView):
            self.matviews_mgr.drop(ast.name, ast.if_exists)
            return self._row_count_result(0)
        if isinstance(ast, t.Use):
            # reference UseTask: switch the session's default catalog and
            # schema. Over a CatalogStore the used catalog becomes the FIRST
            # resolver of bare names (a per-session store; the loaded one is
            # not changed)
            from .server.catalog_store import CatalogStore

            cat_name, schema = ast.catalog, ast.schema
            if cat_name is None and isinstance(self.catalog, CatalogStore) \
                    and schema in self.catalog.catalogs:
                cat_name, schema = schema, "default"
            if cat_name is not None:
                if not isinstance(self.catalog, CatalogStore) or \
                        cat_name not in self.catalog.catalogs:
                    raise ValueError(f"catalog {cat_name!r} does not exist")
                ordered = {cat_name: self.catalog.catalogs[cat_name]}
                ordered.update(self.catalog.catalogs)
                self._swap_catalog(CatalogStore(ordered))
            elif schema not in self.schemas:
                raise ValueError(f"schema {schema!r} does not exist")
            self.current_schema = schema
            return self._row_count_result(0)
        if isinstance(ast, t.Analyze):
            # reference AnalyzeTask: derive every column's stats through
            # the CBO path and report the analyzed row count
            name = ast.table.lower()
            schema = self._table_schema(self.catalog, name)
            get = getattr(self.catalog, "column_stats", None)
            if get is not None:
                for c in schema:
                    get(name, c)  # populates the connector's stats cache
            return self._row_count_result(int(self.catalog.row_count(name)))
        if isinstance(ast, t.ShowTables):
            return self._show_tables(ast, user)
        if isinstance(ast, t.ShowColumns):
            schema = self._table_schema(self.catalog, ast.table.lower())
            return self._strings_result(
                {"Column": list(schema), "Type": [str(ty) for ty in schema.values()]},
                ("Column", "Type"))
        if isinstance(ast, t.StartTransaction):
            if self._txn is not None:
                raise ValueError("transaction already in progress")
            from .exec.transaction import TransactionCatalog

            self._txn_base = self.catalog
            self._txn = TransactionCatalog(self._writable())
            self._swap_catalog(self._txn)
            return self._row_count_result(0)
        if isinstance(ast, (t.Commit, t.Rollback)):
            txn = self._txn
            if txn is None:
                raise ValueError("no transaction in progress")
            try:
                if isinstance(ast, t.Commit):
                    txn.commit()
                else:
                    txn.rollback()
            finally:
                self._swap_catalog(self._txn_base)
                self._txn = None
            return self._row_count_result(0)
        if isinstance(ast, t.CreateTable):
            return self._create_table(ast)
        if isinstance(ast, t.DropTable):
            cat = self._writable()
            name = ast.name.lower()
            if name in self.matviews_mgr.views:
                raise ValueError(f"{name!r} is a materialized view; use DROP MATERIALIZED VIEW")
            if name not in cat.table_names():
                if ast.if_exists:
                    return self._row_count_result(0)
                raise ValueError(f"table {ast.name!r} does not exist")
            cat.drop_table(name)
            return self._row_count_result(0)
        if isinstance(ast, t.Insert):
            return self._insert(ast)
        if isinstance(ast, t.Delete):
            return self._delete(ast)
        if isinstance(ast, (t.CreateView, t.DropView, t.ShowCreateView, t.CreateSchema,
                            t.DropSchema, t.ShowSchemas)):
            return self._views_and_schemas(ast)
        if isinstance(ast, (t.ShowFunctions, t.ShowGrants, t.ShowCatalogs,
                            t.ShowCreateTable, t.ShowStats)):
            return self._show_metadata(ast)
        if isinstance(ast, (t.Prepare, t.Deallocate, t.ExecutePrepared, t.DescribeInput,
                            t.DescribeOutput)):
            return self._prepared_statement(ast, user)
        # -- session properties (reference SetSessionTask.java,
        # ResetSessionTask.java) --
        if isinstance(ast, t.SetSession):
            key = ast.name.lower()
            if key not in SESSION_PROPERTIES:
                raise ValueError(f"unknown session property {key!r}")
            value = SESSION_PROPERTIES[key](str(self._literal_value(ast.value)))
            _check_ported_properties({key: value})
            self._session_overrides[key] = value
            return self._row_count_result(0)
        if isinstance(ast, t.ResetSession):
            self._session_overrides.pop(ast.name.lower(), None)
            return self._row_count_result(0)
        if isinstance(ast, t.ShowSession):
            rows = sorted(SESSION_PROPERTIES)
            vals = [str(self._session_overrides.get(k, "")) for k in rows]
            return self._strings_result({"Name": rows, "Value": vals}, ("Name", "Value"))
        # -- ALTER TABLE (reference RenameTableTask.java,
        # RenameColumnTask.java, AddColumnTask.java, DropColumnTask) --
        if isinstance(ast, (t.RenameTable, t.RenameColumn, t.AddColumn, t.DropColumn)):
            return self._alter_table(ast)
        # -- GRANT / REVOKE wired into security.py (reference
        # GrantTask.java, RevokeTask.java) --
        if isinstance(ast, (t.Grant, t.Revoke)):
            ac = self.access_control
            if ac is None or not hasattr(ac, "grant"):
                raise ValueError(
                    "GRANT/REVOKE requires a mutable access control "
                    "(security.RuleBasedAccessControl)"
                )
            table = ast.table.lower()
            if isinstance(ast, t.Grant):
                ac.grant(ast.grantee, table, ast.privilege)
            else:
                ac.revoke(ast.grantee, table, ast.privilege)
            return self._row_count_result(0)
        raise ValueError(f"unsupported statement {type(ast).__name__}")

    def _show_tables(self, ast, user) -> QueryResult:
        # views list alongside tables (reference ShowQueriesRewrite:
        # information_schema.tables carries both)
        names = sorted(set(self.catalog.table_names()) | set(self.views))
        names = self._like_filter(names, ast.like)
        if self.access_control is not None:
            # filter out tables the user cannot read (reference
            # SystemAccessControl.filterTables)
            from .security import AccessDeniedError

            visible = []
            for n in names:
                try:
                    self.access_control.check_can_select_from_table(user, n)
                    visible.append(n)
                except AccessDeniedError:
                    pass
            names = visible
        return self._strings_result({"Table": names}, ("Table",))

    # -- views (reference execution/CreateViewTask.java, DropViewTask.java;
    # expansion happens in the planner) and schemas (CreateSchemaTask.java,
    # DropSchemaTask) --
    def _views_and_schemas(self, ast) -> QueryResult:
        name = getattr(ast, "name", "")
        name = name.lower() if name else name
        if isinstance(ast, t.CreateView):
            if name in self.matviews_mgr.views:
                raise ValueError(f"materialized view {name!r} already exists")
            if name in self.catalog.table_names():
                raise ValueError(f"table {name!r} already exists")
            if name in self.views and not ast.or_replace:
                raise ValueError(f"view {name!r} already exists")
            # validate now: the view text must parse AND plan — against
            # the NEW binding (name excluded), so OR REPLACE cannot store
            # a self-reference that only fails at first use
            vast = parse(ast.query_sql)
            if not isinstance(vast, t.Query):
                raise ValueError("CREATE VIEW requires a SELECT query")
            probe = {k: v for k, v in self.views.items() if k != name}
            Planner(self.catalog, views=probe).plan_query(vast, outer=None, ctes={})
            self.views[name] = ast.query_sql
            return self._row_count_result(0)
        if isinstance(ast, t.DropView):
            if name not in self.views:
                if ast.if_exists:
                    return self._row_count_result(0)
                raise ValueError(f"view {name!r} does not exist")
            del self.views[name]
            return self._row_count_result(0)
        if isinstance(ast, t.ShowCreateView):
            if name not in self.views:
                raise ValueError(f"view {name!r} does not exist")
            txt = f"CREATE VIEW {name} AS {self.views[name]}"
            return self._strings_result({"Create View": [txt]}, ("Create View",))
        if isinstance(ast, t.CreateSchema):
            if name in self.schemas:
                if ast.if_not_exists:
                    return self._row_count_result(0)
                raise ValueError(f"schema {name!r} already exists")
            self.schemas.add(name)
            return self._row_count_result(0)
        if isinstance(ast, t.DropSchema):
            if name == "default":
                raise ValueError("cannot drop the default schema")
            if name not in self.schemas:
                if ast.if_exists:
                    return self._row_count_result(0)
                raise ValueError(f"schema {name!r} does not exist")
            held = [tn for tn in self.catalog.table_names()
                    if tn.lower().startswith(name + ".")]
            if held:
                raise ValueError(f"schema {name!r} is not empty: {held}")
            self.schemas.discard(name)
            return self._row_count_result(0)
        return self._strings_result({"Schema": sorted(self.schemas)}, ("Schema",))

    def _show_metadata(self, ast) -> QueryResult:
        if isinstance(ast, t.ShowFunctions):
            # reference ShowQueriesRewrite SHOW FUNCTIONS over the
            # registry; one row per name, precedence aggregate > scalar >
            # lambda > window (sum/avg/min/max/count exist both as
            # aggregates and window reducers — Presto lists them once)
            from .expr.functions import FUNCTIONS
            from .ops.window import AGGREGATE, OFFSET, RANKING, VALUE
            from .sql.planner import AGG_FUNCS, LAMBDA_FUNCS, REWRITE_AGG_FUNCS

            kind_of = {}
            for n in RANKING | OFFSET | VALUE | AGGREGATE:
                kind_of[n] = "window"
            for n in LAMBDA_FUNCS:
                kind_of[n] = "lambda"
            for n in FUNCTIONS:
                kind_of[n] = "scalar"
            for n in AGG_FUNCS | REWRITE_AGG_FUNCS:
                kind_of[n] = "aggregate"
            keep = set(self._like_filter(list(kind_of), ast.like))
            rows = sorted((n, k) for n, k in kind_of.items() if n in keep)
            return self._strings_result({"Function": [r[0] for r in rows],
                                         "Kind": [r[1] for r in rows]}, ("Function", "Kind"))
        if isinstance(ast, t.ShowGrants):
            # the active rule set (reference: SHOW GRANTS reads
            # information_schema.table_privileges), filtered to rules
            # whose table pattern covers the named table
            import re

            rules = getattr(self.access_control, "rules", []) or []
            rows = [(r.user, r.table, r.privileges) for r in rules]
            if ast.table is not None:
                rows = [(u, tp, p) for (u, tp, p) in rows if re.fullmatch(tp, ast.table.lower())]
            return self._strings_result({"Grantee": [r[0] for r in rows],
                                         "Table": [r[1] for r in rows],
                                         "Privilege": [r[2] for r in rows]},
                                        ("Grantee", "Table", "Privilege"))
        if isinstance(ast, t.ShowCatalogs):
            return self._strings_result(
                {"Catalog": [str(getattr(self.catalog, "name", "default"))]}, ("Catalog",))
        name = ast.name.lower()
        if isinstance(ast, t.ShowCreateTable):
            if name in self.views:
                raise ValueError(f"{name!r} is a view; use SHOW CREATE VIEW")
            schema = self._table_schema(self.catalog, name)
            cols = ",\n   ".join(f"{c} {ty}" for c, ty in schema.items())
            txt = f"CREATE TABLE {name} (\n   {cols}\n)"
            return self._strings_result({"Create Table": [txt]}, ("Create Table",))
        return self._show_stats(name)

    def _show_stats(self, name: str) -> QueryResult:
        """SHOW STATS FOR (reference ShowStatsRewrite): per-column CBO
        statistics — NDV, null fraction, logical min/max — and a summary
        row with the table row count."""
        schema = self._table_schema(self.catalog, name)
        stats_fn = getattr(self.catalog, "column_stats", None)
        rows_total = None
        erc = getattr(self.catalog, "exact_row_count", None)
        if erc is not None:
            try:
                rows_total = float(erc(name))
            except Exception:  # noqa: BLE001 - summary is advisory
                rows_total = None
        cols, ndvs, nfs, lows, highs = [], [], [], [], []
        for c in schema:
            st = None
            if stats_fn is not None:
                try:
                    st = stats_fn(name, c)
                except Exception:  # noqa: BLE001 - per-column stats are advisory
                    st = None
            cols.append(c)
            ndvs.append(None if st is None else st.ndv)
            nfs.append(None if st is None else st.null_fraction)
            lows.append(None if st is None or st.min is None else str(st.min))
            highs.append(None if st is None or st.max is None else str(st.max))
        # summary row (column_name NULL, row_count set) — the reference's layout
        for col in (cols, ndvs, nfs, lows, highs):
            col.append(None)
        rc = [None] * (len(cols) - 1) + [rows_total]
        pg = Page.from_dict(
            {
                "column_name": cols,
                "distinct_values_count": _opt_f64(ndvs, self.device),
                "nulls_fraction": _opt_f64(nfs, self.device),
                "row_count": _opt_f64(rc, self.device),
                "low_value": lows,
                "high_value": highs,
            },
            device=self.device,
        )
        return QueryResult(pg, ("column_name", "distinct_values_count", "nulls_fraction",
                                "row_count", "low_value", "high_value"))

    # -- prepared statements (reference execution/PrepareTask.java,
    # DeallocateTask.java; DESCRIBE INPUT/OUTPUT statements) --
    def _prepared_statement(self, ast, user) -> QueryResult:
        if isinstance(ast, t.Prepare):
            parse(ast.statement_sql)  # must at least parse
            self.prepared[ast.name.lower()] = ast.statement_sql
            return self._row_count_result(0)
        if isinstance(ast, t.Deallocate):
            if self.prepared.pop(ast.name.lower(), None) is None:
                raise ValueError(f"prepared statement {ast.name!r} not found")
            return self._row_count_result(0)
        if isinstance(ast, t.ExecutePrepared):
            return self._execute_prepared(ast, user)
        past = parse(self._prepared_sql(ast.name))
        n_params = t.count_parameters(past)
        if isinstance(ast, t.DescribeInput):
            pg = Page.from_dict(
                {
                    "Position": np.arange(max(n_params, 1), dtype=np.int64),
                    "Type": ["unknown"] * max(n_params, 1),
                },
                device=self.device,
            )
            if n_params == 0:
                pg = Page(pg.blocks, pg.names, torch.zeros((), dtype=torch.int32,
                                                           device=self.device))
            return QueryResult(pg, ("Position", "Type"))
        past = t.substitute_parameters(past, tuple(t.NullLiteral() for _ in range(n_params)))
        if not isinstance(past, t.Query):
            return self._strings_result({"Column": [], "Type": []}, ("Column", "Type"))
        # column names/types are metadata: same privilege as reading
        # (SHOW COLUMNS enforces this; DESCRIBE OUTPUT must too)
        if self.access_control is not None:
            from .security import enforce

            enforce(self.access_control, user, past, views=self.views)
        rp = Planner(self.catalog, views=self.views).plan_query(past, outer=None, ctes={})
        return self._strings_result({"Column": [f.name for f in rp.scope.fields],
                                     "Type": [str(f.type) for f in rp.scope.fields]},
                                    ("Column", "Type"))

    def _prepared_sql(self, name: str) -> str:
        sql = self.prepared.get(name.lower())
        if sql is None:
            raise ValueError(f"prepared statement {name!r} not found")
        return sql

    # -- EXECUTE fast path (exec/qcache.py plan skeletons) --

    def _execute_prepared(self, ast: t.ExecutePrepared, user) -> QueryResult:
        """EXECUTE binds USING values as TYPED CONSTANTS into a cached
        plan skeleton: N executions of one dashboard statement parse and
        plan once, and identical (statement, values, snapshot) executions
        serve straight from the result cache. There is no text
        substitution anywhere on this path — a string parameter is a
        varchar constant, never SQL."""
        past = parse(self._prepared_sql(ast.name))
        n_params = t.count_parameters(past)
        if len(ast.params) != n_params:
            raise ValueError(
                f"prepared statement {ast.name!r} expects {n_params} "
                f"parameters, got {len(ast.params)}"
            )
        bound = t.substitute_parameters(past, ast.params)
        # the BOUND statement passes the same enforcement a direct query
        # would (EXECUTE is not a privilege bypass)
        if self.access_control is not None:
            from .security import enforce

            enforce(self.access_control, user, bound, views=self.views)
        if not isinstance(bound, t.Query):
            return self._execute_statement(bound, user)
        # SET SESSION overrides apply to prepared executions the same as
        # to direct queries
        target = (self.with_properties(dict(self._session_overrides))
                  if self._session_overrides else self)
        node = target._plan_prepared(past, ast.params, bound)
        return target._execute_plan_cached(node)

    def _plan_prepared(self, past, params, bound: t.Query) -> N.PlanNode:
        """Plan an EXECUTE through the skeleton cache: parameters become
        param-tagged typed literals, the optimized plan is cached once
        per (statement, parameter-type signature, planning env), and new
        values REBIND the cached tree instead of re-planning. Guards, in
        order: (1) the skeleton is only kept when every parameter index
        survives into the plan (a value consumed at plan time — LIMIT ?,
        a folded negation — disqualifies it), (2) the first rebind to new
        values is verified against one direct re-plan, then trusted,
        (3) anything non-rebindable falls back to the ordinary per-value
        plan cache."""
        from .exec import qcache

        if not self.plan_cache or not params:
            return self._plan_query_cached(bound)
        lits = [self._param_literal(p) for p in params]
        if any(lv is None for lv in lits):
            # non-literal USING expressions: per-value plan cache only
            return self._plan_query_cached(bound)
        values = tuple(lv.value for lv in lits)
        sig = tuple(str(lv.type) for lv in lits)
        key = ("x", past, sig, self._plan_env_key())
        ent = qcache.PLAN_CACHE.lookup(key, self.catalog)
        if ent is not None and ent.rebindable:
            if values == ent.values0:
                return ent.plan
            plan = qcache.rebind_plan(ent.plan, values)
            if not ent.verified:
                direct = self._plan_query_uncached(bound)
                if qcache.strip_params(plan) == direct:
                    ent.verified = True
                else:
                    ent.rebindable = False
                    return direct
            return plan
        if ent is not None:  # known-non-rebindable statement shape
            return self._plan_query_cached(bound)
        wrapped = t.substitute_parameters(
            past, tuple(t.BoundParameter(i, p) for i, p in enumerate(params)))
        try:
            skel = self._plan_query_uncached(wrapped)
        except Exception:  # noqa: BLE001 — param in a literal-only spot
            skel = None
        rebindable = skel is not None and (
            qcache.collect_param_indices(skel) == set(range(len(params))))
        if not rebindable:
            fallback = self._plan_query_cached(bound)
            qcache.PLAN_CACHE.store(key, fallback, self.catalog, rebindable=False,
                                    values0=values)
            return fallback
        qcache.PLAN_CACHE.store(key, skel, self.catalog, rebindable=True, verified=False,
                                values0=values)
        return skel

    @staticmethod
    def _param_literal(node):
        """Plan one USING argument as a typed ir constant (mirrors the
        planner's literal cases), or None when it is not a plain literal."""
        from .expr import ir
        from .sql.planner import _number_literal, _parse_timestamp_literal

        if isinstance(node, t.UnaryOp) and node.op == "-" and isinstance(
            node.operand, t.NumberLiteral
        ):
            lit = _number_literal(node.operand.text)
            if not isinstance(lit.value, (int, float)):
                return None  # Decimal lanes stay symbolic (planner parity)
            return ir.Literal(-lit.value, lit.type)
        if isinstance(node, t.NumberLiteral):
            return _number_literal(node.text)
        if isinstance(node, t.StringLiteral):
            return ir.Literal(node.value, T.VARCHAR)
        if isinstance(node, t.BooleanLiteral):
            return ir.Literal(node.value, T.BOOLEAN)
        if isinstance(node, t.NullLiteral):
            return ir.Literal(None, T.UNKNOWN)
        if isinstance(node, t.DateLiteral):
            return ir.Literal(node.value, T.DATE)
        if isinstance(node, t.TimestampLiteral):
            return ir.Literal(_parse_timestamp_literal(node.value), T.TIMESTAMP)
        if isinstance(node, t.IntervalLiteral):
            n = int(node.value) * (-1 if node.negative else 1)
            if node.unit in ("year", "month"):
                months = n * (12 if node.unit == "year" else 1)
                return ir.Literal(months, T.INTERVAL_YEAR_MONTH)
            if node.unit == "day":
                return ir.Literal(n, T.INTERVAL_DAY)
        return None

    @staticmethod
    def _literal_value(node):
        if isinstance(node, t.StringLiteral):
            return node.value
        if isinstance(node, t.NumberLiteral):
            return node.text
        if isinstance(node, t.BooleanLiteral):
            return node.value
        raise ValueError("SET SESSION requires a literal value")

    def _alter_table(self, ast) -> QueryResult:
        """ALTER TABLE against a writable connector: metadata-only ops are
        a page rewrite + replace (the in-memory connectors have no
        separate metadata store)."""
        from .ops.union import null_block
        from .page import intern_dictionary

        cat = self._writable()
        name = (ast.name if isinstance(ast, t.RenameTable) else ast.table).lower()
        if name not in cat.table_names():
            raise ValueError(f"table {name!r} does not exist")
        page = cat.page(name)
        if isinstance(ast, t.RenameTable):
            new = ast.new_name.lower()
            if new in cat.table_names() or new in self.views:
                raise ValueError(f"table {new!r} already exists")
            cat.create_table_from_page(new, page)
            cat.drop_table(name)
            return self._row_count_result(0)
        cols = list(page.names)
        blocks = list(page.blocks)
        if isinstance(ast, t.RenameColumn):
            old = ast.name.lower()
            new = ast.new_name.lower()
            if old not in cols:
                raise ValueError(f"column {old!r} does not exist")
            if new in cols:
                raise ValueError(f"column {new!r} already exists")
            cols[cols.index(old)] = new
        elif isinstance(ast, t.AddColumn):
            cname = ast.column.name.lower()
            if cname in cols:
                raise ValueError(f"column {cname!r} already exists")
            typ = T.parse_type(ast.column.type_name)
            # all NULL: zeros under an all-false validity, on the table's
            # device; a varchar column gets the empty dictionary
            did = intern_dictionary(()) if isinstance(typ, T.VarcharType) else None
            cols.append(cname)
            blocks.append(null_block(typ, page.capacity, did, page.device))
        elif isinstance(ast, t.DropColumn):
            cname = ast.name.lower()
            if cname not in cols:
                raise ValueError(f"column {cname!r} does not exist")
            if len(cols) == 1:
                raise ValueError("cannot drop the only column")
            i = cols.index(cname)
            del cols[i]
            del blocks[i]
        cat.replace(name, Page(tuple(blocks), tuple(cols), page.count))
        return self._row_count_result(0)

    def _create_table(self, ast: t.CreateTable) -> QueryResult:
        cat = self._writable()
        name = ast.name.lower()
        if name in self.views:
            # the planner resolves views first, so a same-named table
            # would be permanently shadowed — reject the collision both
            # ways (CREATE VIEW already checks tables)
            raise ValueError(f"view {name!r} already exists")
        if name in self.matviews_mgr.views:
            raise ValueError(f"materialized view {name!r} already exists")
        if name in cat.table_names():
            if ast.if_not_exists:
                return self._row_count_result(0)
            raise ValueError(f"table {name!r} already exists")
        if ast.query is None:
            schema = {}
            for col in ast.columns:
                cname = col.name.lower()
                if cname in schema:
                    raise ValueError(f"duplicate column {cname!r}")
                schema[cname] = T.parse_type(col.type_name)
            cat.create_table(name, schema)
            return self._row_count_result(0)
        page, titles = self._run_query_ast(ast.query)
        lowered = tuple(tl.lower() for tl in titles)
        if len(set(lowered)) != len(lowered):
            raise ValueError("CREATE TABLE AS requires unique column names")
        for tl, blk in zip(lowered, page.blocks):
            if isinstance(blk.type, T.UnknownType):
                raise ValueError(
                    f"CREATE TABLE AS column {tl!r} has unknown type "
                    "(all-NULL); cast it to a concrete type"
                )
        cat.create_table_from_page(name, Page(page.blocks, lowered, page.count))
        return self._row_count_result(int(page.count))

    def _insert(self, ast: t.Insert) -> QueryResult:
        from .expr import ir
        from .expr.compiler import project_page
        from .ops.union import null_block
        from .page import intern_dictionary

        cat = self._writable()
        name = ast.table.lower()
        schema = self._table_schema(cat, name)
        targets = tuple(c.lower() for c in ast.columns) if ast.columns else tuple(schema)
        if len(set(targets)) != len(targets):
            raise ValueError("duplicate column in INSERT target list")
        for c in targets:
            if c not in schema:
                raise ValueError(f"column {c!r} not in table {name!r}")
        page, _titles = self._run_query_ast(
            ast.query if isinstance(ast.query, t.Query) else t.Query(ast.query))
        if len(page.blocks) != len(targets):
            raise ValueError(f"INSERT has {len(page.blocks)} columns, expected {len(targets)}")
        # positional channels, then cast each source column to the target type
        chans = tuple(f"c{i}" for i in range(len(page.blocks)))
        page = Page(page.blocks, chans, page.count)
        exprs = []
        for ch, blk, col in zip(chans, page.blocks, targets):
            ref = ir.ColumnRef(ch, blk.type)
            want = schema[col]
            exprs.append(ref if blk.type == want else ir.cast(ref, want))
        cast_pg = project_page(page, tuple(exprs), targets)
        # assemble full-width page in table column order; unmentioned
        # columns are NULL
        by_name = dict(zip(targets, cast_pg.blocks))
        cap = cast_pg.capacity if cast_pg.blocks else 1
        blocks = []
        for col, ty in schema.items():
            if col in by_name:
                blocks.append(by_name[col])
            else:
                did = intern_dictionary(()) if isinstance(ty, T.VarcharType) else None
                blocks.append(null_block(ty, cap, did, page.device))
        n = int(page.count)
        cat.append(name, Page(tuple(blocks), tuple(schema), page.count))
        return self._row_count_result(n)

    def _delete(self, ast: t.Delete) -> QueryResult:
        """DELETE: the rows whose predicate is TRUE go. The predicate is
        planned as the WHERE of `SELECT <row number> FROM table`, so an IN
        or EXISTS subquery in it becomes a semi-join as in any query (the
        JAX package keeps the rows where CASE WHEN predicate THEN false
        ELSE true holds, where its planner refuses a subquery: ROADMAP
        queue 3); the row numbers it returns are dropped on the device."""
        from .ops.filter import compact
        from .ops.union import empty_page

        cat = self._writable()
        name = ast.table.lower()
        schema = self._table_schema(cat, name)
        page = cat.page(name)
        before = int(page.count)
        if ast.where is None:
            cat.replace(name, empty_page(schema, page.device))
            return self._row_count_result(before)
        cap = page.capacity
        row = Block(torch.arange(cap, dtype=torch.int64, device=page.device), T.BIGINT, None)
        numbered = _NumberedTable(self.catalog, name, Page(page.blocks + (row,),
                                                           page.names + (_ROW_NUMBER,),
                                                           page.count))
        sel = t.Select(items=(t.SelectItem(t.Identifier((_ROW_NUMBER,))),),
                       from_=t.Table(name), where=ast.where)
        rp = Planner(numbered, views=self.views).plan_query(t.Query(sel), outer=None, ctes={})
        from .plan.optimizer import optimize

        node = self._fragmented(optimize(N.Output(
            rp.node, tuple(f.channel for f in rp.scope.fields), (_ROW_NUMBER,))), numbered)
        ex = self._new_executor()
        ex.catalog = numbered
        victims = ex.run(node)
        # slot `cap` takes the padding rows of the victims page
        drop = torch.zeros(cap + 1, dtype=torch.bool, device=page.device)
        drop[torch.where(victims.live_mask(), victims.blocks[0].data.to(page.device), cap)] = True
        kept = compact(page, page.live_mask() & ~drop[:cap])
        cat.replace(name, kept)
        return self._row_count_result(before - int(kept.count))

    # -- EXPLAIN ANALYZE (reference ExplainAnalyzeOperator,
    # presto-main/.../execution/ExplainAnalyzeContext.java) --

    def explain_analyze_plan(self, node: N.PlanNode) -> str:
        """Execute the plan with per-operator accounting and render the
        annotated tree, then the dynamic-filter, caches and total lines.
        Each node's ms is host time (exec/stats.py); its row counts are
        read from the device once, after the run."""
        from .exec import qcache
        from .exec.stats import StatsCollector

        collector = StatsCollector()
        ex = self._new_executor(collector)
        t0 = time.perf_counter()
        ex.run(node)
        run_s = time.perf_counter() - t0
        collector.resolve()
        tree = N.plan_tree_str(node, collector=collector)
        # the streaming executor records each operator once per batch and
        # each sink inclusive of its input: the run's own wall is the total
        total_ms = (run_s if self.streaming else collector.total_wall_s()) * 1e3
        peak = collector.peak_bytes / (1024 * 1024)
        dyn_txt = ""
        snap = ex.dyn_ctx.snapshot()
        if snap["filters"]:
            filters = ", ".join(f"{fid}={d}" for fid, d in sorted(snap["filters"].items()))
            scan_p = sum(snap["scan_pruned"].values())
            pre_p = sum(snap["preprobe_pruned"].values())
            dyn_txt = (f"\n-- dynamic filters: {filters}; rows_pruned="
                       f"{scan_p + pre_p:,} (scan {scan_p:,}, pre-probe {pre_p:,})")
        mem_txt = memory_line(ex) if self.streaming and self.mesh is None else ""
        exch_txt = exchange_line(ex) if self.mesh is not None else ""
        # serving-cache counters: EXPLAIN ANALYZE itself always
        # re-executes, so these are the process-wide counters the
        # profiled query runs alongside
        cache_txt = "\n-- caches: " + qcache.format_summary(qcache.snapshot_all())
        # history-based feedback (plan/history.py): fold this run's
        # observed row counts into the store, then show the store's
        # counters — what history the query consumed and what it added
        feedback_txt = ""
        from .plan import history as H

        if H.feedback_on():
            H.HISTORY.record_plan(node, collector, self.catalog)
            fs = H.HISTORY.stats.snapshot()
            err = fs["mean_abs_rel_err"]
            feedback_txt = (f"\n-- feedback: hits={fs['hits']} misses={fs['misses']}"
                            f" records={fs['records']} est-err="
                            f"{'n/a' if err is None else f'{err:.2f}'}"
                            f" replans={fs['replans']}")
        # materialized-view freshness (matview/manager.py): which views
        # exist, delta or recompute maintenance, and how stale each is
        matview_txt = ""
        if self.matviews_mgr.views:
            matview_txt = "\n-- matview: " + self.matviews_mgr.format_summary()
        return (f"{tree}{dyn_txt}{mem_txt}{exch_txt}{cache_txt}{feedback_txt}{matview_txt}\n"
                f"-- total {total_ms:,.1f}ms, peak live output {peak:,.2f}MB")

    def explain_analyze(self, sql: str) -> str:
        return self.explain_analyze_plan(self.plan(sql))
