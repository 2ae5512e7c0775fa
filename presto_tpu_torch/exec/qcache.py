"""Query-serving caches: the repeated-traffic fast path (torch
counterpart of presto_tpu/exec/qcache.py, plan and result caches).

Re-designed equivalent of the reference's serving-side caches: prepared
statements + plan reuse (presto-main QueryPreparer / the analyzer's
parameter rewriting) and the per-split result caching of Presto's
`fragment-result-cache` (presto-main/.../operator/FragmentResultCache).

Three caches, all process-wide and observable:

* PLAN_CACHE   — (normalized statement AST, catalog identity, planning
  env, connector snapshot versions) -> optimized plan, for deterministic
  plans only. EXECUTE of a
  prepared statement stores a *skeleton* whose parameter literals are
  tagged (`ir.Literal.param`) so new parameter values rebind by a tree
  walk instead of a full re-plan.
* RESULT_CACHE — byte-bounded LRU of materialized result pages keyed on
  the executed plan + snapshot versions, the bound counted in device
  bytes (exec/stats.page_device_bytes). A hit returns the cached Page
  object itself. A connector without snapshot versioning
  (`table_version` -> None) is NEVER cached — stale reads are impossible
  by construction, not by TTL.

* HISTORY_CACHE — byte-bounded LRU under the feedback store
  (plan/history.py HistoryStore): observed row counts per plan frame.

The JAX package's cache of traced kernels has no counterpart: eager
PyTorch traces nothing, and the CUDA kernels are built once per process
(cuda_build.py).

A result entry records its tables' delta cursors (`tokens`, connector
delta_token(), e.g. the shard store's). When its tables moved by appends
only, a lookup PATCHES it from the (token, now] delta through the view
maintenance pipeline (matview/patch.py) instead of invalidating it: the
third verdict beside hit and invalidate.

Validity rule shared by the plan and result caches: every entry records
the tables it read and their connector snapshot versions AT PLAN/EXECUTE
time (read BEFORE execution, so a concurrent writer can only ever make a
fresh entry unservable, never a served entry stale), plus a weakref to
the catalog object so an id()-recycled catalog can never alias.
"""

from __future__ import annotations

import dataclasses
import os
import threading
import weakref
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Tuple


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, "") or default)
    except ValueError:
        return default


# ---------------------------------------------------------------------------
# generic bounded LRU with stats
# ---------------------------------------------------------------------------


class CacheStats:
    __slots__ = (
        "hits", "misses", "stores", "evictions", "invalidations", "bytes",
        "patches",
    )

    def __init__(self):
        self.hits = 0
        self.misses = 0
        self.stores = 0
        self.evictions = 0
        self.invalidations = 0  # version-bump / identity-mismatch drops
        self.bytes = 0
        self.patches = 0  # stale entries updated in place from deltas

    def snapshot(self) -> dict:
        total = self.hits + self.misses
        return {
            "hits": self.hits,
            "misses": self.misses,
            "stores": self.stores,
            "evictions": self.evictions,
            "invalidations": self.invalidations,
            "bytes": self.bytes,
            "patches": self.patches,
            "hit_rate": round(self.hits / total, 4) if total else None,
        }


class LRUCache:
    """Thread-safe bounded LRU. Entries carry a byte size so the cache can
    be bounded by entries, bytes, or both. max_entries/max_bytes of 0
    disables the cache entirely (get always misses, put is a no-op)."""

    def __init__(self, max_entries: Optional[int] = None,
                 max_bytes: Optional[int] = None, name: str = "cache"):
        self.max_entries = max_entries
        self.max_bytes = max_bytes
        self.name = name
        self.stats = CacheStats()
        self._lock = threading.Lock()
        self._data: "OrderedDict[Any, Tuple[Any, int]]" = OrderedDict()

    @property
    def enabled(self) -> bool:
        return self.max_entries != 0 and self.max_bytes != 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._data)

    def get(self, key, count: bool = True):
        with self._lock:
            ent = self._data.get(key)
            if ent is None:
                if count:
                    self.stats.misses += 1
                return None
            self._data.move_to_end(key)
            if count:
                self.stats.hits += 1
            return ent[0]

    def put(self, key, value, nbytes: int = 0) -> None:
        if not self.enabled:
            return
        with self._lock:
            old = self._data.pop(key, None)
            if old is not None:
                self.stats.bytes -= old[1]
            self._data[key] = (value, nbytes)
            self.stats.bytes += nbytes
            self.stats.stores += 1
            self._evict_locked()

    def _evict_locked(self) -> None:
        while self._data and (
            (self.max_entries is not None
             and len(self._data) > self.max_entries)
            or (self.max_bytes is not None
                and self.stats.bytes > self.max_bytes)
        ):
            _k, (_v, nb) = self._data.popitem(last=False)
            self.stats.bytes -= nb
            self.stats.evictions += 1

    def invalidate(self, key) -> None:
        with self._lock:
            ent = self._data.pop(key, None)
            if ent is not None:
                self.stats.bytes -= ent[1]
                self.stats.invalidations += 1

    def reset(self) -> None:
        """Drop every entry AND zero the counters. The stats swap must
        happen under the lock: a concurrent store() holds the lock while
        it increments stats.bytes, and swapping the object between its
        insert and its increment strands the increment on the old stats
        — leaving the NEW stats claiming 0 bytes for a non-empty map."""
        with self._lock:
            self._data.clear()
            self.stats = CacheStats()

    def snapshot(self) -> dict:
        out = self.stats.snapshot()
        with self._lock:
            out["entries"] = len(self._data)
        out["max_entries"] = self.max_entries
        out["max_bytes"] = self.max_bytes
        return out


# ---------------------------------------------------------------------------
# snapshot-version validity
# ---------------------------------------------------------------------------


def table_versions(catalog, tables) -> Optional[Tuple[int, ...]]:
    """Snapshot-version vector for `tables`, or None when ANY table (or the
    catalog itself) lacks versioning — the uncacheable-never-stale rule."""
    fn = getattr(catalog, "table_version", None)
    if fn is None:
        return None
    out = []
    for tname in tables:
        try:
            v = fn(tname)
        except Exception:  # noqa: BLE001 — dropped table etc.: uncacheable
            return None
        if v is None:
            return None
        out.append(int(v))
    return tuple(out)


def delta_tokens(catalog, tables) -> Optional[Tuple[Any, ...]]:
    """Per-table delta cursors (connector delta_token(), e.g. the shard
    store's seq high-water marks), or None when any table's connector
    cannot produce one. Tokens make a result entry PATCHABLE: on a version
    mismatch the cache applies the (token, now] delta instead of evicting
    (the matview maintenance pipeline)."""
    fn = getattr(catalog, "delta_token", None)
    if fn is None:
        return None
    out = []
    for tname in tables:
        try:
            tok = fn(tname)
        except Exception:  # noqa: BLE001 — dropped table: not patchable
            return None
        if tok is None:
            return None
        out.append(tok)
    return tuple(out)


def _walk(obj, visit) -> None:
    """Generic traversal over plan/expression trees: `visit(leaf)` on
    every node, recursing through dataclass fields and tuples (the only
    containers plan nodes and RowExpressions use)."""
    visit(obj)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            _walk(getattr(obj, f.name), visit)
    elif isinstance(obj, tuple):
        for v in obj:
            _walk(v, visit)


def plan_tables(node) -> Tuple[str, ...]:
    """Every connector table a plan reads (TableScan walk through all
    dataclass fields, so scalar-subquery plans are covered too)."""
    from ..plan import nodes as N

    seen: List[str] = []

    def visit(obj):
        if isinstance(obj, N.TableScan) and obj.table not in seen:
            seen.append(obj.table)

    _walk(node, visit)
    return tuple(seen)


def plan_is_deterministic(node) -> bool:
    """False when the plan contains TABLESAMPLE or a context-dependent
    function (random/now/...): such results must never be served twice."""
    from ..expr import ir
    from ..plan import nodes as N
    from ..plan.rules import _NONDETERMINISTIC

    ok = [True]

    def visit(obj):
        if isinstance(obj, N.Sample) or (
            isinstance(obj, ir.Call) and obj.name in _NONDETERMINISTIC
        ):
            ok[0] = False

    _walk(node, visit)
    return ok[0]


# ---------------------------------------------------------------------------
# parameter-skeleton rebinding (EXECUTE fast path)
# ---------------------------------------------------------------------------
#
# The planner tags literals that came from EXECUTE parameters with their
# parameter index (ir.Literal.param). A cached skeleton plan is rebound to
# new values by a pure tree walk; plan-shape safety comes from three
# guards: (1) param-tagged literals are opaque to constant folding and
# value-sensitive rules (plan/rules.py), (2) a skeleton is only cached
# when EVERY parameter index survives into the plan (a value consumed at
# plan time — LIMIT ?, folded negation — disqualifies it), and (3) the
# first rebind to genuinely new values is verified against a direct
# re-plan once, then trusted.


def _walk_rebuild(obj, fn):
    """Generic rebuild over plan/expression dataclass trees and tuples.
    `fn(leaf)` returns a replacement or the leaf itself."""
    new = fn(obj)
    if new is not obj:
        return new
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        changes = {}
        for f in dataclasses.fields(obj):
            v = getattr(obj, f.name)
            nv = _walk_rebuild(v, fn)
            if nv is not v:
                changes[f.name] = nv
        return dataclasses.replace(obj, **changes) if changes else obj
    if isinstance(obj, tuple):
        newt = tuple(_walk_rebuild(v, fn) for v in obj)
        if any(a is not b for a, b in zip(newt, obj)):
            return newt
        return obj
    return obj


def collect_param_indices(node) -> set:
    from ..expr import ir

    found: set = set()

    def visit(obj):
        if isinstance(obj, ir.Literal) and obj.param is not None:
            found.add(obj.param)

    _walk(node, visit)
    return found


def rebind_plan(node, values: Tuple[Any, ...]):
    """Swap every param-tagged literal's value for values[param]."""
    from ..expr import ir

    def fn(obj):
        if isinstance(obj, ir.Literal) and obj.param is not None:
            v = values[obj.param]
            if v != obj.value:  # NaN != NaN: always replaced, still right
                return dataclasses.replace(obj, value=v)
        return obj

    return _walk_rebuild(node, fn)


def strip_params(node):
    """Drop param tags (for equality comparison against a direct plan)."""
    from ..expr import ir

    def fn(obj):
        if isinstance(obj, ir.Literal) and obj.param is not None:
            return dataclasses.replace(obj, param=None)
        return obj

    return _walk_rebuild(node, fn)


# ---------------------------------------------------------------------------
# plan cache
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class PlanEntry:
    plan: Any
    tables: Tuple[str, ...]
    versions: Tuple[int, ...]
    catalog_ref: Any  # weakref.ref to the catalog (identity guard)
    # EXECUTE skeletons only:
    rebindable: bool = False
    verified: bool = False
    values0: Optional[Tuple[Any, ...]] = None  # values the skeleton planned with


class SnapshotValidatedCache(LRUCache):
    """LRU whose entries carry (tables, versions, catalog weakref) and are
    only served while the catalog object is the same AND every table's
    connector snapshot version still matches — the ONE staleness rule
    both the plan and result caches share."""

    def lookup(self, key, catalog):
        ent = self.get(key, count=False)
        if ent is None:
            with self._lock:
                self.stats.misses += 1
            return None
        if ent.catalog_ref() is not catalog or (
            table_versions(catalog, ent.tables) != ent.versions
        ):
            self.invalidate(key)
            with self._lock:
                self.stats.misses += 1
            return None
        with self._lock:
            self.stats.hits += 1
        return ent


class PlanCache(SnapshotValidatedCache):
    def __init__(self, max_entries: int):
        super().__init__(max_entries=max_entries, name="plan")

    def store(self, key, plan, catalog, **kw) -> Optional[PlanEntry]:
        """Cache `plan` keyed by `key` iff every referenced table reports a
        snapshot version (unversioned -> uncacheable, never stale) and the
        plan is deterministic: TABLESAMPLE draws its seed at plan time, so
        a cached plan would draw the same rows on every run (the JAX
        package caches it and varies the rows only through its executor's
        per-node sample offsets, which this package keeps per query)."""
        if not self.enabled or not plan_is_deterministic(plan):
            return None
        tables = plan_tables(plan)
        versions = table_versions(catalog, tables)
        if versions is None:
            return None
        try:
            ref = weakref.ref(catalog)
        except TypeError:
            return None
        ent = PlanEntry(plan, tables, versions, ref, **kw)
        self.put(key, ent)
        return ent


# ---------------------------------------------------------------------------
# result cache
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ResultEntry:
    page: Any
    titles: Tuple[str, ...]
    tables: Tuple[str, ...]
    versions: Tuple[int, ...]
    catalog_ref: Any
    nbytes: int = 0
    # per-table delta cursors recorded with the entry; None = the entry
    # can only hit or invalidate, never patch
    tokens: Optional[Tuple[Any, ...]] = None


class ResultCache(SnapshotValidatedCache):
    def __init__(self, max_bytes: int):
        super().__init__(max_bytes=max_bytes, name="result")

    def preversions(self, plan, catalog):
        """(tables, versions, tokens) read BEFORE execution — the ordering
        that makes a concurrent write waste the entry instead of staling
        it — or None when any table is unversioned (bypass). Tokens are
        read AFTER the version vector; store() keeps them only when the
        versions still match after the run, which pins the executed data
        to exactly the tokens' snapshot (a later delta can never count
        rows twice that raced in during the run)."""
        tables = plan_tables(plan)
        versions = table_versions(catalog, tables)
        if versions is None:
            return None
        return (tables, versions, delta_tokens(catalog, tables))

    def store(self, key, page, titles, catalog, pre) -> None:
        if not self.enabled or pre is None:
            return
        from .stats import page_device_bytes

        try:
            ref = weakref.ref(catalog)
        except TypeError:
            return
        nbytes = int(page_device_bytes(page))
        if self.max_bytes is not None and nbytes > self.max_bytes:
            return  # bigger than the whole cache: not worth thrashing
        tables, versions, tokens = pre
        if tokens is not None and table_versions(catalog, tables) != versions:
            # a writer raced the run: the page may hold rows newer than
            # the tokens claim, and a patch from them would apply those
            # rows twice — keep the entry but make it unpatchable
            tokens = None
        self.put(key, ResultEntry(page, tuple(titles), tables, versions,
                                  ref, nbytes, tokens), nbytes=nbytes)

    def lookup(self, key, catalog):
        """Hit / patch / invalidate: the snapshot-validated lookup plus a
        third verdict — an entry whose base tables moved by appends only
        is brought up to date IN PLACE from the (token, now] delta when
        its plan (key[1]) is delta-patchable, instead of being evicted.
        patch_entry returns None where patching does not apply (no
        tokens, a rewrite, a receding cursor, DeltaUnavailable, a delta
        too large); any other fault propagates and fails the query."""
        ent = self.get(key, count=False)
        if ent is None:
            with self._lock:
                self.stats.misses += 1
            return None
        if ent.catalog_ref() is not catalog:
            self.invalidate(key)
            with self._lock:
                self.stats.misses += 1
            return None
        if table_versions(catalog, ent.tables) == ent.versions:
            with self._lock:
                self.stats.hits += 1
            return ent
        patched = None
        if ent.tokens is not None and len(key) >= 2:
            from ..matview.patch import patch_entry

            patched = patch_entry(key[1], ent, catalog)
        if patched is not None:
            self.put(key, patched, nbytes=patched.nbytes)
            with self._lock:
                self.stats.patches += 1
                self.stats.hits += 1
            return patched
        self.invalidate(key)
        with self._lock:
            self.stats.misses += 1
        return None


# ---------------------------------------------------------------------------
# process-wide instances
# ---------------------------------------------------------------------------

PLAN_CACHE = PlanCache(_env_int("PRESTO_TPU_PLAN_CACHE_ENTRIES", 256))
RESULT_CACHE = ResultCache(_env_int("PRESTO_TPU_RESULT_CACHE_BYTES", 64 << 20))
# observed-row-count feedback entries (plan/history.py HistoryStore),
# bounded like the JAX package's: an entry is a few hundred bytes
HISTORY_CACHE = LRUCache(
    max_entries=_env_int("PRESTO_TPU_FEEDBACK_ENTRIES", 8192),
    max_bytes=_env_int("PRESTO_TPU_FEEDBACK_BYTES", 4 << 20),
    name="history",
)


def snapshot_all() -> Dict[str, dict]:
    return {
        "plan": PLAN_CACHE.snapshot(),
        "result": RESULT_CACHE.snapshot(),
        "history": HISTORY_CACHE.snapshot(),
    }


def format_summary(snap: Dict[str, dict]) -> str:
    """One-line cache summary for EXPLAIN ANALYZE."""
    parts = []
    for name in ("plan", "result", "history"):
        s = snap.get(name)
        if s is None:
            continue
        line = f"{name} {s['hits']}h/{s['misses']}m/{s['evictions']}e"
        if s.get("patches"):
            line += f"/{s['patches']}p"
        if s.get("bytes"):
            line += f" {s['bytes']:,}B"
        parts.append(line)
    return ", ".join(parts)


def reset_all() -> None:
    """Test hook: drop every cached entry AND zero the counters."""
    for c in (PLAN_CACHE, RESULT_CACHE, HISTORY_CACHE):
        c.reset()
    # the feedback store layers a generation counter and its own stats
    # over HISTORY_CACHE; reset those too, or a cleared cache would keep
    # serving a stale generation to the executors' estimate caches
    from ..plan import history

    history.HISTORY.reset()
