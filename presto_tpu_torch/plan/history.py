"""History-based feedback: the store of observed row counts (torch
counterpart of presto_tpu/plan/history.py; reference: Presto's
history-based optimizer, presto-main/.../cost/
HistoryBasedPlanStatisticsCalculator and the
HistoricalStatisticsEquivalentPlanMarkingOptimizer that keys plans by
canonical form).

The engine measures the truth of every run — EXPLAIN ANALYZE's per-node
row counts, the hybrid join's partitions and recursion, matview refresh
walls. This module keeps it for the next plan:

* `fingerprint(node)` — a SEMANTIC key for a plan subtree, not a
  positional one. A join frame digests the UNORDERED set of relational
  atoms beneath it (base relations, applied predicates, barrier
  sub-plans), so `(A ⋈ B) ⋈ C` and `A ⋈ (B ⋈ C)` agree on the final
  frame {A,B,C} while each intermediate keeps its own key: the greedy
  join orderer evaluates candidate subtrees that never ran in that shape,
  and they must still hit observations recorded from the shape that did.
  Literals bound from EXECUTE parameters (`ir.Literal.param`) contribute
  their type only, the plan cache's skeleton rule.
* `HistoryStore` — a process-wide, byte-bounded LRU
  (exec/qcache.HISTORY_CACHE) of per-frame observations: rows, the static
  estimate at record time, hybrid-join partition/recursion outcomes,
  matview refresh walls. Entries record the tables they depend on and
  their connector snapshot versions; a `table_version` bump invalidates
  on the next lookup (unversioned connectors are never recorded). A
  monotone `generation` bumps on every record and invalidation, so plan
  and estimate caches keyed on it never serve estimates derived from a
  superseded history.
* Misprediction decay — when a fresh observation deviates >= 2x from the
  stored one, the entry is counted against; two strikes drop it.

Consumers: plan/stats.StatsDeriver (join ordering, build/probe sides),
exec/stream hybrid-join sizing and matview/manager's delta-vs-full
decision, all behind the PRESTO_TPU_FEEDBACK knob (server/knobs.py). The
JAX package also gates them on its `adaptive_plan` breaker, which reverts
to static plans after repeated faults; the port has no breaker, and a
fault in the store propagates. AdaptiveReplan is raised by the JAX
package's coordinator (ROADMAP queue 1 item 9).
"""

from __future__ import annotations

import dataclasses
import hashlib
import threading
import weakref
from typing import Dict, Optional, Tuple

from ..exec.qcache import HISTORY_CACHE, plan_tables, table_versions
from ..expr import ir
from ..server import knobs
from . import nodes as N

# deviation factor that counts as a misprediction, and how many strikes
# drop the entry (decay): history that keeps disagreeing with reality
# must stop steering plans
MISPREDICT_FACTOR = 2.0
MISPREDICT_LIMIT = 2
# EMA weight of the newest observation when refreshing a live entry
_EMA = 0.5
# nominal per-entry size for the byte bound (a frozen dataclass of
# scalars and small tuples)
_ENTRY_BYTES = 256


# ---------------------------------------------------------------------------
# semantic plan-subtree fingerprints
# ---------------------------------------------------------------------------


def _expr_atom(e) -> str:
    """Canonical digest text of an expression. Param-tagged literals are
    opaque (type only): one skeleton, one history key, any bound value."""
    if isinstance(e, ir.ColumnRef):
        return f"c:{e.name}"
    if isinstance(e, ir.Literal):
        if e.param is not None:
            return f"p:{e.type}"
        return f"l:{e.value!r}"
    if isinstance(e, ir.Call):
        inner = ",".join(_expr_atom(a) for a in e.args)
        return f"f:{e.name}({inner})"
    if isinstance(e, ir.Lambda):
        return f"lam:{_expr_atom(e.body)}"
    return f"e:{type(e).__name__}"


def _digest(head: str, atoms) -> str:
    h = hashlib.sha1(head.encode())
    for a in sorted(atoms):
        h.update(b"\x00")
        h.update(a.encode())
    return f"{head.split(':', 1)[0]}:{h.hexdigest()[:20]}"


# node classes whose observed output rows are worth recording (everything
# else either preserves its child's count or is trivially bounded)
_RECORDABLE = (
    N.TableScan, N.Filter, N.Join, N.SemiJoin, N.Aggregate, N.Distinct,
    N.Union,
)


def _frame(node, memo: Dict[int, tuple]) -> tuple:
    """(fingerprint|None, atom frozenset, deterministic) for a subtree.

    Atom sets flow upward through row-preserving nodes; barrier nodes
    (aggregates, limits, ...) collapse their subtree into one opaque atom,
    so a join above them still has an order-invariant frame. A
    nondeterministic subtree (TABLESAMPLE) poisons every ancestor's
    fingerprint: its observed counts are not reusable."""
    got = memo.get(id(node))
    if got is not None:
        return got
    out = _frame_uncached(node, memo)
    memo[id(node)] = out
    return out


def _frame_uncached(node, memo) -> tuple:
    if isinstance(node, N.TableScan):
        atoms = frozenset({f"rel:{node.catalog}.{node.table}"})
        return _digest("rel", atoms), atoms, True
    if isinstance(node, N.Filter):
        _fp, atoms, det = _frame(node.child, memo)
        atoms = atoms | {f"pred:{_expr_atom(node.predicate)}"}
        return (_digest("rel", atoms) if det else None), atoms, det
    if isinstance(node, N.Join):
        _lfp, latoms, ldet = _frame(node.left, memo)
        _rfp, ratoms, rdet = _frame(node.right, memo)
        det = ldet and rdet
        atoms = latoms | ratoms
        if node.kind != "inner":
            atoms = atoms | {f"outer:{node.kind}"}
        if node.residual is not None:
            atoms = atoms | {f"pred:{_expr_atom(node.residual)}"}
        return (_digest("join", atoms) if det else None), atoms, det
    if isinstance(node, N.SemiJoin):
        _cfp, catoms, cdet = _frame(node.child, memo)
        sfp, _satoms, sdet = _frame(node.source, memo)
        det = cdet and sdet
        keys = ",".join(_expr_atom(k) for k in node.probe_keys)
        atoms = catoms | {f"semi:{int(node.anti)}:{node.mark}:{sfp}:{keys}"}
        return (_digest("rel", atoms) if det else None), atoms, det
    if isinstance(node, N.Aggregate):
        cfp, _catoms, det = _frame(node.child, memo)
        groups = sorted(_expr_atom(e) for e in node.group_exprs)
        fp = _digest("agg", [f"src:{cfp}"] + [f"g:{g}" for g in groups])
        return (fp if det else None), frozenset({f"sub:{fp}"}), det
    if isinstance(node, N.Distinct):
        cfp, _catoms, det = _frame(node.child, memo)
        fields = sorted(f for f, _t in node.fields)
        fp = _digest("agg", [f"src:{cfp}", "distinct"] + [f"g:{f}" for f in fields])
        return (fp if det else None), frozenset({f"sub:{fp}"}), det
    if isinstance(node, N.Union):
        subs = [_frame(c, memo) for c in node.children]
        det = all(d for _f, _a, d in subs)
        fp = _digest("union", [f"src:{f}" for f, _a, _d in subs])
        return (fp if det else None), frozenset({f"sub:{fp}"}), det
    if isinstance(node, N.Sample):
        # sampled counts are per-seed noise: never recorded, never reused
        _f, atoms, _d = _frame(node.child, memo)
        return None, atoms | {"sample"}, False
    if isinstance(node, (N.Limit, N.TopN)):
        cfp, _catoms, det = _frame(node.child, memo)
        fp = _digest("limit", [f"src:{cfp}", f"n:{node.count}"])
        return None, frozenset({f"sub:{fp}"}), det
    children = node.children
    if len(children) == 1:
        # row-preserving pass-through (Project/Sort/Window/Output/...):
        # same frame, same fingerprint as the child
        return _frame(children[0], memo)
    if not children:
        return None, frozenset({f"leaf:{type(node).__name__}"}), True
    subs = [_frame(c, memo) for c in children]
    det = all(d for _f, _a, d in subs)
    fp = _digest(f"op:{type(node).__name__}", [f"src:{f}" for f, _a, _d in subs])
    return None, frozenset({f"sub:{fp}"}), det


def fingerprint(node, memo: Optional[Dict[int, tuple]] = None) -> Optional[str]:
    """Semantic history key for one plan subtree (None = not keyable:
    nondeterministic, or a node kind with nothing worth recording). Pass
    a shared `memo` dict when fingerprinting many nodes of one tree: the
    walk is then linear in the tree, not quadratic."""
    return _frame(node, memo if memo is not None else {})[0]


# ---------------------------------------------------------------------------
# the store
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class HistoryEntry:
    """One observed frame. rows is an EMA over observations; est_rows is
    the STATIC estimate at first record time. hybrid_* / delta_per_row_s /
    full_wall_s are the execution-setup channels (exec/stream.py,
    matview/manager.py)."""

    rows: Optional[float]
    est_rows: Optional[float]
    n: int
    tables: Tuple[str, ...]
    versions: Tuple[int, ...]
    catalog_ref: object  # weakref.ref
    kind: str = ""
    mispredicts: int = 0
    hybrid_parts: int = 0
    hybrid_depth: int = 0
    delta_per_row_s: Optional[float] = None
    full_wall_s: Optional[float] = None


class FeedbackStats:
    """Counters of the feedback store (EXPLAIN ANALYZE's `-- feedback:`
    footer renders the snapshot)."""

    __slots__ = (
        "hits", "misses", "records", "invalidations", "decays",
        "mispredictions", "replans", "err_sum", "err_n", "_lock",
    )

    def __init__(self):
        self._lock = threading.Lock()
        self.reset()

    def reset(self) -> None:
        with self._lock:
            self.hits = 0
            self.misses = 0
            self.records = 0
            self.invalidations = 0
            self.decays = 0
            self.mispredictions = 0
            self.replans = 0
            self.err_sum = 0.0  # sum of |est-observed| / max(observed, 1)
            self.err_n = 0

    def snapshot(self) -> dict:
        with self._lock:
            total = self.hits + self.misses
            return {
                "hits": self.hits,
                "misses": self.misses,
                "records": self.records,
                "invalidations": self.invalidations,
                "decays": self.decays,
                "mispredictions": self.mispredictions,
                "replans": self.replans,
                "hit_rate": round(self.hits / total, 4) if total else None,
                "mean_abs_rel_err": (
                    round(self.err_sum / self.err_n, 4) if self.err_n else None
                ),
            }


class HistoryStore:
    """Record/lookup over exec/qcache.HISTORY_CACHE with the snapshot-
    version validity rule of the plan and result caches, plus the
    generation counter the estimate caches key on."""

    def __init__(self, cache=HISTORY_CACHE):
        self.cache = cache
        self.stats = FeedbackStats()
        self._lock = threading.Lock()
        self._generation = 0

    @property
    def generation(self) -> int:
        return self._generation

    def _bump(self) -> None:
        with self._lock:
            self._generation += 1

    def reset(self) -> None:
        self.cache.reset()
        self.stats.reset()
        self._bump()

    @staticmethod
    def _key(fp: str, catalog) -> str:
        """Store key: fingerprint scoped by catalog identity. One process
        serves many catalogs and fingerprints hash table NAMES only, so
        two catalogs with a same-named table would otherwise clobber each
        other's observations; the entry's weakref still guards against
        id() reuse after the owner is collected."""
        return f"{fp}@{id(catalog):x}"

    # -- write side --

    def record(self, fp: Optional[str], *, catalog, tables,
               rows: Optional[float] = None,
               est_rows: Optional[float] = None, kind: str = "",
               hybrid: Optional[Tuple[int, int]] = None,
               delta_per_row_s: Optional[float] = None,
               full_wall_s: Optional[float] = None) -> bool:
        """Fold one observation into the store. Unversioned tables are
        never recorded (their entries could not be invalidated). A rows
        observation that contradicts a live entry >= MISPREDICT_FACTOR
        counts a strike; MISPREDICT_LIMIT strikes decay the entry."""
        if fp is None:
            return False
        tables = tuple(tables)
        versions = table_versions(catalog, tables)
        if versions is None:
            return False
        key = self._key(fp, catalog)
        old = self.cache.get(key, count=False)
        live = (
            old is not None
            and old.catalog_ref() is catalog
            and old.tables == tables
            and old.versions == versions
        )
        with self.stats._lock:
            self.stats.records += 1
            if rows is not None and est_rows is not None:
                self.stats.err_sum += min(abs(est_rows - rows) / max(rows, 1.0), 100.0)
                self.stats.err_n += 1
        if live and rows is not None and old.rows is not None:
            hi, lo = max(rows, old.rows, 1.0), max(min(rows, old.rows), 1.0)
            if hi / lo >= MISPREDICT_FACTOR:
                with self.stats._lock:
                    self.stats.mispredictions += 1
                if old.mispredicts + 1 >= MISPREDICT_LIMIT:
                    self.cache.invalidate(key)
                    with self.stats._lock:
                        self.stats.decays += 1
                    self._bump()
                    return True
                old = dataclasses.replace(old, mispredicts=old.mispredicts + 1)
        if live:
            new = dataclasses.replace(
                old,
                rows=(
                    old.rows if rows is None else
                    rows if old.rows is None else
                    old.rows * (1 - _EMA) + rows * _EMA
                ),
                est_rows=old.est_rows if est_rows is None else (
                    old.est_rows if old.est_rows is not None else est_rows
                ),
                n=old.n + 1,
                kind=old.kind or kind,
                hybrid_parts=hybrid[0] if hybrid else old.hybrid_parts,
                hybrid_depth=hybrid[1] if hybrid else old.hybrid_depth,
                delta_per_row_s=(
                    delta_per_row_s if delta_per_row_s is not None else old.delta_per_row_s
                ),
                full_wall_s=full_wall_s if full_wall_s is not None else old.full_wall_s,
            )
        else:
            new = HistoryEntry(
                rows=rows, est_rows=est_rows, n=1, tables=tables,
                versions=versions, catalog_ref=weakref.ref(catalog),
                kind=kind,
                hybrid_parts=hybrid[0] if hybrid else 0,
                hybrid_depth=hybrid[1] if hybrid else 0,
                delta_per_row_s=delta_per_row_s,
                full_wall_s=full_wall_s,
            )
        self.cache.put(key, new, nbytes=_ENTRY_BYTES)
        self._bump()
        return True

    # -- read side --

    def lookup(self, fp: Optional[str], catalog) -> Optional[HistoryEntry]:
        """Validated entry for a fingerprint, or None. Stale entries
        (catalog identity or any table_version moved) are dropped HERE:
        the lookup is the invalidation point, as in the plan cache."""
        if fp is None:
            return None
        key = self._key(fp, catalog)
        ent = self.cache.get(key, count=False)
        if ent is None:
            with self.stats._lock:
                self.stats.misses += 1
            return None
        if (
            # owner collected (and its id() reused): unverifiable
            ent.catalog_ref() is not catalog
            or table_versions(catalog, ent.tables) != ent.versions
        ):
            self.cache.invalidate(key)
            with self.stats._lock:
                self.stats.invalidations += 1
                self.stats.misses += 1
            self._bump()
            return None
        with self.stats._lock:
            self.stats.hits += 1
        return ent

    def observed_rows(self, fp: Optional[str], catalog) -> Optional[float]:
        ent = self.lookup(fp, catalog)
        return None if ent is None or ent.rows is None else float(ent.rows)

    def wants_observation(self, root, catalog) -> bool:
        """True when the plan has at least one recordable frame without a
        live entry — the observe-once policy: a plan whose frames are all
        remembered never pays for the collector-instrumented run."""
        memo: Dict[int, tuple] = {}
        missing = [False]

        def visit(n):
            if missing[0] or not isinstance(n, _RECORDABLE):
                return
            fp = fingerprint(n, memo)
            if fp is None:
                return
            ent = self.cache.get(self._key(fp, catalog), count=False)
            if (
                ent is None
                or ent.rows is None
                or ent.catalog_ref() is not catalog
                or table_versions(catalog, ent.tables) != ent.versions
            ):
                missing[0] = True

        _walk_plan(root, visit)
        return missing[0]

    def record_plan(self, root, collector, catalog) -> int:
        """Fold one executed plan's collector measurements into the store
        (the query-completion hook). Returns the entries recorded."""
        collector.resolve()
        memo: Dict[int, tuple] = {}
        deriver = _static_deriver(catalog)
        done = 0

        def visit(n):
            nonlocal done
            if not isinstance(n, _RECORDABLE):
                return
            ns = collector.lookup(n)
            if ns is None or not ns.calls:
                return
            fp = fingerprint(n, memo)
            if fp is None:
                return
            tables = plan_tables(n)
            if not tables:
                return
            est = float(deriver.stats(n).rows)
            if self.record(fp, catalog=catalog, tables=tables,
                           rows=float(ns.rows_out), est_rows=est,
                           kind=type(n).__name__):
                done += 1

        _walk_plan(root, visit)
        return done

    def rows_snapshot(self, limit: int = 256):
        """(fingerprint, entry) pairs, most recently used last."""
        with self.cache._lock:
            items = list(self.cache._data.items())[-limit:]
        return [(k.rsplit("@", 1)[0], v) for k, (v, _nb) in items]


def _walk_plan(node, visit) -> None:
    visit(node)
    for c in node.children:
        _walk_plan(c, visit)


def _static_deriver(catalog):
    from .stats import StatsDeriver

    return StatsDeriver(catalog, use_history=False)


# ---------------------------------------------------------------------------
# gating + process-wide instance
# ---------------------------------------------------------------------------


def feedback_on() -> bool:
    """The one gate every consumer checks: the PRESTO_TPU_FEEDBACK knob
    (the JAX package also asks its adaptive_plan breaker, which the port
    does not have)."""
    return knobs.feedback_enabled()


def plan_env_token() -> int:
    """History generation for plan-environment cache keys; a constant
    when feedback is off, so toggling the knob also re-plans."""
    return HISTORY.generation if feedback_on() else -1


class AdaptiveReplan(RuntimeError):
    """Raised at an exchange boundary when a stage's observed output
    contradicts its estimate grossly enough that the downstream plan is
    presumed wrong (the JAX package's coordinator raises it; the port's
    waits for ROADMAP queue 1 item 9). NOT retryable by a same-plan
    retry loop: the session re-plans against the updated history."""

    retryable = False
    adaptive = True


HISTORY = HistoryStore()
