"""Statistics framework: per-column stats + derivation through plan nodes.

Re-designed equivalent of the reference's cost framework
(presto-main/.../cost/, 40 files: StatsCalculator.java,
FilterStatsCalculator.java, JoinStatsRule.java, and the connector stats
SPI feeding it). TPU-first reduction: ONE derivation function over the
frozen plan dataclasses producing `PlanStats` — estimated row count plus
per-channel `ColumnStats` (NDV / min / max / null fraction) — memoized per
walk. Consumers:

* the planner's join ordering (sql/planner.py FromPlanner picks the next
  relation by estimated JOIN OUTPUT, reference ReorderJoins),
* the fragmenter's broadcast-vs-repartition choice
  (plan/fragment.py, reference DetermineJoinDistributionType),
* EXPLAIN row estimates.

min/max are LOGICAL values (days for dates, unscaled-decimal / 10^scale,
None for varchar) so they compare directly against literal values.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

from .. import types as T
from ..expr import ir
from . import nodes as N

DEFAULT_FILTER_SELECTIVITY = 0.25
DEFAULT_EQ_SELECTIVITY = 0.05
DEFAULT_RANGE_SELECTIVITY = 0.35


@dataclasses.dataclass(frozen=True)
class ColumnStats:
    """Reference: spi/statistics/ColumnStatistics (+ the equi-depth
    histogram the reference derives in FilterStatsCalculator via
    StatisticRange — here carried explicitly)."""

    ndv: Optional[float] = None
    min: Optional[float] = None  # logical value; None = unknown/varchar
    max: Optional[float] = None
    null_fraction: float = 0.0
    # equi-depth boundaries (logical values at quantiles 0..1): rank of a
    # value interpolates to a selectivity without a uniformity assumption
    histogram: Optional[Tuple[float, ...]] = None

    def fraction_below(self, x: float) -> Optional[float]:
        """P[col <= x] over non-null rows, from the histogram when
        present, else linear between min/max."""
        h = self.histogram
        if h and len(h) >= 2:
            import bisect

            b = len(h) - 1
            i = bisect.bisect_right(h, x)
            if i == 0:
                return 0.0
            if i > b:
                return 1.0
            lo, hi = h[i - 1], h[i]
            inner = 0.0 if hi <= lo else (x - lo) / (hi - lo)
            return ((i - 1) + min(max(inner, 0.0), 1.0)) / b
        if self.min is None or self.max is None or self.max <= self.min:
            return None
        return min(max((x - self.min) / (self.max - self.min), 0.0), 1.0)

    def cap_ndv(self, rows: float) -> "ColumnStats":
        if self.ndv is None or self.ndv <= rows:
            return self
        return dataclasses.replace(self, ndv=max(rows, 1.0))


@dataclasses.dataclass(frozen=True)
class PlanStats:
    """Reference: cost/PlanNodeStatsEstimate."""

    rows: float
    columns: Dict[str, ColumnStats] = dataclasses.field(default_factory=dict)

    def column(self, ch: str) -> ColumnStats:
        return self.columns.get(ch, ColumnStats())

    def scaled(self, factor: float) -> "PlanStats":
        rows = max(self.rows * factor, 0.0)
        return PlanStats(
            rows, {c: s.cap_ndv(rows) for c, s in self.columns.items()}
        )


def literal_value(lit: ir.Literal) -> Optional[float]:
    """Logical ordering value of a literal (matches ColumnStats min/max)."""
    v = lit.value
    if v is None:
        return None
    t = lit.type
    if isinstance(t, T.DateType):
        if isinstance(v, str):
            import datetime as dt

            try:
                d = dt.date.fromisoformat(v)
            except ValueError:
                return None
            return float((d - dt.date(1970, 1, 1)).days)
        return float(v)
    if isinstance(t, T.VarcharType):
        return None
    try:
        return float(v)
    except (TypeError, ValueError):
        return None


class StatsDeriver:
    """One memoized derivation walk (reference StatsCalculator's rule set,
    collapsed into a visitor).

    With history-based feedback on (plan/history.py, PRESTO_TPU_FEEDBACK),
    every derived estimate is overridden by a validated OBSERVED row count
    for the node's semantic frame before it is memoized, so join
    reordering and build/probe-side selection run on measured rows. Pass
    use_history=False to force the static derivation (the baseline the
    feedback error compares against), use_history=True to consult the
    store whatever the knob says."""

    def __init__(self, catalog, use_history: Optional[bool] = None):
        self.catalog = catalog
        self._memo: Dict[int, PlanStats] = {}
        self._fp_memo: Dict[int, tuple] = {}
        self._history = None
        if use_history is not False:
            from . import history as H

            if use_history or H.feedback_on():
                self._history = H.HISTORY

    def stats(self, node: N.PlanNode) -> PlanStats:
        got = self._memo.get(id(node))
        if got is None:
            got = self._derive(node)
            if self._history is not None:
                got = self._observed(node, got)
            self._memo[id(node)] = got
        return got

    def _observed(self, node: N.PlanNode, ps: PlanStats) -> PlanStats:
        """Replace the estimated row count with the store's observation
        when one is live for this node's frame; column stats stay derived
        (history records counts, not distributions), their NDVs capped at
        the observed rows. A store fault propagates (the JAX package
        trips its adaptive_plan breaker and derives statically)."""
        from . import history as H

        fp = H.fingerprint(node, self._fp_memo)
        obs = self._history.observed_rows(fp, self.catalog)
        if obs is None:
            return ps
        return PlanStats(obs, {c: s.cap_ndv(obs) for c, s in ps.columns.items()})

    # -- per-node rules --

    def _derive(self, node: N.PlanNode) -> PlanStats:
        meth = getattr(self, f"_d_{type(node).__name__.lower()}", None)
        if meth is not None:
            return meth(node)
        if node.children:
            return self.stats(node.children[0])
        return PlanStats(1e6)

    def _d_tablescan(self, node: N.TableScan) -> PlanStats:
        try:
            rows = float(self.catalog.row_count(node.table))
        except Exception:
            return PlanStats(1e9)
        cols: Dict[str, ColumnStats] = {}
        get = getattr(self.catalog, "column_stats", None)
        if get is not None:
            for ch, src, _typ in node.columns:
                try:
                    cs = get(node.table, src)
                except Exception:  # noqa: BLE001 — connector stats are
                    # best-effort: a missing column simply has no stats
                    cs = None
                if cs is not None:
                    cols[ch] = cs
        return PlanStats(rows, cols)

    def _d_singlerow(self, node) -> PlanStats:
        return PlanStats(1.0)

    def _d_sample(self, node) -> PlanStats:
        child = self.stats(node.children[0])
        return dataclasses.replace(
            child, rows=max(child.rows * node.fraction, 1.0)
        )

    def _d_filter(self, node: N.Filter) -> PlanStats:
        return filter_stats(self.stats(node.child), node.predicate)

    def _d_project(self, node: N.Project) -> PlanStats:
        child = self.stats(node.child)
        cols = {}
        for nm, e in zip(node.names, node.exprs):
            if isinstance(e, ir.ColumnRef):
                cols[nm] = child.column(e.name)
        return PlanStats(child.rows, cols)

    def _d_aggregate(self, node: N.Aggregate) -> PlanStats:
        child = self.stats(node.child)
        if not node.group_exprs:
            return PlanStats(1.0)
        groups = 1.0
        cols = {}
        for nm, e in zip(node.group_names, node.group_exprs):
            cs = (
                child.column(e.name)
                if isinstance(e, ir.ColumnRef)
                else ColumnStats()
            )
            cols[nm] = cs
            groups *= cs.ndv if cs.ndv else max(child.rows / 10.0, 1.0)
            groups = min(groups, child.rows)
        rows = max(min(groups, child.rows), 1.0)
        return PlanStats(rows, {c: s.cap_ndv(rows) for c, s in cols.items()})

    def _d_distinct(self, node: N.Distinct) -> PlanStats:
        child = self.stats(node.child)
        groups = 1.0
        for f, _t in node.fields:
            cs = child.column(f)
            groups *= cs.ndv if cs.ndv else max(child.rows / 10.0, 1.0)
            groups = min(groups, child.rows)
        return PlanStats(max(groups, 1.0), dict(child.columns))

    def _d_join(self, node: N.Join) -> PlanStats:
        left, right = self.stats(node.left), self.stats(node.right)
        rows = join_output_rows(
            left, right, node.left_keys, node.right_keys, node.kind
        )
        cols = {**left.columns, **right.columns}
        return PlanStats(rows, {c: s.cap_ndv(rows) for c, s in cols.items()})

    def _d_semijoin(self, node: N.SemiJoin) -> PlanStats:
        child, source = self.stats(node.child), self.stats(node.source)
        if node.mark is not None:
            # mark joins filter NOTHING: every probe row passes through
            # plus a boolean membership column
            return PlanStats(child.rows, dict(child.columns))
        sel = 0.5
        if node.probe_keys and isinstance(node.probe_keys[0], ir.ColumnRef):
            pk = child.column(node.probe_keys[0].name)
            sk = (
                source.column(node.source_keys[0].name)
                if node.source_keys and isinstance(node.source_keys[0], ir.ColumnRef)
                else ColumnStats()
            )
            if pk.ndv and sk.ndv:
                sel = min(sk.ndv / pk.ndv, 1.0)
        if node.anti:
            sel = 1.0 - sel
        return child.scaled(max(sel, 0.01))

    def _d_union(self, node: N.Union) -> PlanStats:
        rows = sum(self.stats(c).rows for c in node.children)
        return PlanStats(max(rows, 1.0), dict(self.stats(node.children[0]).columns))

    def _d_limit(self, node: N.Limit) -> PlanStats:
        child = self.stats(node.child)
        return PlanStats(min(child.rows, float(node.count)), dict(child.columns))

    def _d_topn(self, node: N.TopN) -> PlanStats:
        child = self.stats(node.child)
        return PlanStats(min(child.rows, float(node.count)), dict(child.columns))

    def _d_unnest(self, node: N.Unnest) -> PlanStats:
        return self.stats(node.child).scaled(3.0)


def filter_stats(child: PlanStats, predicate) -> PlanStats:
    """FilterStatsCalculator: per-conjunct selectivity from column stats,
    narrowing the filtered column's range/NDV."""
    rows = child.rows
    cols = dict(child.columns)

    def conjuncts(e):
        if isinstance(e, ir.Call) and e.name == "and":
            for a in e.args:
                yield from conjuncts(a)
        else:
            yield e

    sel_total = 1.0
    for e in conjuncts(predicate):
        s = _conjunct_selectivity(e, cols)
        sel_total *= s
    rows = max(rows * sel_total, 0.0)
    return PlanStats(rows, {c: cs.cap_ndv(rows) for c, cs in cols.items()})


def _conjunct_selectivity(e, cols: Dict[str, ColumnStats]) -> float:
    if not isinstance(e, ir.Call):
        return 0.5
    if e.name == "or":
        s = 0.0
        for a in e.args:
            s = s + _conjunct_selectivity(a, dict(cols)) * (1 - s)
        return min(s, 1.0)
    if e.name == "not" and len(e.args) == 1:
        return 1.0 - _conjunct_selectivity(e.args[0], dict(cols))
    col, lit, op = _col_op_literal(e)
    if col is None:
        from ..sql.planner import _selectivity

        return _selectivity(e)
    cs = cols.get(col.name, ColumnStats())
    nn = 1.0 - cs.null_fraction
    if op == "eq":
        if lit is None:
            return DEFAULT_EQ_SELECTIVITY
        cols[col.name] = dataclasses.replace(
            cs, ndv=1.0, min=lit, max=lit, null_fraction=0.0
        )
        if cs.ndv:
            return nn / cs.ndv
        return DEFAULT_EQ_SELECTIVITY
    if op == "in":
        k = len(e.args) - 1
        if cs.ndv:
            return min(nn * k / cs.ndv, 1.0)
        return min(0.05 * k, 0.5)
    if op in ("lt", "le", "gt", "ge", "between"):
        if (
            lit is None
            or cs.min is None
            or cs.max is None
            or cs.max <= cs.min
        ):
            return DEFAULT_RANGE_SELECTIVITY
        # histogram-aware rank interpolation (reference
        # FilterStatsCalculator range estimation; equi-depth histogram
        # replaces the uniformity assumption where the sample derived
        # one). Fractions are CONDITIONED on the current [min, max] —
        # earlier conjuncts narrow min/max but keep the full-table
        # histogram, so renormalize to the surviving mass.
        f_lo = cs.fraction_below(cs.min) or 0.0
        f_hi = cs.fraction_below(cs.max)
        f_hi = 1.0 if f_hi is None else f_hi
        mass = max(f_hi - f_lo, 1e-12)

        def cond_below(x: float) -> float:
            f = cs.fraction_below(min(max(x, cs.min), cs.max))
            if f is None:
                return DEFAULT_RANGE_SELECTIVITY
            return min(max((f - f_lo) / mass, 0.0), 1.0)

        if op == "between":
            lo, hi = lit
            frac = max(cond_below(hi) - cond_below(lo), 0.0)
            cols[col.name] = dataclasses.replace(
                cs, min=max(lo, cs.min), max=min(hi, cs.max)
            )
        elif op in ("lt", "le"):
            frac = cond_below(lit)
            cols[col.name] = dataclasses.replace(cs, max=min(lit, cs.max))
        else:
            frac = 1.0 - cond_below(lit)
            cols[col.name] = dataclasses.replace(cs, min=max(lit, cs.min))
        return nn * min(max(frac, 0.0), 1.0)
    if op == "like":
        return 0.1
    return 0.5


def _col_op_literal(e: ir.Call):
    """Match (column op literal) in either direction; returns
    (ColumnRef|None, logical value, op). BETWEEN returns a (lo, hi) pair."""
    flip = {"lt": "gt", "le": "ge", "gt": "lt", "ge": "le", "eq": "eq"}
    if e.name == "between" and len(e.args) == 3:
        c, lo, hi = e.args
        if (
            isinstance(c, ir.ColumnRef)
            and isinstance(lo, ir.Literal)
            and isinstance(hi, ir.Literal)
        ):
            vlo, vhi = literal_value(lo), literal_value(hi)
            if vlo is not None and vhi is not None:
                return c, (vlo, vhi), "between"
        return None, None, None
    if e.name == "in":
        if e.args and isinstance(e.args[0], ir.ColumnRef):
            return e.args[0], None, "in"
        return None, None, None
    if e.name == "like" and isinstance(e.args[0], ir.ColumnRef):
        return e.args[0], None, "like"
    if e.name not in flip or len(e.args) != 2:
        return None, None, None
    a, b = e.args
    if isinstance(a, ir.ColumnRef) and isinstance(b, ir.Literal):
        return a, literal_value(b), e.name
    if isinstance(b, ir.ColumnRef) and isinstance(a, ir.Literal):
        return b, literal_value(a), flip[e.name]
    return None, None, None


def join_output_rows(
    left: PlanStats, right: PlanStats, left_keys, right_keys, kind: str
) -> float:
    """JoinStatsRule: |L x R| / prod(max(ndv_l, ndv_r)) per key pair
    (independence assumption), floored for outer kinds."""
    if not left_keys:
        rows = left.rows * right.rows  # cross join
    else:
        rows = left.rows * right.rows
        for lk, rk in zip(left_keys, right_keys):
            nl = (
                left.column(lk.name).ndv
                if isinstance(lk, ir.ColumnRef)
                else None
            )
            nr = (
                right.column(rk.name).ndv
                if isinstance(rk, ir.ColumnRef)
                else None
            )
            d = max(nl or 0.0, nr or 0.0)
            if d <= 0:
                d = max(min(left.rows, right.rows) / 10.0, 1.0)
            rows /= d
    rows = max(rows, 1.0)
    if kind == "left":
        rows = max(rows, left.rows)
    elif kind == "right":
        rows = max(rows, right.rows)
    elif kind == "full":
        rows = max(rows, left.rows + right.rows)
    return rows


def derive(node: N.PlanNode, catalog) -> PlanStats:
    """Entry point: stats for one plan tree (memoized within the call)."""
    return StatsDeriver(catalog).stats(node)


def storage_bounds(cs: ColumnStats, typ):
    """[lo, hi] in STORAGE units from a column's LOGICAL min/max stats —
    the keypack planner's input (ops/keypack.py). ColumnStats min/max are
    logical (scaled decimals divided out, dates as epoch days); bit
    packing operates on storage integers, so scale is multiplied back in
    with a +-1 margin against float rounding. Floats are returned as
    float bounds (the planner transforms them through the total-order
    map). None = unknown / unbounded — the column can't be
    stats-packed."""
    import math

    if cs is None or cs.min is None or cs.max is None:
        return None
    lo_f, hi_f = float(cs.min), float(cs.max)
    if not (math.isfinite(lo_f) and math.isfinite(hi_f)) or hi_f < lo_f:
        return None
    if isinstance(typ, (T.DoubleType, T.RealType)):
        return lo_f, hi_f
    scale = getattr(typ, "scale", 0) or 0
    mul = 10 ** scale
    return math.floor(lo_f * mul) - 1, math.ceil(hi_f * mul) + 1


def stats_from_column(
    data, valid, typ, dictionary, total_rows: int
) -> ColumnStats:
    """Compute ColumnStats from a (possibly sampled) host column. NDV
    scales up linearly when the sample looks key-like (>50% distinct) —
    the standard low/high-cardinality split. min/max are LOGICAL values
    (scaled decimals divided out, dates as epoch days); varchar columns
    get NDV only."""
    import numpy as np

    data = np.asarray(data)
    n = len(data)
    null_fraction = 0.0
    if valid is not None:
        valid = np.asarray(valid)
        null_fraction = float(1.0 - valid.mean()) if n else 0.0
        data = data[valid]
    if data.size == 0:
        return ColumnStats(ndv=0.0, null_fraction=null_fraction)
    if data.ndim == 2:  # long-decimal lanes: logical = hi*2^32 + lo
        data = data[:, 0].astype(np.float64) * float(1 << 32) + data[
            :, 1
        ].astype(np.float64)
    d = float(len(np.unique(data)))
    if dictionary is not None:
        return ColumnStats(
            ndv=min(d, float(len(dictionary))), null_fraction=null_fraction
        )
    ndv = d
    if total_rows > n and d / max(len(data), 1) > 0.5:
        ndv = d * (total_rows / n)
    scale = getattr(typ, "scale", None)
    div = float(10**scale) if scale else 1.0
    hist = None
    if data.size >= 64:
        # 32-bucket equi-depth boundaries from the sample (reference:
        # the StatisticRange-based estimates FilterStatsCalculator makes;
        # an explicit histogram replaces the uniformity assumption)
        qs = np.quantile(data, np.linspace(0.0, 1.0, 33))
        hist = tuple(float(q) / div for q in qs)
    return ColumnStats(
        ndv=ndv,
        min=float(data.min()) / div,
        max=float(data.max()) / div,
        null_fraction=null_fraction,
        histogram=hist,
    )
