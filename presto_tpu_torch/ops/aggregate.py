"""Grouped and global aggregation (torch counterpart of
presto_tpu/ops/aggregate.py).

Re-designed equivalent of the reference's aggregation stack:
HashAggregationOperator + MultiChannelGroupByHash (presto-main/.../operator/
MultiChannelGroupByHash.java:54) and the compiled Accumulators
(operator/aggregation/AccumulatorCompiler.java).

Strategies here: the dense small-domain kernel (ops/groupby_kernel.py,
tried first by the executor), DIRECT (`grouped_aggregate_direct`, keys
that are small-domain codes, driven by the hand-coded benchmark
pipelines) and, for every other shape, SORT — hash the
group keys, sort rows by hash, detect run boundaries on the actual key
values (collisions stay distinct groups), dense group ids via cumsum, then
segment reductions. Output capacity = max_groups (a planner-provided
bound); the live group count is a device scalar.

Aggregate functions ported: count/count_star/sum/min/max/avg/checksum,
min_by/max_by, percentile (approx_percentile, exact by selection), the
HyperLogLog sketch (approx_distinct, approx_set, merge), the quantile
sketch (ops/qsketch.py), the central moments behind stddev, variance,
skewness and kurtosis (ops/moments.py), the collection aggregates
(array_agg, map_agg, histogram, map_union, multimap_agg,
numeric_histogram: padded (groups, width) blocks whose width the executor
grows on overflow, the `$collect_need` protocol) and the linear-regression
accumulators (ops/mlreg.py), with SQL null semantics (nulls don't
contribute; empty-group sum/min/max = NULL, count = 0).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import numpy as np
import torch

from .. import types as T
from ..expr.compiler import evaluate
from ..expr.functions import NotPortedError, Val, lane_compaction
from ..page import Block, Page, to_tensor
from .hashing import hash_rows, unsigned_order_key

PORTED = ("count", "count_star", "sum", "min", "max", "avg", "checksum",
          "min_by", "max_by", "percentile",
          "approx_distinct", "hll_registers", "hll_merge",
          "qsketch", "qsketch_merge",
          "cmoments", "cmoments_merge",
          "array_agg", "map_agg", "histogram", "map_union", "multimap_agg", "num_hist",
          "linreg", "linreg_acc", "linreg_merge")
# aggregates whose state is a per-group sketch or accumulator row
SKETCH_FUNCS = ("approx_distinct", "hll_registers", "hll_merge",
                "qsketch", "qsketch_merge", "cmoments", "cmoments_merge",
                "linreg", "linreg_acc", "linreg_merge")
# aggregates whose result is a padded collection block (reference
# ArrayAggregationFunction, MapAggregationFunction, HistogramAggregation,
# MapUnionAggregation, MultimapAggregationFunction,
# NumericHistogramAggregation)
COLLECTION_AGGS = ("array_agg", "map_agg", "histogram", "map_union", "multimap_agg",
                   "num_hist")


@dataclasses.dataclass(frozen=True)
class AggSpec:
    """One aggregate: func(input_expr [, key_expr]) AS name. `input2` is
    the ordering key of min_by/max_by (reference
    operator/aggregation/MinMaxByAggregations)."""

    func: str  # an aggregate the planner names (PORTED ones evaluate here)
    input: Optional[object]  # RowExpression; None for count_star
    name: str
    output_type: T.Type
    input2: Optional[object] = None

    @staticmethod
    def infer_output_type(func: str, input_type: Optional[T.Type]) -> T.Type:
        if func in ("count", "count_star", "checksum", "approx_distinct"):
            return T.BIGINT
        if func == "array_agg":
            return T.ArrayType(input_type)
        if func == "histogram":
            return T.MapType(input_type, T.BIGINT)
        if func in ("min", "max", "min_by", "max_by"):
            return input_type
        if func == "sum":
            if isinstance(input_type, T.DecimalType):
                # long decimal result (reference: sum(decimal) -> decimal(38,s))
                return T.DecimalType(38, input_type.scale)
            if T.is_floating(input_type):
                return T.DOUBLE
            return T.BIGINT
        if func == "avg":
            if isinstance(input_type, T.DecimalType):
                return input_type  # reference: avg(decimal) keeps the scale
            return T.DOUBLE
        raise KeyError(f"unsupported aggregate {func!r}")


def _require_ported(aggs: Sequence[AggSpec]) -> None:
    for a in aggs:
        if a.func not in PORTED:
            raise NotPortedError(f"not ported yet: aggregate {a.func!r}")


def min_identity(dtype):
    if dtype.is_floating_point:
        return float("inf")
    if dtype == torch.bool:
        return True
    return torch.iinfo(dtype).max


def max_identity(dtype):
    if dtype.is_floating_point:
        return float("-inf")
    if dtype == torch.bool:
        return False
    return torch.iinfo(dtype).min


def _segment_sum(x, gid, num_segments):
    out = torch.zeros((num_segments,) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
    return out.index_add_(0, gid.to(torch.int64), x)


def _segment_extreme(x, gid, num_segments, func: str):
    ident = min_identity(x.dtype) if func == "min" else max_identity(x.dtype)
    out = torch.full((num_segments,), ident, dtype=x.dtype, device=x.device)
    reduce = "amin" if func == "min" else "amax"
    return out.scatter_reduce_(0, gid.to(torch.int64), x, reduce, include_self=True)


def _segment_reduce(func, data, valid, gid, num_segments, wide: bool = False):
    """One aggregate over dense group ids; returns (values, group_has_value).

    wide=True accumulates sums in two int64 lanes (ops/decimal128.py) —
    exact beyond int64, the reference's decimal(38) sum path. Lane-shaped
    inputs (data.ndim == 2) stay wide."""
    from . import decimal128 as d128

    contributes = valid
    if func in ("count", "count_star"):
        return _segment_sum(contributes.to(torch.int64), gid, num_segments), None
    if func == "checksum":
        x = torch.where(contributes, data, torch.zeros_like(data))
        return _segment_sum(x, gid, num_segments), None
    masked_count = _segment_sum(contributes.to(torch.int64), gid, num_segments)
    has = masked_count > 0
    lanes_in = data.ndim == 2
    if func in ("sum", "avg"):
        if lanes_in or (wide and not data.is_floating_point()):
            lanes = data if lanes_in else d128.from_int64(data.to(torch.int64))
            lanes = torch.where(contributes[:, None], lanes, 0)
            s = d128.segment_sum_wide(lanes, gid, num_segments)
        else:
            contrib = torch.where(contributes, data, torch.zeros_like(data))
            s = _segment_sum(contrib, gid, num_segments)
        if func == "sum":
            return s, has
        return (s, masked_count), has
    if lanes_in:  # min/max over long decimal lanes: lexicographic two-pass
        ident = min_identity(data.dtype) if func == "min" else max_identity(data.dtype)
        hi = torch.where(contributes, data[:, 0], ident)
        lo = torch.where(contributes, data[:, 1], ident)
        best_hi = _segment_extreme(hi, gid, num_segments, func)
        on_best = contributes & (data[:, 0] == best_hi[gid.to(torch.int64)])
        lo2 = torch.where(on_best, lo, ident)
        best_lo = _segment_extreme(lo2, gid, num_segments, func)
        return torch.stack([best_hi, best_lo], dim=-1), has
    if func in ("min", "max"):
        ident = min_identity(data.dtype) if func == "min" else max_identity(data.dtype)
        contrib = torch.where(contributes, data, torch.full_like(data, ident))
        return _segment_extreme(contrib, gid, num_segments, func), has
    raise KeyError(func)


def avg_from_sum_count(s, cnt, output_type: T.Type, input_type: Optional[T.Type]):
    """Finalize avg from (sum, count): decimal HALF_UP in scaled units, else
    double division (descaling decimal inputs). Wide (two-lane) sums divide
    exactly via ops/decimal128.py (counts < 2^31)."""
    from . import decimal128 as d128

    safe = torch.clamp(cnt, min=1)
    if s.ndim == 2:  # exact long-decimal intermediate
        if isinstance(output_type, T.DecimalType) and output_type.is_long:
            return d128.from_int64(d128.ddiv_int64_half_up(s, safe))
        if isinstance(output_type, T.DecimalType):
            return d128.ddiv_int64_half_up(s, safe).to(output_type.storage_dtype)
        sd = d128.to_float64(s)
        if input_type is not None and isinstance(input_type, T.DecimalType):
            sd = sd / (10**input_type.scale)
        return (sd / safe).to(output_type.storage_dtype)
    if isinstance(output_type, T.DecimalType):
        data = torch.sign(s) * ((2 * torch.abs(s) + safe) // (2 * safe))
    else:
        sd = s.to(torch.float64)
        if input_type is not None and isinstance(input_type, T.DecimalType):
            sd = sd / (10**input_type.scale)
        data = sd / safe
    return data.to(output_type.storage_dtype)


def _finalize(spec: AggSpec, raw, has, input_type: Optional[T.Type], dict_id=None) -> Block:
    if spec.func == "avg":
        s, cnt = raw
        return Block(avg_from_sum_count(s, cnt, spec.output_type, input_type),
                     spec.output_type, has)
    if spec.func in ("count", "count_star"):
        return Block(raw.to(torch.int64), spec.output_type, None)
    # min/max over varchar operate on sorted-dictionary codes; keep the dict
    return Block(raw.to(spec.output_type.storage_dtype), spec.output_type, has, dict_id)


def _eval_inputs(page: Page, group_exprs, aggs):
    keys = [evaluate(e, page) for e in group_exprs]
    ins = []
    for a in aggs:
        if a.input is None:
            ins.append(None)
            continue
        v = evaluate(a.input, page)
        if a.func in ("min", "max") and isinstance(v.type, T.VarcharType):
            from ..expr.functions import require_sorted_dict

            require_sorted_dict(v, f"{a.func} aggregate")
        if a.func == "checksum":
            # pre-hash: checksum aggregates row hashes, nulls included.
            # Varchar hashes the STRING VALUES (host-hashed dictionary table)
            from .hashing import hash_column

            if isinstance(v.type, T.VarcharType):
                import hashlib

                d = v.dictionary or ()
                table = np.array(
                    [
                        int.from_bytes(
                            hashlib.blake2b(s.encode(), digest_size=8).digest(),
                            "little",
                        )
                        for s in d
                    ],
                    np.uint64,
                ).view(np.int64)
                hv = to_tensor(table, torch.int64, v.device)[v.data.to(torch.int64)]
                if v.valid is not None:
                    hv = torch.where(v.valid, hv, 0x9AE16A3B)
                v = Val(hv, None, T.BIGINT)
            else:
                v = Val(hash_column(v.data, v.valid), None, T.BIGINT)
        ins.append(v)
    return keys, ins


def _eval_by_keys(page: Page, aggs):
    """Ordering keys for min_by/max_by (AggSpec.input2), aligned with aggs."""
    out = []
    for a in aggs:
        if a.input2 is None or a.func == "percentile":
            out.append(None)
            continue
        k = evaluate(a.input2, page)
        if isinstance(k.type, T.VarcharType):
            from ..expr.functions import require_sorted_dict

            require_sorted_dict(k, f"{a.func} ordering key")
        if k.data.ndim == 2:
            raise NotImplementedError(f"{a.func} over a long-decimal ordering key")
        out.append(k)
    return out


def _reduce_by(func, value: Val, key: Val, contributes, gid, num_groups: int):
    """min_by/max_by: per group, the value at the extreme ordering key —
    best key per group, first row index attaining it, then a gather."""
    n = key.data.shape[0]
    gid = gid.to(torch.int64)
    kc = contributes if key.valid is None else (contributes & key.valid)
    if key.data.is_floating_point():
        kc = kc & ~torch.isnan(key.data)
    kind = "min" if func == "min_by" else "max"
    ident = min_identity(key.data.dtype) if kind == "min" else max_identity(key.data.dtype)
    kdat = torch.where(kc, key.data, torch.full_like(key.data, ident))
    best = _segment_extreme(kdat, gid, num_groups, kind)
    has = _segment_extreme(kc.to(torch.int32), gid, num_groups, "max") > 0
    candidate = kc & (kdat == best[torch.clamp(gid, max=num_groups - 1)])
    ridx = torch.where(candidate, torch.arange(n, device=gid.device), n)
    first = torch.full((num_groups,), n, dtype=torch.int64, device=gid.device)
    first = first.scatter_reduce_(0, gid, ridx, "amin", include_self=True)
    first = torch.clamp(first, max=n - 1)
    vdat = value.data[first]
    vval = has if value.valid is None else (has & value.valid[first])
    return vdat, vval


def _reduce_percentile(fraction: float, value: Val, contributes, gid, num_groups: int):
    """Exact percentile by selection: one composite sort by (group, value)
    with non-contributing rows pushed to each group's end, then a gather at
    first + round(p * (n-1)) per group. It meets approx_percentile's
    contract exactly (the reference uses a qdigest estimate,
    operator/aggregation/ApproximateLongPercentileAggregations)."""
    from .sort import asc_normalized_scalar_key

    data = value.data
    gid = gid.to(torch.int64)
    vc = contributes if value.valid is None else (contributes & value.valid)
    if data.ndim == 2:
        # long-decimal lanes: lexicographic (hi, lo) by two stable passes
        # (the canonical lo lane is non-negative, ops/decimal128.py)
        order = torch.argsort(data[:, 1], stable=True)
        order = order[torch.argsort(data[order, 0], stable=True)]
    else:
        norm = asc_normalized_scalar_key(data, True)
        if norm.is_floating_point():
            vc = vc & ~torch.isnan(norm)
        # stable three-pass composite sort: by value, contributing rows
        # first, then by group id; no sentinel values, so genuine extremes
        # never collide with excluded rows
        order = torch.argsort(norm, stable=True)
    order = order[torch.argsort((~vc)[order].to(torch.uint8), stable=True)]
    order = order[torch.argsort(gid[order], stable=True)]
    n = data.shape[0]
    pos = torch.arange(n, dtype=torch.int64, device=data.device)
    gid_o = gid[order]
    vc_o = vc[order]
    # contributing rows sit at each group's front: the group start is the
    # first contributing position
    first = torch.full((num_groups,), n, dtype=torch.int64, device=data.device)
    first = first.scatter_reduce_(0, gid_o, torch.where(vc_o, pos, n), "amin",
                                  include_self=True)
    cnt = _segment_sum(vc_o.to(torch.int64), gid_o, num_groups)
    has = cnt > 0
    last = torch.clamp(cnt - 1, min=0)
    off = torch.minimum(torch.round(fraction * last.to(torch.float64)).to(torch.int64), last)
    target = torch.clamp(first + off, max=n - 1)
    return data[order[target]], has


def positional_reduce(spec: AggSpec, value, by_key, contributes, gid, num_groups: int):
    """Dispatch for the positional aggregates (min_by/max_by/percentile)."""
    if spec.func == "percentile":
        return _reduce_percentile(float(spec.input2.value), value, contributes, gid,
                                  num_groups)
    return _reduce_by(spec.func, value, by_key, contributes, gid, num_groups)


def sketch_block(spec: AggSpec, data, valid, live, gid, num_groups: int,
                 value: Optional[Val] = None, label: Optional[Val] = None) -> Block:
    """The HyperLogLog, quantile-sketch, central-moments and regression
    aggregates of rows by group id `gid`: one block of `num_groups` rows,
    the estimate or the mergeable state. The regression aggregates take
    the feature array `value` and the label `label`, in `gid`'s row order
    (sorted)."""
    from . import moments as mo
    from . import qsketch as qs

    func = spec.func
    if func in ("linreg", "linreg_acc", "linreg_merge"):
        return _linreg_block(spec, data, valid, live, gid, num_groups, value, label)
    # hll_merge reads every live row's registers, as the reference does
    contributes = live if valid is None or func == "hll_merge" else (live & valid)
    if func in ("approx_distinct", "hll_registers"):
        regs = hll_group_registers(data, contributes, gid, num_groups)
        if func == "approx_distinct":
            return Block(hll_estimate(regs), T.BIGINT, None)
        return Block(regs, spec.output_type, None)
    if func == "hll_merge":
        return Block(hll_merge_registers(data, contributes, gid, num_groups),
                     spec.output_type, None)
    if func in ("qsketch", "qsketch_merge"):
        build = qs.group_sketch if func == "qsketch" else qs.merge_sketches
        return Block(build(data, contributes, gid, num_groups), T.ArrayType(T.BIGINT),
                     None)
    build = mo.group_moments if func == "cmoments" else mo.merge_moments
    acc = build(data, contributes, gid, num_groups)
    return Block(acc, T.ArrayType(T.DOUBLE), None,
                 lengths=torch.full((num_groups,), mo.ACC_WIDTH, dtype=torch.int32,
                                    device=acc.device))


def _linreg_block(spec, data, valid, live, gid, num_groups, value, label) -> Block:
    from . import mlreg

    contributes = live if valid is None else (live & valid)
    if spec.func == "linreg_merge":
        acc = mlreg.merge_accumulators(data, contributes, gid, num_groups)
    else:
        if label.valid is not None:
            contributes = contributes & label.valid
        lens = value.lengths
        if lens is None:
            lens = torch.full(data.shape[:1], data.shape[1], dtype=torch.int32,
                              device=data.device)
        acc = mlreg.group_accumulate(mlreg.logical_values(data, value.type), lens,
                                     mlreg.logical_values(label.data, label.type),
                                     contributes, gid, num_groups)
    has = None
    if spec.func == "linreg":
        acc, has = mlreg.solve_weights(acc)  # an empty group has a NULL model
    return Block(acc, T.ArrayType(T.DOUBLE), has,
                 lengths=torch.full(acc.shape[:1], acc.shape[1], dtype=torch.int32,
                                    device=acc.device))


# ---------------------------------------------------------------------------
# collection aggregates over rows sorted by group id: each group's rows are
# one contiguous run, gathered into a (groups, width) block. `width` is the
# executor's guess; each collector also returns the width it needed
# ---------------------------------------------------------------------------


def _sorted_val(v: Optional[Val], order) -> Optional[Val]:
    """A Val's rows in `order`, collection companions included."""
    if v is None:
        return None
    take = lambda x: None if x is None else x[order]  # noqa: E731
    keys = None
    if v.keys is not None:
        keys = Val(v.keys.data[order], None, v.keys.type, v.keys.dict_id)
    return Val(v.data[order], take(v.valid), v.type, v.dict_id, lengths=take(v.lengths),
               elem_valid=take(v.elem_valid), keys=keys)


def _run_bounds(gid_s, num_groups: int):
    """Per-group [start, count) of the contiguous runs in sorted order."""
    grange = torch.arange(num_groups, dtype=gid_s.dtype, device=gid_s.device)
    start = torch.searchsorted(gid_s, grange, side="left")
    end = torch.searchsorted(gid_s, grange, side="right")
    return start, end - start


def _window(start, counts, width: int, cap: int):
    """(groups, width) row positions of each run's first `width` rows and
    the mask of those inside the run."""
    j = torch.arange(width, device=start.device)
    pos = torch.clamp(start[:, None] + j[None, :], 0, max(cap - 1, 0))
    inb = j[None, :] < torch.clamp(counts, max=width)[:, None]
    return pos, inb


def collect_array_agg(v: Val, live_s, gid_s, num_groups: int, width: int):
    """array_agg: each group's run, in row order, as one padded row.
    Returns (block, needed width)."""
    start, counts = _run_bounds(gid_s, num_groups)
    pos, inb = _window(start, counts, width, gid_s.shape[0])
    ev = inb if v.valid is None else (inb & v.valid[pos])
    blk = Block(v.data[pos], T.ArrayType(v.type), None, v.dict_id,
                lengths=torch.clamp(counts, max=width).to(torch.int32), elem_valid=ev)
    return blk, counts.max()


def _pair_runs(gid_s, key_norm, contributes, num_groups: int):
    """Sort rows by (group, key hash) and find the distinct (group, key)
    runs: (perm, pair group id, pair first position, pair row count), pair
    arrays of row capacity (unused pairs carry group id num_groups)."""
    cap = gid_s.shape[0]
    gidc = torch.where(contributes, gid_s, num_groups)
    o1 = torch.argsort(unsigned_order_key(key_norm), stable=True)
    perm = o1[torch.argsort(gidc[o1], stable=True)]
    g2 = gidc[perm]
    k2 = key_norm[perm]
    boundary = torch.ones(cap, dtype=torch.bool, device=gid_s.device)
    if cap > 1:
        boundary[1:] = (g2[1:] != g2[:-1]) | (k2[1:] != k2[:-1])
    pair_id = torch.cumsum(boundary.to(torch.int64), 0) - 1
    ar = torch.arange(cap, device=gid_s.device)
    first_pos = torch.full((cap,), cap, dtype=torch.int64, device=gid_s.device)
    first_pos = first_pos.scatter_reduce_(0, pair_id, ar, "amin", include_self=True)
    pair_count = torch.zeros(cap, dtype=torch.int64, device=gid_s.device)
    pair_count.index_add_(0, pair_id, torch.ones_like(pair_id))
    pair_gid = torch.full((cap,), num_groups, dtype=torch.int64, device=gid_s.device)
    pair_gid = pair_gid.scatter(0, pair_id, g2.to(torch.int64))
    return perm, pair_gid, torch.clamp(first_pos, max=max(cap - 1, 0)), pair_count


def _pair_windows(kv: Val, live_s, gid_s, num_groups: int, width: int):
    """Distinct keys per group: (perm, first_row per pair, pair windows
    per group (ppos, inb), per-group pair counts, pair row counts)."""
    cap = gid_s.shape[0]
    contributes = live_s if kv.valid is None else (live_s & kv.valid)
    perm, pair_gid, first_pos, pair_count = _pair_runs(gid_s, hash_rows([kv]), contributes,
                                                       num_groups)
    # per-group range over the pair axis (pairs are sorted by group)
    pstart, pcounts = _run_bounds(pair_gid, num_groups)
    ppos, inb = _window(pstart, pcounts, width, cap)
    return perm, perm[first_pos], ppos, inb, pcounts, pair_count, first_pos


def collect_map_agg(spec, kv: Val, vv: Optional[Val], live_s, gid_s, num_groups: int,
                    width: int):
    """histogram / map_agg over sorted rows: the distinct keys of a group by
    a second (group, key) sort, in key-hash order; the values are the
    counts (histogram) or the value of a key's first row (map_agg).
    Returns (block, needed width)."""
    perm, first_row, ppos, inb, pcounts, pair_count, _ = _pair_windows(
        kv, live_s, gid_s, num_groups, width)
    lens = torch.clamp(pcounts, max=width).to(torch.int32)
    rows = first_row[ppos]
    kblk = Block(kv.data[rows], T.ArrayType(kv.type), None, kv.dict_id, lengths=lens,
                 elem_valid=inb)
    if spec.func == "histogram":
        vals, vtype, vdict, ev = pair_count[ppos], T.BIGINT, None, inb
    else:
        vals, vtype, vdict = vv.data[rows], vv.type, vv.dict_id
        ev = inb if vv.valid is None else (inb & vv.valid[rows])
    blk = Block(vals, T.MapType(kv.type, vtype), None, vdict, lengths=lens, elem_valid=ev,
                key_block=kblk)
    return blk, pcounts.max()


def collect_map_union(spec, mv: Val, live_s, gid_s, num_groups: int, width: int):
    """map_union over sorted rows: each row's map entries become (key,
    value) pseudo-rows for the map_agg machinery — the merged map keeps the
    first value seen per key (the reference keeps an arbitrary one)."""
    cap, w = mv.data.shape[0], mv.data.shape[1]
    lens = mv.lengths if mv.lengths is not None else torch.full(
        (cap,), w, dtype=torch.int32, device=mv.device)
    inb = torch.arange(w, device=mv.device)[None, :] < lens[:, None]
    live_x = live_s.repeat_interleave(w) & inb.reshape(-1)
    if mv.valid is not None:
        live_x = live_x & mv.valid.repeat_interleave(w)
    kv = Val(mv.keys.data.reshape(-1), None, mv.type.key, mv.keys.dict_id)
    ev = None if mv.elem_valid is None else mv.elem_valid.reshape(-1)
    vv = Val(mv.data.reshape(-1), ev, mv.type.value, mv.dict_id)
    return collect_map_agg(AggSpec("map_agg", None, spec.name, spec.output_type), kv, vv,
                           live_x, gid_s.repeat_interleave(w), num_groups, width)


def collect_multimap_agg(spec, kv: Val, vv: Val, live_s, gid_s, num_groups: int, width: int):
    """multimap_agg(k, v): map k -> ARRAY of every v seen with k (reference
    MultimapAggregationFunction). The values ride a 3-D (group, key,
    occurrence) block; the rows of a (group, key) pair are contiguous in
    the pair-sorted order, in row order."""
    cap = gid_s.shape[0]
    perm, first_row, ppos, inb, pcounts, pair_count, first_pos = _pair_windows(
        kv, live_s, gid_s, num_groups, width)
    lens = torch.clamp(pcounts, max=width).to(torch.int32)
    kblk = Block(kv.data[first_row[ppos]], T.ArrayType(kv.type), None, kv.dict_id,
                 lengths=lens, elem_valid=inb)
    e = torch.arange(width, device=gid_s.device)
    vpos = torch.clamp(first_pos[ppos][:, :, None] + e[None, None, :], 0, max(cap - 1, 0))
    vcnt = pair_count[ppos]
    rows3 = perm[vpos]
    ev3 = inb[:, :, None] & (e[None, None, :] < torch.clamp(vcnt, max=width)[:, :, None])
    if vv.valid is not None:
        ev3 = ev3 & vv.valid[rows3]
    blk = Block(vv.data[rows3], spec.output_type, None, vv.dict_id, lengths=lens,
                elem_valid=ev3, key_block=kblk)
    # only live windows count toward the retry width: clamped gathers past
    # a group's pairs read other pairs' counts
    return blk, torch.maximum(pcounts.max(), torch.where(inb, vcnt, 0).max())


def numeric_histogram_agg(spec, v: Val, contributes, gid, num_groups: int) -> Block:
    """numeric_histogram(b, x): an equal-width histogram over each group's
    [min, max] — bucket key = mean of its members, value = member count.
    The reference's NumericHistogramAggregation adapts its buckets while
    streaming; this is the JAX package's fixed-shape equivalent (same bucket
    count contract, deterministic boundaries)."""
    from ..expr.ir import Literal

    b = spec.input2
    buckets = int(b.value if isinstance(b, Literal) else b)
    x = v.data.to(torch.float64)
    if isinstance(v.type, T.DecimalType) and not v.type.is_long:
        x = x / (10 ** v.type.scale)
    g = gid.to(torch.int64)
    mn = torch.full((num_groups,), float("inf"), dtype=torch.float64, device=x.device)
    mn = mn.scatter_reduce_(0, g, torch.where(contributes, x, float("inf")), "amin",
                            include_self=True)
    mx = torch.full((num_groups,), float("-inf"), dtype=torch.float64, device=x.device)
    mx = mx.scatter_reduce_(0, g, torch.where(contributes, x, float("-inf")), "amax",
                            include_self=True)
    w = torch.clamp((mx - mn) / buckets, min=1e-300)
    bi = torch.clamp(torch.floor((x - mn[g]) / w[g]), 0, buckets - 1).to(torch.int64)
    bi = torch.where(contributes, bi, 0)  # dead rows' NaN/inf bins stay in range
    flat = g * buckets + bi
    cnt = torch.zeros(num_groups * buckets, dtype=torch.float64, device=x.device)
    cnt = cnt.index_add_(0, flat, contributes.to(torch.float64)).reshape(num_groups, buckets)
    sx = torch.zeros(num_groups * buckets, dtype=torch.float64, device=x.device)
    sx = sx.index_add_(0, flat, torch.where(contributes, x, 0.0)).reshape(num_groups, buckets)
    centers = sx / torch.clamp(cnt, min=1.0)
    # non-empty buckets to the front (empty buckets are absent from the map)
    occupied = cnt > 0
    order = lane_compaction(occupied)
    centers = torch.gather(centers, 1, order)
    weights = torch.gather(cnt, 1, order)
    lens = occupied.sum(dim=1, dtype=torch.int32)
    inb = torch.arange(buckets, device=x.device)[None, :] < lens[:, None]
    kblk = Block(centers, T.ArrayType(T.DOUBLE), None, None, lengths=lens, elem_valid=inb)
    return Block(weights, T.MapType(T.DOUBLE, T.DOUBLE), None, None, lengths=lens,
                 elem_valid=inb, key_block=kblk)


def collection_block(spec: AggSpec, v: Val, bk: Optional[Val], live_s, gid_s,
                     num_groups: int, width: int):
    """One collection aggregate over rows sorted by group id (`v`, `bk` in
    that order): (block of num_groups rows, needed width)."""
    if spec.func == "array_agg":
        return collect_array_agg(v, live_s, gid_s, num_groups, width)
    if spec.func in ("map_agg", "histogram"):
        return collect_map_agg(spec, v, bk, live_s, gid_s, num_groups, width)
    if spec.func == "map_union":
        return collect_map_union(spec, v, live_s, gid_s, num_groups, width)
    if spec.func == "multimap_agg":
        return collect_multimap_agg(spec, v, bk, live_s, gid_s, num_groups, width)
    contributes = live_s if v.valid is None else (live_s & v.valid)
    blk = numeric_histogram_agg(spec, v, contributes, gid_s, num_groups)
    return blk, torch.zeros((), dtype=torch.int64, device=gid_s.device)


# ---------------------------------------------------------------------------
# HyperLogLog (reference ApproximateCountDistinctAggregations + airlift
# HyperLogLog): registers from the value hash, so estimates equal the JAX
# package's exactly
# ---------------------------------------------------------------------------

HLL_P = 10  # 2^10 = 1024 registers; standard error 1.04/sqrt(m) ~ 3.25%
HLL_M = 1 << HLL_P


def _clz64(x):
    """Count leading zeros of the uint64 bits of an int64 tensor (binary
    search: at each step, if the top `shift` bits are zero, skip them)."""
    from .hashing import _srl

    is_zero = x == 0
    n = torch.zeros(x.shape, dtype=torch.int32, device=x.device)
    for shift in (32, 16, 8, 4, 2, 1):
        top_zero = _srl(x, 64 - shift) == 0
        n = n + torch.where(top_zero, shift, 0).to(torch.int32)
        x = torch.where(top_zero, x << shift, x)
    return torch.where(is_zero, 64, n)


def hll_row_registers(data, contributes):
    """(register index, rank) per row: the HLL insert decomposition."""
    from .hashing import _srl, hash_column

    h = hash_column(data, None)
    reg = _srl(h, 64 - HLL_P).to(torch.int32)
    rank = torch.clamp(_clz64(h << HLL_P) + 1, max=64 - HLL_P + 1).to(torch.int32)
    return torch.where(contributes, reg, -1), rank


def hll_group_registers(data, contributes, gid, num_groups: int):
    """Per-group register arrays (num_groups, HLL_M) int8: scatter-max of
    row ranks, the mergeable HLL state."""
    reg, rank = hll_row_registers(data, contributes)
    flat_idx = torch.where(reg >= 0, gid.to(torch.int64) * HLL_M + reg, num_groups * HLL_M)
    flat = torch.zeros(num_groups * HLL_M + 1, dtype=torch.int8, device=data.device)
    flat = flat.scatter_reduce_(0, flat_idx, rank.to(torch.int8), "amax", include_self=True)
    return flat[:-1].reshape(num_groups, HLL_M)


def hll_merge_registers(data_s, contributes, gid, num_groups: int):
    """Elementwise max-merge of register-array rows per group."""
    masked = torch.where(contributes[:, None], data_s, torch.zeros((), dtype=data_s.dtype,
                                                                   device=data_s.device))
    out = torch.zeros((num_groups, HLL_M), dtype=data_s.dtype, device=data_s.device)
    idx = gid.to(torch.int64)[:, None].expand(-1, HLL_M)
    return out.scatter_reduce_(0, idx, masked, "amax", include_self=True)


def hll_estimate(registers):
    """(num_groups, HLL_M) registers -> int64 estimates (HLL with the
    linear-counting small-range correction)."""
    m = float(HLL_M)
    alpha = 0.7213 / (1.0 + 1.079 / m)
    r = registers.to(torch.float64)
    raw = alpha * m * m / torch.exp2(-r).sum(dim=1)
    zeros = (registers == 0).sum(dim=1).to(torch.float64)
    linear = m * (math.log(m) - torch.log(torch.clamp(zeros, min=1.0)))
    est = torch.where((raw <= 2.5 * m) & (zeros > 0), linear, raw)
    return torch.round(est).to(torch.int64)


def _masked_live(page: Page, pre_mask) -> torch.Tensor:
    """Liveness restricted by a fused selection mask (Aggregate.mask)."""
    live = page.live_mask()
    if pre_mask is None:
        return live
    mv = evaluate(pre_mask, page)
    m = mv.data if mv.valid is None else (mv.data & mv.valid)
    return live & m


def _agg_contributes(v: Optional[Val], live):
    if v is None or v.valid is None:  # count(*) / no nulls
        return live
    return live & v.valid


def _wide_for(spec: AggSpec, v: Optional[Val]) -> bool:
    """Exact two-lane accumulation for decimal sums/averages (the decimal(38)
    path); float sums stay float, bigint sums keep int64."""
    return (
        v is not None
        and isinstance(v.type, T.DecimalType)
        and spec.func in ("sum", "avg")
    )


def _neq_adjacent(d):
    """Adjacent-row inequality with a leading True; lane columns (n, 2)
    differ if any lane differs."""
    neq = d[1:] != d[:-1]
    if neq.ndim == 2:
        neq = neq.any(dim=-1)
    return torch.cat([torch.ones(1, dtype=torch.bool, device=d.device), neq])


def _canon_cmp(d):
    """Canonical EQUALITY key for run detection: floats through the total
    order so ±0.0 tie and all NaNs compare equal."""
    if d.is_floating_point():
        from .sort import _float_total_order

        return _float_total_order(d)
    return d


def _neq_adjacent_nullaware(data, valid):
    """Adjacent-row inequality under SQL grouping semantics: a NULL differs
    from any non-NULL, two adjacent NULLs are EQUAL. Leading element True."""
    neq = _neq_adjacent(_canon_cmp(data))
    if valid is None:
        return neq
    f = torch.zeros(1, dtype=torch.bool, device=data.device)
    vneq = torch.cat([f, valid[1:] != valid[:-1]])
    both_null = torch.cat([f, (~valid[1:]) & (~valid[:-1])])
    return (neq & ~both_null) | vneq


def _mask_reduce(func, data, contributes, wide=False):
    """_segment_reduce for ONE group (the global aggregate) as plain masked
    reductions. Same return contract as _segment_reduce with G = 1."""
    from . import decimal128 as d128

    m = contributes
    cnt = m.sum(dtype=torch.int64).reshape(1)
    if func in ("count", "count_star"):
        return cnt, None
    if func == "checksum":
        return torch.where(m, data, 0).sum(dtype=torch.int64).reshape(1), None
    has = cnt > 0
    lanes_in = data.ndim == 2
    if func in ("sum", "avg"):
        if lanes_in or (wide and not data.is_floating_point()):
            lanes = data if lanes_in else d128.from_int64(data.to(torch.int64))
            x = torch.where(m[:, None], lanes, 0)
            hi, lo = d128.dnorm(x[:, 0].sum(), x[:, 1].sum())
            s = torch.stack([hi, lo]).reshape(1, 2)
        else:
            s = torch.where(m, data, torch.zeros_like(data)).sum().reshape(1)
        if func == "sum":
            return s, has
        return (s, cnt), has
    ident = min_identity(data.dtype) if func == "min" else max_identity(data.dtype)
    red = torch.amin if func == "min" else torch.amax
    if lanes_in:  # long decimal: lexicographic (hi, then lo among best-hi)
        hi, lo = data[:, 0], data[:, 1]
        best_hi = red(torch.where(m, hi, ident))
        best_lo = red(torch.where(m & (hi == best_hi), lo, ident))
        return torch.stack([best_hi, best_lo]).reshape(1, 2), has
    full = torch.full_like(data, ident)
    if data.numel() == 0:
        return torch.full((1,), ident, dtype=data.dtype, device=data.device), has
    return red(torch.where(m, data, full)).reshape(1), has


# ---------------------------------------------------------------------------
# DIRECT strategy (small-domain keys)
# ---------------------------------------------------------------------------


def direct_group_ids(keys: Sequence[Val], domains: Sequence[int], live):
    """Mixed-radix group id from non-null small-int codes."""
    gid = torch.zeros(live.shape, dtype=torch.int32, device=live.device)
    for v, dom in zip(keys, domains):
        if v.valid is not None:
            raise NotPortedError("not ported yet: nullable direct group key")
        gid = gid * dom + v.data.to(torch.int32)
    return gid


DIRECT_FUNCS = ("count", "count_star", "sum", "avg")
# sub-slots per group of the direct scatter: rows go round-robin over them,
# so the atomics of a hot group do not queue on one address
DIRECT_SPREAD = 64


def grouped_aggregate_direct(
    page: Page,
    group_exprs,
    group_names,
    aggs: Sequence[AggSpec],
    domains: Sequence[int],
    pre_mask=None,
) -> Page:
    """Aggregation when every key is a non-null code in [0, domain), for
    count/sum/avg over integer and decimal inputs. Every aggregate's
    channels (its contributing count where its input has nulls, its value
    or the value's two decimal lanes) go through ONE scatter-add by the
    mixed-radix group id, each group over DIRECT_SPREAD sub-slots summed
    after. Output rows are exactly the occupied combinations, compacted."""
    from . import decimal128 as d128
    from .filter import compact

    for a in aggs:
        if a.func not in DIRECT_FUNCS:
            raise NotPortedError(f"not ported yet: direct aggregate {a.func!r}")
    dev = page.device
    live = _masked_live(page, pre_mask)
    keys, ins = _eval_inputs(page, group_exprs, aggs)
    num_groups = math.prod(domains)
    # dead rows -> the overflow group num_groups, dropped below
    gid = torch.where(live, direct_group_ids(keys, domains, live), num_groups)

    # channel-major (width, n) sources: channel 0 counts live rows
    # (occupancy, and the count of every aggregate whose input has no nulls)
    chans, layout, width = [live.to(torch.int64)[None]], [], 1
    for spec, v in zip(aggs, ins):
        contributes = _agg_contributes(v, live)
        cnt_at = val_at = lanes = 0
        if v is not None and v.valid is not None:
            chans.append(contributes.to(torch.int64)[None])
            cnt_at, width = width, width + 1
        if spec.func in ("sum", "avg"):
            if v.data.is_floating_point():
                raise NotPortedError("not ported yet: direct sum of a float")
            x = v.data.to(torch.int64)
            if x.ndim == 2:
                x = x.T
            elif _wide_for(spec, v):  # d128.from_int64's lanes, channel-major
                x = torch.stack([x >> d128.RADIX_BITS, x & d128.MASK32])
            else:
                x = x[None]
            chans.append(torch.where(contributes, x, 0))
            val_at, lanes = width, x.shape[0]
            width += lanes
        layout.append((cnt_at, val_at, lanes))
    n = live.shape[0]
    slot = gid.to(torch.int64) * DIRECT_SPREAD + (
        torch.arange(n, device=dev) & (DIRECT_SPREAD - 1))
    acc = torch.zeros((width, (num_groups + 1) * DIRECT_SPREAD), dtype=torch.int64, device=dev)
    acc.index_add_(1, slot, torch.cat(chans))
    tot = acc.view(width, num_groups + 1, DIRECT_SPREAD).sum(dim=2)[:, :num_groups]

    blocks, names = [], []
    # group key columns: codes from the group id (mixed radix)
    rem = torch.arange(num_groups, dtype=torch.int32, device=dev)
    codes = []
    for dom in reversed(domains):
        codes.append(rem % dom)
        rem = rem // dom
    codes.reverse()
    for v, name, code in zip(keys, group_names, codes):
        blocks.append(Block(code.to(v.data.dtype), v.type, None, v.dict_id))
        names.append(name)

    for spec, v, (cnt_at, val_at, lanes) in zip(aggs, ins, layout):
        cnt = tot[cnt_at]
        if spec.func in ("count", "count_star"):
            raw, has = cnt, None
        else:
            s = tot[val_at:val_at + lanes]
            s = torch.stack(d128.dnorm(s[0], s[1]), dim=-1) if lanes == 2 else s[0]
            raw, has = (s if spec.func == "sum" else (s, cnt)), cnt > 0
        in_t = None if v is None else v.type
        did = None if v is None else v.dict_id
        blocks.append(_finalize(spec, raw, has, in_t, did))
        names.append(spec.name)
    out = Page.from_blocks(blocks, names, count=num_groups, device=dev)
    return compact(out, tot[0] > 0)


# ---------------------------------------------------------------------------
# SORT strategy (general keys)
# ---------------------------------------------------------------------------


def grouped_aggregate_sorted(
    page: Page,
    group_exprs,
    group_names,
    aggs: Sequence[AggSpec],
    max_groups: int,
    pre_mask=None,
    max_elems: int = 128,
) -> Page:
    """General grouped aggregation via hash-sort + run detection.

    max_groups is the static output capacity; the returned count may exceed
    it, and the caller retries with a larger capacity (executor). With a
    collection aggregate the page gains a `$collect_need` column whose first
    row is the widest collection any group needed: the caller retries with
    max_elems at least that wide and drops the column."""
    _require_ported(aggs)
    dev = page.device
    cap = page.capacity
    live = _masked_live(page, pre_mask)
    keys, ins = _eval_inputs(page, group_exprs, aggs)

    h = unsigned_order_key(hash_rows(keys))
    # dead rows sort to the end: the uint64 max sentinel
    h = torch.where(live, h, torch.iinfo(torch.int64).max)
    # a collection's element order is the rows' order within their group,
    # which only a stable sort keeps
    order = torch.argsort(h, stable=any(a.func in COLLECTION_AGGS for a in aggs))

    live_s = live[order]
    keys_s = [
        Val(v.data[order], None if v.valid is None else v.valid[order], v.type, v.dict_id)
        for v in keys
    ]

    # run boundaries on actual key values (collision-proof)
    boundary = torch.zeros(cap, dtype=torch.bool, device=dev)
    if cap:
        boundary[0] = True
    for v in keys_s:
        boundary = boundary | _neq_adjacent_nullaware(v.data, v.valid)
    boundary = boundary & live_s
    gid_s = torch.cumsum(boundary.to(torch.int32), 0, dtype=torch.int32) - 1
    if cap:
        num_live_groups = torch.clamp(gid_s[-1] + 1, min=0)
    else:
        num_live_groups = torch.zeros((), dtype=torch.int32, device=dev)
    gid_s = torch.where(live_s, gid_s, max_groups).to(torch.int64)
    # groups past the capacity fold into the overflow slot (the count
    # still reports them, so the caller retries)
    gid_s = torch.clamp(gid_s, max=max_groups)

    # representative (first) row index per group, for key gather
    first_idx = torch.full((max_groups + 1,), cap, dtype=torch.int64, device=dev)
    first_idx = first_idx.scatter_reduce_(
        0, gid_s, torch.arange(cap, device=dev), "amin", include_self=True
    )
    first_idx = torch.clamp(first_idx, max=max(cap - 1, 0))[:max_groups]

    blocks, names = [], []
    for v, name in zip(keys_s, group_names):
        kvalid = None if v.valid is None else v.valid[first_idx]
        blocks.append(Block(v.data[first_idx], v.type, kvalid, v.dict_id))
        names.append(name)

    by_keys = _eval_by_keys(page, aggs)
    collect_need = None
    for spec, v, bk in zip(aggs, ins, by_keys):
        if spec.func in COLLECTION_AGGS:
            blk, need = collection_block(spec, _sorted_val(v, order), _sorted_val(bk, order),
                                         live_s, gid_s, max_groups + 1, max_elems)
            blocks.append(blk.take_rows(slice(0, max_groups)))
            names.append(spec.name)
            collect_need = need if collect_need is None else torch.maximum(collect_need, need)
            continue
        if spec.func in SKETCH_FUNCS:
            blk = sketch_block(spec, v.data[order], None if v.valid is None else v.valid[order],
                               live_s, gid_s, max_groups + 1, _sorted_val(v, order),
                               _sorted_val(bk, order))
            blocks.append(blk.take_rows(slice(0, max_groups)))
            names.append(spec.name)
            continue
        if spec.func in ("min_by", "max_by", "percentile"):
            v_sorted = Val(v.data[order], None if v.valid is None else v.valid[order],
                           v.type, v.dict_id)
            k_sorted = None if bk is None else Val(
                bk.data[order], None if bk.valid is None else bk.valid[order],
                bk.type, bk.dict_id)
            vdat, vval = positional_reduce(
                spec, v_sorted, k_sorted, live_s, gid_s, max_groups + 1
            )
            blocks.append(
                Block(vdat[:max_groups].to(spec.output_type.storage_dtype),
                      spec.output_type, vval[:max_groups], v.dict_id)
            )
            names.append(spec.name)
            continue
        if v is None:
            data_s = torch.zeros(cap, dtype=torch.int64, device=dev)
            contributes = live_s
            in_t = None
        else:
            data_s = v.data[order]
            valid_s = None if v.valid is None else v.valid[order]
            contributes = live_s if valid_s is None else (live_s & valid_s)
            in_t = v.type
        raw, has = _segment_reduce(
            spec.func, data_s, contributes, gid_s, max_groups + 1,
            wide=_wide_for(spec, v),
        )
        if isinstance(raw, tuple):
            raw = tuple(x[:max_groups] for x in raw)
        else:
            raw = raw[:max_groups]
        has = None if has is None else has[:max_groups]
        did = None if v is None else v.dict_id
        blocks.append(_finalize(spec, raw, has, in_t, did))
        names.append(spec.name)
    _append_need(blocks, names, collect_need, max_groups, dev)
    return Page.from_blocks(blocks, names, count=num_live_groups, device=dev)


def _append_need(blocks, names, collect_need, rows: int, dev) -> None:
    """The `$collect_need` column: the needed collection width in row 0."""
    if collect_need is None:
        return
    need_col = torch.zeros(max(rows, 1), dtype=torch.int32, device=dev)
    need_col[0] = collect_need.to(torch.int32)
    blocks.append(Block(need_col, T.INTEGER, None))
    names.append("$collect_need")


# ---------------------------------------------------------------------------
# the final step of a decomposed aggregation (the plan's AggFinalize node)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AvgPost:
    """Post-exchange step: name = sum_col / cnt_col with avg typing."""

    name: str
    sum_col: str
    cnt_col: str
    output_type: T.Type
    input_type: T.Type


def decompose_partial(aggs: Sequence[AggSpec]):
    """(partial_specs, final_specs, post_steps) of a decomposable
    aggregation (the JAX package's decompose_partial): partial specs run
    per batch, final specs over the concatenated partial rows, post steps
    derive avg. The sketch, moment and regression aggregates raise
    KeyError here, as a non-decomposable aggregate does in the JAX
    package: their callers aggregate the whole input in one pass."""
    from ..expr.ir import ColumnRef

    partial, final, post = [], [], []
    for a in aggs:
        if a.func in ("count", "count_star", "checksum"):
            partial.append(a)
            final.append(AggSpec("sum", ColumnRef(a.name, T.BIGINT), a.name, T.BIGINT))
        elif a.func in ("sum", "min", "max"):
            partial.append(a)
            final.append(AggSpec(a.func, ColumnRef(a.name, a.output_type), a.name,
                                 a.output_type))
        elif a.func == "avg":
            in_t = a.input.type
            sum_t = AggSpec.infer_output_type("sum", in_t)
            s_name, c_name = f"{a.name}$sum", f"{a.name}$cnt"
            partial.append(AggSpec("sum", a.input, s_name, sum_t))
            partial.append(AggSpec("count", a.input, c_name, T.BIGINT))
            final.append(AggSpec("sum", ColumnRef(s_name, sum_t), s_name, sum_t))
            final.append(AggSpec("sum", ColumnRef(c_name, T.BIGINT), c_name, T.BIGINT))
            post.append(AvgPost(a.name, s_name, c_name, a.output_type, in_t))
        else:
            raise KeyError(f"cannot decompose aggregate {a.func!r}")
    return tuple(partial), tuple(final), tuple(post)


def apply_avg_post(page: Page, aggs: Sequence[AggSpec], post: Sequence[AvgPost]) -> Page:
    """Produce the user-visible columns (group keys + aggregates in `aggs`
    order) from a final-aggregated page containing decomposed columns."""
    by_name = {p.name: p for p in post}
    for p in post:
        if not isinstance(p, AvgPost):
            raise NotPortedError(f"not ported yet: post step {type(p).__name__}")
    helper_cols = {x for p in post for x in (p.sum_col, p.cnt_col)}
    agg_names = {a.name for a in aggs}
    blocks, names = [], []
    for name, b in zip(page.names, page.blocks):
        if name not in helper_cols and name not in agg_names:
            blocks.append(b)
            names.append(name)
    for a in aggs:
        p = by_name.get(a.name)
        if p is None:
            blocks.append(page.block(a.name))
            names.append(a.name)
            continue
        s = page.block(p.sum_col).data
        cnt = page.block(p.cnt_col).data
        data = avg_from_sum_count(s, cnt, p.output_type, p.input_type)
        blocks.append(Block(data, p.output_type, cnt > 0))
        names.append(a.name)
    return Page(tuple(blocks), tuple(names), page.count)


def global_aggregate(page: Page, aggs: Sequence[AggSpec], pre_mask=None,
                     max_elems: int = 128) -> Page:
    """Aggregation with no GROUP BY — one output row (reference
    AggregationOperator). Collection aggregates are max_elems wide and add
    the `$collect_need` column, as in grouped_aggregate_sorted."""
    _require_ported(aggs)
    dev = page.device
    live = _masked_live(page, pre_mask)
    _, ins = _eval_inputs(page, (), aggs)
    by_keys = _eval_by_keys(page, aggs)
    blocks, names = [], []
    gid = torch.zeros(page.capacity, dtype=torch.int64, device=dev)
    order0 = gid0 = collect_need = None
    for spec, v, bk in zip(aggs, ins, by_keys):
        if spec.func in SKETCH_FUNCS and not spec.func.startswith("linreg"):
            # dead rows go to a second group, dropped
            blk = sketch_block(spec, v.data, v.valid, live, (~live).to(torch.int64), 2)
            blocks.append(blk.take_rows(slice(0, 1)))
            names.append(spec.name)
            continue
        if spec.func in COLLECTION_AGGS or spec.func in SKETCH_FUNCS:
            # the collectors and the regression accumulators read rows
            # sorted by group
            if order0 is None:
                # live rows first, in row order; dead rows form a second
                # group, dropped
                order0 = torch.argsort((~live).to(torch.uint8), stable=True)
                gid0 = (~live[order0]).to(torch.int64)
            v_s, bk_s, live_s = _sorted_val(v, order0), _sorted_val(bk, order0), live[order0]
            if spec.func in COLLECTION_AGGS:
                blk, need = collection_block(spec, v_s, bk_s, live_s, gid0, 2, max_elems)
                collect_need = need if collect_need is None else torch.maximum(collect_need,
                                                                                need)
            else:
                blk = sketch_block(spec, v_s.data, v_s.valid, live_s, gid0, 2, v_s, bk_s)
            blocks.append(blk.take_rows(slice(0, 1)))
            names.append(spec.name)
            continue
        if spec.func in ("min_by", "max_by", "percentile"):
            vdat, vval = positional_reduce(spec, v, bk, live, gid, 1)
            blocks.append(Block(vdat.to(spec.output_type.storage_dtype),
                                spec.output_type, vval, v.dict_id))
            names.append(spec.name)
            continue
        contributes = _agg_contributes(v, live)
        if v is None:
            data = torch.zeros(page.capacity, dtype=torch.int64, device=dev)
        else:
            data = v.data
        raw, has = _mask_reduce(spec.func, data, contributes, wide=_wide_for(spec, v))
        in_t = None if v is None else v.type
        did = None if v is None else v.dict_id
        blocks.append(_finalize(spec, raw, has, in_t, did))
        names.append(spec.name)
    _append_need(blocks, names, collect_need, 1, dev)
    return Page.from_blocks(blocks, names, count=1, device=dev)
