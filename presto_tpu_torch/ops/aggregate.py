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

Aggregate functions ported: count/count_star/sum/min/max/avg/checksum and
min_by/max_by, with SQL null semantics (nulls don't contribute; empty-group
sum/min/max = NULL, count = 0). The collection, sketch and regression
aggregates of the JAX package raise "not ported yet".
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import numpy as np
import torch

from .. import types as T
from ..expr.compiler import evaluate
from ..expr.functions import NotPortedError, Val
from ..page import Block, Page, to_tensor
from .hashing import hash_rows, unsigned_order_key

PORTED = ("count", "count_star", "sum", "min", "max", "avg", "checksum",
          "min_by", "max_by")


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


def positional_reduce(spec: AggSpec, value, by_key, contributes, gid, num_groups: int):
    if spec.func == "percentile":
        raise NotPortedError("not ported yet: aggregate 'percentile'")
    return _reduce_by(spec.func, value, by_key, contributes, gid, num_groups)


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
    it, and the caller retries with a larger capacity (executor)."""
    _require_ported(aggs)
    dev = page.device
    cap = page.capacity
    live = _masked_live(page, pre_mask)
    keys, ins = _eval_inputs(page, group_exprs, aggs)

    h = unsigned_order_key(hash_rows(keys))
    # dead rows sort to the end: the uint64 max sentinel
    h = torch.where(live, h, torch.iinfo(torch.int64).max)
    order = torch.argsort(h)

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
    for spec, v, bk in zip(aggs, ins, by_keys):
        if spec.func in ("min_by", "max_by"):
            v_sorted = Val(v.data[order], None if v.valid is None else v.valid[order],
                           v.type, v.dict_id)
            k_sorted = Val(bk.data[order], None if bk.valid is None else bk.valid[order],
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
    return Page.from_blocks(blocks, names, count=num_live_groups, device=dev)


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


def global_aggregate(page: Page, aggs: Sequence[AggSpec], pre_mask=None) -> Page:
    """Aggregation with no GROUP BY — one output row (reference
    AggregationOperator)."""
    _require_ported(aggs)
    dev = page.device
    live = _masked_live(page, pre_mask)
    _, ins = _eval_inputs(page, (), aggs)
    by_keys = _eval_by_keys(page, aggs)
    blocks, names = [], []
    gid = torch.zeros(page.capacity, dtype=torch.int64, device=dev)
    for spec, v, bk in zip(aggs, ins, by_keys):
        if spec.func in ("min_by", "max_by"):
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
    return Page.from_blocks(blocks, names, count=1, device=dev)
