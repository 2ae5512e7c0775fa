"""Window functions (torch counterpart of presto_tpu/ops/window.py).

Re-designed equivalent of the reference's WindowOperator and window
function library (presto-main/.../operator/WindowOperator.java,
operator/window/): the reference walks each partition of a PagesIndex row
by row; here the whole page is sorted once by (partition hash, order keys)
and every function is a segmented scan over the sorted layout:

  row_number   position - partition_start
  rank         peer_group_start - partition_start + 1
  dense_rank   segmented count of peer boundaries
  ntile        bucketing arithmetic on row_number / partition size
  percent_rank / cume_dist   rank arithmetic over partition sizes
  lag / lead   shifted gathers guarded by partition id
  first/last/nth_value, sum/avg/min/max/count OVER   prefix sums over
               per-row frame bounds (a sparse table for framed min/max)

Every step is a tensor operation on the page's device (sorts, cumsums,
gathers, index_add_/scatter_reduce_); nothing reads the host. Rows come
out sorted by (partition, order), as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

from .. import types as T
from ..expr.compiler import evaluate
from ..expr.functions import Val, require_sorted_dict
from ..page import Block, Page
from .aggregate import (
    _neq_adjacent,
    _neq_adjacent_nullaware,
    _segment_sum,
    avg_from_sum_count,
    max_identity,
    min_identity,
)
from . import decimal128 as d128
from .hashing import hash_rows, unsigned_order_key
from .keypack import pack_keys
from .sort import SortKey, apply_permutation, lexsort_permutation, sort_permutation

RANKING = {"row_number", "rank", "dense_rank", "ntile", "percent_rank", "cume_dist"}
OFFSET = {"lag", "lead"}
VALUE = {"first_value", "last_value", "nth_value"}
AGGREGATE = {"sum", "avg", "min", "max", "count"}

# frame bound kinds (reference operator/window/FrameInfo.java BoundType)
UNB_PRECEDING = "unbounded_preceding"
PRECEDING = "preceding"
CURRENT = "current"
FOLLOWING = "following"
UNB_FOLLOWING = "unbounded_following"


@dataclasses.dataclass(frozen=True)
class Frame:
    """Window frame (reference FrameInfo): mode 'rows' or 'range'; offsets
    are row counts (rows mode) or order-key deltas in storage units (range
    mode, which needs exactly one numeric order key)."""

    mode: str  # 'rows' | 'range'
    start_kind: str = UNB_PRECEDING
    start_offset: int = 0
    end_kind: str = CURRENT
    end_offset: int = 0


@dataclasses.dataclass(frozen=True)
class WindowFunc:
    func: str
    input: Optional[object]  # RowExpression (None for row_number etc.)
    name: str
    output_type: T.Type
    offset: int = 1  # lag/lead distance; ntile bucket count; nth_value n
    running: bool = False  # cumulative frame (UNBOUNDED PRECEDING..CURRENT)
    frame: Optional[Frame] = None  # explicit frame; None = SQL default
    default: Optional[object] = None  # lag/lead default RowExpression


def _argsort(x):
    """Stable ascending argsort; bool keys sort False first."""
    if x.dtype == torch.bool:
        x = x.to(torch.uint8)
    return torch.argsort(x, stable=True)


def _cummax(x):
    return torch.cummax(x, 0).values


def _sort_for_window(page: Page, partition_exprs, order_keys: Sequence[SortKey]):
    """Permutation ordering rows by (partition hash, raw partition keys,
    order keys); dead rows last. The raw keys are stable tie-break passes
    under the hash, so two partition values whose 64-bit hashes collide
    still cluster contiguously."""
    live = page.live_mask()
    perm = sort_permutation(page, order_keys) if order_keys else _argsort(~live)
    if partition_exprs:
        pkeys = [evaluate(e, page) for e in partition_exprs]
        for v in pkeys:  # least-significant tie-breaks first (stable sorts)
            d = v.data
            if v.valid is not None:
                # canonicalize NULL slots: their storage is garbage and must
                # not reorder rows within an all-NULL partition
                mask = v.valid if d.ndim == 1 else v.valid[:, None]
                d = torch.where(mask, d, torch.zeros_like(d))
            if d.ndim == 2:  # long-decimal lanes: (hi, lo) lexicographic
                perm = perm[_argsort(d[perm, 1])]
                perm = perm[_argsort(d[perm, 0])]
            else:
                perm = perm[_argsort(d[perm])]
            if v.valid is not None:
                perm = perm[_argsort(v.valid[perm])]
        h = unsigned_order_key(hash_rows(pkeys))
        perm = perm[_argsort(h[perm])]
    return perm[_argsort(~live[perm])]


def _partition_bounds(page: Page, partition_exprs, perm):
    """(boundary, pid, start, part_size, live_s) over the sorted order."""
    cap = page.capacity
    live_s = page.live_mask()[perm]
    boundary = torch.zeros(cap, dtype=torch.bool, device=page.device)
    if cap:
        boundary[0] = True
    for e in partition_exprs:
        v = evaluate(e, page)
        boundary = boundary | _neq_adjacent_nullaware(
            v.data[perm], None if v.valid is None else v.valid[perm])
    boundary = boundary & live_s
    pid, start, part_size = _bounds_from_boundary(boundary, live_s, cap)
    return boundary, pid, start, part_size, live_s


def _peer_bounds(page: Page, order_keys: Sequence[SortKey], perm, boundary):
    """Peer-group boundaries: an order-key change within a partition."""
    peer = boundary
    for k in order_keys:
        v = evaluate(k.expr, page)
        peer = peer | _neq_adjacent_nullaware(
            v.data[perm], None if v.valid is None else v.valid[perm])
    return peer


def _need_peer(funcs, order_keys) -> bool:
    return any(
        f.func in ("rank", "dense_rank", "percent_rank", "cume_dist")
        or (f.func in AGGREGATE | VALUE and order_keys)
        for f in funcs
    )


def _bounds_from_boundary(boundary, live_s, cap):
    """(pid, start, part_size) over the sorted order from the
    partition-start flags (shared by the legacy per-key detection and the
    packed-key shift detection)."""
    pid = torch.cumsum(boundary.to(torch.int64), 0) - 1
    pid = torch.where(live_s, pid, cap)  # dead rows own a segment
    idx = torch.arange(cap, dtype=torch.int64, device=boundary.device)
    start = _cummax(torch.where(boundary, idx, 0))
    sizes = _segment_sum(live_s.to(torch.int64), pid, cap + 1)
    part_size = sizes[torch.clamp(pid, max=cap)]
    return pid, start, part_size


def window_op(page: Page, partition_exprs, order_keys: Sequence[SortKey],
              funcs: Sequence[WindowFunc]) -> Page:
    perm = _sort_for_window(page, partition_exprs, order_keys)
    boundary, pid, start, part_size, live_s = _partition_bounds(page, partition_exprs, perm)
    peer = None
    if _need_peer(funcs, order_keys):
        peer = _peer_bounds(page, order_keys, perm, boundary)
    return _window_body(page, perm, boundary, pid, start, part_size, live_s, peer,
                        order_keys, funcs)


def window_op_packed(page: Page, partition_exprs, order_keys: Sequence[SortKey],
                     funcs: Sequence[WindowFunc], plan):
    """Window functions over a single-lane packed (partition, order) key
    (ops/keypack.py): one stable sort replaces the hash and per-key sort
    cascade, and partition and peer boundaries fall out of integer compares
    on the sorted key (partition identity is the key shifted right past the
    order-key bits).

    Returns (page, ok); a False `ok` (a sampled-stats range miss) means the
    caller must rerun the legacy window_op."""
    cap = page.capacity
    vals = [evaluate(e, page) for e in partition_exprs] + [
        evaluate(k.expr, page) for k in order_keys]
    live = page.live_mask()
    lanes, ok = pack_keys(vals, plan, live)
    perm = lexsort_permutation(lanes)
    packed_s = lanes[0][perm]
    live_s = live[perm]
    boundary = _neq_adjacent(packed_s >> plan.order_bits) & live_s
    pid, start, part_size = _bounds_from_boundary(boundary, live_s, cap)
    peer = None
    if _need_peer(funcs, order_keys):
        peer = boundary | _neq_adjacent(packed_s)
    out = _window_body(page, perm, boundary, pid, start, part_size, live_s, peer,
                       order_keys, funcs)
    return out, ok


def _window_body(page: Page, perm, boundary, pid, start, part_size, live_s, peer,
                 order_keys: Sequence[SortKey], funcs: Sequence[WindowFunc]) -> Page:
    sorted_page = apply_permutation(page, perm)
    cap = page.capacity
    dev = page.device
    idx = torch.arange(cap, dtype=torch.int64, device=dev)

    peer_start = next_peer = None
    if peer is not None:
        peer_start = _cummax(torch.where(peer, idx, 0))
        next_peer = _next_peer_start(peer, cap)

    # the single numeric order key in sorted layout (RANGE offset frames)
    order_vals = None
    if len(order_keys) == 1:
        k = order_keys[0]
        ov = evaluate(k.expr, page)
        if not isinstance(ov.type, T.VarcharType):
            order_vals = (ov.data[perm], None if ov.valid is None else ov.valid[perm],
                          k.ascending)

    frame_cache = {}

    def bounds_for(frame: Frame):
        hit = frame_cache.get(frame)
        if hit is None:
            needs_key = frame.mode == "range" and any(
                kind in (PRECEDING, FOLLOWING) for kind in (frame.start_kind, frame.end_kind))
            if needs_key and order_vals is None:
                raise NotImplementedError(
                    "RANGE offset frames require exactly one numeric ORDER BY key")
            ps = peer_start if peer_start is not None else start
            np_ = next_peer if next_peer is not None else start + part_size
            hit = _frame_bounds(frame, idx, start, part_size, ps, np_, order_vals, cap)
            frame_cache[frame] = hit
        return hit

    def effective_frame(f: WindowFunc) -> Optional[Frame]:
        if f.frame is not None:
            return f.frame
        if order_keys:
            # SQL default: RANGE UNBOUNDED PRECEDING .. CURRENT ROW (ties
            # aggregate together)
            return Frame("range", UNB_PRECEDING, 0, CURRENT, 0)
        return None  # the whole partition

    blocks = list(sorted_page.blocks)
    names = list(sorted_page.names)

    for f in funcs:
        rn = idx - start + 1  # row_number
        dict_id = None
        if f.func == "row_number":
            data, valid = rn, None
        elif f.func == "rank":
            data, valid = peer_start - start + 1, None
        elif f.func == "dense_rank":
            d = torch.cumsum(peer.to(torch.int64), 0)
            d_start = _cummax(torch.where(boundary, d, 0))
            data, valid = d - d_start + 1, None
        elif f.func == "ntile":
            n = f.offset
            sz = torch.clamp(part_size, min=1)
            base = sz // n
            rem = sz % n
            r0 = rn - 1
            big_rows = rem * (base + 1)
            bucket = torch.where(
                r0 < big_rows,
                r0 // torch.clamp(base + 1, min=1),
                rem + (r0 - big_rows) // torch.clamp(base, min=1),
            )
            data, valid = bucket + 1, None
        elif f.func == "percent_rank":
            rk = (peer_start - start + 1).to(torch.float64)
            denom = torch.clamp(part_size - 1, min=1).to(torch.float64)
            data, valid = torch.where(part_size > 1, (rk - 1) / denom, 0.0), None
        elif f.func == "cume_dist":
            # rows with order key <= current = end of peer group - start
            nxt = torch.minimum(_next_peer_start(peer, cap), start + part_size)
            data = (nxt - start).to(torch.float64) / torch.clamp(part_size, min=1).to(
                torch.float64)
            valid = None
        elif f.func in OFFSET:
            v = evaluate(f.input, sorted_page)
            dict_id = v.dict_id
            k = f.offset if f.func == "lag" else -f.offset
            src = idx - k
            in_bounds = (src >= 0) & (src < cap)
            src_c = torch.clamp(src, 0, max(cap - 1, 0))
            same_part = in_bounds & (pid[src_c] == pid)
            data = v.data[src_c]
            valid = same_part
            if v.valid is not None:
                valid = valid & v.valid[src_c]
            if f.default is not None:  # lag(x, n, default)
                dv = evaluate(f.default, sorted_page)
                mask = same_part if data.ndim == 1 else same_part[:, None]
                data = torch.where(mask, data, dv.data)
                dvalid = dv.valid_mask()
                vvalid = torch.ones(cap, dtype=torch.bool, device=dev) if v.valid is None \
                    else v.valid[src_c]
                valid = torch.where(same_part, vvalid, dvalid)
        elif f.func in VALUE:
            v = evaluate(f.input, sorted_page)
            dict_id = v.dict_id
            frame = effective_frame(f)
            if frame is None:
                lo, hi = start, start + part_size - 1
            else:
                lo, hi = bounds_for(frame)
            if f.func == "first_value":
                pos = lo
            elif f.func == "last_value":
                pos = hi
            else:  # nth_value(x, n): the n-th row of the frame, 1-based
                pos = lo + (f.offset - 1)
            in_frame = (pos >= lo) & (pos <= hi) & (lo <= hi)
            pos_c = torch.clamp(pos, 0, max(cap - 1, 0))
            data = v.data[pos_c]
            valid = in_frame
            if v.valid is not None:
                valid = valid & v.valid[pos_c]
        elif f.func in AGGREGATE:
            frame = effective_frame(f)
            if f.input is None:
                v = None
                contrib = live_s
                data_in = torch.ones(cap, dtype=torch.int64, device=dev)
            else:
                v = evaluate(f.input, sorted_page)
                if f.func in ("min", "max") and isinstance(v.type, T.VarcharType):
                    require_sorted_dict(v, f"{f.func} window function")
                    dict_id = v.dict_id
                contrib = live_s if v.valid is None else (live_s & v.valid)
                data_in = v.data
            if frame is None:
                data, valid = self_agg(f, v, data_in, contrib, pid, start, idx, cap)
            else:
                lo, hi = bounds_for(frame)
                data, valid = _frame_agg(f, v, data_in, contrib, lo, hi, cap)
        else:
            raise KeyError(f"unsupported window function {f.func!r}")
        blocks.append(Block(data, f.output_type, valid, dict_id))
        names.append(f.name)

    return Page(tuple(blocks), tuple(names), page.count)


def _part_search(keys, pstart, pend_plus1, target, strict: bool, asc: bool):
    """Vectorized per-row binary search inside each partition's sorted run.

    Returns the smallest j in [pstart, pend_plus1] such that
      asc,  strict=False:  keys[j] >= target      (lower bound)
      asc,  strict=True:   keys[j] >  target      (upper bound)
      desc: comparisons flipped (runs are descending).
    35 fixed iterations cover any int32 capacity."""
    lo = pstart
    hi = pend_plus1
    n = keys.shape[0]
    for _ in range(35):
        active = lo < hi
        mid = (lo + hi) >> 1
        kv = keys[torch.clamp(mid, 0, n - 1)]
        if asc:
            go_right = (kv <= target) if strict else (kv < target)
        else:
            go_right = (kv >= target) if strict else (kv > target)
        lo = torch.where(active & go_right, mid + 1, lo)
        hi = torch.where(active & ~go_right, mid, hi)
    return lo


def _frame_bounds(frame: Frame, idx, start, part_size, peer_start, next_peer, order_vals,
                  cap):
    """Per-row inclusive [lo, hi] frame bounds in sorted coordinates.

    RANGE mode with an offset needs exactly one numeric order key
    (order_vals = (data, valid or None, ascending)); CURRENT bounds in RANGE
    mode are peer-group bounds (the SQL standard)."""
    pend = start + part_size - 1
    if frame.mode == "rows":

        def bound(kind, off, is_start):
            if kind == UNB_PRECEDING:
                return start
            if kind == UNB_FOLLOWING:
                return pend
            if kind == CURRENT:
                return idx
            return idx - off if kind == PRECEDING else idx + off

    else:  # range
        # order_vals is None for a multi-key ORDER BY, legal while no bound
        # needs a key offset (bounds_for rejects offset frames before here)
        data, kvalid, asc = order_vals if order_vals is not None else (None, None, True)
        knull = torch.zeros(cap, dtype=torch.bool, device=idx.device) if kvalid is None \
            else ~kvalid

        def bound(kind, off, is_start):
            if kind == UNB_PRECEDING:
                return start
            if kind == UNB_FOLLOWING:
                return pend
            if kind == CURRENT:
                return peer_start if is_start else next_peer - 1
            if data.is_floating_point():
                delta = float(off)
            else:
                delta = int(off)
            target = data - delta if kind == PRECEDING else data + delta
            if not asc:  # descending runs: preceding means larger values
                target = data + delta if kind == PRECEDING else data - delta
            if is_start:
                j = _part_search(data, start, pend + 1, target, False, asc)
            else:
                j = _part_search(data, start, pend + 1, target, True, asc) - 1
            # rows with NULL keys frame over their null peer group
            return torch.where(knull, peer_start if is_start else next_peer - 1, j)

    lo = bound(frame.start_kind, frame.start_offset, True)
    hi = bound(frame.end_kind, frame.end_offset, False)
    return torch.maximum(lo, start), torch.minimum(hi, pend)


def _log2_floor(n):
    """floor(log2(n)) for integer n >= 1 without float rounding hazards."""
    x = n
    r = torch.zeros_like(x)
    for shift in (16, 8, 4, 2, 1):
        big = x >= (1 << shift)
        r = r + torch.where(big, shift, 0)
        x = torch.where(big, x >> shift, x)
    return r


def _sparse_table_query(lanes, lo, hi, pick, idents):
    """min/max over inclusive [lo, hi] through a sparse table (log
    doubling) over one or more parallel lanes: O(n log n) build, O(1) per
    query. `pick(a_lanes, b_lanes) -> selected lanes` is the (possibly
    lexicographic) comparator; `idents` pads the shifted tails."""
    cap = lanes[0].shape[0]
    levels = [tuple(lanes)]
    j = 0
    while (1 << (j + 1)) <= cap:
        prev = levels[-1]
        shift = 1 << j
        shifted = tuple(
            torch.cat([p[shift:], torch.full((shift,), idn, dtype=p.dtype, device=p.device)])
            for p, idn in zip(prev, idents))
        levels.append(pick(prev, shifted))
        j += 1
    flats = tuple(torch.stack([lv[k] for lv in levels]).reshape(-1) for k in range(len(lanes)))
    length = torch.clamp(hi - lo + 1, min=1)
    lv = _log2_floor(length)
    span = torch.ones_like(lv) << lv
    top = flats[0].shape[0] - 1
    i1 = torch.clamp(lv * cap + lo, 0, top)
    i2 = torch.clamp(lv * cap + hi - span + 1, 0, top)
    return pick(tuple(f[i1] for f in flats), tuple(f[i2] for f in flats))


def _range_minmax_pair(xh, xl, lo, hi, kind: str):
    """Lexicographic (hi, lo) min/max, the long-decimal twin of
    _range_minmax on the shared sparse table (canonical decimal128 order,
    ops/decimal128.py)."""
    big = torch.iinfo(torch.int64).max
    ident = big if kind == "min" else -big - 1

    def pick(a, b):
        ah, al = a
        bh, bl = b
        if kind == "min":
            take_a = (ah < bh) | ((ah == bh) & (al <= bl))
        else:
            take_a = (ah > bh) | ((ah == bh) & (al >= bl))
        return torch.where(take_a, ah, bh), torch.where(take_a, al, bl)

    return _sparse_table_query((xh, xl), lo, hi, pick, (ident, ident))


def _range_minmax(x, lo, hi, kind: str, ident):
    """Scalar min/max over inclusive [lo, hi] on the shared sparse table."""
    op = torch.minimum if kind == "min" else torch.maximum

    def pick(a, b):
        return (op(a[0], b[0]),)

    return _sparse_table_query((x,), lo, hi, pick, (ident,))[0]


def _frame_agg(f: WindowFunc, v, data_in, contrib, lo, hi, cap):
    """sum/avg/min/max/count over per-row [lo, hi] frames through exclusive
    prefix sums (and a sparse table for min/max)."""
    empty = lo > hi
    hi_c = torch.clamp(hi, 0, cap - 1)
    lo_c = torch.clamp(lo, max=cap - 1)
    zero = torch.zeros(1, dtype=torch.int64, device=contrib.device)
    cnt_pre = torch.cat([zero, torch.cumsum(contrib.to(torch.int64), 0)])
    cnt = torch.where(empty, 0, cnt_pre[hi_c + 1] - cnt_pre[lo_c])
    if f.func == "count":
        return cnt, None
    wide = f.func in ("sum", "avg") and (
        data_in.ndim == 2 or (v is not None and isinstance(v.type, T.DecimalType)))
    if f.func in ("sum", "avg"):
        if wide:
            lanes = data_in if data_in.ndim == 2 else d128.from_int64(data_in.to(torch.int64))
            x = torch.where(contrib[:, None], lanes, 0)
            pre = torch.cat([torch.zeros((1, 2), dtype=torch.int64, device=x.device),
                             d128.cumsum_wide(x)])
            s = d128.dsub(pre[hi_c + 1], pre[lo_c])
            s = torch.where(empty[:, None], 0, s)
        else:
            x = torch.where(contrib, data_in, torch.zeros_like(data_in))
            pre = torch.cat([torch.zeros(1, dtype=x.dtype, device=x.device),
                             torch.cumsum(x, 0)])
            s = torch.where(empty, 0, pre[hi_c + 1] - pre[lo_c])
        if f.func == "sum":
            return s, cnt > 0
        return _avg(s, cnt, f, v), cnt > 0
    # min/max
    if data_in.ndim == 2:
        big = torch.iinfo(torch.int64).max
        ih = big if f.func == "min" else -big - 1
        xh = torch.where(contrib, data_in[:, 0], ih)
        xl = torch.where(contrib, data_in[:, 1], ih)
        oh, ol = _range_minmax_pair(xh, xl, lo_c, hi_c, f.func)
        return torch.stack([oh, ol], dim=1), cnt > 0
    ident = min_identity(data_in.dtype) if f.func == "min" else max_identity(data_in.dtype)
    x = torch.where(contrib, data_in, torch.full_like(data_in, ident))
    return _range_minmax(x, lo_c, hi_c, f.func, ident), cnt > 0


def _next_peer_start(peer, cap):
    """For each row i, the smallest boundary index > i (cap if none): the
    suffix min of boundary positions, shifted by one."""
    idxs = torch.arange(cap, dtype=torch.int64, device=peer.device)
    b_pos = torch.where(peer, idxs, cap)
    sufmin = torch.flip(torch.cummin(torch.flip(b_pos, [0]), 0).values, [0])
    return torch.cat([sufmin[1:], torch.full((1,), cap, dtype=torch.int64, device=peer.device)])


def self_agg(f: WindowFunc, v: Optional[Val], data_in, contrib, pid, start, idx, cap):
    """sum/avg/min/max/count OVER the whole partition or a running frame."""
    # exact two-lane accumulation for decimal sums/avgs (decimal(38))
    wide = f.func in ("sum", "avg") and (
        data_in.ndim == 2 or (v is not None and isinstance(v.type, T.DecimalType)))
    contrib64 = contrib.to(torch.int64)
    if f.running:
        cnt_arr = torch.cumsum(contrib64, 0)
        cnt = cnt_arr - _gather_at(cnt_arr - contrib64, start)
        if f.func in ("sum", "avg", "count"):
            if f.func == "count":
                return cnt, None
            if wide:
                lanes = data_in if data_in.ndim == 2 else d128.from_int64(data_in.to(torch.int64))
                x = torch.where(contrib[:, None], lanes, 0)
                c = d128.cumsum_wide(x)
                run = d128.dsub(c, _gather_at(d128.dsub(c, x), start))
            else:
                x = torch.where(contrib, data_in, torch.zeros_like(data_in))
                c = torch.cumsum(x, 0)
                # rebase: the exclusive cumsum at the partition start
                run = c - _gather_at(c - x, start)
            if f.func == "avg":
                return _avg(run, cnt, f, v), cnt > 0
            return run, cnt > 0
        ident = min_identity(data_in.dtype) if f.func == "min" else max_identity(data_in.dtype)
        x = torch.where(contrib, data_in, torch.full_like(data_in, ident))
        return _segmented_scan(x, idx == start, f.func), cnt > 0
    # the whole partition
    num_seg = cap + 1
    at = torch.clamp(pid, max=cap)
    cnt = _segment_sum(contrib64, pid, num_seg)[at]
    if f.func == "count":
        return cnt, None
    if f.func in ("sum", "avg"):
        if wide:
            lanes = data_in if data_in.ndim == 2 else d128.from_int64(data_in.to(torch.int64))
            x = torch.where(contrib[:, None], lanes, 0)
            s = d128.segment_sum_wide(x, pid, num_seg)[at]
        else:
            x = torch.where(contrib, data_in, torch.zeros_like(data_in))
            s = _segment_sum(x, pid, num_seg)[at]
        if f.func == "sum":
            return s, cnt > 0
        return _avg(s, cnt, f, v), cnt > 0
    ident = min_identity(data_in.dtype) if f.func == "min" else max_identity(data_in.dtype)
    xm = torch.where(contrib, data_in, torch.full_like(data_in, ident))
    out = torch.full((num_seg,), ident, dtype=xm.dtype, device=xm.device)
    reduce = "amin" if f.func == "min" else "amax"
    return out.scatter_reduce_(0, pid, xm, reduce, include_self=True)[at], cnt > 0


def _avg(s, cnt, f: WindowFunc, v: Optional[Val]):
    return avg_from_sum_count(s, torch.clamp(cnt, min=0), f.output_type,
                              None if v is None else v.type)


def _gather_at(arr, pos):
    return arr[torch.clamp(pos, 0, arr.shape[0] - 1)]


def _segmented_scan(x, seg_start_flag, kind: str):
    """Segmented inclusive running min/max by Hillis-Steele with flag
    propagation (O(n log n) work, log n steps)."""
    n = x.shape[0]
    v = x
    f = seg_start_flag
    op = torch.minimum if kind == "min" else torch.maximum
    pos = torch.arange(n, device=x.device)
    shift = 1
    while shift < n:
        v_prev = torch.cat([v[:1].repeat(shift), v[:-shift]])
        f_prev = torch.cat([torch.ones(shift, dtype=torch.bool, device=x.device), f[:-shift]])
        in_range = pos >= shift
        v = torch.where(in_range & ~f, op(v, v_prev), v)
        f = torch.where(in_range, f | f_prev, f)
        shift *= 2
    return v
