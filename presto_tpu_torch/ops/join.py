"""Join operators (torch counterpart of presto_tpu/ops/join.py).

Re-designed equivalent of the reference's join stack: HashBuilderOperator
-> PagesIndex -> JoinCompiler-generated PagesHash + PositionLinks, probed
by LookupJoinOperator (presto-main/.../operator/JoinHash.java:28).

`build()` takes the linear-probe hash table of ops/join_kernel.py (the CUDA
insert and probe kernels) whenever the build is eligible for it; the other
builds (no keys, more than TABLE_MAX_BUILD rows, varchar keys too large to
value-hash) take the SORTED-HASH layout below: the build side sorted by key
hash with a bucket directory over the top hash bits, probed by two gathers
plus a short collision scan that verifies true key equality. join_n1 /
semi_match_mask / join_expand dispatch on the layout build() produced. That
choice is by eligibility only: a kernel fault fails the query.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np
import torch

from ..expr.compiler import evaluate
from ..expr.functions import Val
from ..page import Page
from .filter import compact
from .hashing import _srl, hash_rows, hash_rows_values, unsigned_order_key, value_hashable
from .join_kernel import (
    JoinTable,
    _prepare_keys,
    _verify,
    build_table,
    table_join_expand,
    table_join_n1,
    table_semi_mask,
)

_DEAD_KEY = (1 << 63) - 1  # unsigned_order_key of the all-ones hash


@dataclasses.dataclass
class BuildSide:
    """Sorted build-side lookup source. All arrays have the build page's
    capacity; live rows come first, ordered by unsigned hash."""

    sorted_key: torch.Tensor  # unsigned_order_key of the hashes, sorted
    order: torch.Tensor  # sorted position -> original row
    page: Page
    key_vals: Tuple[Val, ...]  # unsorted key values (original order)
    count: torch.Tensor  # live build rows
    # sorted positions of bucket b (top bucket_bits of the hash) span
    # [bucket_start[b], bucket_start[b + 1])
    bucket_start: torch.Tensor
    bucket_bits: int
    value_hashed: bool = False  # varchar keys hashed by dictionary VALUE


def _pick_bucket_bits(capacity: int) -> int:
    """Directory of ~2x build capacity (bucket occupancy <= 0.5)."""
    bits = max(1, int(np.ceil(np.log2(max(capacity, 1) * 2))))
    return min(bits, 22)


def build(page: Page, key_exprs):
    """A build side for probing: the hash table when eligible, else the
    sorted-hash layout."""
    jt = build_table(page, key_exprs)
    return jt if jt is not None else build_sorted(page, key_exprs)


def build_sorted(page: Page, key_exprs) -> BuildSide:
    """Sort the build side by key hash. Empty key_exprs put every row in one
    bucket (cross join)."""
    keys = [evaluate(e, page) for e in key_exprs]
    live = page.live_mask()
    dev = page.device
    value_hashed = any(k.dict_id is not None for k in keys) and value_hashable(keys)
    if not keys:
        h = torch.zeros(page.capacity, dtype=torch.int64, device=dev)
    elif value_hashed:
        h = hash_rows_values(keys)
    else:
        h = hash_rows(keys)
    okey = torch.where(live, unsigned_order_key(h), _DEAD_KEY)  # dead rows last
    order = torch.sort(okey, stable=True).indices
    sk = okey[order]
    bits = _pick_bucket_bits(page.capacity)
    bucket = _srl(unsigned_order_key(sk), 64 - bits)
    starts = torch.searchsorted(
        bucket, torch.arange((1 << bits) + 1, dtype=torch.int64, device=dev)
    ).to(torch.int32)
    return BuildSide(sk, order, page, tuple(keys), page.count, starts, bits, value_hashed)


def _probe_ranges(bs: BuildSide, probe_keys: Sequence[Val], capacity: int):
    """Per probe row: the [lo, hi) CANDIDATE range in the sorted build (the
    whole hash-prefix bucket; key equality decides membership)."""
    dev = bs.count.device
    cnt = bs.count.to(torch.int32)
    if not probe_keys:  # cross join: every live build row is a candidate
        return torch.zeros(capacity, dtype=torch.int32, device=dev), cnt.expand(capacity)
    h = hash_rows_values(probe_keys) if bs.value_hashed else hash_rows(probe_keys)
    b = _srl(h, 64 - bs.bucket_bits)
    lo = torch.minimum(bs.bucket_start[b], cnt)
    hi = torch.minimum(bs.bucket_start[b + 1], cnt)
    return lo, hi


def _collision_scan(bs: BuildSide, probe_keys, lo, hi, max_scan: int = 4):
    """First true-key match inside each candidate range: max_scan slots
    unrolled, then a loop while any row still has unscanned candidates.
    Returns (matched, build_row)."""
    matched = torch.zeros(lo.shape, dtype=torch.bool, device=lo.device)
    build_row = torch.zeros(lo.shape, dtype=torch.int64, device=lo.device)
    limit = bs.sorted_key.shape[0] - 1
    prep = _prepare_keys(bs.key_vals, probe_keys)
    every = torch.arange(lo.shape[0], device=lo.device)

    def probe_slot(k, matched, build_row):
        cand = lo.to(torch.int64) + k
        rows = bs.order[torch.clamp(cand, max=limit)]
        ok = (cand < hi) & _verify(prep, every, rows) & ~matched
        return matched | ok, torch.where(ok, rows, build_row)

    for k in range(max_scan):
        matched, build_row = probe_slot(k, matched, build_row)
    k = max_scan
    while bool((~matched & (lo + k < hi)).any()):
        matched, build_row = probe_slot(k, matched, build_row)
        k += 1
    return matched, build_row


def join_n1(probe: Page, bs, probe_key_exprs, build_names: Sequence[str],
            out_build_names: Sequence[str], kind: str = "inner") -> Page:
    """Join where each probe row matches at most ONE build row (FK->PK;
    also semi/anti). kind: inner | left | semi | anti. Probe columns pass
    through, build columns are gathered (NULL where unmatched, for left)."""
    if isinstance(bs, JoinTable):
        return table_join_n1(probe, bs, probe_key_exprs, build_names, out_build_names, kind)
    return _join_n1_sorted(probe, bs, probe_key_exprs, build_names, out_build_names, kind)


def _join_n1_sorted(probe: Page, bs: BuildSide, probe_key_exprs, build_names,
                    out_build_names, kind: str = "inner") -> Page:
    probe_keys = [evaluate(e, probe) for e in probe_key_exprs]
    live = probe.live_mask()
    lo, hi = _probe_ranges(bs, probe_keys, probe.capacity)
    matched, build_row = _collision_scan(bs, probe_keys, lo, hi)
    matched = matched & live
    if kind == "semi":
        return compact(probe, matched)
    if kind == "anti":
        return compact(probe, ~matched & live)
    blocks = list(probe.blocks)
    names = list(probe.names)
    for bname, oname in zip(build_names, out_build_names):
        b = bs.page.block(bname)
        valid = matched if b.valid is None else (matched & b.valid[build_row])
        blocks.append(b.gather(build_row, valid))
        names.append(oname)
    out = Page(tuple(blocks), tuple(names), probe.count)
    if kind == "inner":
        return compact(out, matched)
    if kind == "left":
        return out  # unmatched rows keep probe columns, build columns NULL
    raise ValueError(f"unknown join kind {kind!r}")


def semi_match_mask(probe: Page, bs, probe_key_exprs) -> torch.Tensor:
    """Per-probe-row match membership (the mark join: the reference
    HashSemiJoinOperator's semiJoinOutput channel)."""
    if isinstance(bs, JoinTable):
        return table_semi_mask(probe, bs, probe_key_exprs)
    probe_keys = [evaluate(e, probe) for e in probe_key_exprs]
    lo, hi = _probe_ranges(bs, probe_keys, probe.capacity)
    matched, _ = _collision_scan(bs, probe_keys, lo, hi)
    return matched & probe.live_mask()


def source_null_state(source: Page, source_key_exprs):
    """(empty, has_null) of a NOT IN source, as 0-d bool tensors on its
    device: no live row, and a live row with a NULL key. Reductions only,
    so the caller's mask needs no host read."""
    live = source.live_mask()
    has_null = torch.zeros((), dtype=torch.bool, device=source.device)
    for e in source_key_exprs:
        v = evaluate(e, source)
        if v.valid is not None:
            has_null = has_null | (live & ~v.valid).any()
    return ~live.any(), has_null


def null_aware_anti(page: Page, probe_key_exprs, empty, has_null) -> Page:
    """Presto's `v NOT IN (S)` over the rows an anti join kept: all of them
    when S is empty; otherwise none when S holds a NULL, and never a row
    whose v is NULL (its comparison is NULL, not true)."""
    probe_null = torch.zeros(page.capacity, dtype=torch.bool, device=page.device)
    for e in probe_key_exprs:
        v = evaluate(e, page)
        if v.valid is not None:
            probe_null = probe_null | ~v.valid
    return compact(page, empty | (~probe_null & ~has_null))


def join_expand(probe: Page, bs, probe_key_exprs, probe_out: Sequence[str],
                build_out: Sequence[Tuple[str, str]], out_capacity: int,
                kind: str = "inner"):
    """General 1:N inner/left join with a static output capacity. Returns
    (page, overflow): overflow > 0 means the caller must retry with a
    larger capacity (the table path counts verified matches, the sorted
    path hash-range candidates)."""
    if isinstance(bs, JoinTable):
        return table_join_expand(probe, bs, probe_key_exprs, probe_out, build_out,
                                 out_capacity, kind)
    return _join_expand_sorted(probe, bs, probe_key_exprs, probe_out, build_out,
                               out_capacity, kind)


def _join_expand_sorted(probe: Page, bs: BuildSide, probe_key_exprs, probe_out,
                        build_out, out_capacity: int, kind: str = "inner"):
    probe_keys = [evaluate(e, probe) for e in probe_key_exprs]
    live = probe.live_mask()
    dev = probe.device
    lo, hi = _probe_ranges(bs, probe_keys, probe.capacity)
    # candidates per probe row; a LEFT probe row with candidates but no TRUE
    # match still emits one NULL-extended row, so detect real matches first
    counts = torch.where(live, hi - lo, 0).to(torch.int64)
    if kind == "left":
        has_match, _ = _collision_scan(bs, probe_keys, lo, hi)
        no_match = live & ~has_match
        counts = torch.where(no_match, 1, counts)
    offsets = torch.cumsum(counts, 0)
    total = offsets[-1] if probe.capacity else torch.zeros((), dtype=torch.int64, device=dev)
    starts = offsets - counts

    out_i = torch.arange(out_capacity, dtype=torch.int64, device=dev)
    src = torch.searchsorted(offsets, out_i, right=True)
    src = torch.clamp(src, max=probe.capacity - 1)
    within = out_i - starts[src]
    in_bounds = out_i < total
    sorted_pos = torch.clamp(lo.to(torch.int64)[src] + within, max=bs.sorted_key.shape[0] - 1)
    build_row = bs.order[sorted_pos]

    eq = _verify(_prepare_keys(bs.key_vals, probe_keys), src, build_row)
    if kind == "left":
        synthetic = no_match[src]
        keep = in_bounds & (eq | synthetic)
        build_valid_base = ~synthetic
    else:
        keep = in_bounds & eq
        build_valid_base = torch.ones(out_capacity, dtype=torch.bool, device=dev)

    blocks, names = [], []
    for name in probe_out:
        b = probe.block(name)
        blocks.append(b.take_rows(src))
        names.append(name)
    for bname, oname in build_out:
        b = bs.page.block(bname)
        valid = build_valid_base if b.valid is None else (build_valid_base & b.valid[build_row])
        blocks.append(b.gather(build_row, valid))
        names.append(oname)
    out = Page.from_blocks(blocks, names, count=out_capacity, device=dev)
    overflow = torch.clamp(total - out_capacity, min=0)
    return compact(out, keep), overflow
