"""Hash joins on a linear-probe slot table, with the insert and probe
kernels written in CUDA (torch counterpart of presto_tpu/ops/pallas_join.py).

The reference engine generates a PagesHash + PositionLinks per key
signature (presto-main sql/gen JoinCompiler). Here, as in the JAX package,
the table is an explicit linear-probe hash table (arXiv:1905.13376's
build / probe / multiway design):

* BUILD: every live row with non-NULL keys claims a slot at its desired
  slot (the top `bits` bits of its 32-bit tag) or one of the R_MAX slots
  after it. Rows left over (heavy single-key skew) move to a tag-sorted
  OVERFLOW region probed by binary search. A permanently EMPTY last slot
  ends every scan without wrap-around.
* PROBE: per probe row, scan from the desired slot to the first EMPTY slot;
  32-bit tag matches are verified by true key equality (dictionary-unified
  for varchar), so tag collisions only cost a re-check. First-match (n1,
  semi, anti, mark) and all-matches (1:N expand) variants.
* MULTIWAY: one pass over a fact batch resolves two or more dimension
  tables before any intermediate page is materialized.

Tags are uint32 values held as int32 bit patterns (EMPTY = -1); real tags
are clamped at 0xFFFFFFFE. `join_insert` and `join_probe` are the kernel
wrappers: for CUDA tensors they launch csrc/join_insert.cu (replacing
pallas_join.py::_pallas_insert_kernel) and csrc/join_probe.cu (replacing
_pallas_probe_kernel); for CPU tensors they run `join_insert_plain` and
`join_probe_plain`. There is no fault fallback: a kernel that fails to
build or launch fails the query. Everything else (key preparation,
verification, the probe loop, the overflow and all-matches scans and page
emission) is device tensor code.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..expr.compiler import evaluate
from ..expr.functions import Val
from ..page import Block, Page
from .hashing import _srl, hash_rows_values, value_hashable

EMPTY_TAG = -1  # 0xFFFFFFFF as int32 bits: a vacant slot
MAX_TAG = 0xFFFFFFFE  # real tags clamp below EMPTY
R_MAX = 64  # insert attempts per row; leftovers go to the overflow region
MAX_SCAN = 16  # probe-kernel scan length per launch
TABLE_MAX_BUILD = 1 << 22  # larger builds keep the sorted-hash layout
_MAX_BITS = 23
THREADS = 256

# launches of the two CUDA kernels (one per wrapper call on CUDA tensors)
insert_launches = 0
probe_launches = 0
# hash tables built (the join took the table path), on any device
table_builds = 0


def _i32(tag_u: torch.Tensor) -> torch.Tensor:
    """uint32 values held in int64 -> the int32 with the same bits."""
    return torch.where(tag_u >= (1 << 31), tag_u - (1 << 32), tag_u).to(torch.int32)


def _tag_desired(h: torch.Tensor, bits: int):
    """(int32 tag bits, int32 desired slot) from 64-bit row hashes: the tag
    keeps the TOP 32 hash bits, clamped below EMPTY, and the desired slot
    is the tag's top `bits` bits."""
    t = torch.clamp(_srl(h, 32), max=MAX_TAG)
    return _i32(t), (t >> (32 - bits)).to(torch.int32)


def _pick_bits(n: int) -> int:
    bits = max(4, int(np.ceil(np.log2(max(n, 1) * 2))))
    return min(bits, _MAX_BITS)


def table_size(bits: int) -> int:
    return (1 << bits) + R_MAX + 1


@dataclasses.dataclass
class JoinTable:
    """Linear-probe hash table over one build page. The slot arrays have
    2^bits + R_MAX + 1 entries; the last is permanently EMPTY. Overflow
    rows sit sorted by (signed int32) tag in of_tag / of_row."""

    slot_tag: torch.Tensor  # int32 tag bits; EMPTY_TAG = vacant
    slot_row: torch.Tensor  # int32 build row; -1 = vacant
    bits: int
    of_tag: torch.Tensor  # int32, sorted ascending (may be empty)
    of_row: torch.Tensor  # int32
    page: Page  # build page (payload gathers)
    key_vals: Tuple[Val, ...]  # evaluated build keys
    key_exprs: tuple
    count: int  # live build rows

    @staticmethod
    def from_numpy(slot_tag, slot_row, bits, of_tag, of_row, page, key_vals, key_exprs,
                   count, device) -> "JoinTable":
        """A table from numpy slot arrays (uint32 tags, as the JAX package
        builds them) on `device`; the overflow region is re-sorted by the
        signed order this package's searches use."""
        dev = torch.device(device)
        of_t = np.asarray(of_tag, np.uint32).view(np.int32)
        order = np.argsort(of_t, kind="stable")
        return JoinTable(
            torch.from_numpy(np.asarray(slot_tag, np.uint32).view(np.int32).copy()).to(dev),
            torch.from_numpy(np.asarray(slot_row, np.int32).copy()).to(dev),
            int(bits),
            torch.from_numpy(of_t[order].copy()).to(dev),
            torch.from_numpy(np.asarray(of_row, np.int32)[order].copy()).to(dev),
            page, tuple(key_vals), tuple(key_exprs), int(count),
        )


# ---------------------------------------------------------------------------
# kernel 2: insert
# ---------------------------------------------------------------------------


def join_insert_plain(tag, row, desired, bits: int):
    """(slot_tag, slot_row, pending) in plain torch: the JAX package's
    round-parallel insert (`_host_insert`). Round k scatters each pending
    row at desired + k (some writer wins each slot), a gather confirms the
    winner, losers go on; rows unplaced after R_MAX rounds are pending."""
    dev = tag.device
    size = table_size(bits)
    limit = size - 2  # the last slot stays EMPTY
    slot_tag = torch.full((size,), EMPTY_TAG, dtype=torch.int32, device=dev)
    slot_row = torch.full((size,), -1, dtype=torch.int32, device=dev)
    d = desired.to(torch.int64)
    live = row >= 0
    cand0 = torch.clamp(d, max=limit)
    slot_row[torch.where(live, cand0, size - 1)] = torch.where(live, row, -1)
    slot_row[size - 1] = -1
    won0 = live & (slot_row[cand0] == row)
    slot_tag[cand0[won0]] = tag[won0]
    pend = torch.nonzero(live & ~won0).flatten()
    for k in range(1, R_MAX):
        if not pend.numel():
            break
        cand = torch.clamp(d[pend] + k, max=limit)
        vacant = slot_row[cand] == -1
        trial = pend[vacant]
        if trial.numel():
            tc = cand[vacant]
            slot_row[tc] = row[trial]
            won = slot_row[tc] == row[trial]
            slot_tag[tc[won]] = tag[trial[won]]
            placed = torch.zeros(pend.numel(), dtype=torch.bool, device=dev)
            placed[torch.nonzero(vacant).flatten()[won]] = True
            pend = pend[~placed]
    pending = torch.zeros(tag.shape[0], dtype=torch.int32, device=dev)
    pending[pend] = 1
    return slot_tag, slot_row, pending


def _check_vectors(*ts):
    n = ts[0].shape[0]
    for t in ts:
        if t.dtype != torch.int32 or t.ndim != 1 or t.shape[0] != n or not t.is_contiguous():
            raise ValueError("expected contiguous int32 vectors of one length")
        if t.device != ts[0].device:
            raise ValueError("all inputs must be on one device")


def _bind(name: str, argtypes):
    from .. import cuda_build

    fn = getattr(cuda_build.load(name), name)
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes
    return fn


_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def _blocks(n: int) -> int:
    return max(1, min(-(-n // THREADS), 1 << 20))


def join_insert(tag, row, desired, bits: int):
    """Build the slot arrays: (slot_tag, slot_row, pending), int32 each.
    `tag` holds uint32 tag bits, `row` the build row id or -1 (not
    inserted), `desired` the desired slot, < 2^bits. CUDA tensors go
    through csrc/join_insert.cu, CPU tensors through join_insert_plain."""
    global insert_launches
    _check_vectors(tag, row, desired)
    if not 4 <= bits <= _MAX_BITS:
        raise ValueError(f"bits {bits} out of range")
    dev = tag.device
    if dev.type == "cpu":
        return join_insert_plain(tag, row, desired, bits)
    if dev.type != "cuda":
        raise ValueError(f"no join_insert kernel for device {dev}")
    size = table_size(bits)
    n = tag.shape[0]
    slot_tag = torch.empty(size, dtype=torch.int32, device=dev)
    slot_row = torch.empty(size, dtype=torch.int32, device=dev)
    pending = torch.empty(n, dtype=torch.int32, device=dev)
    fn = _bind("join_insert", [_P, _P, _P, _LL, _I, _P, _P, _P, _I, _I, _P])
    rc = fn(tag.data_ptr(), row.data_ptr(), desired.data_ptr(), n, size,
            slot_tag.data_ptr(), slot_row.data_ptr(), pending.data_ptr(), _blocks(n),
            THREADS, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"join_insert launch failed: cudaError {rc}")
    if n:
        insert_launches += 1
    return slot_tag, slot_row, pending


def insert_invariant_errors(tag, row, desired, bits: int, slot_tag, slot_row, pending):
    """What is wrong with an insert's output, [] when nothing. Any correct
    insert (the kernel's or the plain version's, whatever the race order)
    keeps these: placed and pending rows partition the rows with row >= 0;
    every placed row sits once, at a slot in its R_MAX window
    [min(desired, limit), min(desired + R_MAX - 1, limit)] whose tag is its
    own, with every slot from its window start up to it occupied; a pending
    row found its whole window occupied; vacant slots (the last one
    always) hold EMPTY."""
    errs = []
    dev = tag.device
    size = table_size(bits)
    limit = size - 2
    live = row >= 0
    pend = pending.bool()
    if slot_tag.shape[0] != size or slot_row.shape[0] != size:
        return [f"slot arrays are not {size} long"]
    if bool((pend & ~live).any()):
        errs.append("a row that was not to be inserted is pending")
    occ = slot_row >= 0
    if bool(occ[size - 1]) or int(slot_tag[size - 1]) != EMPTY_TAG:
        errs.append("the last slot is not EMPTY")
    if bool(((slot_tag == EMPTY_TAG) == occ).any()):
        errs.append("a slot's tag disagrees with its occupancy")
    # row id -> input index
    at = torch.full((int(row.max()) + 2 if row.numel() else 1,), -1, dtype=torch.int64,
                    device=dev)
    idx = torch.nonzero(live).flatten()
    at[row[idx].to(torch.int64)] = idx
    slots = torch.nonzero(occ).flatten()
    owners = at[slot_row[slots].to(torch.int64)]
    if bool((owners < 0).any()):
        return errs + ["a slot holds a row that was not to be inserted"]
    placed_count = torch.zeros(tag.shape[0], dtype=torch.int64, device=dev)
    placed_count.index_add_(0, owners, torch.ones_like(owners))
    if bool((placed_count[live] != (~pend[live]).to(torch.int64)).any()):
        errs.append("placed and pending rows do not partition the live rows")
    lo = torch.clamp(desired.to(torch.int64), max=limit)
    hi = torch.clamp(desired.to(torch.int64) + R_MAX - 1, max=limit)
    cum = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev), torch.cumsum(occ.long(), 0)])
    o_lo = lo[owners]
    if bool(((slots < o_lo) | (slots > hi[owners])).any()):
        errs.append("a row sits outside its window")
    if bool((slot_tag[slots] != tag[owners]).any()):
        errs.append("a slot's tag is not its row's tag")
    if bool((cum[slots + 1] - cum[o_lo] != slots - o_lo + 1).any()):
        errs.append("a vacant slot lies between a row's window start and its slot")
    p = torch.nonzero(pend).flatten()
    if bool((cum[hi[p] + 1] - cum[lo[p]] != hi[p] - lo[p] + 1).any()):
        errs.append("a pending row had a vacant slot in its window")
    return errs


# ---------------------------------------------------------------------------
# kernel 3: probe
# ---------------------------------------------------------------------------


def join_probe_plain(slot_tag, slot_row, tag, desired, start, max_scan: int = MAX_SCAN):
    """(pos, row, more) in plain torch: the JAX package's probe kernel
    body. Per probe row, scan max_scan slots from desired + start: the
    first tag-match position and its row (-1 when none), and more = 1 when
    the scan neither matched nor met an EMPTY slot."""
    limit = slot_tag.shape[0] - 1
    base = desired.to(torch.int64) + start.to(torch.int64)
    found = torch.zeros(tag.shape, dtype=torch.bool, device=tag.device)
    ended = torch.zeros_like(found)
    pos = torch.full(tag.shape, -1, dtype=torch.int32, device=tag.device)
    row = torch.full_like(pos, -1)
    for k in range(max_scan):
        cand = torch.clamp(base + k, max=limit)
        t = slot_tag[cand]
        hit = ~found & ~ended & (t == tag)
        pos = torch.where(hit, cand.to(torch.int32), pos)
        row = torch.where(hit, slot_row[cand], row)
        found = found | hit
        ended = ended | (t == EMPTY_TAG)
    return pos, row, (~found & ~ended).to(torch.int32)


def join_probe(slot_tag, slot_row, tag, desired, start, max_scan: int = MAX_SCAN):
    """First tag match per probe row from scan offset `start` (see
    join_probe_plain). CUDA tensors go through csrc/join_probe.cu, CPU
    tensors through join_probe_plain."""
    global probe_launches
    _check_vectors(slot_tag, slot_row)
    _check_vectors(tag, desired, start)
    if slot_tag.device != tag.device:
        raise ValueError("table and probe rows must be on one device")
    dev = tag.device
    if dev.type == "cpu":
        return join_probe_plain(slot_tag, slot_row, tag, desired, start, max_scan)
    if dev.type != "cuda":
        raise ValueError(f"no join_probe kernel for device {dev}")
    m = tag.shape[0]
    pos = torch.empty(m, dtype=torch.int32, device=dev)
    row = torch.empty_like(pos)
    more = torch.empty_like(pos)
    if m == 0:
        return pos, row, more
    fn = _bind("join_probe", [_P, _P, _I, _P, _P, _P, _LL, _I, _P, _P, _P, _I, _I, _P])
    rc = fn(slot_tag.data_ptr(), slot_row.data_ptr(), slot_tag.shape[0], tag.data_ptr(),
            desired.data_ptr(), start.data_ptr(), m, max_scan, pos.data_ptr(),
            row.data_ptr(), more.data_ptr(), _blocks(m), THREADS,
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"join_probe launch failed: cudaError {rc}")
    probe_launches += 1
    return pos, row, more


# ---------------------------------------------------------------------------
# build
# ---------------------------------------------------------------------------


def build_table(page: Page, key_exprs) -> Optional[JoinTable]:
    """The linear-probe JoinTable of a build page, or None when the shape
    takes the sorted-hash layout instead: no keys (cross join), a build
    over TABLE_MAX_BUILD rows, or varchar keys too large to value-hash."""
    global table_builds
    if not key_exprs or page.capacity > TABLE_MAX_BUILD:
        return None
    keys = [evaluate(e, page) for e in key_exprs]
    if not value_hashable(keys):
        return None
    dev = page.device
    n = page.capacity
    cnt = int(page.count)
    bits = _pick_bits(cnt)
    tag, desired = _tag_desired(hash_rows_values(keys), bits)
    # only live rows with fully NON-NULL keys: NULL never equi-matches
    live = page.live_mask()
    for k in keys:
        if k.valid is not None:
            live = live & k.valid
    rows = torch.where(live, torch.arange(n, dtype=torch.int32, device=dev), -1)
    slot_tag, slot_row, pending = join_insert(tag, rows.to(torch.int32), desired, bits)
    left = torch.nonzero(pending).flatten()
    if left.numel():
        of_tag, order = torch.sort(tag[left], stable=True)
        of_row = rows[left][order].to(torch.int32)
    else:
        of_tag = torch.empty(0, dtype=torch.int32, device=dev)
        of_row = torch.empty(0, dtype=torch.int32, device=dev)
    table_builds += 1
    return JoinTable(slot_tag, slot_row, bits, of_tag, of_row, page, tuple(keys),
                     tuple(key_exprs), cnt)


# ---------------------------------------------------------------------------
# key verification
# ---------------------------------------------------------------------------


def _comparable_pair(pv: Val, bv: Val):
    """(probe data, build data) made directly comparable: varchar columns
    with different dictionaries translate through one unified dictionary,
    once per probe batch."""
    from ..expr.functions import unify_dictionaries
    from .. import types as T

    if (isinstance(pv.type, T.VarcharType) and pv.dict_id is not None
            and bv.dict_id is not None and pv.dict_id != bv.dict_id):
        pd_, bd_, _ = unify_dictionaries(pv, bv)
        return pd_, bd_
    return pv.data, bv.data


def _prepare_keys(build_keys: Sequence[Val], probe_keys: Sequence[Val]):
    """Per key: (probe data, build data, probe valid, build valid). Both
    build layouts (this table and ops/join.py's sorted hash) verify keys
    through this and `_verify`."""
    return [(*_comparable_pair(pv, bv), pv.valid, bv.valid)
            for pv, bv in zip(probe_keys, build_keys)]


def _verify(prep, probe_idx: torch.Tensor, build_rows: torch.Tensor) -> torch.Tensor:
    """True key equality probe[probe_idx] == build[build_rows]; NULL never
    matches."""
    build_rows = build_rows.to(torch.int64)
    ok = torch.ones(probe_idx.shape[0], dtype=torch.bool, device=probe_idx.device)
    for pd_, bd_, pvld, bvld in prep:
        part = pd_[probe_idx] == bd_[build_rows]
        if part.ndim == 2:  # long-decimal lanes
            part = part.all(dim=-1)
        if pvld is not None:
            part = part & pvld[probe_idx]
        if bvld is not None:
            part = part & bvld[build_rows]
        ok = ok & part
    return ok


# ---------------------------------------------------------------------------
# probe: first verified match (n1 / semi / anti / mark)
# ---------------------------------------------------------------------------


def _probe_n1(jt: JoinTable, ptag, pdesired, live, prep):
    """First VERIFIED match per live probe row: (matched, build_row).

    Drives the probe kernel: a row whose tag match fails key verification
    relaunches just past that match, a row whose scan ran max_scan slots
    without a match or EMPTY resumes max_scan further on. One host read per
    round (the pending set's size)."""
    dev = ptag.device
    m = ptag.shape[0]
    matched = torch.zeros(m, dtype=torch.bool, device=dev)
    brow = torch.zeros(m, dtype=torch.int32, device=dev)
    start = torch.zeros(m, dtype=torch.int32, device=dev)
    pend = torch.nonzero(live).flatten()
    limit = jt.slot_tag.shape[0] - 1
    rounds = 0
    while pend.numel() and rounds <= limit:
        pd_ = pdesired[pend]
        st = start[pend]
        pos, row, more = join_probe(jt.slot_tag, jt.slot_row, ptag[pend], pd_, st)
        got = pos >= 0
        ok = got & _verify(prep, pend, torch.clamp(row, min=0))
        matched[pend] = ok
        brow[pend] = torch.where(ok, row, brow[pend])
        retry = got & ~ok  # a tag collision: scan on past it
        more = more.bool()
        start[pend] = torch.where(retry, pos - pd_ + 1, torch.where(more, st + MAX_SCAN, st))
        pend = pend[retry | more]
        rounds += 1
    if jt.of_tag.numel():
        rest = torch.nonzero(live & ~matched).flatten()
        if rest.numel():
            m2, b2 = _probe_overflow(jt, ptag, prep, rest)
            matched[m2] = True
            brow[m2] = b2
    return matched, brow


def _overflow_ranges(jt: JoinTable, ptag, pend):
    lo = torch.searchsorted(jt.of_tag, ptag[pend])
    hi = torch.searchsorted(jt.of_tag, ptag[pend], right=True)
    sel = lo < hi
    return pend[sel], lo[sel], hi[sel]


def _probe_overflow(jt: JoinTable, ptag, prep, pend):
    """First verified match within the tag-sorted overflow region."""
    act, lo, hi = _overflow_ranges(jt, ptag, pend)
    out_idx: List[torch.Tensor] = []
    out_row: List[torch.Tensor] = []
    while act.numel():
        rows_c = jt.of_row[lo]
        ok = _verify(prep, act, rows_c)
        out_idx.append(act[ok])
        out_row.append(rows_c[ok])
        lo = lo + 1
        keep = ~ok & (lo < hi)
        act, lo, hi = act[keep], lo[keep], hi[keep]
    if out_idx:
        return torch.cat(out_idx), torch.cat(out_row)
    return pend[:0], jt.of_row[:0]


# ---------------------------------------------------------------------------
# probe: all matches (1:N expand)
# ---------------------------------------------------------------------------


def _probe_all(jt: JoinTable, ptag, pdesired, live, prep):
    """EVERY verified match as (probe row, build row) pairs, probe-row
    major (within a row: slot-scan order, then overflow order)."""
    dev = ptag.device
    limit = jt.slot_tag.shape[0] - 1
    d = pdesired.to(torch.int64)
    pi: List[torch.Tensor] = []
    bi: List[torch.Tensor] = []
    active = torch.nonzero(live).flatten()
    k = 0
    while active.numel() and k <= limit:
        cand = torch.clamp(d[active] + k, max=limit)
        t = jt.slot_tag[cand]
        rows_c = jt.slot_row[cand]
        ok = (t == ptag[active]) & _verify(prep, active, torch.clamp(rows_c, min=0))
        pi.append(active[ok])
        bi.append(rows_c[ok])
        active = active[t != EMPTY_TAG]
        k += 1
    if jt.of_tag.numel():
        act, lo, hi = _overflow_ranges(jt, ptag, torch.nonzero(live).flatten())
        cnt = hi - lo
        idx = torch.repeat_interleave(act, cnt)
        first = torch.repeat_interleave(lo - (torch.cumsum(cnt, 0) - cnt), cnt)
        posn = first + torch.arange(idx.numel(), device=dev)
        rows_c = jt.of_row[posn]
        ok = _verify(prep, idx, rows_c)
        pi.append(idx[ok])
        bi.append(rows_c[ok])
    if not pi:
        return live.new_zeros(0, dtype=torch.int64), jt.slot_row[:0]
    probe_idx = torch.cat(pi)
    build_idx = torch.cat(bi)
    order = torch.sort(probe_idx, stable=True).indices
    return probe_idx[order], build_idx[order]


# ---------------------------------------------------------------------------
# page emission
# ---------------------------------------------------------------------------


def _emit_gather(b: Block, idx: torch.Tensor, capacity: int,
                 extra_valid: Optional[torch.Tensor] = None) -> Block:
    """Gather block rows by index into a capacity-padded Block (rows past
    len(idx) are dead by the page count)."""
    n = idx.shape[0]
    full = torch.zeros(capacity, dtype=torch.int64, device=idx.device)
    full[:n] = idx
    v = None
    if b.valid is not None or extra_valid is not None:
        vv = torch.ones(n, dtype=torch.bool, device=idx.device) if b.valid is None else b.valid[idx]
        if extra_valid is not None:
            vv = vv & extra_valid
        v = torch.zeros(capacity, dtype=torch.bool, device=idx.device)
        v[:n] = vv
    return Block(b.data[full], b.type, v, b.dict_id)


def _count(n: int, device) -> torch.Tensor:
    return torch.tensor(n, dtype=torch.int32, device=device)


def _compact_page(page: Page, keep: torch.Tensor) -> Page:
    idx = torch.nonzero(keep).flatten()
    blocks = tuple(_emit_gather(b, idx, page.capacity) for b in page.blocks)
    return Page(blocks, page.names, _count(idx.numel(), page.device))


def _probe_setup(probe: Page, jt: JoinTable, probe_key_exprs):
    probe_keys = [evaluate(e, probe) for e in probe_key_exprs]
    ptag, pdesired = _tag_desired(hash_rows_values(probe_keys), jt.bits)
    return ptag, pdesired, _prepare_keys(jt.key_vals, probe_keys)


# ---------------------------------------------------------------------------
# public: the table-side join API
# ---------------------------------------------------------------------------


def table_join_n1(probe: Page, jt: JoinTable, probe_key_exprs, build_names: Sequence[str],
                  out_build_names: Sequence[str], kind: str = "inner") -> Page:
    """join_n1 over the hash table (inner | left | semi | anti)."""
    live = probe.live_mask()
    ptag, pdesired, prep = _probe_setup(probe, jt, probe_key_exprs)
    matched, brow = _probe_n1(jt, ptag, pdesired, live, prep)
    if kind == "semi":
        return _compact_page(probe, matched & live)
    if kind == "anti":
        return _compact_page(probe, ~matched & live)
    if kind == "inner":
        idx = torch.nonzero(matched & live).flatten()
        blocks = [_emit_gather(b, idx, probe.capacity) for b in probe.blocks]
        names = list(probe.names)
        bidx = brow[idx]
        for bname, oname in zip(build_names, out_build_names):
            blocks.append(_emit_gather(jt.page.block(bname), bidx, probe.capacity))
            names.append(oname)
        return Page(tuple(blocks), tuple(names), _count(idx.numel(), probe.device))
    if kind == "left":
        blocks = list(probe.blocks)
        names = list(probe.names)
        srow = torch.where(matched, brow, 0).to(torch.int64)
        for bname, oname in zip(build_names, out_build_names):
            b = jt.page.block(bname)
            v = matched if b.valid is None else (matched & b.valid[srow])
            blocks.append(Block(b.data[srow], b.type, v, b.dict_id))
            names.append(oname)
        return Page(tuple(blocks), tuple(names), probe.count)
    raise ValueError(f"unknown join kind {kind!r}")


def table_semi_mask(probe: Page, jt: JoinTable, probe_key_exprs) -> torch.Tensor:
    """semi_match_mask over the hash table (the mark join)."""
    live = probe.live_mask()
    ptag, pdesired, prep = _probe_setup(probe, jt, probe_key_exprs)
    matched, _ = _probe_n1(jt, ptag, pdesired, live, prep)
    return matched & live


def table_join_expand(probe: Page, jt: JoinTable, probe_key_exprs, probe_out: Sequence[str],
                      build_out: Sequence[Tuple[str, str]], out_capacity: int,
                      kind: str = "inner") -> Tuple[Page, int]:
    """join_expand over the hash table: exact verified pairs, so the
    returned overflow is exactly total_matches - out_capacity (one retry
    always suffices)."""
    live = probe.live_mask()
    ptag, pdesired, prep = _probe_setup(probe, jt, probe_key_exprs)
    probe_idx, build_idx = _probe_all(jt, ptag, pdesired, live, prep)
    build_idx = build_idx.to(torch.int64)
    if kind == "left":
        # one NULL-extended row for every live probe row with no match
        has = torch.zeros(probe.capacity, dtype=torch.bool, device=probe.device)
        has[probe_idx] = True
        synth = torch.nonzero(live & ~has).flatten()
        probe_idx = torch.cat([probe_idx, synth])
        build_idx = torch.cat([build_idx, torch.full_like(synth, -1)])
        order = torch.sort(probe_idx, stable=True).indices
        probe_idx, build_idx = probe_idx[order], build_idx[order]
    total = probe_idx.numel()
    emit = min(total, out_capacity)
    pidx = probe_idx[:emit]
    bidx = torch.clamp(build_idx[:emit], min=0)
    bvalid = build_idx[:emit] >= 0
    blocks, names = [], []
    for name in probe_out:
        blocks.append(_emit_gather(probe.block(name), pidx, out_capacity))
        names.append(name)
    for bname, oname in build_out:
        blocks.append(_emit_gather(jt.page.block(bname), bidx, out_capacity, extra_valid=bvalid))
        names.append(oname)
    out = Page(tuple(blocks), tuple(names), _count(emit, probe.device))
    return out, max(total - out_capacity, 0)


def table_multiway_n1(probe: Page,
                      specs: Sequence[Tuple[JoinTable, tuple, Sequence[str], Sequence[str]]]) -> Page:
    """Multiway probe: chain two or more build tables through ONE pass over
    the probe batch (INNER, at most one match per side): the batch survives
    every side's probe before any output page is materialized."""
    keep = probe.live_mask()
    gathered = []
    for jt, key_exprs, build_names, out_names in specs:
        ptag, pdesired, prep = _probe_setup(probe, jt, key_exprs)
        matched, brow = _probe_n1(jt, ptag, pdesired, keep, prep)
        keep = keep & matched
        gathered.append((brow, jt, build_names, out_names))
    idx = torch.nonzero(keep).flatten()
    blocks = [_emit_gather(b, idx, probe.capacity) for b in probe.blocks]
    names = list(probe.names)
    for brow, jt, build_names, out_names in gathered:
        bidx = brow[idx]
        for bname, oname in zip(build_names, out_names):
            blocks.append(_emit_gather(jt.page.block(bname), bidx, probe.capacity))
            names.append(oname)
    return Page(tuple(blocks), tuple(names), _count(idx.numel(), probe.device))
