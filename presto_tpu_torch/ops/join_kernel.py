"""Hash joins on a linear-probe slot table, with the insert and probe
kernels written in CUDA (torch counterpart of presto_tpu/ops/pallas_join.py).

The reference engine generates a PagesHash + PositionLinks per key
signature (presto-main sql/gen JoinCompiler). Here, as in the JAX package,
the table is an explicit linear-probe hash table (arXiv:1905.13376's
build / probe / multiway design):

* BUILD: every live row with non-NULL keys claims a slot at its desired
  slot (the top `bits` bits of its 32-bit tag) or one of the R_MAX slots
  after it. Rows left over (heavy single-key skew) move to a tag-sorted
  OVERFLOW region probed by binary search. A permanently vacant last slot
  ends every scan without wrap-around.
* PROBE: per probe row, scan from the desired slot to the first vacant
  slot; 32-bit tag matches are verified by true key equality
  (dictionary-unified for varchar), so tag collisions only cost a
  re-check. First-match (n1, semi, anti, mark) and all-matches (1:N
  expand) variants.
* MULTIWAY: one pass over a fact batch resolves two or more dimension
  tables before any intermediate page is materialized.

A slot is one packed 8-byte word, (tag, row) as two int32: `slots` is a
(2^bits + R_MAX + 1, 2) int32 tensor, vacant = (EMPTY_TAG, -1), and
`slot_tag` / `slot_row` are its two columns as strided views. Tags are
uint32 values held as int32 bit patterns (EMPTY = -1); real tags are
clamped at 0xFFFFFFFE.

`join_insert` and `join_probe` are the kernel wrappers: for CUDA tensors
they launch csrc/join_insert.cu (replacing
pallas_join.py::_pallas_insert_kernel; one launch per build, overflow
rows appended on the card) and csrc/join_probe.cu (replacing
_pallas_probe_kernel and the host key check around it: the first
VERIFIED match of every probe row in one launch); for CPU tensors they
run `join_insert_plain` and `join_probe_plain`. There is no fault
fallback: a kernel that fails to build or launch fails the query.
Everything else (key preparation, the overflow and all-matches scans and
page emission) is device tensor code.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..expr.compiler import evaluate
from ..expr.functions import NotPortedError, Val
from ..obs.kernelprof import KERNEL_PROFILE
from ..page import Block, Page
from .hashing import _srl, hash_rows_values, value_hashable

EMPTY_TAG = -1  # 0xFFFFFFFF as int32 bits: a vacant slot
MAX_TAG = 0xFFFFFFFE  # real tags clamp below EMPTY
R_MAX = 64  # insert attempts per row; leftovers go to the overflow region
MAX_KEYS = 8  # keys the probe kernel's parameters carry (csrc/join_probe.cu)
TABLE_MAX_BUILD = 1 << 22  # larger builds keep the sorted-hash layout
_MAX_BITS = 23
_PLAIN_ROUND = 16  # slots join_probe_plain scans per round
THREADS = 256

# element kinds of a key column, as csrc/join_probe.cu's KeyKind names them
KEY_KINDS = {torch.bool: 0, torch.int8: 0, torch.uint8: 0, torch.int16: 1, torch.int32: 2,
             torch.int64: 3, torch.float32: 4, torch.float64: 5}

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
    is the tag's top `bits` bits. The kernels derive both the same way."""
    t = torch.clamp(_srl(h, 32), max=MAX_TAG)
    return _i32(t), (t >> (32 - bits)).to(torch.int32)


def _pick_bits(n: int) -> int:
    bits = max(4, int(np.ceil(np.log2(max(n, 1) * 2))))
    return min(bits, _MAX_BITS)


def table_size(bits: int) -> int:
    return (1 << bits) + R_MAX + 1


@dataclasses.dataclass
class JoinTable:
    """Linear-probe hash table over one build page. `slots` has
    2^bits + R_MAX + 1 packed (tag, row) slots; the last is permanently
    vacant. Overflow rows sit sorted by (signed int32) tag in of_tag /
    of_row."""

    slots: torch.Tensor  # (size, 2) int32: tag bits, build row; (EMPTY_TAG, -1) = vacant
    bits: int
    of_tag: torch.Tensor  # int32, sorted ascending (may be empty)
    of_row: torch.Tensor  # int32
    page: Page  # build page (payload gathers)
    key_vals: Tuple[Val, ...]  # evaluated build keys
    key_exprs: tuple
    count: int  # live build rows

    @property
    def slot_tag(self) -> torch.Tensor:
        return self.slots[:, 0]

    def occupancy(self) -> float:
        """Share of the 2^bits slots holding a row (overflow rows excluded;
        no host read: both counts are known on the host)."""
        return (self.count - len(self.of_tag)) / (1 << self.bits)

    @property
    def slot_row(self) -> torch.Tensor:
        return self.slots[:, 1]

    @staticmethod
    def from_numpy(slot_tag, slot_row, bits, of_tag, of_row, page, key_vals, key_exprs,
                   count, device) -> "JoinTable":
        """A table from numpy slot arrays (uint32 tags, as the JAX package
        builds them) on `device`, packed into slot words; the overflow
        region is re-sorted by the signed order this package's searches
        use."""
        dev = torch.device(device)
        of_t = np.asarray(of_tag, np.uint32).view(np.int32)
        order = np.argsort(of_t, kind="stable")
        slots = np.stack([np.asarray(slot_tag, np.uint32).view(np.int32),
                          np.asarray(slot_row, np.int32)], axis=1)
        return JoinTable(
            torch.from_numpy(slots).to(dev),
            int(bits),
            torch.from_numpy(of_t[order].copy()).to(dev),
            torch.from_numpy(np.asarray(of_row, np.int32)[order].copy()).to(dev),
            page, tuple(key_vals), tuple(key_exprs), int(count),
        )


# ---------------------------------------------------------------------------
# the CUDA libraries
# ---------------------------------------------------------------------------


class InsertParams(ctypes.Structure):
    """csrc/join_insert.cu's InsertParams, field for field: passed by
    pointer to the C entry, which copies it into the launch."""

    _fields_ = [
        ("hash", ctypes.c_void_p),
        ("live", ctypes.c_void_p),
        ("slots", ctypes.c_void_p),  # size + 1 words: the table, then the counter
        ("overflow", ctypes.c_void_p),
        ("n", ctypes.c_longlong),
        ("size", ctypes.c_int),
        ("bits", ctypes.c_int),
    ]


class ProbeKey(ctypes.Structure):
    """csrc/join_probe.cu's ProbeKey: one key column pair."""

    _fields_ = [
        ("probe", ctypes.c_void_p),
        ("build", ctypes.c_void_p),
        ("probe_valid", ctypes.c_void_p),  # None: no NULLs
        ("build_valid", ctypes.c_void_p),
        ("kind", ctypes.c_int),
        ("lanes", ctypes.c_int),
    ]


class ProbeParams(ctypes.Structure):
    """csrc/join_probe.cu's ProbeParams, field for field."""

    _fields_ = [
        ("slots", ctypes.c_void_p),
        ("hash", ctypes.c_void_p),
        ("live", ctypes.c_void_p),
        ("matched", ctypes.c_void_p),
        ("brow", ctypes.c_void_p),
        ("m", ctypes.c_longlong),
        ("size", ctypes.c_int),
        ("bits", ctypes.c_int),
        ("num_keys", ctypes.c_int),
        ("key", ProbeKey * MAX_KEYS),
    ]


_LIBS: Dict[str, ctypes.CDLL] = {}
_PARAMS = {"join_insert": InsertParams, "join_probe": ProbeParams}


def _lib(name: str) -> ctypes.CDLL:
    """Kernel library `name` (join_insert | join_probe), built and bound
    at first use."""
    lib = _LIBS.get(name)
    if lib is None:
        from .. import cuda_build

        lib = cuda_build.load(name)
        launch = getattr(lib, f"{name}_launch")
        launch.restype = ctypes.c_int
        launch.argtypes = [ctypes.POINTER(_PARAMS[name]), ctypes.c_int, ctypes.c_void_p]
        layout = getattr(lib, f"{name}_params_layout")
        layout.restype = ctypes.c_int
        layout.argtypes = [ctypes.POINTER(ctypes.c_longlong)]
        _LIBS[name] = lib
    return lib


def params_layout(name: str) -> List[int]:
    """The parameter struct of kernel library `name` as the C side lays it
    out (sizeof, then field offsets; for join_probe then ProbeKey's): the
    card's build, to compare with `ctypes_layout(name)`."""
    buf = (ctypes.c_longlong * 32)()
    n = getattr(_lib(name), f"{name}_params_layout")(buf)
    return list(buf[:n])


def ctypes_layout(name: str) -> List[int]:
    """The same figures for the ctypes twins."""
    out = []
    for struct in (_PARAMS[name],) + ((ProbeKey,) if name == "join_probe" else ()):
        out += [ctypes.sizeof(struct)] + [getattr(struct, f).offset for f, _ in struct._fields_]
    return out


def _blocks(n: int) -> int:
    return max(1, min(-(-n // THREADS), 1 << 20))


def _stream(dev: torch.device) -> int:
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    return torch._C._cuda_getCurrentRawStream(idx)


def _check_rows(h, live):
    if h.dtype != torch.int64 or h.ndim != 1 or not h.is_contiguous():
        raise ValueError("expected a contiguous int64 vector of row hashes")
    if live.dtype != torch.bool or live.shape != h.shape or not live.is_contiguous():
        raise ValueError("expected a contiguous bool live mask, one flag per hash")
    if live.device != h.device:
        raise ValueError("all inputs must be on one device")


# ---------------------------------------------------------------------------
# kernel 2: insert
# ---------------------------------------------------------------------------


def join_insert_plain(h, live, bits: int):
    """(slots, overflow, last) in plain torch: the JAX package's
    round-parallel insert (`_host_insert`) of every live row, row id = its
    index. Round k scatters each pending row at desired + k (some writer
    wins each slot), a gather confirms the winner, losers go on; rows
    unplaced after R_MAX rounds fill overflow[:last + 1] as (tag, row)
    pairs in row order."""
    dev = h.device
    tag, desired = _tag_desired(h, bits)
    n = h.shape[0]
    size = table_size(bits)
    limit = size - 2  # the last slot stays vacant
    slots = torch.full((size, 2), -1, dtype=torch.int32, device=dev)
    slot_tag, slot_row = slots[:, 0], slots[:, 1]
    row = torch.where(live, torch.arange(n, dtype=torch.int32, device=dev), -1)
    d = desired.to(torch.int64)
    cand0 = torch.clamp(d, max=limit)
    slot_row[torch.where(live, cand0, size - 1)] = row
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
    overflow = torch.full((n, 2), -1, dtype=torch.int32, device=dev)
    overflow[:pend.numel()] = torch.stack([tag[pend], pend.to(torch.int32)], dim=1)
    return slots, overflow, torch.tensor(pend.numel() - 1, dtype=torch.int32, device=dev)


def join_insert(h, live, bits: int):
    """Build the slot table of the rows with live[i]: (slots, overflow,
    last). `h` holds the 64-bit row hashes; a row's id is its index.
    `slots` is the (table_size(bits), 2) int32 table; rows that claimed no
    slot of their R_MAX window are the (tag, row) pairs overflow[:last + 1]
    (`last` a 0-d int32 tensor on the device, -1 when none; their order is
    the race's). CUDA tensors go through csrc/join_insert.cu (one memset,
    one launch, no host read), CPU tensors through join_insert_plain."""
    global insert_launches
    _check_rows(h, live)
    if not 4 <= bits <= _MAX_BITS:
        raise ValueError(f"bits {bits} out of range")
    dev = h.device
    if dev.type == "cpu":
        return join_insert_plain(h, live, bits)
    if dev.type != "cuda":
        raise ValueError(f"no join_insert kernel for device {dev}")
    n = h.shape[0]
    size = table_size(bits)
    table = torch.empty((size + 1, 2), dtype=torch.int32, device=dev)
    overflow = torch.empty((n, 2), dtype=torch.int32, device=dev)
    p = InsertParams(h.data_ptr(), live.data_ptr(), table.data_ptr(), overflow.data_ptr(), n,
                     size, bits)
    lib = _lib("join_insert")
    timing = KERNEL_PROFILE.start("join_insert", dev) if n else None
    rc = lib.join_insert_launch(ctypes.byref(p), _blocks(n), _stream(dev))
    if rc != 0:
        raise RuntimeError(f"join_insert launch failed: cudaError {rc}")
    if n:
        KERNEL_PROFILE.stop(timing)
        insert_launches += 1
    return table[:size], overflow, table[size, 0]


def insert_invariant_errors(h, live, bits: int, slots, overflow, last):
    """What is wrong with an insert's output, [] when nothing. Any correct
    insert (the kernel's or the plain version's, whatever the race order)
    keeps these: placed rows and overflow rows partition the live rows;
    every placed row sits once, at a slot in its R_MAX window
    [min(desired, limit), min(desired + R_MAX - 1, limit)] whose tag is its
    own, with every slot from its window start up to it occupied; an
    overflow pair holds its row's tag, and its row found its whole window
    occupied; vacant slots (the last one always) hold (EMPTY_TAG, -1)."""
    errs = []
    dev = h.device
    tag, desired = _tag_desired(h, bits)
    n = h.shape[0]
    size = table_size(bits)
    limit = size - 2
    if tuple(slots.shape) != (size, 2):
        return [f"the table is not ({size}, 2)"]
    slot_tag, slot_row = slots[:, 0], slots[:, 1]
    count = int(last) + 1
    if not 0 <= count <= n:
        return [f"overflow count {count} is outside [0, {n}]"]
    of_rows = overflow[:count, 1].to(torch.int64)
    if bool(((of_rows < 0) | (of_rows >= n)).any()):
        return errs + ["an overflow pair names no row"]
    pend = torch.zeros(n, dtype=torch.bool, device=dev)
    pend[of_rows] = True
    if int(pend.sum()) != count:
        errs.append("a row overflowed twice")
    if bool((pend & ~live).any()):
        errs.append("a row that was not to be inserted overflowed")
    if bool((overflow[:count, 0] != tag[of_rows]).any()):
        errs.append("an overflow pair's tag is not its row's tag")
    occ = slot_row >= 0
    if bool(occ[size - 1]) or int(slot_tag[size - 1]) != EMPTY_TAG:
        errs.append("the last slot is not vacant")
    if bool(((slot_tag == EMPTY_TAG) == occ).any()):
        errs.append("a slot's tag disagrees with its occupancy")
    slots_at = torch.nonzero(occ).flatten()
    owners = slot_row[slots_at].to(torch.int64)
    if bool((owners >= n).any()) or bool((~live[torch.clamp(owners, max=n - 1)]).any()):
        return errs + ["a slot holds a row that was not to be inserted"]
    placed_count = torch.zeros(n, dtype=torch.int64, device=dev)
    placed_count.index_add_(0, owners, torch.ones_like(owners))
    if bool((placed_count[live] != (~pend[live]).to(torch.int64)).any()):
        errs.append("placed and overflow rows do not partition the live rows")
    lo = torch.clamp(desired.to(torch.int64), max=limit)
    hi = torch.clamp(desired.to(torch.int64) + R_MAX - 1, max=limit)
    cum = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev), torch.cumsum(occ.long(), 0)])
    o_lo = lo[owners]
    if bool(((slots_at < o_lo) | (slots_at > hi[owners])).any()):
        errs.append("a row sits outside its window")
    if bool((slot_tag[slots_at] != tag[owners]).any()):
        errs.append("a slot's tag is not its row's tag")
    if bool((cum[slots_at + 1] - cum[o_lo] != slots_at - o_lo + 1).any()):
        errs.append("a vacant slot lies between a row's window start and its slot")
    p = of_rows
    if bool((cum[hi[p] + 1] - cum[lo[p]] != hi[p] - lo[p] + 1).any()):
        errs.append("an overflow row had a vacant slot in its window")
    return errs


# ---------------------------------------------------------------------------
# kernel 3: probe
# ---------------------------------------------------------------------------


def _kernel_keys(prep):
    """`prep` (see _prepare_keys) as the probe kernel reads it: each key's
    probe and build data of one dtype with one lane count, contiguous.
    Raises NotPortedError for what its parameters cannot carry."""
    if len(prep) > MAX_KEYS:
        raise NotPortedError(f"a join on {len(prep)} keys: the probe kernel takes at most "
                             f"{MAX_KEYS}")
    out = []
    for pd_, bd_, pvld, bvld in prep:
        if pd_.dtype != bd_.dtype:
            common = torch.promote_types(pd_.dtype, bd_.dtype)
            pd_, bd_ = pd_.to(common), bd_.to(common)
        if pd_.dtype not in KEY_KINDS or pd_.ndim not in (1, 2) or pd_.shape[1:] != bd_.shape[1:]:
            raise NotPortedError(f"a join key of {pd_.dtype} {tuple(pd_.shape[1:])} / "
                                 f"{tuple(bd_.shape[1:])} lanes")
        for v in (pvld, bvld):
            if v is not None and v.dtype != torch.bool:
                raise ValueError("key validity masks must be bool")
        out.append((pd_.contiguous(), bd_.contiguous(),
                    None if pvld is None else pvld.contiguous(),
                    None if bvld is None else bvld.contiguous()))
    return out


def pack_probe_params(slots, h, live, matched, brow, bits: int, keys) -> ProbeParams:
    """The probe launch's parameters: the tensors' addresses, sizes and,
    per key of `keys` (as _kernel_keys makes them), the data and
    validity addresses, element kind and lane count."""
    dev = h.device
    p = ProbeParams(slots.data_ptr(), h.data_ptr(), live.data_ptr(), matched.data_ptr(),
                    brow.data_ptr(), h.shape[0], slots.shape[0], bits, len(keys))
    for k, (pd_, bd_, pvld, bvld) in enumerate(keys):
        if any(t is not None and t.device != dev for t in (pd_, bd_, pvld, bvld)):
            raise ValueError("keys must be on the probe rows' device")
        p.key[k] = ProbeKey(pd_.data_ptr(), bd_.data_ptr(),
                            None if pvld is None else pvld.data_ptr(),
                            None if bvld is None else bvld.data_ptr(),
                            KEY_KINDS[pd_.dtype], 1 if pd_.ndim == 1 else pd_.shape[1])
    return p


def join_probe_plain(slots, h, live, bits: int, prep):
    """(matched, brow) in plain torch: the first VERIFIED match of every
    live probe row in the slot region, brow -1 where none. Rounds of
    _PLAIN_ROUND slots from each row's desired slot, bounded by the
    table's size; every tag match before the row's first vacant slot is
    checked with _verify, and a row stops at its first verified match or
    at a vacant slot."""
    dev = h.device
    tag, desired = _tag_desired(h, bits)
    slot_tag, slot_row = slots[:, 0], slots[:, 1]
    limit = slots.shape[0] - 1
    m = h.shape[0]
    matched = torch.zeros(m, dtype=torch.bool, device=dev)
    brow = torch.full((m,), -1, dtype=torch.int32, device=dev)
    act = torch.nonzero(live).flatten()
    steps = torch.arange(_PLAIN_ROUND, device=dev)
    start = 0
    while act.numel() and start <= limit:
        cand = torch.clamp(desired[act].to(torch.int64)[:, None] + start + steps, max=limit)
        st, sr = slot_tag[cand], slot_row[cand]
        scanning = torch.cumsum((st == EMPTY_TAG).to(torch.int32), 1) == 0
        hr, hc = torch.nonzero(scanning & (st == tag[act][:, None]), as_tuple=True)
        ok = _verify(prep, act[hr], sr[hr, hc])
        good = torch.zeros_like(scanning)
        good[hr[ok], hc[ok]] = True
        found = good.any(1)
        first = good.to(torch.int32).argmax(1)
        matched[act[found]] = True
        brow[act[found]] = sr[found, first[found]]
        act = act[~found & scanning[:, -1]]
        start += _PLAIN_ROUND
    return matched, brow


def join_probe(slots, h, live, bits: int, prep):
    """(matched bool, brow int32) per probe row: the first slot from the
    row's desired slot, before the first vacant one, whose tag is the
    row's AND whose build row's keys equal the row's (brow -1 where none;
    rows with live[i] false or a NULL key never match). `h` holds the
    probe rows' 64-bit hashes, `prep` the keys as _prepare_keys makes
    them (at most MAX_KEYS). The overflow region is not searched. CUDA
    tensors go through csrc/join_probe.cu (one launch, no host read),
    CPU tensors through join_probe_plain."""
    global probe_launches
    _check_rows(h, live)
    if (slots.dtype != torch.int32 or tuple(slots.shape) != (table_size(bits), 2)
            or not slots.is_contiguous()):
        raise ValueError("expected a contiguous (table_size(bits), 2) int32 slot table")
    if slots.device != h.device:
        raise ValueError("table and probe rows must be on one device")
    keys = _kernel_keys(prep)
    dev = h.device
    if dev.type == "cpu":
        return join_probe_plain(slots, h, live, bits, keys)
    if dev.type != "cuda":
        raise ValueError(f"no join_probe kernel for device {dev}")
    m = h.shape[0]
    matched = torch.empty(m, dtype=torch.bool, device=dev)
    brow = torch.empty(m, dtype=torch.int32, device=dev)
    if m == 0:
        return matched, brow
    p = pack_probe_params(slots, h, live, matched, brow, bits, keys)
    lib = _lib("join_probe")
    timing = KERNEL_PROFILE.start("join_probe", dev)
    rc = lib.join_probe_launch(ctypes.byref(p), _blocks(m), _stream(dev))
    if rc != 0:
        raise RuntimeError(f"join_probe launch failed: cudaError {rc}")
    KERNEL_PROFILE.stop(timing)
    probe_launches += 1
    return matched, brow


# ---------------------------------------------------------------------------
# build
# ---------------------------------------------------------------------------


def build_table(page: Page, key_exprs) -> Optional[JoinTable]:
    """The linear-probe JoinTable of a build page, or None when the shape
    takes the sorted-hash layout instead: no keys (cross join), a build
    over TABLE_MAX_BUILD rows, varchar keys too large to value-hash, or
    keys the probe kernel cannot carry (more than MAX_KEYS, or a key
    whose kind or lanes _kernel_keys refuses). Two host reads: the live
    count (it sizes the table) and the overflow count after the insert."""
    global table_builds
    if not key_exprs or page.capacity > TABLE_MAX_BUILD or len(key_exprs) > MAX_KEYS:
        return None
    keys = [evaluate(e, page) for e in key_exprs]
    if not value_hashable(keys) or not all(k.data.dtype in KEY_KINDS and k.data.ndim in (1, 2)
                                           for k in keys):
        return None
    cnt = int(page.count)
    bits = _pick_bits(cnt)
    # only live rows with fully NON-NULL keys: NULL never equi-matches
    live = page.live_mask()
    for k in keys:
        if k.valid is not None:
            live = live & k.valid
    slots, overflow, last = join_insert(hash_rows_values(keys), live, bits)
    left = int(last) + 1
    if left:
        pairs = overflow[:left]
        wide = pairs.to(torch.int64)
        pairs = pairs[torch.argsort(wide[:, 0] * (1 << 32) + wide[:, 1])]  # by (tag, row)
        of_tag, of_row = pairs[:, 0].contiguous(), pairs[:, 1].contiguous()
    else:
        of_tag = of_row = torch.empty(0, dtype=torch.int32, device=page.device)
    table_builds += 1
    return JoinTable(slots, bits, of_tag, of_row, page, tuple(keys), tuple(key_exprs), cnt)


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
    through this: the probe kernel on the card, `_verify` in tensor code."""
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


def _probe_n1(jt: JoinTable, h, live, prep):
    """First VERIFIED match per live probe row: (matched, build_row), -1
    where none. The slot region is one join_probe call: on the card one
    launch and no host read. The overflow region (present only after heavy
    key skew; its size is known on the host) is searched in tensor code
    for the rows still unmatched."""
    matched, brow = join_probe(jt.slots, h, live, jt.bits, prep)
    if jt.of_tag.numel():
        rest = torch.nonzero(live & ~matched).flatten()
        if rest.numel():
            ptag, _ = _tag_desired(h, jt.bits)
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
    return b.gather(full, v)


def _count(n: int, device) -> torch.Tensor:
    return torch.tensor(n, dtype=torch.int32, device=device)


def _compact_page(page: Page, keep: torch.Tensor) -> Page:
    idx = torch.nonzero(keep).flatten()
    blocks = tuple(_emit_gather(b, idx, page.capacity) for b in page.blocks)
    return Page(blocks, page.names, _count(idx.numel(), page.device))


def _probe_setup(probe: Page, jt: JoinTable, probe_key_exprs):
    """(probe row hashes, prepared keys) of a probe page."""
    probe_keys = [evaluate(e, probe) for e in probe_key_exprs]
    return hash_rows_values(probe_keys), _prepare_keys(jt.key_vals, probe_keys)


# ---------------------------------------------------------------------------
# public: the table-side join API
# ---------------------------------------------------------------------------


def table_join_n1(probe: Page, jt: JoinTable, probe_key_exprs, build_names: Sequence[str],
                  out_build_names: Sequence[str], kind: str = "inner") -> Page:
    """join_n1 over the hash table (inner | left | semi | anti)."""
    live = probe.live_mask()
    h, prep = _probe_setup(probe, jt, probe_key_exprs)
    matched, brow = _probe_n1(jt, h, live, prep)
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
            blocks.append(b.gather(srow, v))
            names.append(oname)
        return Page(tuple(blocks), tuple(names), probe.count)
    raise ValueError(f"unknown join kind {kind!r}")


def table_semi_mask(probe: Page, jt: JoinTable, probe_key_exprs) -> torch.Tensor:
    """semi_match_mask over the hash table (the mark join)."""
    live = probe.live_mask()
    h, prep = _probe_setup(probe, jt, probe_key_exprs)
    matched, _ = _probe_n1(jt, h, live, prep)
    return matched & live


def table_join_expand(probe: Page, jt: JoinTable, probe_key_exprs, probe_out: Sequence[str],
                      build_out: Sequence[Tuple[str, str]], out_capacity: int,
                      kind: str = "inner") -> Tuple[Page, int]:
    """join_expand over the hash table: exact verified pairs, so the
    returned overflow is exactly total_matches - out_capacity (one retry
    always suffices)."""
    live = probe.live_mask()
    h, prep = _probe_setup(probe, jt, probe_key_exprs)
    ptag, pdesired = _tag_desired(h, jt.bits)
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
        h, prep = _probe_setup(probe, jt, key_exprs)
        matched, brow = _probe_n1(jt, h, keep, prep)
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
