"""Runtime dynamic filters: build-side summaries pushed into probe scans
(torch counterpart of the single-process half of presto_tpu/exec/dynfilter.py).

Re-designed equivalent of the reference's dynamic filtering stack
(presto-main/.../operator/DynamicFilterSourceOperator collecting build-side
values, LocalDynamicFiltersCollector feeding probe-side scans). After a
join's build side materializes, the executor derives ONE per-key summary on
the device and publishes it under the planner-assigned filter id. The
strategy follows the build side's real cardinality:

  minmax   exact min/max of the build keys (ordered storage types);
  inlist   exact sorted distinct values when build NDV <= IN_LIST_LIMIT,
           membership by binary search;
  bloom    blocked bloom filter over the engine row hash otherwise
           (ops/bloomfilter.py): no false negatives.

Probe rows with NULL keys are pruned too (NULL never equi-matches); the
planner annotates only inner joins and plain semi joins, where dropping
non-matching probe rows early is an identity on the result.
"""

from __future__ import annotations

import base64
import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .. import types as T
from ..ops.bloomfilter import bloom_build, bloom_query, choose_log2_bits
from ..ops.hashing import hash_column

IN_LIST_LIMIT = 8192  # build NDV at or under this derives the exact IN-list

_ORDERED = (
    T.BigintType, T.IntegerType, T.SmallintType, T.TinyintType,
    T.DateType, T.TimestampType, T.DoubleType, T.RealType,
)


def _is_ordered_storage(typ) -> bool:
    """Types whose 1-D storage ints/floats order like the logical value."""
    return isinstance(typ, _ORDERED) or (
        isinstance(typ, T.DecimalType) and not typ.is_long
    )


@dataclasses.dataclass
class DynamicFilter:
    """One derived build-side summary, queryable on the device. A filter
    carries minmax when the key type is ordered, plus exactly one of
    values / bloom_words / str_values when membership is on."""

    strategy: str  # 'minmax' | 'inlist' | 'bloom'
    build_rows: int
    lo: Optional[torch.Tensor] = None  # storage-unit scalars
    hi: Optional[torch.Tensor] = None
    values: Optional[torch.Tensor] = None  # sorted distinct storage values
    bloom_words: Optional[torch.Tensor] = None
    log2_bits: int = 0
    str_values: Optional[Tuple[str, ...]] = None  # varchar IN-list (logical)
    empty_build: bool = False  # no live build rows: the probe matches nothing

    def mask(self, val) -> torch.Tensor:
        """Per-row keep mask over a probe key Val/Block: False rows can
        never match the build side. The summary follows the probe to its
        device (a mesh worker's pre-probe may sit on another card)."""
        data = val.data
        dev = data.device
        if self.empty_build:
            return torch.zeros(data.shape[:1], dtype=torch.bool, device=data.device)
        if self.str_values is not None:
            keep = self._varchar_mask(val)
        else:
            keep = torch.ones(data.shape[:1], dtype=torch.bool, device=data.device)
            if self.lo is not None and data.ndim == 1:
                keep = (data >= self.lo.to(dev)) & (data <= self.hi.to(dev))
            if self.values is not None and data.ndim == 1:
                dt = torch.promote_types(self.values.dtype, data.dtype)
                values, probe = self.values.to(dev, dt), data.to(dt).contiguous()
                pos = torch.searchsorted(values, probe).clamp(max=values.shape[0] - 1)
                keep = keep & (values[pos] == probe)
            elif self.bloom_words is not None:
                h = hash_column(data)
                keep = keep & bloom_query(self.bloom_words.to(dev), h, self.log2_bits)
        if val.valid is not None:
            keep = keep & val.valid  # NULL keys never equi-match
        return keep

    def _varchar_mask(self, val) -> torch.Tensor:
        """Varchar membership through the probe DICTIONARY: a host lookup
        table over its entries, gathered by code (codes are
        dictionary-local; logical strings are the cross-dictionary
        currency)."""
        data = val.data
        if val.dict_id is None:
            return torch.ones(data.shape[:1], dtype=torch.bool, device=data.device)
        entries = val.dictionary
        members = frozenset(self.str_values)
        lut = np.fromiter((s in members for s in entries), np.bool_, count=len(entries))
        if not len(lut):
            return torch.zeros(data.shape[:1], dtype=torch.bool, device=data.device)
        lut_t = torch.from_numpy(lut).to(data.device)
        return lut_t[torch.clamp(data.to(torch.int64), 0, len(lut) - 1)]

    def describe(self) -> str:
        if self.empty_build:
            return "empty"
        if self.strategy == "bloom":
            return f"bloom(n={self.build_rows},bits=2^{self.log2_bits})"
        if self.strategy == "inlist":
            n = len(self.str_values) if self.str_values is not None else int(self.values.shape[0])
            return f"inlist({n})"
        return f"minmax(n={self.build_rows})"


def _key_stats(data, valid):
    """(n, ndv, sorted keys) with invalid rows sent to the dtype's max
    sentinel, so live distinct values occupy a prefix."""
    if data.is_floating_point():
        sentinel = float("inf")
    else:
        sentinel = torch.iinfo(data.dtype).max
    s = torch.sort(torch.where(valid, data, torch.full_like(data, sentinel))).values
    n = valid.sum(dtype=torch.int64)
    idx = torch.arange(data.shape[0], dtype=torch.int64, device=data.device)
    boundary = torch.cat([torch.ones(1, dtype=torch.bool, device=data.device), s[1:] != s[:-1]])
    ndv = (boundary & (idx < n)).sum(dtype=torch.int64)
    return n, ndv, s, boundary


def derive_filter(val, live: torch.Tensor) -> Optional[DynamicFilter]:
    """Summarize one build-side key column (a Val/Block) into a
    DynamicFilter, or None when the type has no cheap summary. One host
    read of (n, ndv) picks the strategy."""
    data = val.data
    valid = live if val.valid is None else (live & val.valid)
    typ = val.type
    if isinstance(typ, T.VarcharType):
        return _derive_varchar(val, valid)
    if data.ndim != 1 or data.dtype == torch.bool or not _is_ordered_storage(typ):
        return None  # long-decimal lanes, booleans: not worth a filter
    if data.is_floating_point():
        # NaN build keys never equi-match, and a NaN min/max would prune
        # every probe row: treat them as absent
        valid = valid & ~torch.isnan(data)
    n_d, ndv_d, s, boundary = _key_stats(data, valid)
    n, ndv = torch.stack([n_d, ndv_d]).tolist()
    if n == 0:
        return DynamicFilter("minmax", 0, empty_build=True)
    lo = s[0]
    hi = torch.where(valid, data, lo).max()
    if ndv <= IN_LIST_LIMIT:
        values = s[:n][boundary[:n]]
        return DynamicFilter("inlist", n, lo=lo, hi=hi, values=values)
    log2_bits = choose_log2_bits(ndv)
    words = bloom_build(hash_column(data), valid, log2_bits)
    return DynamicFilter("bloom", n, lo=lo, hi=hi, bloom_words=words, log2_bits=log2_bits)


def _derive_varchar(val, valid) -> Optional[DynamicFilter]:
    """Varchar keys: the logical string set of the live rows' codes. A
    dictionary above the IN-list limit gets no filter (a bloom over codes
    would be wrong across dictionaries)."""
    if val.dict_id is None:
        return None
    entries = val.dictionary
    if len(entries) > IN_LIST_LIMIT:
        return None
    nbits = max(len(entries), 1)
    codes = torch.clamp(val.data.to(torch.int64), 0, nbits - 1)
    seen = torch.zeros(nbits + 1, dtype=torch.bool, device=val.data.device)
    seen[torch.where(valid, codes, nbits)] = True
    seen_h = seen[:nbits].cpu().numpy()
    n = int(seen_h.sum())
    if n == 0:
        return DynamicFilter("minmax", 0, empty_build=True)
    strs = tuple(s for s, flag in zip(entries, seen_h) if flag)
    return DynamicFilter("inlist", n, str_values=strs)


class DynamicFilterContext:
    """Per-query registry of derived filters. The single-process executor
    publishes synchronously (a build side completes before its probe side
    runs), so `get` never waits."""

    def __init__(self):
        self._filters: Dict[str, DynamicFilter] = {}
        # fid -> rows pruned at a scan/filter vs before a probe
        self.scan_pruned: Dict[str, int] = {}
        self.preprobe_pruned: Dict[str, int] = {}

    def publish(self, fid: str, df: DynamicFilter) -> None:
        self._filters[fid] = df

    def get(self, fid: str) -> Optional[DynamicFilter]:
        return self._filters.get(fid)

    def note_pruned(self, fid: str, n: int, where: str = "scan") -> None:
        book = self.scan_pruned if where == "scan" else self.preprobe_pruned
        book[fid] = book.get(fid, 0) + int(n)

    def total_pruned(self) -> int:
        return sum(self.scan_pruned.values()) + sum(self.preprobe_pruned.values())

    def snapshot(self) -> dict:
        """The last query's filters and pruning counts (benchmark/northstar.py)."""
        return {
            "filters": {fid: df.describe() for fid, df in self._filters.items()},
            "scan_pruned": dict(self.scan_pruned),
            "preprobe_pruned": dict(self.preprobe_pruned),
        }

    def reset(self) -> None:
        self._filters.clear()
        self.scan_pruned.clear()
        self.preprobe_pruned.clear()


# ---------------------------------------------------------------------------
# host accumulation + summaries (the host half of the JAX package's
# exec/dynfilter.py:383-602): filters derived from an offloaded build side
# that lives in pinned host memory or on disk (exec/stream.py
# _publish_host_filters). The cluster half (merge_summaries, shipping
# between tasks) waits for the server port.
# ---------------------------------------------------------------------------


def in_list_limit() -> int:
    return IN_LIST_LIMIT


def _bloom_words_host(hashes: np.ndarray, log2_bits: int,
                      words: Optional[np.ndarray] = None) -> np.ndarray:
    """OR the bits of int64 `hashes` into uint32 bloom words (ops/bloomfilter
    on the CPU, so a host-built filter answers the card's probes)."""
    h = torch.from_numpy(np.ascontiguousarray(hashes).view(np.int64))
    built = bloom_build(h, torch.ones(h.shape, dtype=torch.bool), log2_bits)
    new = built.numpy().astype(np.uint32)
    return new if words is None else (words | new)


class HostFilterAccumulator:
    """Accumulates a filter summary on the HOST over numpy columns (spilled
    build sides). Varchar and long-decimal channels are skipped (dictionary
    codes are per-dictionary; 2-lane storage has no scalar summary)."""

    def __init__(self, channel: str):
        self.channel = channel
        self.typ = None
        self.count = 0
        self.lo = None
        self.hi = None
        self.values: Optional[set] = set()  # None once overflowed
        self.words: Optional[np.ndarray] = None
        self.log2_bits = choose_log2_bits(in_list_limit() * 4)
        self.unsupported = False

    def add_numpy(self, data: np.ndarray, valid, typ) -> None:
        """Accumulate raw host columns."""
        if self.unsupported:
            return
        if data.ndim != 1 or isinstance(typ, T.VarcharType) or not _is_ordered_storage(typ):
            self.unsupported = True
            return
        self.typ = typ
        if valid is not None:
            data = data[valid]
        if np.issubdtype(data.dtype, np.floating):
            data = data[~np.isnan(data)]  # NaN never equi-matches
        if not len(data):
            return
        self.count += len(data)
        lo, hi = data.min(), data.max()
        self.lo = lo if self.lo is None else min(self.lo, lo)
        self.hi = hi if self.hi is None else max(self.hi, hi)
        if self.values is not None:
            self.values.update(np.unique(data).tolist())
            if len(self.values) > in_list_limit():
                self.values = None  # overflow: bloom only from here on
        self.words = _bloom_words_host(_host_hash(data), self.log2_bits, self.words)

    def summary(self) -> Optional[dict]:
        """JSON-able summary, or None when nothing useful accrued."""
        if self.unsupported or self.typ is None:
            return None
        out = {
            "count": self.count,
            "type": repr(self.typ),
            "lo": _json_scalar(self.lo),
            "hi": _json_scalar(self.hi),
            "float": isinstance(self.typ, (T.DoubleType, T.RealType)),
            # REAL keys hash by their float32 bit pattern: a values->bloom
            # conversion must re-hash at the same width
            "real": isinstance(self.typ, T.RealType),
        }
        if self.count == 0:
            out["empty"] = True
            return out
        if self.values is not None:
            out["values"] = [_json_scalar(v) for v in sorted(self.values)]
        else:
            out["bloom_b64"] = base64.b64encode(self.words.tobytes()).decode()
            out["log2_bits"] = self.log2_bits
        return out


def _host_hash(data: np.ndarray) -> np.ndarray:
    """Host replica of ops/hashing.hash_column for 1-D numeric storage,
    bit-identical (as uint64), so host-built blooms answer the device's
    probes."""
    if np.issubdtype(data.dtype, np.floating):
        data = np.where(data == 0, np.zeros_like(data), data)
        data = np.where(np.isnan(data), np.full_like(data, np.nan), data)
        width = data.dtype.itemsize
        bits = data.view({4: np.uint32, 8: np.uint64}[width]).astype(np.uint64)
    else:
        bits = data.astype(np.uint64)
    with np.errstate(over="ignore"):
        x = bits
        x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        return x ^ (x >> np.uint64(31))


def _json_scalar(v):
    if v is None:
        return None
    if isinstance(v, (np.floating, float)):
        return float(v)
    return int(v)


def _words_of(summary: dict) -> Optional[np.ndarray]:
    """The uint32 bloom words of a summary; a pure value set converts by
    hashing at the key's STORAGE width (REAL keys hash their float32 bit
    pattern, as the device probe does)."""
    b64 = summary.get("bloom_b64")
    if b64 is None:
        vals = summary.get("values")
        if vals is None:
            return None
        lb = summary.get("log2_bits") or choose_log2_bits(in_list_limit() * 4)
        if summary.get("real"):
            dt = np.float32
        elif summary.get("float"):
            dt = np.float64
        else:
            dt = np.int64
        return _bloom_words_host(_host_hash(np.asarray(vals, dt)), lb)
    return np.frombuffer(base64.b64decode(b64), np.uint32).copy()


def filter_from_summary(summary: Optional[dict], key_type, device="cpu") -> Optional[DynamicFilter]:
    """A device-queryable DynamicFilter from a host summary."""
    if summary is None:
        return None
    if summary.get("empty"):
        return DynamicFilter("minmax", 0, empty_build=True)
    device = torch.device(device)
    dt = torch.float64 if summary.get("float") else torch.int64
    count = summary.get("count", 0)
    lo_h, hi_h = summary.get("lo"), summary.get("hi")
    lo = hi = None
    if lo_h is not None:
        lo = torch.tensor(lo_h, dtype=dt, device=device)
        hi = torch.tensor(hi_h, dtype=dt, device=device)
    if "values" in summary:
        values = torch.tensor(summary["values"], dtype=dt, device=device)
        return DynamicFilter("inlist", count or int(values.shape[0]), lo=lo, hi=hi,
                             values=values)
    if "bloom_b64" in summary:
        words = np.frombuffer(base64.b64decode(summary["bloom_b64"]), np.uint32)
        return DynamicFilter("bloom", count, lo=lo, hi=hi,
                             bloom_words=torch.from_numpy(words.astype(np.int64)).to(device),
                             log2_bits=int(summary["log2_bits"]))
    if lo is None:
        return None
    return DynamicFilter("minmax", count, lo=lo, hi=hi)
