"""Deterministic TPC-H benchmark data, generated on the device (torch
counterpart of presto_tpu/benchmark/benchgen.py).

Every column is a pure function of the row index through a splitmix64
counter generator, so the benchmark never uploads table data: the device
path generates its input where it runs (a few scalars cross the host link),
and the host twin (`numpy_columns`) generates bit-identical columns with
numpy for the baseline and the checks. This mirrors the reference's
benchmark connector, which generates synthetic pages worker-side from
splits (presto-tpch/.../TpchRecordSet.java).

Distributions are the JAX package's (TPC-H spec shapes: §4.2.3 pricing,
date windows, returnflag/linestatus rules), with its one simplification:
every order has exactly LINES_PER_ORDER lineitems.

torch has no uint64 remainder, so the device path keeps the splitmix64
stream in int64 with the same bits (ops/hashing.py: products and sums wrap
mod 2^64, logical shifts are masked by hand) and takes the unsigned modulo
through a logical shift (`_Torch.umod`). The twin keeps numpy's uint64.
Columns are generated one at a time, each from the row index, so a large
table never holds every intermediate at once.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import types as T
from ..ops.hashing import _signed, _srl, mix64
from ..page import Block, Page, intern_dictionary

STARTDATE = 8035  # 1992-01-01
CURRENTDATE = 9298  # 1995-06-17
ENDDATE = 10591  # 1998-12-31

DEC12_2 = T.DecimalType(12, 2)
DEC4_2 = T.DecimalType(4, 2)

_RF_POOL = ("A", "N", "R")
_LS_POOL = ("F", "O")
_SEG_POOL = ("AUTOMOBILE", "BUILDING", "FURNITURE", "HOUSEHOLD", "MACHINERY")
_BRAND_POOL = tuple(
    f"Brand#{m}{x}" for m in range(1, 6) for x in range(1, 6)
)  # already sorted lexically
_CONTAINER_POOL = tuple(
    sorted(
        f"{a} {b}"
        for a in ("JUMBO", "LG", "MED", "SM", "WRAP")
        for b in ("BAG", "BOX", "CAN", "CASE", "DRUM", "JAR", "PACK", "PKG")
    )
)

LINES_PER_ORDER = 4

# name -> (Type, dictionary pool | None)
SCHEMAS: Dict[str, Dict[str, Tuple[T.Type, Optional[tuple]]]] = {
    "lineitem": {
        "l_orderkey": (T.BIGINT, None),
        "l_partkey": (T.BIGINT, None),
        "l_suppkey": (T.BIGINT, None),
        "l_linenumber": (T.BIGINT, None),
        "l_quantity": (DEC12_2, None),
        "l_extendedprice": (DEC12_2, None),
        "l_discount": (DEC4_2, None),
        "l_tax": (DEC4_2, None),
        "l_returnflag": (T.VARCHAR, _RF_POOL),
        "l_linestatus": (T.VARCHAR, _LS_POOL),
        "l_shipdate": (T.DATE, None),
        "l_receiptdate": (T.DATE, None),
    },
    "orders": {
        "o_orderkey": (T.BIGINT, None),
        "o_custkey": (T.BIGINT, None),
        "o_totalprice": (DEC12_2, None),
        "o_orderdate": (T.DATE, None),
        "o_shippriority": (T.BIGINT, None),
    },
    "customer": {
        "c_custkey": (T.BIGINT, None),
        "c_nationkey": (T.BIGINT, None),
        "c_acctbal": (DEC12_2, None),
        "c_mktsegment": (T.VARCHAR, _SEG_POOL),
    },
    "supplier": {
        "s_suppkey": (T.BIGINT, None),
        "s_nationkey": (T.BIGINT, None),
        "s_acctbal": (DEC12_2, None),
    },
    "part": {
        "p_partkey": (T.BIGINT, None),
        "p_size": (T.BIGINT, None),
        "p_retailprice": (DEC12_2, None),
        "p_brand": (T.VARCHAR, _BRAND_POOL),
        "p_container": (T.VARCHAR, _CONTAINER_POOL),
    },
}

_GOLDEN = 0x9E3779B97F4A7C15
_STREAM_MUL = 0xA0761D6478BD642F


def _stream_base(stream: int) -> int:
    """A stream's counter offset, wrapped to 64 bits (a python int)."""
    return (stream * _STREAM_MUL) & 0xFFFFFFFFFFFFFFFF


class _Numpy:
    """The host twin's arithmetic: int64 columns, splitmix64 in uint64."""

    def arange(self, start: int, stop: int):
        return np.arange(start, stop, dtype=np.int64)

    def zeros(self, n: int):
        return np.zeros(n, np.int64)

    def where(self, cond, a, b):
        return np.where(cond, a, b)

    def i32(self, x):
        return x.astype(np.int32)

    def row_sums(self, x, width: int):
        return x.reshape(-1, width).sum(axis=1)

    def u64(self, stream: int, i):
        z = (i.astype(np.uint64) + np.uint64(_stream_base(stream))) * np.uint64(_GOLDEN)
        z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        return z ^ (z >> np.uint64(31))

    def umod(self, z, m: int):
        return (z % np.uint64(m)).astype(np.int64)


class _Torch:
    """The device path's arithmetic: int64 columns on `device`, splitmix64
    as int64 bit patterns."""

    def __init__(self, device):
        self.device = torch.device(device)

    def arange(self, start: int, stop: int):
        return torch.arange(start, stop, dtype=torch.int64, device=self.device)

    def zeros(self, n: int):
        return torch.zeros(n, dtype=torch.int64, device=self.device)

    def where(self, cond, a, b):
        return torch.where(cond, a, b)

    def i32(self, x):
        return x.to(torch.int32)

    def row_sums(self, x, width: int):
        return x.reshape(-1, width).sum(dim=1)

    def u64(self, stream: int, i):
        return mix64((i + _signed(_stream_base(stream))) * _signed(_GOLDEN))

    def umod(self, z, m: int):
        """z mod m with z read as uint64, for 0 < m < 2^62: the logical
        shift makes the dividend non-negative, and z = 2·(z >>> 1) + (z & 1)."""
        return (2 * (_srl(z, 1) % m) + (z & 1)) % m


def _uni(xp, stream: int, i, lo: int, hi: int):
    """Uniform int64 in [lo, hi) (modulo bias is irrelevant here and
    identical across the twins)."""
    return xp.umod(xp.u64(stream, i), hi - lo) + lo


def _retail_price_cents(partkey):
    # p_retailprice = 90000 + ((pk/10) mod 20001) + 100*(pk mod 1000)  (§4.2.3)
    return 90000 + (partkey // 10) % 20001 + 100 * (partkey % 1000)


def _sizes(sf: float) -> Dict[str, int]:
    n_orders = max(int(1_500_000 * sf), 8)
    return {
        "orders": n_orders,
        "lineitem": n_orders * LINES_PER_ORDER,
        "customer": max(int(150_000 * sf), 4),
        "part": max(int(200_000 * sf), 4),
        "supplier": max(int(10_000 * sf), 2),
    }


def _lineitem(xp, s, i, column: str):
    """One lineitem column for row numbers i (int64)."""

    def partkey():
        return _uni(xp, 3, i, 1, s["part"] + 1)

    def qty():
        return _uni(xp, 4, i, 1, 51)

    def shipdate():
        orderdate = _uni(xp, 7, i // LINES_PER_ORDER, STARTDATE, ENDDATE - 151 + 1)
        return orderdate + _uni(xp, 8, i, 1, 122)

    def receiptdate():
        return shipdate() + _uni(xp, 9, i, 1, 31)

    if column == "l_orderkey":
        return i // LINES_PER_ORDER + 1
    if column == "l_partkey":
        return partkey()
    if column == "l_suppkey":
        return _uni(xp, 12, i, 1, s["supplier"] + 1)
    if column == "l_linenumber":
        return i % LINES_PER_ORDER + 1
    if column == "l_quantity":
        return qty() * 100
    if column == "l_extendedprice":
        return qty() * _retail_price_cents(partkey())
    if column == "l_discount":
        return _uni(xp, 5, i, 0, 11)
    if column == "l_tax":
        return _uni(xp, 6, i, 0, 9)
    if column == "l_returnflag":
        odd = xp.umod(xp.u64(10, i), 2) != 0
        return xp.i32(xp.where(receiptdate() <= CURRENTDATE, xp.where(odd, 2, 0), 1))
    if column == "l_linestatus":
        return xp.i32(shipdate() > CURRENTDATE)
    if column == "l_shipdate":
        return xp.i32(shipdate())
    if column == "l_receiptdate":
        return xp.i32(receiptdate())
    raise KeyError(column)


def _orders(xp, s, o, column: str):
    if column == "o_orderkey":
        return o + 1
    if column == "o_custkey":
        return _uni(xp, 11, o, 1, s["customer"] + 1)
    if column == "o_totalprice":
        # per-order sum of gross over its lines, from the streams the
        # lineitem columns use, so the rollup is consistent
        li = (o[:, None] * LINES_PER_ORDER + xp.arange(0, LINES_PER_ORDER)[None, :]).reshape(-1)
        pk = _uni(xp, 3, li, 1, s["part"] + 1)
        price = _uni(xp, 4, li, 1, 51) * _retail_price_cents(pk)
        net = price * (100 - _uni(xp, 5, li, 0, 11)) // 100
        gross = net * (100 + _uni(xp, 6, li, 0, 9)) // 100
        return xp.row_sums(gross, LINES_PER_ORDER)
    if column == "o_orderdate":
        return xp.i32(_uni(xp, 7, o, STARTDATE, ENDDATE - 151 + 1))
    if column == "o_shippriority":
        return xp.zeros(o.shape[0])
    raise KeyError(column)


def _customer(xp, s, i, column: str):
    if column == "c_custkey":
        return i + 1
    if column == "c_nationkey":
        return _uni(xp, 21, i, 0, 25)
    if column == "c_acctbal":
        return _uni(xp, 22, i, -99999, 1000000)
    if column == "c_mktsegment":
        return xp.i32(xp.umod(xp.u64(23, i), len(_SEG_POOL)))
    raise KeyError(column)


def _supplier(xp, s, i, column: str):
    if column == "s_suppkey":
        return i + 1
    if column == "s_nationkey":
        return _uni(xp, 31, i, 0, 25)
    if column == "s_acctbal":
        return _uni(xp, 32, i, -99999, 1000000)
    raise KeyError(column)


def _part(xp, s, i, column: str):
    if column == "p_partkey":
        return i + 1
    if column == "p_size":
        return _uni(xp, 41, i, 1, 51)
    if column == "p_retailprice":
        return _retail_price_cents(i + 1)
    if column == "p_brand":
        # brand code (m-1)*5+(x-1) with m, x uniform 1..5: the sorted
        # Brand#11..Brand#55 pool makes the code purely arithmetic
        return xp.i32(_uni(xp, 42, i, 0, 5) * 5 + _uni(xp, 43, i, 0, 5))
    if column == "p_container":
        return xp.i32(xp.umod(xp.u64(44, i), len(_CONTAINER_POOL)))
    raise KeyError(column)


_GENERATORS = {
    "lineitem": _lineitem,
    "orders": _orders,
    "customer": _customer,
    "supplier": _supplier,
    "part": _part,
}


def _generate(xp, table: str, sf: float, columns: Sequence[str], start: int, count: int):
    s = _sizes(sf)
    i = xp.arange(start, start + count)
    return {c: _GENERATORS[table](xp, s, i, c) for c in columns}


def supports(table: str, columns: Sequence[str]) -> bool:
    return table in SCHEMAS and all(c in SCHEMAS[table] for c in columns)


def numpy_columns(table: str, sf: float, columns: Sequence[str]) -> Dict[str, np.ndarray]:
    """Host twin: {name: numpy array}, bit-identical to the device columns."""
    return _generate(_Numpy(), table, sf, tuple(columns), 0, _sizes(sf)[table])


def numpy_columns_range(
    table: str, sf: float, columns: Sequence[str], start: int, count: int
) -> Dict[str, np.ndarray]:
    """Host twin of device_range: rows [start, start+count)."""
    return _generate(_Numpy(), table, sf, tuple(columns), start, count)


def device_range(
    table: str, sf: float, columns: Sequence[str], start: int, count: int, device="cuda"
) -> Tuple[torch.Tensor, ...]:
    """Rows [start, start+count) of `columns`, generated on `device` in
    their storage dtypes."""
    schema = SCHEMAS[table]
    xp = _Torch(device)
    s = _sizes(sf)
    i = xp.arange(start, start + count)
    return tuple(
        _GENERATORS[table](xp, s, i, c).to(schema[c][0].storage_dtype) for c in columns
    )


def device_page(table: str, sf: float, columns: Sequence[str], device="cuda") -> Page:
    """The whole table's `columns` generated on `device` as a Page."""
    columns = tuple(columns)
    arrays = device_range(table, sf, columns, 0, _sizes(sf)[table], device)
    return page_of(table, columns, arrays, None, device)


def page_of(table: str, columns: Sequence[str], arrays, pad_to: Optional[int], device) -> Page:
    """Wrap generated column tensors as a Page (dictionary pools interned),
    padded to `pad_to` rows when given."""
    schema = SCHEMAS[table]
    blocks = {}
    for c, arr in zip(columns, arrays):
        typ, pool = schema[c]
        did = intern_dictionary(pool) if pool is not None else None
        blocks[c] = Block(arr, typ, None, did)
    return Page.from_dict(blocks, pad_to=pad_to, device=device)
