"""TPC-H data generator — columnar, vectorized, deterministic.

This is the torch package's copy of presto_tpu/connectors/tpch.py: the same
numpy generator with the same seeds, so it yields the same rows bit for bit
and TpchCatalog(sf) is the same data in both packages. Pages land on the
catalog's device ("cuda" unless the caller passes device="cpu").

Re-designed equivalent of the reference's presto-tpch connector
(presto-tpch/src/main/java/com/facebook/presto/tpch/, which wraps the
io.airlift.tpch dbgen port; presto-tpch/pom.xml:20). Like the reference it is
the engine's primary benchmark/test data source (BenchmarkQueryRunner.java:55).

Differences from classic dbgen, on purpose:
* Generation is vectorized numpy (single pass per column) instead of the
  per-row C-style RNG streams, so SF10 generates in seconds on the host.
  Distributions, domains, cardinalities and referential rules follow the
  TPC-H spec (sizes §4.2.5, pricing formulas §4.2.3); text columns come from
  spec word lists but with a bounded combinatorial pool so they stay
  dictionary-friendly. Checksums therefore match OUR oracle, not Java dbgen —
  cross-engine checksum parity is tracked in BASELINE.md.
* Strings are born dictionary-encoded. Per-row-unique formatted strings
  (c_name, phones, clerks …) use LazyDict subclasses so we never materialize
  millions of python strings.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from .. import types as T
from ..page import Block, LazyDict, Page, intern_dictionary

# ---------------------------------------------------------------------------
# spec constants
# ---------------------------------------------------------------------------

STARTDATE = 8035  # 1992-01-01
CURRENTDATE = 9298  # 1995-06-17
ENDDATE = 10591  # 1998-12-31

NATIONS = [
    ("ALGERIA", 0), ("ARGENTINA", 1), ("BRAZIL", 1), ("CANADA", 1),
    ("EGYPT", 4), ("ETHIOPIA", 0), ("FRANCE", 3), ("GERMANY", 3),
    ("INDIA", 2), ("INDONESIA", 2), ("IRAN", 4), ("IRAQ", 4),
    ("JAPAN", 2), ("JORDAN", 4), ("KENYA", 0), ("MOROCCO", 0),
    ("MOZAMBIQUE", 0), ("PERU", 1), ("CHINA", 2), ("ROMANIA", 3),
    ("SAUDI ARABIA", 4), ("VIETNAM", 2), ("RUSSIA", 3),
    ("UNITED KINGDOM", 3), ("UNITED STATES", 1),
]
REGIONS = ["AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST"]

SEGMENTS = ["AUTOMOBILE", "BUILDING", "FURNITURE", "HOUSEHOLD", "MACHINERY"]
PRIORITIES = ["1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED", "5-LOW"]
INSTRUCTIONS = ["COLLECT COD", "DELIVER IN PERSON", "NONE", "TAKE BACK RETURN"]
SHIPMODES = ["AIR", "FOB", "MAIL", "RAIL", "REG AIR", "SHIP", "TRUCK"]
CONTAINERS = [
    f"{a} {b}"
    for a in ["JUMBO", "LG", "MED", "SM", "WRAP"]
    for b in ["BAG", "BOX", "CAN", "CASE", "DRUM", "JAR", "PACK", "PKG"]
]
TYPES = [
    f"{a} {b} {c}"
    for a in ["ECONOMY", "LARGE", "MEDIUM", "PROMO", "SMALL", "STANDARD"]
    for b in ["ANODIZED", "BRUSHED", "BURNISHED", "PLATED", "POLISHED"]
    for c in ["BRASS", "COPPER", "NICKEL", "STEEL", "TIN"]
]
COLORS = [
    "almond", "antique", "aquamarine", "azure", "beige", "bisque", "black",
    "blanched", "blue", "blush", "brown", "burlywood", "burnished", "chartreuse",
    "chiffon", "chocolate", "coral", "cornflower", "cornsilk", "cream", "cyan",
    "dark", "deep", "dim", "dodger", "drab", "firebrick", "floral", "forest",
    "frosted", "gainsboro", "ghost", "goldenrod", "green", "grey", "honeydew",
    "hot", "indian", "ivory", "khaki", "lace", "lavender", "lawn", "lemon",
    "light", "lime", "linen", "magenta", "maroon", "medium", "metallic",
    "midnight", "mint", "misty", "moccasin", "navajo", "navy", "olive", "orange",
    "orchid", "pale", "papaya", "peach", "peru", "pink", "plum", "powder",
    "puff", "purple", "red", "rose", "rosy", "royal", "saddle", "salmon",
    "sandy", "seashell", "sienna", "sky", "slate", "smoke", "snow", "spring",
    "steel", "tan", "thistle", "tomato", "turquoise", "violet", "wheat", "white",
    "yellow",
]

_COMMENT_VERBS = ["sleep", "wake", "haggle", "nag", "cajole", "detect", "integrate", "boost", "promise", "solve"]
_COMMENT_ADJS = ["furious", "sly", "careful", "blithe", "quick", "fluffy", "slow", "quiet", "ruthless", "thin"]
_COMMENT_NOUNS = ["packages", "requests", "accounts", "deposits", "foxes", "ideas", "theodolites", "pinto beans", "instructions", "dependencies"]
_COMMENT_ADVS = ["quickly", "slowly", "blithely", "carefully", "furiously", "silently", "daringly", "evenly", "finally", "especially"]

COMMENT_POOL = tuple(
    sorted(
        {
            f"{adv} {adj} {noun} {verb} about the {adj2} {noun2}"
            for adv in _COMMENT_ADVS[:6]
            for adj in _COMMENT_ADJS[:6]
            for noun in _COMMENT_NOUNS[:6]
            for verb in ["haggle", "nag", "sleep", "wake"]
            for adj2, noun2 in [("furious", "packages"), ("special", "requests"),
                                ("express", "deposits"), ("regular", "accounts")]
        }
    )
)

# supplier comments for Q16: some contain 'Customer...Complaints'
SUPP_COMMENT_POOL = tuple(
    sorted(
        set(COMMENT_POOL[:2048])
        | {f"Customer {w} Complaints" for w in _COMMENT_ADVS}
    )
)


# ---------------------------------------------------------------------------
# lazy dictionaries for per-row-unique formatted strings
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class FormatDict(LazyDict):
    """Entry i = f'{prefix}{i+1:0{width}d}' — zero-padded, so entry order is
    lexicographic order (is_sorted=True)."""

    prefix: str
    width: int
    count: int
    is_sorted: bool = True

    def __len__(self):
        return self.count

    def __getitem__(self, i):
        if isinstance(i, (int, np.integer)):
            if i < 0 or i >= self.count:
                raise IndexError(i)
            return f"{self.prefix}{i + 1:0{self.width}d}"
        raise TypeError(i)


@dataclasses.dataclass(frozen=True)
class PhoneDict(LazyDict):
    """Entry i = phone for key i+1: 'CC-LLL-LLL-LLLL' with country code
    10+nationkey. Deterministic mix of the index; NOT lexicographically
    sorted across nations (is_sorted=False)."""

    seed: int
    count: int
    nation_seed: int  # regenerate nationkeys from this seed
    is_sorted: bool = False

    def _nation(self, i):
        # must match the table's nationkey column: same generator, same seed
        if not hasattr(self, "_nations"):
            rng = np.random.default_rng(self.nation_seed)
            object.__setattr__(self, "_nations", rng.integers(0, 25, self.count))
        return self._nations[i]

    def __len__(self):
        return self.count

    def __getitem__(self, i):
        if not isinstance(i, (int, np.integer)):
            raise TypeError(i)
        n = self._nation(int(i))
        a = (i * 7919 + self.seed) % 900 + 100
        b = (i * 104729 + self.seed) % 900 + 100
        c = (i * 1299709 + self.seed) % 9000 + 1000
        return f"{10 + n}-{a}-{b}-{c}"


@dataclasses.dataclass(frozen=True)
class AddressDict(LazyDict):
    """Pseudo-random alphanumeric addresses, deterministic in the index."""

    seed: int
    count: int
    is_sorted: bool = False

    _CHARS = "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789 ,"

    def __len__(self):
        return self.count

    def __getitem__(self, i):
        if not isinstance(i, (int, np.integer)):
            raise TypeError(i)
        x = (int(i) + 1) * 2654435761 + self.seed
        n = 10 + x % 16
        out = []
        for _ in range(n):
            x = (x * 6364136223846793005 + 1442695040888963407) % (1 << 64)
            out.append(self._CHARS[(x >> 33) % len(self._CHARS)])
        return "".join(out)


# ---------------------------------------------------------------------------
# columnar table container
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Column:
    data: np.ndarray
    type: T.Type
    dictionary: Optional[object] = None  # tuple or LazyDict
    valid: Optional[np.ndarray] = None  # bool mask; None = all valid


@dataclasses.dataclass
class Table:
    name: str
    columns: Dict[str, Column]

    @property
    def num_rows(self) -> int:
        return len(next(iter(self.columns.values())).data)

    def to_page(self, start: int = 0, stop: Optional[int] = None, pad_to=None,
                device="cuda") -> Page:
        stop = self.num_rows if stop is None else min(stop, self.num_rows)
        blocks, names = [], []
        for name, c in self.columns.items():
            arr = c.data[start:stop]
            v = None if c.valid is None else c.valid[start:stop]
            blk = Block.from_numpy(
                arr, c.type, valid=v, dictionary=c.dictionary, device=device
            )
            blocks.append(blk)
            names.append(name)
        n = stop - start
        if pad_to is not None and pad_to > n:
            from ..page import _pad_block

            blocks = [_pad_block(b, pad_to) for b in blocks]
        return Page.from_blocks(blocks, names, count=n, device=device)


# ---------------------------------------------------------------------------
# generators
# ---------------------------------------------------------------------------


def _pool_col(rng, n, pool) -> Column:
    pool = tuple(pool) if not isinstance(pool, tuple) else pool
    codes = rng.integers(0, len(pool), n).astype(np.int32)
    return Column(codes, T.VARCHAR, pool)


def _dec(arr, scale=2, precision=12) -> Column:
    return Column(arr.astype(np.int64), T.DecimalType(precision, scale))


def gen_region() -> Table:
    rng = np.random.default_rng(1001)
    n = 5
    return Table(
        "region",
        {
            "r_regionkey": Column(np.arange(n, dtype=np.int64), T.BIGINT),
            "r_name": Column(np.arange(n, dtype=np.int32), T.VARCHAR, tuple(REGIONS)),
            "r_comment": _pool_col(rng, n, COMMENT_POOL),
        },
    )


def gen_nation() -> Table:
    rng = np.random.default_rng(1002)
    n = len(NATIONS)
    names = [x[0] for x in NATIONS]
    order = np.argsort(names)  # dictionary must be sorted; codes remap
    sorted_names = tuple(np.array(names)[order])
    code_of = {name: i for i, name in enumerate(sorted_names)}
    codes = np.array([code_of[name] for name in names], np.int32)
    return Table(
        "nation",
        {
            "n_nationkey": Column(np.arange(n, dtype=np.int64), T.BIGINT),
            "n_name": Column(codes, T.VARCHAR, sorted_names),
            "n_regionkey": Column(
                np.array([x[1] for x in NATIONS], np.int64), T.BIGINT
            ),
            "n_comment": _pool_col(rng, n, COMMENT_POOL),
        },
    )


def gen_supplier(sf: float) -> Table:
    n = int(10_000 * sf)
    rng = np.random.default_rng(2001)
    nation_seed = 2002
    nations = np.random.default_rng(nation_seed).integers(0, 25, n)
    return Table(
        "supplier",
        {
            "s_suppkey": Column(np.arange(1, n + 1, dtype=np.int64), T.BIGINT),
            "s_name": Column(
                np.arange(n, dtype=np.int32), T.VARCHAR, FormatDict("Supplier#", 9, n)
            ),
            "s_address": Column(
                np.arange(n, dtype=np.int32), T.VARCHAR, AddressDict(7, n)
            ),
            "s_nationkey": Column(nations.astype(np.int64), T.BIGINT),
            "s_phone": Column(
                np.arange(n, dtype=np.int32), T.VARCHAR, PhoneDict(17, n, nation_seed)
            ),
            "s_acctbal": _dec(rng.integers(-99999, 999999, n)),
            "s_comment": _pool_col(rng, n, SUPP_COMMENT_POOL),
        },
    )


def retail_price_cents(partkey: np.ndarray) -> np.ndarray:
    """p_retailprice = 90000 + ((partkey/10) mod 20001) + 100*(partkey mod 1000),
    in cents (spec §4.2.3)."""
    pk = partkey.astype(np.int64)
    return 90000 + (pk // 10) % 20001 + 100 * (pk % 1000)


def gen_part(sf: float) -> Table:
    n = int(200_000 * sf)
    rng = np.random.default_rng(3001)
    pk = np.arange(1, n + 1, dtype=np.int64)
    # p_name: concatenation of 5 color words; bounded pool of pairs for the
    # dictionary, full 5-word names would explode it. Q9/Q16-style predicates
    # use LIKE '%green%', which works over any pool containing the colors.
    name_pool = tuple(
        sorted(
            {
                f"{a} {b} {c}"
                for a in COLORS[:24]
                for b in COLORS[24:48]
                for c in COLORS[48:60]
            }
        )
    )
    mfgr = rng.integers(1, 6, n)
    sub = rng.integers(1, 6, n)
    # sorted pools are Brand#11..Brand#55 / Manufacturer#1..5 in order, so
    # codes are computable arithmetically (no python loop over rows)
    brand_pool = tuple(sorted({f"Brand#{m}{x}" for m in range(1, 6) for x in range(1, 6)}))
    brand_codes = ((mfgr - 1) * 5 + (sub - 1)).astype(np.int32)
    mfgr_pool = tuple(sorted({f"Manufacturer#{m}" for m in range(1, 6)}))
    mfgr_codes = (mfgr - 1).astype(np.int32)
    return Table(
        "part",
        {
            "p_partkey": Column(pk, T.BIGINT),
            "p_name": _pool_col(rng, n, name_pool),
            "p_mfgr": Column(mfgr_codes, T.VARCHAR, mfgr_pool),
            "p_brand": Column(brand_codes, T.VARCHAR, brand_pool),
            "p_type": _pool_col(rng, n, tuple(sorted(TYPES))),
            "p_size": Column(rng.integers(1, 51, n).astype(np.int64), T.BIGINT),
            "p_container": _pool_col(rng, n, tuple(sorted(CONTAINERS))),
            "p_retailprice": _dec(retail_price_cents(pk)),
            "p_comment": _pool_col(rng, n, COMMENT_POOL),
        },
    )


def _partsupp_suppkey(partkey: np.ndarray, i: np.ndarray, s: int) -> np.ndarray:
    """Spec §4.2.5.4: ps_suppkey = (ps_partkey + (i * (S/4 + (ps_partkey-1)/S))) % S + 1"""
    pk = partkey.astype(np.int64)
    return (pk + i * (s // 4 + (pk - 1) // s)) % s + 1


def gen_partsupp(sf: float) -> Table:
    p = int(200_000 * sf)
    s = int(10_000 * sf)
    rng = np.random.default_rng(4001)
    partkey = np.repeat(np.arange(1, p + 1, dtype=np.int64), 4)
    i = np.tile(np.arange(4, dtype=np.int64), p)
    return Table(
        "partsupp",
        {
            "ps_partkey": Column(partkey, T.BIGINT),
            "ps_suppkey": Column(_partsupp_suppkey(partkey, i, s), T.BIGINT),
            "ps_availqty": Column(rng.integers(1, 10_000, 4 * p).astype(np.int64), T.BIGINT),
            "ps_supplycost": _dec(rng.integers(100, 100_001, 4 * p)),
            "ps_comment": _pool_col(rng, 4 * p, COMMENT_POOL),
        },
    )


def gen_customer(sf: float) -> Table:
    n = int(150_000 * sf)
    rng = np.random.default_rng(5001)
    nation_seed = 5002
    nations = np.random.default_rng(nation_seed).integers(0, 25, n)
    return Table(
        "customer",
        {
            "c_custkey": Column(np.arange(1, n + 1, dtype=np.int64), T.BIGINT),
            "c_name": Column(
                np.arange(n, dtype=np.int32), T.VARCHAR, FormatDict("Customer#", 9, n)
            ),
            "c_address": Column(
                np.arange(n, dtype=np.int32), T.VARCHAR, AddressDict(11, n)
            ),
            "c_nationkey": Column(nations.astype(np.int64), T.BIGINT),
            "c_phone": Column(
                np.arange(n, dtype=np.int32), T.VARCHAR, PhoneDict(23, n, nation_seed)
            ),
            "c_acctbal": _dec(rng.integers(-99999, 999999, n)),
            "c_mktsegment": _pool_col(rng, n, tuple(SEGMENTS)),
            "c_comment": _pool_col(rng, n, COMMENT_POOL),
        },
    )


def gen_orders_and_lineitem(sf: float) -> Tuple[Table, Table]:
    n_orders = int(1_500_000 * sf)
    n_cust = int(150_000 * sf)
    n_part = int(200_000 * sf)
    n_supp = int(10_000 * sf)
    rng = np.random.default_rng(6001)

    orderkey = np.arange(1, n_orders + 1, dtype=np.int64)
    # spec: only customers with custkey % 3 != 0 place orders
    raw = rng.integers(1, max(n_cust, 2), n_orders).astype(np.int64)
    custkey = raw + (raw % 3 == 0)  # bump multiples of 3
    custkey = np.where(custkey > n_cust, np.maximum(custkey - 3, 1), custkey)
    orderdate = rng.integers(STARTDATE, ENDDATE - 151 + 1, n_orders).astype(np.int32)

    # lineitems: 1..7 per order
    lines = rng.integers(1, 8, n_orders)
    total_lines = int(lines.sum())
    starts = np.concatenate([[0], np.cumsum(lines)[:-1]])
    l_orderkey = np.repeat(orderkey, lines)
    l_linenumber = (np.arange(total_lines) - np.repeat(starts, lines) + 1).astype(np.int64)
    l_partkey = rng.integers(1, n_part + 1, total_lines).astype(np.int64)
    supp_i = rng.integers(0, 4, total_lines).astype(np.int64)
    l_suppkey = _partsupp_suppkey(l_partkey, supp_i, n_supp)
    qty = rng.integers(1, 51, total_lines).astype(np.int64)
    l_quantity = qty * 100  # decimal(12,2)
    l_extendedprice = qty * retail_price_cents(l_partkey)
    l_discount = rng.integers(0, 11, total_lines).astype(np.int64)  # cents: 0.00-0.10
    l_tax = rng.integers(0, 9, total_lines).astype(np.int64)
    l_orderdate = np.repeat(orderdate, lines).astype(np.int64)
    l_shipdate = (l_orderdate + rng.integers(1, 122, total_lines)).astype(np.int32)
    l_commitdate = (l_orderdate + rng.integers(30, 91, total_lines)).astype(np.int32)
    l_receiptdate = (l_shipdate + rng.integers(1, 31, total_lines)).astype(np.int32)

    returned = l_receiptdate <= CURRENTDATE
    rf = np.where(returned, np.where(rng.random(total_lines) < 0.5, 0, 2), 1)
    rf_pool = ("A", "N", "R")  # codes 0,1,2 — sorted
    shipped = l_shipdate > CURRENTDATE
    ls_pool = ("F", "O")
    l_linestatus = shipped.astype(np.int32)  # O if shipped after current date

    # per-order rollups
    net = l_extendedprice * (100 - l_discount) // 100
    gross = net * (100 + l_tax) // 100
    o_totalprice = np.add.reduceat(gross, starts)
    o_count = lines
    o_f = np.add.reduceat((l_linestatus == 0).astype(np.int64), starts)
    o_status = np.where(o_f == o_count, 0, np.where(o_f == 0, 1, 2))
    status_pool = ("F", "O", "P")

    orders = Table(
        "orders",
        {
            "o_orderkey": Column(orderkey, T.BIGINT),
            "o_custkey": Column(custkey, T.BIGINT),
            "o_orderstatus": Column(o_status.astype(np.int32), T.VARCHAR, status_pool),
            "o_totalprice": _dec(o_totalprice),
            "o_orderdate": Column(orderdate, T.DATE),
            "o_orderpriority": _pool_col(rng, n_orders, tuple(PRIORITIES)),
            "o_clerk": Column(
                rng.integers(0, max(int(1000 * sf), 1), n_orders).astype(np.int32),
                T.VARCHAR,
                FormatDict("Clerk#", 9, max(int(1000 * sf), 1)),
            ),
            "o_shippriority": Column(np.zeros(n_orders, np.int64), T.BIGINT),
            "o_comment": _pool_col(rng, n_orders, COMMENT_POOL),
        },
    )
    lineitem = Table(
        "lineitem",
        {
            "l_orderkey": Column(l_orderkey, T.BIGINT),
            "l_partkey": Column(l_partkey, T.BIGINT),
            "l_suppkey": Column(l_suppkey, T.BIGINT),
            "l_linenumber": Column(l_linenumber, T.BIGINT),
            "l_quantity": _dec(l_quantity),
            "l_extendedprice": _dec(l_extendedprice),
            "l_discount": _dec(l_discount, scale=2, precision=4),
            "l_tax": _dec(l_tax, scale=2, precision=4),
            "l_returnflag": Column(rf.astype(np.int32), T.VARCHAR, rf_pool),
            "l_linestatus": Column(l_linestatus, T.VARCHAR, ls_pool),
            "l_shipdate": Column(l_shipdate, T.DATE),
            "l_commitdate": Column(l_commitdate, T.DATE),
            "l_receiptdate": Column(l_receiptdate, T.DATE),
            "l_shipinstruct": _pool_col(rng, total_lines, tuple(INSTRUCTIONS)),
            "l_shipmode": _pool_col(rng, total_lines, tuple(SHIPMODES)),
            "l_comment": _pool_col(rng, total_lines, COMMENT_POOL),
        },
    )
    return orders, lineitem


_CACHE: Dict[Tuple[str, float], Table] = {}


def table(name: str, sf: float = 1.0) -> Table:
    """Generate (and cache) a TPC-H table at the given scale factor."""
    key = (name, sf)
    if key in _CACHE:
        return _CACHE[key]
    if name == "region":
        t = gen_region()
    elif name == "nation":
        t = gen_nation()
    elif name == "supplier":
        t = gen_supplier(sf)
    elif name == "part":
        t = gen_part(sf)
    elif name == "partsupp":
        t = gen_partsupp(sf)
    elif name == "customer":
        t = gen_customer(sf)
    elif name in ("orders", "lineitem"):
        o, l = gen_orders_and_lineitem(sf)
        _CACHE[("orders", sf)] = o
        _CACHE[("lineitem", sf)] = l
        return _CACHE[key]
    else:
        raise KeyError(f"unknown tpch table {name!r}")
    _CACHE[key] = t
    return t


TABLE_NAMES = [
    "region", "nation", "supplier", "part", "partsupp",
    "customer", "orders", "lineitem",
]


def schema(name: str, sf: float = 1.0):
    """Column name -> Type mapping without forcing full generation for the
    big tables (generates small ones; uses a cached prototype otherwise)."""
    t = table(name, sf if name in ("region", "nation") else min(sf, 0.01))
    return {cname: c.type for cname, c in t.columns.items()}


# base cardinality per unit scale factor (spec §4.2.5); lineitem is ~6M/sf
_BASE_ROWS = {
    "region": 5,
    "nation": 25,
    "supplier": 10_000,
    "part": 200_000,
    "partsupp": 800_000,
    "customer": 150_000,
    "orders": 1_500_000,
    "lineitem": 6_000_000,
}

_UNIQUE_COLUMNS = {
    "region": [("r_regionkey",)],
    "nation": [("n_nationkey",)],
    "supplier": [("s_suppkey",)],
    "part": [("p_partkey",)],
    "partsupp": [("ps_partkey", "ps_suppkey")],
    "customer": [("c_custkey",)],
    "orders": [("o_orderkey",)],
    "lineitem": [("l_orderkey", "l_linenumber")],
}


class TpchCatalog:
    """Catalog + runtime data provider for the embedded TPC-H connector
    (reference presto-tpch: TpchMetadata + statistics provider). Implements
    the planner's Catalog protocol and serves device-resident Pages to the
    executor, cached per table."""

    name = "tpch"

    def __init__(self, sf: float = 1.0, device="cuda"):
        self.sf = sf
        self.device = device
        self._pages: Dict[str, "Page"] = {}
        self._tables: Dict[str, Table] = {}

    def with_device(self, device) -> "TpchCatalog":
        """A catalog that serves the same generated host tables (shared, not
        regenerated) as pages on `device`."""
        twin = TpchCatalog(self.sf, device=device)
        twin._tables = self._tables
        return twin

    def table_names(self):
        return list(TABLE_NAMES)

    def schema(self, tname: str):
        return schema(tname, self.sf)

    def row_count(self, tname: str) -> int:
        if tname in ("region", "nation"):
            return _BASE_ROWS[tname]
        return int(_BASE_ROWS[tname] * self.sf)

    def unique_columns(self, tname: str):
        return _UNIQUE_COLUMNS.get(tname, [])

    def table_version(self, tname: str) -> int:
        """Generated data is immutable: a constant snapshot version makes
        every tpch read cacheable forever (exec/qcache.py)."""
        if tname not in TABLE_NAMES:
            raise KeyError(f"table {tname!r} does not exist")
        return 0

    def page(self, tname: str) -> "Page":
        """Full-table Page with SOURCE column names (executor renames to
        plan channels). Cached: repeated queries reuse device arrays."""
        pg = self._pages.get(tname)
        if pg is None:
            pg = self.host_table(tname).to_page(device=self.device)
            self._pages[tname] = pg
        return pg

    def host_table(self, tname: str) -> Table:
        """Host-resident (numpy) table, cached — the streaming scan source
        (reference ConnectorPageSource: data stays off-device until a split
        batch is requested)."""
        tb = self._tables.get(tname)
        if tb is None:
            tb = table(tname, self.sf)
            self._tables[tname] = tb
        return tb

    def exact_row_count(self, tname: str) -> int:
        return self.host_table(tname).num_rows

    def column_stats(self, tname: str, column: str):
        """Exact per-column statistics from the host-resident generator
        data (reference presto-tpch statistics provider), cached."""
        from ..plan.stats import stats_from_column

        cache = getattr(self, "_stats_cache", None)
        if cache is None:
            cache = self._stats_cache = {}
        key = (tname, column)
        if key not in cache:
            col = self.host_table(tname).columns[column]
            cache[key] = stats_from_column(
                col.data,
                getattr(col, "valid", None),
                col.type,
                col.dictionary,
                self.exact_row_count(tname),
            )
        return cache[key]

    def scan(self, tname: str, start: int, stop: int, pad_to=None,
             columns=None, predicate=None) -> "Page":
        """One batch of rows [start, stop) as a device Page — the split/
        morsel read path (reference BackgroundHiveSplitLoader splits +
        ConnectorPageSource.getNextPage). Honors column pushdown; the
        in-memory generator has no row-group statistics to prune by."""
        tb = self.host_table(tname)
        if columns is not None:
            tb = Table(tb.name, {c: tb.columns[c] for c in columns})
        return tb.to_page(start, stop, pad_to=pad_to, device=self.device)
