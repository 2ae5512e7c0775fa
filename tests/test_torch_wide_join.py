"""A join on more than the probe kernel's 8 keys (the build takes the
sorted-hash layout of ops/join.py instead of the kernel table), held
against the JAX package on the CPU at TPC-H SF 0.01: lineitem joined to
itself on 9 keys, and the same in EXISTS form; both count lineitem, since
the keys hold (l_orderkey, l_linenumber). Also the shapes build_table now
leaves to the sorted-hash layout (too many keys, a key kind the probe
kernel cannot carry), and a 9-key join with NULL keys against the JAX
package."""

import numpy as np
import pytest
import torch

from presto_tpu.connectors.memory import MemoryCatalog as RMemory
from presto_tpu.connectors.tpch import TpchCatalog as RCatalog
from presto_tpu.page import Page as RPage
from presto_tpu.session import Session as RSession
from presto_tpu_torch import types as T
from presto_tpu_torch.connectors.memory import MemoryCatalog
from presto_tpu_torch.connectors.tpch import TpchCatalog
from presto_tpu_torch.expr import ir
from presto_tpu_torch.ops import join_kernel as jk
from presto_tpu_torch.page import Page
from presto_tpu_torch.session import Session

torch.set_num_threads(1)

SF = 0.01
KEYS = ("l_orderkey", "l_linenumber", "l_partkey", "l_suppkey", "l_quantity",
        "l_extendedprice", "l_discount", "l_tax", "l_shipdate")
ON = " and ".join(f"a.{k} = b.{k}" for k in KEYS)
SQL = {
    "join": f"select count(*) from lineitem a join lineitem b on {ON}",
    "exists": f"select count(*) from lineitem a where exists (select 1 from lineitem b where {ON})",
    "not_exists": ("select count(*) from lineitem a where not exists (select 1 from lineitem b "
                   f"where {ON} and b.l_linenumber > 1)"),
    "grouped": (f"select a.l_returnflag, count(*), sum(b.l_quantity) from lineitem a join "
                f"lineitem b on {ON} group by a.l_returnflag order by 1"),
}


@pytest.fixture(scope="module")
def sessions():
    ref = RSession(RCatalog(sf=SF), plan_cache=False, result_cache=False)
    ref.executor.dynamic_filtering = False
    return Session(TpchCatalog(SF, device="cpu"), device="cpu", result_cache=False), ref


@pytest.mark.parametrize("label", ["join", "exists"])
def test_nine_key_join_equals_the_jax_package(sessions, label):
    mine, ref = sessions
    got = mine.query(SQL[label]).rows()
    assert got == ref.query(SQL[label]).rows() == [(60104,)]


@pytest.mark.parametrize("label", ["not_exists", "grouped"])
def test_nine_key_join_shapes_equal_the_jax_package(sessions, label):
    mine, ref = sessions
    assert mine.query(SQL[label]).rows() == ref.query(SQL[label]).rows()


def _col(name, typ):
    return ir.ColumnRef(name, typ)


def test_build_table_leaves_wide_and_odd_keys_to_sorted_hash():
    n = 64
    cols = {f"k{i}": (np.arange(n, dtype=np.int64), T.BIGINT) for i in range(9)}
    page = Page.from_dict(cols, device="cpu")
    keys = [_col(f"k{i}", T.BIGINT) for i in range(9)]
    before = jk.table_builds
    assert jk.build_table(page, keys) is None  # 9 keys: past MAX_KEYS
    assert jk.build_table(page, keys[:jk.MAX_KEYS]) is not None
    assert jk.table_builds == before + 1


def test_nine_key_join_with_null_keys_equals_the_jax_package():
    rng = np.random.default_rng(7)
    n = 200
    a = {f"k{i}": rng.integers(0, 3, n).astype(np.int64) for i in range(9)}
    b = {f"j{i}": a[f"k{i}"][::-1].copy() for i in range(9)}
    mine = Session(MemoryCatalog({"a": Page.from_dict(a, device="cpu"),
                                  "b": Page.from_dict(b, device="cpu")}, device="cpu"),
                   device="cpu")
    ref = RSession(RMemory({"a": RPage.from_dict(a), "b": RPage.from_dict(b)}))
    on = " and ".join(f"k{i} = j{i}" for i in range(1, 9))
    for sql in (
        f"select count(*), sum(k1) from a join b on k0 = j0 and {on} where k2 < 2 or k3 = 1",
        # a NULL key never matches: k0 is NULL where it is 0
        f"select count(*) from a join b on (case when k0 = 0 then null else k0 end) = j0 "
        f"and {on}",
    ):
        got = mine.query(sql).rows()
        assert got == ref.query(sql).rows()
        assert got[0][0] > 0
