"""End to end: the join queries of TPC-H at SF 0.01 through
presto_tpu_torch.Session (device="cpu") give exactly presto_tpu.Session's
rows (decimals exact), with the port's joins on the hash-table path.

Q3, Q5, Q17 and Q18 are the slice's queries; Q4 (semi join), Q13 (left
join), Q21 (semi and anti joins with a residual), Q22 (scalar subquery and
anti join) and a star join (two stacked n1 joins fused into one multiway
probe) cover the rest of the join nodes.
"""

import pytest
import torch

from presto_tpu.benchmark.tpch_sql import QUERIES
from presto_tpu.connectors.tpch import TpchCatalog as RCatalog
from presto_tpu.session import Session as RSession
from presto_tpu_torch.connectors.tpch import TpchCatalog
from presto_tpu_torch.exec import executor as ex
from presto_tpu_torch.ops import groupby_kernel as gk
from presto_tpu_torch.ops import join_kernel as jk
from presto_tpu_torch.session import Session

# one torch thread: the suite runs in parallel worker processes
# (pytest-xdist), and a thread per core in each oversubscribes the host
torch.set_num_threads(1)

STAR_SQL = (
    "select count(*) c, sum(l_extendedprice + o_totalprice + s_acctbal) v from lineitem "
    "join orders on l_orderkey = o_orderkey join supplier on l_suppkey = s_suppkey"
)

# hash tables each query builds at SF 0.01 (one per Join / SemiJoin, and
# the residual semi join's second build)
TABLES = {3: 2, 5: 5, 17: 2, 18: 3, 4: 1, 13: 1, 21: 7, 22: 1}


@pytest.fixture(scope="module")
def sessions():
    """The port's session, and presto_tpu's without plan and result caches
    and without its dynamic filters: they only prune rows, and off they
    halve the kernels its jit compiles for a join query."""
    ref = RSession(RCatalog(0.01), plan_cache=False, result_cache=False)
    ref.executor.dynamic_filtering = False
    return Session(TpchCatalog(0.01, device="cpu"), device="cpu", result_cache=False), ref


@pytest.mark.parametrize("q", [3, 5, 17, 18, 4, 13, 21, 22])
def test_join_queries_equal_reference(q, sessions):
    port, ref = sessions
    builds, hits = jk.table_builds, gk.hash_hits
    got = port.query(QUERIES[q]).rows()
    want = ref.query(QUERIES[q]).rows()
    assert got == want and len(got) > 0
    assert [type(x) for x in got[0]] == [type(x) for x in want[0]]
    assert jk.table_builds - builds == TABLES[q]
    if q in (3, 18):  # their aggregates take the hash-slot strategy here
        assert gk.hash_hits > hits


def test_star_join_fuses_into_multiway_probe(sessions, monkeypatch):
    port, ref = sessions
    calls = []
    fused = ex.table_multiway_n1

    def spy(probe, specs):
        calls.append(len(specs))
        return fused(probe, specs)

    monkeypatch.setattr(ex, "table_multiway_n1", spy)
    got = port.query(STAR_SQL).rows()
    assert got == ref.query(STAR_SQL).rows() and got[0][0] > 0
    assert calls == [2]


@pytest.mark.parametrize("q", [3, 18])
def test_dynamic_filters_prune_probe_scans(q, sessions):
    port, _ = sessions
    port.query(QUERIES[q]).rows()
    assert port.executor.dyn_ctx.total_pruned() > 0



@pytest.mark.parametrize("q", [3, 5, 17, 18])
def test_chip_smoke_numpy_checks_agree_with_port(q, sessions):
    """chip_smoke.py holds the card's rows against these independent numpy
    computations at SF 1; here they are held against the port at SF 0.01."""
    import chip_smoke

    port, _ = sessions
    tables = {n: port.catalog.host_table(n) for n in chip_smoke.TPCH_TABLES}
    assert chip_smoke.JOIN_QUERIES[q](tables) == port.query(QUERIES[q]).rows()
