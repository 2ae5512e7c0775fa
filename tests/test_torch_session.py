"""End to end: TPC-H Q1 and Q6 at SF 0.01 through presto_tpu_torch.Session
(device="cpu") give exactly presto_tpu.Session's rows (decimals exact), and
the port's Q1 takes the dense kernel strategy."""

import pytest
import torch

from presto_tpu.benchmark.tpch_sql import QUERIES
from presto_tpu.connectors.tpch import TpchCatalog as RCatalog
from presto_tpu.session import Session as RSession
from presto_tpu_torch.connectors.tpch import TpchCatalog
from presto_tpu_torch.exec.executor import ExecutionError
from presto_tpu_torch.expr.functions import NotPortedError
from presto_tpu_torch.ops import groupby_kernel as gk
from presto_tpu_torch.session import Session


@pytest.fixture(scope="module")
def sessions():
    return (
        Session(TpchCatalog(0.01, device="cpu"), device="cpu"),
        RSession(RCatalog(0.01), plan_cache=False, result_cache=False),
    )


@pytest.mark.parametrize("q", [1, 6])
def test_tpch_rows_equal_reference(q, sessions):
    port, ref = sessions
    hits = gk.dense_hits
    got = port.query(QUERIES[q]).rows()
    want = ref.query(QUERIES[q]).rows()
    assert got == want and len(got) == (4 if q == 1 else 1)
    assert [type(x) for x in got[0]] == [type(x) for x in want[0]]
    # Q1's grouped aggregate goes through the dense (kernel) strategy;
    # Q6 is a global aggregate and runs none
    assert gk.dense_hits == hits + (1 if q == 1 else 0)


def test_session_device_and_unported_paths(sessions):
    port, _ = sessions
    res = port.query(QUERIES[1])
    assert all(str(b.device) == "cpu" for b in res.page.blocks)
    assert "Aggregate" in port.explain(QUERIES[1])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Session(TpchCatalog(0.01, device="cpu"))
    with pytest.raises(NotPortedError, match="not ported yet: window functions"):
        port.query("select n_name, rank() over (order by n_regionkey) from nation")
    with pytest.raises(ExecutionError, match="not ported yet: Union"):
        port.query("select n_name from nation union all select r_name from region")
