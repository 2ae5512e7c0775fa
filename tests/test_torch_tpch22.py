"""End to end: the twelve TPC-H queries no other port test holds (Q2,
Q7-Q12, Q14-Q16, Q19 and Q20) at SF 0.01 through presto_tpu_torch.Session
(device="cpu") give presto_tpu.Session's rows: integers, decimals, dates,
strings and NULLs exactly, doubles within the tolerance of
presto_tpu/testing/oracle.py (chip_smoke.row_diff).

Q20 is empty over this generator at every scale factor: p_name's first word
comes from the first 24 colours, and 'forest' is not among them. So the
Q20 variant with `p_name like '%forest%'` (chip_smoke.q20_variant) is held
too, and must return rows.
"""

import pytest
import torch

import chip_smoke
from presto_tpu.benchmark.tpch_sql import QUERIES
from presto_tpu.connectors.tpch import TpchCatalog as RCatalog
from presto_tpu.session import Session as RSession
from presto_tpu_torch.connectors.tpch import TpchCatalog
from presto_tpu_torch.session import Session

# one torch thread: the suite runs in parallel worker processes
# (pytest-xdist), and a thread per core in each oversubscribes the host
torch.set_num_threads(1)

TEXTS = {q: QUERIES[q] for q in (2, 7, 8, 9, 10, 11, 12, 14, 15, 16, 19, 20)}
TEXTS["q20_variant"] = chip_smoke.q20_variant(QUERIES[20])


def _ref(catalog):
    """presto_tpu's session without plan and result caches, and without its
    dynamic filters: they only prune rows, and off they halve the kernels
    its jit compiles for a join query."""
    sess = RSession(catalog, plan_cache=False, result_cache=False)
    sess.executor.dynamic_filtering = False
    return sess


@pytest.fixture(scope="module")
def sessions():
    return (
        Session(TpchCatalog(0.01, device="cpu"), device="cpu"),
        _ref(RCatalog(0.01)),
    )


@pytest.mark.parametrize("q", list(TEXTS))
def test_query_equals_reference(q, sessions):
    port, ref = sessions
    got = port.query(TEXTS[q]).rows()
    want = ref.query(TEXTS[q]).rows()
    assert chip_smoke.row_diff(got, want) is None, chip_smoke.row_diff(got, want)
    if q == 20:
        assert got == []
    else:
        assert len(got) > 0
