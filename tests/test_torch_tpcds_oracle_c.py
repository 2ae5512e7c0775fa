"""All 103 TPC-DS texts through presto_tpu_torch's Session.query
(device="cpu") at SF 0.02 against the SQLite oracle, under the same
ORACLE_SQL rewrites and assert_same_results that hold the JAX package in
tests/test_tpcds_queries.py (imported from there, not copied). Both
packages pass the same check, so the port equals the JAX package through
the oracle. The texts are split over three files by position in the sorted
query ids (this file takes every third, from the third), so that each file
stays well inside one test worker's share of the run.
"""

import pytest

# (importing test_torch_tpcds also sets its one torch thread)
from test_torch_tpcds import QIDS, check_query, port_and_oracle  # noqa: F401 (a fixture)


@pytest.mark.parametrize("qid", QIDS[2::3])
def test_query_equals_oracle(qid, port_and_oracle):
    check_query(qid, *port_and_oracle)
