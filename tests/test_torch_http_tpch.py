"""All 22 TPC-H texts at SF 0.01 through a two-worker port cluster
(in-process WorkerServers on the CPU, real HTTP between them), each held
to the port's local Session over the same catalog; Q3, Q5, Q10, Q17 and
Q18 again with every join repartitioned, through the hierarchical
exchange. The earlier files hold that local Session against the JAX
package, so the JAX package does not run here."""

import pytest
import torch

from presto_tpu_torch.benchmark.tpch_sql import QUERIES
from presto_tpu_torch.connectors.tpch import TpchCatalog
from presto_tpu_torch.server import HttpClusterSession, NodeManager, WorkerServer, serde
from presto_tpu_torch.session import Session

torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def _no_stripe_threads_left():
    """The stripe pool's threads stop with the module."""
    yield
    serde.shutdown_stripe_pool()

SF = 0.01
REPARTITIONED = (3, 5, 10, 17, 18)


@pytest.fixture(scope="module")
def sessions():
    catalog = TpchCatalog(SF, device="cpu")
    workers = [WorkerServer(TpchCatalog(SF, device="cpu")).start() for _ in range(2)]
    try:
        nodes = NodeManager([w.uri for w in workers], interval=3600)
        yield {
            "cost": HttpClusterSession(catalog, nodes, result_cache=False),
            "repartitioned": HttpClusterSession(catalog, nodes, broadcast_threshold=0,
                                                result_cache=False),
            "local": Session(catalog, device="cpu", result_cache=False),
        }
    finally:
        for w in workers:
            w.stop()


def _check(got, want, sql):
    if "order by" not in sql.lower():
        got, want = sorted(map(repr, got)), sorted(map(repr, want))
    assert got == want


@pytest.mark.parametrize("q", sorted(QUERIES))
def test_tpch_through_the_cluster(sessions, q):
    sql = QUERIES[q]
    _check(sessions["cost"].query(sql).rows(), sessions["local"].query(sql).rows(), sql)


@pytest.mark.parametrize("q", REPARTITIONED)
def test_tpch_repartitioned_through_the_cluster(sessions, q):
    sql = QUERIES[q]
    sess = sessions["repartitioned"]
    _check(sess.query(sql).rows(), sessions["local"].query(sql).rows(), sql)
    assert sess.scheduler.stats_snapshot()["hier"]["wire_pages"] > 0
