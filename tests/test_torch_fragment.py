"""The port's fragmenter (presto_tpu_torch/plan/fragment.py) against the
JAX package's: EXPLAIN (TYPE DISTRIBUTED) of a port session over an
8-worker mesh prints, for each of the 22 TPC-H texts at SF 0.01, the text
the JAX package's fragmenter gives at width 8 for the same plan, under the
cost-based distribution (broadcast_threshold None) and with every join
repartitioned (0). No query runs. (The JAX package's own mesh session
fragments an already fragmented plan there and raises, so its side is
`fragment_plan` over its local session's plan.)

One departure, held here: a null-aware semi join (NOT IN) reads its
whole source, so the port replicates it even where a plain IN semi join
over the same tables is repartitioned."""

import pytest
import torch

from presto_tpu.benchmark.tpch_sql import QUERIES
from presto_tpu.connectors.tpch import TpchCatalog as RCatalog
from presto_tpu.plan import nodes as RN
from presto_tpu.plan.fragment import Fragmenter as RFragmenter
from presto_tpu.plan.fragment import fragment_plan as ref_fragment_plan
from presto_tpu.session import Session as RSession
from presto_tpu_torch.connectors.memory import MemoryCatalog
from presto_tpu_torch.connectors.tpch import TpchCatalog
from presto_tpu_torch.page import Page
from presto_tpu_torch.parallel import default_mesh
from presto_tpu_torch.plan import nodes as N
from presto_tpu_torch.plan.fragment import Exchange, fragment_plan, fragments
from presto_tpu_torch.session import Session

torch.set_num_threads(1)

SF = 0.01
WIDTH = 8


@pytest.fixture(scope="module")
def catalogs():
    return TpchCatalog(SF, device="cpu"), RCatalog(SF)


@pytest.fixture(scope="module")
def ref_plans(catalogs):
    ref = RSession(catalogs[1], plan_cache=False, result_cache=False)
    return {q: ref.plan(QUERIES[q]) for q in QUERIES}


class _ReferenceRules(RFragmenter):
    """The JAX package's fragmenter plus the port's one departure: the
    semi joins whose port counterpart is null-aware (NOT IN) broadcast.
    The JAX package's SemiJoin has no null-aware flag, so they are named
    by their probe-key tuples, which the semi join's broadcast condition
    passes to `_has_varchar_keys`."""

    def __init__(self, catalog, threshold, null_aware_keys):
        super().__init__(catalog, threshold, WIDTH)
        self.null_aware_keys = null_aware_keys

    def _has_varchar_keys(self, keys) -> bool:
        return any(keys is k for k in self.null_aware_keys) or super()._has_varchar_keys(keys)


def _null_aware_keys(ref_node, port_node) -> list:
    """Probe-key tuples of the reference plan's semi joins that are
    null-aware in the port's plan of the same text (same tree shape)."""
    out = []
    if isinstance(port_node, N.SemiJoin) and port_node.null_aware:
        out.append(ref_node.probe_keys)
    for r, p in zip(ref_node.children, port_node.children):
        out += _null_aware_keys(r, p)
    return out


@pytest.mark.parametrize("threshold", [None, 0])
def test_explain_distributed_equals_reference(catalogs, ref_plans, threshold):
    cat, rcat = catalogs
    sess = Session(cat, mesh=default_mesh(WIDTH, device="cpu"), broadcast_threshold=threshold,
                   plan_cache=False, result_cache=False)
    local = Session(cat, device="cpu", plan_cache=False)
    departures = 0
    for q in sorted(QUERIES):
        rplan = ref_plans[q]
        na = _null_aware_keys(rplan, local.plan(QUERIES[q]))
        want = RN.plan_tree_str(_ReferenceRules(rcat, threshold, na).fragment(rplan))
        if RN.plan_tree_str(ref_fragment_plan(rplan, rcat, threshold, WIDTH)) != want:
            departures += 1
        got = "\n".join(r[0] for r in sess.query(
            "explain (type distributed) " + QUERIES[q]).rows())
        assert got == want, f"Q{q}"
        assert "Exchange" in got
    # the departure changes one text: Q16's NOT IN, which the JAX package
    # repartitions when every join is
    assert departures == (1 if threshold == 0 else 0)


def test_local_session_fragments_for_two_workers(catalogs):
    """Without a mesh, EXPLAIN (TYPE DISTRIBUTED) fragments for 2 workers,
    as the JAX package does; the session's own plan stays unfragmented."""
    cat, rcat = catalogs
    port = Session(cat, device="cpu", plan_cache=False)
    ref = RSession(rcat, plan_cache=False, result_cache=False)
    sql = "explain (type distributed) " + QUERIES[3]
    assert port.query(sql).rows() == ref.query(sql).rows()
    assert "Exchange" not in port.explain(QUERIES[3])


def _semijoins(node):
    out = [node] if isinstance(node, N.SemiJoin) else []
    for c in node.children:
        out += _semijoins(c)
    return out


def test_null_aware_semi_join_never_repartitioned():
    import numpy as np

    rng = np.random.default_rng(5)
    n = 20_000
    cat = MemoryCatalog({
        "t": Page.from_dict({"a": rng.integers(0, 5_000, n)}, device="cpu"),
        "u": Page.from_dict({"b": rng.integers(0, 5_000, n)}, device="cpu"),
    }, device="cpu")
    plain = Session(cat, device="cpu").plan("select a from t where a in (select b from u)")
    for threshold in (None, 0):
        frag = fragment_plan(plain, cat, threshold, WIDTH)
        (sj,) = _semijoins(frag)
        assert not sj.null_aware
        assert isinstance(sj.source, Exchange) and sj.source.kind == "repartition"
    not_in = Session(cat, device="cpu").plan(
        "select a from t where a not in (select b from u)")
    for threshold in (None, 0):
        frag = fragment_plan(not_in, cat, threshold, WIDTH)
        (sj,) = _semijoins(frag)
        assert sj.null_aware
        assert isinstance(sj.source, Exchange) and sj.source.kind == "replicate"
        assert not (isinstance(sj.child, Exchange) and sj.child.kind == "repartition")
        assert len(fragments(frag)) >= 3
