"""EXPLAIN and EXPLAIN ANALYZE of presto_tpu_torch.Session (device="cpu")
against presto_tpu.Session at TPC-H SF 0.01: the cases of the JAX
package's tests/test_explain.py, each plan node's rows in and out equal to
the JAX package's over the same plan (dynamic filters off in both: they
prune scan rows), the strategy notes and the session properties that
change them, and the StatsCollector (exec/stats.py): counts parked as
device scalars and read in ONE host transfer in resolve()."""

import re

import pytest
import torch

from presto_tpu.benchmark.tpch_sql import QUERIES
from presto_tpu.connectors.tpch import TpchCatalog as RTpchCatalog
from presto_tpu.exec import stats as rstats
from presto_tpu.session import Session as RSession
from presto_tpu_torch.connectors.tpch import TpchCatalog
from presto_tpu_torch.exec import stats
from presto_tpu_torch.page import Page
from presto_tpu_torch.session import Session

# one torch thread: the suite runs in parallel worker processes
# (pytest-xdist), and a thread per core in each oversubscribes the host
torch.set_num_threads(1)

Q3 = QUERIES[3]
NODE_LINE = re.compile(r"^(\s*- \S+).*\[[\d,.]+ms, in ([\d,]+) rows, out ([\d,]+) rows")


@pytest.fixture(scope="module")
def sessions():
    """(port, reference) at SF 0.01, dynamic filters off in both."""
    port = Session(TpchCatalog(0.01, device="cpu"), device="cpu", dynamic_filtering=False)
    ref = RSession(RTpchCatalog(0.01), dynamic_filtering=False)
    return port, ref


def node_rows(text):
    """[(indented node name, rows in, rows out)] of an EXPLAIN ANALYZE."""
    out = []
    for line in text.split("\n"):
        m = NODE_LINE.match(line)
        if m:
            out.append((m.group(1), int(m.group(2).replace(",", "")),
                        int(m.group(3).replace(",", ""))))
    return out


# -- the JAX package's tests/test_explain.py ----------------------------------


def test_explain_renders_plan(sessions):
    port, ref = sessions
    text = port.explain(Q3)
    assert "TableScan" in text and "Join" in text and "Aggregate" in text
    assert text == ref.explain(Q3)


def test_explain_statement_returns_plan_rows(sessions):
    port, ref = sessions
    lines = [r[0] for r in port.query("explain " + Q3).rows()]
    assert any("Join" in ln for ln in lines)
    assert not any("ms," in ln for ln in lines)  # no timings without ANALYZE
    assert lines == [r[0] for r in ref.query("explain " + Q3).rows()]


@pytest.mark.parametrize("q", [3, 5])
def test_explain_analyze_per_operator_rows_equal_reference(sessions, q):
    """Every operator line carries wall time, rows in and out, and bytes;
    the rows in and out of every node equal the JAX package's."""
    port, ref = sessions
    text = port.explain_analyze(QUERIES[q])
    lines = text.split("\n")
    op_lines = [ln for ln in lines if ln.strip().startswith("-") and "--" not in ln]
    assert len(op_lines) >= 5
    for ln in op_lines:
        assert re.search(r"\[[\d,.]+ms, in [\d,]+ rows, out [\d,]+ rows", ln), ln
    got = node_rows(text)
    assert len(got) == len(op_lines)
    assert got == node_rows(ref.explain_analyze(QUERIES[q]))
    scan = next(ln for ln in lines if "TableScan lineitem" in ln)
    assert re.search(r"out [\d,]{3,} rows", scan)
    # the caches footer, then (tracing is on by default) the critical path
    caches = next(i for i, ln in enumerate(lines) if ln.startswith("-- caches: plan "))
    assert lines[caches + 1].startswith("-- trace: trace ")
    assert "total" in lines[-1] and "peak live output" in lines[-1]


def test_explain_analyze_statement(sessions):
    port, _ = sessions
    res = port.query("explain analyze " + Q3)
    assert any("ms," in r[0] for r in res.rows())
    assert res.page.device.type == "cpu"


# -- strategy notes and the session properties --------------------------------


def aggregate_note(text):
    return re.search(r"- Aggregate .*strategy=([\w-]+)", text).group(1)


def test_pallas_groupby_property_switches_the_strategy():
    """The dense kernel strategy (`pallas`) by default; SET SESSION
    pallas_groupby = false takes the next strategy and keeps the rows."""
    sess = Session(TpchCatalog(0.01, device="cpu"), device="cpu")
    want = sess.query(QUERIES[1]).rows()
    assert aggregate_note(sess.explain_analyze(QUERIES[1])) == "pallas"
    sess.query("set session pallas_groupby = false")
    text = "\n".join(r[0] for r in sess.query("explain analyze " + QUERIES[1]).rows())
    assert aggregate_note(text) in ("hash-slot", "hash-sort")
    assert sess.query(QUERIES[1]).rows() == want
    sess.query("reset session pallas_groupby")
    text = "\n".join(r[0] for r in sess.query("explain analyze " + QUERIES[1]).rows())
    assert aggregate_note(text) == "pallas"


SEMI = ("select count(*) from orders where o_orderkey in "
        "(select l_orderkey from lineitem where l_quantity > 49)")


def test_dynamic_filtering_property(sessions):
    """Dynamic filters on: Q5's -- dynamic filters: line, and a semi-join's
    df[...] and dyn_pruned notes; SET SESSION dynamic_filtering = false:
    none of them, the same rows."""
    base, _ = sessions
    sess = Session(base.catalog, device="cpu")

    def explain(sql):
        return "\n".join(r[0] for r in sess.query("explain analyze " + sql).rows())

    assert "-- dynamic filters:" in explain(QUERIES[5])
    on = explain(SEMI)
    assert re.search(r"- SemiJoin .*df\[df0=inlist\(\d+\), derive", on)
    assert re.search(r"- TableScan orders .*dyn_pruned=[\d,]+ \(df0:inlist\)", on)
    sess.query("set session dynamic_filtering = false")
    for sql in (QUERIES[5], SEMI):
        off = explain(sql)
        assert "-- dynamic filters:" not in off and "df[" not in off and "dyn_pruned" not in off
        assert sess.query(sql).rows() == base.query(sql).rows()


def test_join_and_keypack_notes(sessions):
    port, _ = sessions
    assert re.search(r"- Join .*strategy=hash-table\(host\) occ=\d+%", port.explain_analyze(Q3))
    text = port.explain_analyze("select o_orderkey from orders order by o_custkey, o_orderkey "
                                "limit 5")
    assert re.search(r"- TopN .*strategy=keypack=bitpack", text)
    text = port.explain_analyze("select distinct o_custkey from orders")
    assert re.search(r"- Distinct .*strategy=keypack=bitpack", text)


# -- the StatsCollector ---------------------------------------------------------


def test_row_counts_are_read_in_one_batch(sessions, monkeypatch):
    """Executing under a collector makes no more host reads than without
    one, and resolve() reads every node's counts in one transfer."""
    port, _ = sessions
    node = port.plan(QUERIES[5])
    reads = {"n": 0}

    def counting(name):
        orig = getattr(torch.Tensor, name)

        def wrapper(self, *a, **k):
            reads["n"] += 1
            return orig(self, *a, **k)

        monkeypatch.setattr(torch.Tensor, name, wrapper)

    for name in ("__int__", "__index__", "__bool__", "__float__", "item", "tolist", "numpy"):
        counting(name)
    ex = port._new_executor()
    ex.run(node)
    plain = reads["n"]
    collector = stats.StatsCollector()
    ex = port._new_executor(collector)
    reads["n"] = 0
    ex.run(node)
    assert reads["n"] == plain
    reads["n"] = 0
    collector.resolve()
    assert reads["n"] == 1
    lines = stats_lines(node, collector)
    assert len(lines) >= 10 and all(s.calls >= 1 for s in lines if s.rows_out)


def stats_lines(node, collector):
    out = []

    def walk(n):
        s = collector.lookup(n)
        if s is not None:
            out.append(s)
        for c in n.children:
            walk(c)

    walk(node)
    return out


def test_collector_records_and_formats_like_reference():
    """Lists of counts, ints and 0-d tensors are parked and folded in
    resolve(), and NodeStats.line renders as the JAX package's."""
    c = stats.StatsCollector()
    node = object()
    c.record(node, 0.0123, [torch.tensor(5, dtype=torch.int32), 7],
             torch.tensor(3, dtype=torch.int32), 2048, retries=1)
    c.record(node, 0.001, [], torch.tensor(4), 4096)
    assert len(c._pending) == 2
    c.resolve()
    s = c.lookup(node)
    assert (s.calls, s.rows_in, s.rows_out, s.retries) == (2, 12, 7, 1)
    assert c.peak_bytes == 4096 and abs(c.total_wall_s() - 0.0133) < 1e-12
    s.detail = "strategy=pallas"
    ref = rstats.NodeStats(**{f: getattr(s, f) for f in s.__dataclass_fields__})
    assert s.line() == ref.line()
    assert s.line().startswith("[13.3ms, in 12 rows, out 7 rows, 4.0kB, 2 calls")


def test_page_device_bytes_equal_reference_on_flat_pages():
    """Flat blocks: data and validity bytes, as the JAX package counts."""
    import numpy as np

    from presto_tpu.page import Page as RPage

    cols = {"a": np.arange(10, dtype=np.int64), "s": ["x", None] * 5,
            "d": np.arange(10, dtype=np.float64)}
    assert stats.page_device_bytes(Page.from_dict(cols, device="cpu")) == \
        rstats.page_device_bytes(RPage.from_dict(cols))
