"""presto_tpu_torch on an NVIDIA card: the groupby, join-insert,
join-probe and fused-Q1 kernels against their plain versions (the groupby
kernel also at the edges of its regimes and grid, chip_smoke.py's
GROUPBY_EDGES, and as one launch per call; the first-match join probe as
one launch, the table build with at most two host reads; the fused-Q1
kernel at the edges of its loads and grid, chip_smoke.py's Q1_EDGES, and
as one launch per call), and the 22 TPC-H queries, the analytic set of
chip_smoke.py (windows, set operations, ROLLUP, moments, TABLESAMPLE), the
103 TPC-DS texts and the scalar function families of chip_smoke.py's
FUNCTION_SQL (both over TPC-DS SF 0.01), the hand-coded pipelines and the
statement sequence of chip_smoke.py's `statements` path (TPC-H SF 0.01) on
"cuda" against the same on "cpu"; and the streaming executor at a budget
that offloads (Q3's hybrid hash join, a NOT IN through the partitioned
semi join) against the materializing session on the card; a bucketed
Hive warehouse read on the card through the grouped bucket join against
the same warehouse read on the CPU; the `matview` batches of chip_smoke.py
(three materialized views over a shard store with lineitem appended in
batches) and TPC-H Q3, Q5, Q9 and Q18 run twice with history-based
feedback on, each on the card against the CPU (TPC-H SF 0.01); and Q3,
Q5, Q16 and Q18 over an 8-worker mesh on the card, broadcast and
repartitioned, against the single-device CPU session.

These tests import neither jax nor presto_tpu, so they also run where only
PyTorch is installed:

    python3 -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Without a CUDA device they skip.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from presto_tpu_torch.benchmark import handcoded
from presto_tpu_torch.benchmark.tpcds_sql import QUERIES as TPCDS_QUERIES
from presto_tpu_torch.benchmark.tpch_sql import QUERIES
from presto_tpu_torch.connectors.tpcds import TpcdsCatalog
from presto_tpu_torch.connectors.tpch import TpchCatalog
from presto_tpu_torch.ops import agg_kernel as ak
from presto_tpu_torch.ops import groupby_kernel as gk
from presto_tpu_torch.ops import join_kernel as jk
from presto_tpu_torch.session import Session


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def in_new_process(kind, name, *args):
    """A torch.profiler check of chip_smoke (kind "one_launch":
    one_launch_check, "probe": probe_launch_check, "build": build_check)
    made in a new process on the saved inputs, so that it does not depend
    on what ran before it: late in a long process torch.profiler loses
    device records (chip_smoke.launch_checks_in_child). The check raises
    there if it fails; returns its result."""
    (res,) = chip_smoke.launch_checks_in_child([(kind, name, args)])
    return res


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["int64", "float64"])
def test_kernel_matches_plain(cuda, dtype):
    rng = np.random.default_rng(13)
    n, G = 300_000, 64
    gid = torch.from_numpy(rng.integers(0, G, n).astype(np.int32)).to(cuda)
    live = torch.from_numpy(rng.random(n) < 0.9).to(cuda)
    count = torch.tensor(n - 5, dtype=torch.int32, device=cuda)
    if dtype == "int64":
        chans = torch.from_numpy(rng.integers(-(1 << 40), 1 << 40, (3, n))).to(cuda)
        kinds, sources = [gk.COUNT, gk.ADD, gk.MIN, gk.MAX], [-1, 0, 1, 2]
    else:
        chans = torch.from_numpy(rng.normal(0.0, 1e3, (2, n))).to(cuda)
        kinds, sources = [gk.ADD, gk.ADD], [0, 1]
    call = (gid, live, count, chans, kinds, sources, G)
    before = gk.launches
    got = gk.groupby_totals(*call)
    want = gk.groupby_totals_plain(*call)
    torch.cuda.synchronize()
    assert gk.launches == before + 1
    if dtype == "int64":
        assert torch.equal(got, want)
    else:  # shared-memory atomics add in no fixed order
        mag = gk.groupby_totals_plain(gid, live, count, chans.abs(), kinds, sources, G)
        assert bool(((got - want).abs() <= 1e-12 * mag + 1e-9).all())


@pytest.mark.cuda
@pytest.mark.parametrize("name", chip_smoke.GROUPBY_EDGES)
def test_kernel_regime_edges_match_plain(cuda, name):
    call, tol, expect = chip_smoke.groupby_edge_cases(cuda, n_big=200_000)[name]
    regime, blocks = gk.launch_shape(cuda, call[3][0].dtype, call[0].shape[0], call[6],
                                     len(call[4]))
    if expect and "register" in expect:
        assert (regime != gk.ATOMIC) == expect["register"]
    if expect and "blocks" in expect:
        assert blocks == expect["blocks"]
    before = gk.launches
    got = gk.groupby_totals(*call)
    want = gk.groupby_totals_plain(*call)
    torch.cuda.synchronize()
    assert gk.launches == before + 1
    assert got.dtype == want.dtype and got.shape == want.shape
    if tol is chip_smoke.exact:
        assert torch.equal(got, want)
    else:
        assert bool(((got - want).abs() <= tol(call)).all())


@pytest.mark.cuda
def test_kernel_call_is_one_launch_without_copies(cuda):
    """A warm call: one kernel on the device and no copy or stream sync."""
    call, _, _ = chip_smoke.groupby_edge_cases(cuda, n_big=200_000)["count_below_n"]
    res = in_new_process("one_launch", "count_below_n", call)
    assert res["launches"] == 1 and res["memcpy"] == 0 and res["stream_syncs"] == 0


def _insert_inputs(cuda, n, skew):
    rng = np.random.default_rng(17 + skew)
    h = rng.integers(-(1 << 63), (1 << 63) - 1, n, dtype=np.int64)
    if skew:  # one hash repeated 400 times: rows overflow, scans pass other rows
        h[rng.permutation(n)[:400]] = h[0]
    live = rng.random(n) < 0.95
    return torch.from_numpy(h).to(cuda), torch.from_numpy(live).to(cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("skew", [False, True])
def test_join_kernels_match_plain(cuda, skew):
    n = 200_000
    bits = jk._pick_bits(n)
    h, live = _insert_inputs(cuda, n, skew)
    before = jk.insert_launches, jk.probe_launches
    got = jk.join_insert(h, live, bits)
    plain = jk.join_insert_plain(h, live, bits)
    torch.cuda.synchronize()
    assert jk.insert_launches == before[0] + 1
    # any race winner is a valid placement: hold both to the invariants
    for out in (got, plain):
        assert jk.insert_invariant_errors(h, live, bits, *out) == []
    assert (int(got[2]) >= 0) == skew and (int(plain[2]) >= 0) == skew
    # the probe: exact against its plain version on the kernel's table,
    # with the row number as the key (each row finds exactly itself) and
    # with a key that half the probe rows miss
    rng = np.random.default_rng(5)
    m = 300_000
    pick = torch.from_numpy(rng.integers(0, n, m)).to(cuda)
    ph = h[pick].contiguous()
    plive = live[pick].contiguous()
    ids = torch.arange(n, dtype=torch.int32, device=cuda)
    pkey = torch.where(pick % 2 == 0, pick, pick + n).to(torch.int32)
    for prep in ([(pick.to(torch.int32), ids, None, None)], [(pkey, ids, None, None)]):
        want = jk.join_probe_plain(got[0], ph, plive, bits, prep)
        have = jk.join_probe(got[0], ph, plive, bits, prep)
        torch.cuda.synchronize()
        assert torch.equal(have[0], want[0]) and torch.equal(have[1], want[1])
        assert bool(have[0].any())
    assert jk.probe_launches == before[1] + 2
    # rows found in the slot region are exactly the live rows that did not
    # overflow
    over = torch.zeros(n, dtype=torch.bool, device=cuda)
    over[got[1][:int(got[2]) + 1, 1].to(torch.int64)] = True
    full = jk.join_probe(got[0], h, live, bits, [(ids, ids, None, None)])
    assert torch.equal(full[0], live & ~over)


@pytest.mark.cuda
def test_probe_n1_is_one_launch_and_build_reads_twice(cuda):
    """A warm first-match probe of a table with no overflow region: one
    kernel on the device, no copy, no stream sync; a warm build: one insert
    launch, no nonzero, at most two host reads."""
    rng = np.random.default_rng(29)
    key = (chip_smoke._key("k", "bigint"),)
    build = chip_smoke._page({"k": (rng.permutation(50_000).astype(np.int64), "bigint", None,
                                    None)}, cuda)
    probe = chip_smoke._page({"k": (rng.integers(0, 100_000, 200_000), "bigint", None, None)},
                             cuda)
    res = in_new_process("build", "build_50k", build, key)
    assert res["launches"] == 1 and res["nonzero"] == 0 and res["dtoh"] <= 2
    jt = jk.build_table(build, key)
    h, prep = jk._probe_setup(probe, jt, key)
    res = in_new_process("probe", "probe_200k", jt, h, probe.live_mask(), prep)
    assert res["launches"] == 1 and res["memcpy"] == 0 and res["stream_syncs"] == 0


@pytest.fixture(scope="module")
def sessions_sf001():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cat = TpchCatalog(0.01, device="cuda")
    # without the result cache: every query here must execute
    return (Session(cat, device="cuda", result_cache=False),
            Session(cat.with_device("cpu"), device="cpu", result_cache=False))


@pytest.mark.cuda
@pytest.mark.parametrize("q", [*range(1, 23), "q20_variant"])
def test_queries_on_card_equal_cpu(cuda, sessions_sf001, q):
    card, cpu = sessions_sf001
    text = chip_smoke.q20_variant(QUERIES[20]) if q == "q20_variant" else QUERIES[q]
    before = gk.launches, jk.insert_launches
    got = card.query(text).rows()
    if q == 1:
        assert gk.launches > before[0]
    if q in (3, 5, 17, 18):
        assert jk.insert_launches > before[1]
    want = cpu.query(text).rows()
    assert chip_smoke.row_diff(got, want) is None, chip_smoke.row_diff(got, want)
    assert len(got) > 0 or q == 20


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(chip_smoke.ANALYTIC_SQL))
def test_analytic_on_card_equal_cpu(cuda, sessions_sf001, name):
    card, cpu = sessions_sf001
    got = chip_smoke.run_analytic(card, name)
    want = chip_smoke.run_analytic(cpu, name)
    assert chip_smoke.result_diff(name, got, want) is None
    assert len(next(iter(got.values()))[0] if name in chip_smoke.COLUMN_RESULTS else got) > 0


@pytest.fixture(scope="module")
def q1_page_sf01():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return handcoded.lineitem_q1_page(0.1, device="cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["whole", "count_and_cutoff", *chip_smoke.Q1_EDGES])
def test_q1_kernel_matches_plain(cuda, q1_page_sf01, case):
    """The fused Q1 kernel over device-generated lineitem (SF 0.1): whole,
    cut by count and by a cutoff that empties the open groups, and at the
    edges of its loads and grid (chip_smoke.Q1_EDGES: unaligned columns,
    a partial last step, fewer rows than a block's step, count 0, count
    past n)."""
    page = q1_page_sf01
    cols = [page.block(c).data for c in handcoded.Q1_COLUMNS]
    cutoff = 9131 if case == "count_and_cutoff" else 10471
    if case == "whole":
        n_live = page.count
    elif case == "count_and_cutoff":
        n_live = torch.tensor(300_000, dtype=torch.int32, device=cuda)
    else:
        cols, count = chip_smoke.q1_edge_cases(cols)[case]
        n_live = torch.tensor(count, dtype=torch.int32, device=cuda)
        assert ak.paired_loads(cols) == (case not in ("unaligned_view", "one_column_unaligned"))
    cut = torch.tensor(cutoff, dtype=torch.int32, device=cuda)
    before = ak.launches
    got = ak.q1_sums(*cols, n_live, cut)
    want = ak.q1_sums_plain(*cols, n_live, cut)
    torch.cuda.synchronize()
    assert ak.launches == before + 1
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k
    total = int(got["count"].sum())
    assert total <= min(int(n_live), cols[0].shape[0]) and (total > 0) == (case != "count_0")
    if case == "count_and_cutoff":
        assert total < int(n_live) and int(got["count"][1]) == 0


@pytest.mark.cuda
def test_q1_call_is_one_launch_without_copies(cuda, q1_page_sf01):
    """A warm q1_sums call: one kernel on the device (the fold and the lane
    normalization inside it) and no copy or stream sync."""
    cols = [q1_page_sf01.block(c).data for c in handcoded.Q1_COLUMNS]
    call = (*cols, q1_page_sf01.count, torch.tensor(10471, dtype=torch.int32, device=cuda))
    res = in_new_process("one_launch", "q1_sf01", call, "q1_partials")
    assert res["launches"] == 1 and res["memcpy"] == 0 and res["stream_syncs"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("pipeline", ["q1_local", "q1_local_kernel", "q6_local"])
def test_handcoded_on_card_equal_cpu(cuda, pipeline):
    before = ak.launches
    fn = getattr(handcoded, pipeline)
    got = fn(handcoded.lineitem_q1_page(0.01, device="cuda")).to_pylist()
    assert (ak.launches > before) == (pipeline == "q1_local_kernel")
    assert got == fn(handcoded.lineitem_q1_page(0.01, device="cpu")).to_pylist()


@pytest.fixture(scope="module")
def tpcds_sf001():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cat = TpcdsCatalog(0.01, device="cuda")
    # without the result cache: every query here must execute
    return (Session(cat, device="cuda", result_cache=False),
            Session(cat.with_device("cpu"), device="cpu", result_cache=False))


@pytest.mark.cuda
@pytest.mark.parametrize("q", sorted(TPCDS_QUERIES))
def test_tpcds_on_card_equal_cpu(cuda, tpcds_sf001, q):
    """Each TPC-DS text on the card against the port on the CPU over the
    same host tables, rows in order."""
    card, cpu = tpcds_sf001
    got = card.query(TPCDS_QUERIES[q]).rows()
    want = cpu.query(TPCDS_QUERIES[q]).rows()
    assert chip_smoke.row_diff(got, want) is None, chip_smoke.row_diff(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("family", list(chip_smoke.FUNCTION_SQL))
def test_functions_on_card_equal_cpu(cuda, tpcds_sf001, family):
    card, cpu = tpcds_sf001
    got = card.query(chip_smoke.FUNCTION_SQL[family]).rows()
    want = cpu.query(chip_smoke.FUNCTION_SQL[family]).rows()
    assert chip_smoke.row_diff(got, want) is None, chip_smoke.row_diff(got, want)
    assert len(got) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("label", list(chip_smoke.COLLECTION_SQL))
def test_collections_on_card_equal_cpu(cuda, sessions_sf001, label):
    """chip_smoke.py's `collections` texts (ARRAY and MAP values, lambdas,
    UNNEST, regression, geometry, the CDFs) at TPC-H SF 0.01 on the card
    against the CPU over the same host tables, element order included."""
    card, cpu = sessions_sf001
    text = chip_smoke.COLLECTION_SQL[label]
    got = card.query(text).rows()
    want = cpu.query(text).rows()
    assert chip_smoke.row_diff(got, want) is None, chip_smoke.row_diff(got, want)
    assert len(got) > 0


@pytest.mark.cuda
def test_array_agg_width_retry_and_order_on_card(cuda):
    """C1's shape on the card: groups wider than the first 128 elements take
    the `$collect_need` retry, and each group's elements come in the rows'
    order (the group sort is stable), as on the CPU."""
    from presto_tpu_torch.connectors.memory import MemoryCatalog
    from presto_tpu_torch.page import Page

    rng = np.random.default_rng(29)
    n = 50_000
    cols = {"g": rng.integers(0, 40, n).astype(np.int64), "v": np.arange(n, dtype=np.int64)}
    card = Session(MemoryCatalog({"t": Page.from_dict(cols, device="cuda")}), device="cuda")
    cpu = Session(MemoryCatalog({"t": Page.from_dict(cols, device="cpu")}), device="cpu")
    sql = "select g, array_agg(v) from t group by g order by g"
    got = card.query(sql).rows()
    assert card.executor.width_retries == [(128, 2048)]
    assert got == cpu.query(sql).rows()
    for g, arr in got:
        assert arr == np.flatnonzero(cols["g"] == g).tolist()


@pytest.mark.cuda
def test_statements_on_card_equal_cpu(cuda):
    """chip_smoke.py's `statements` sequence (CTAS, INSERT, DELETE with a
    semi-join, ALTER TABLE, transactions, PREPARE/EXECUTE through the plan
    and result caches, session properties, SHOW, GRANT/REVOKE) over a
    MemoryCatalog of TPC-H SF 0.01 on the card against the same on the
    CPU: every statement's rows, EXPLAIN ANALYZE's per-node rows and
    strategies, and the cache hits each made; on the card the kernels
    launch where the path requires them and the repeated EXECUTE
    launches none (chip_smoke.statement_checks)."""
    cat = TpchCatalog(0.01, device="cuda")
    got = chip_smoke.run_statements(chip_smoke.statements_catalog(cat, "cuda"), "cuda")
    fault = chip_smoke.statement_checks(got)
    assert fault is None, fault
    want = chip_smoke.run_statements(
        chip_smoke.statements_catalog(cat.with_device("cpu"), "cpu"), "cpu")
    for label, step in got.items():
        for g, w in zip(step["statements"], want[label]["statements"]):
            for key in ("rows", "plan_hits", "result_hits"):
                assert chip_smoke._same_result(g[key], w[key]), (label, g["sql"], key)


STREAM_SQL = {
    "q3": QUERIES[3],
    "not_in": "select count(*), sum(o_totalprice) from orders where o_custkey not in "
              "(select c_custkey from customer where c_acctbal > 0)",
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(STREAM_SQL))
def test_streaming_on_card_equals_materializing(cuda, sessions_sf001, name):
    """The streaming executor on the card (exec/stream.py) at a budget
    that offloads: Q3 through the hybrid hash join, a NOT IN whose source
    exceeds the budget through the partitioned semi join, each equal to
    the materializing session on the card, with pool.peak within the
    budget and the join kernels launched; no spill file left."""
    from presto_tpu_torch.exec import spillspace

    card, _cpu = sessions_sf001
    budget = 64 << 10
    stream = Session(card.catalog, device="cuda", streaming=True, batch_rows=8192,
                     memory_budget=budget, result_cache=False)
    before = jk.insert_launches, jk.probe_launches
    got = stream.query(STREAM_SQL[name]).rows()
    want = card.query(STREAM_SQL[name]).rows()
    assert chip_smoke.row_diff(got, want) is None, chip_smoke.row_diff(got, want)
    ex = stream.executor
    assert ex.pool.peak <= budget
    tag = "hybrid_hash_join" if name == "q3" else "partitioned_semijoin"
    assert tag in ex.spill_events, ex.spill_events
    assert jk.insert_launches > before[0] and jk.probe_launches > before[1]
    assert spillspace.all_active_bytes() == 0


@pytest.mark.cuda
def test_grouped_bucket_join_over_hive_on_card_equals_cpu(cuda, sessions_sf001, tmp_path):
    """A bucketed Hive warehouse (connectors/hive.py) at SF 0.01: orders
    and lineitem bucketed on the order key, read on the card by a
    streaming session that takes the grouped bucket join under a budget
    below the whole orders build, equal to the same warehouse read on the
    CPU, with the join kernels launched."""
    from presto_tpu_torch.connectors.hive import HiveCatalog

    card, _cpu = sessions_sf001
    wh = HiveCatalog(str(tmp_path / "wh"), device="cuda")
    for name, key in (("orders", "o_orderkey"), ("lineitem", "l_orderkey")):
        page = card.catalog.page(name)
        wh.create_partitioned_table(name, {n: b.type for n, b in zip(page.names, page.blocks)},
                                    bucketed_by=[key], bucket_count=4)
        wh.append(name, page)
    budget = 256 << 10  # the whole orders build is 300,000 bytes, a bucket ~75,000
    stream = Session(wh, device="cuda", streaming=True, batch_rows=8192, memory_budget=budget,
                     result_cache=False)
    before = jk.insert_launches, jk.probe_launches
    got = stream.query(chip_smoke.FILES_JOIN_SQL).rows()
    want = Session(HiveCatalog(wh.root, device="cpu"), device="cpu", streaming=True,
                   batch_rows=8192, result_cache=False).query(chip_smoke.FILES_JOIN_SQL).rows()
    assert chip_smoke.row_diff(got, want) is None, chip_smoke.row_diff(got, want)
    assert chip_smoke.row_diff(got, card.query(chip_smoke.FILES_JOIN_SQL).rows()) is None
    assert "grouped_bucket_join" in stream.executor.spill_events
    assert stream.executor.pool.peak <= budget
    assert jk.insert_launches > before[0] and jk.probe_launches > before[1]


@pytest.mark.cuda
def test_matview_cycle_on_card_equals_cpu(cuda, tmp_path):
    """chip_smoke's `matview` batches at SF 0.01 (V1-V3 over a shard store,
    lineitem appended in MV_BATCHES batches, V1 and V2 refreshed by delta and V3 in
    full, each view held to numpy and the cached V1 text patched) on the
    card and on the CPU: every view's rows equal, kernels 1-3 launched."""
    rows = {}
    for dev in ("cuda", "cpu"):
        cat = TpchCatalog(0.01, device=dev)
        tables = {n: cat.host_table(n) for n in chip_smoke.TPCH_TABLES}
        store, li, oracle, _s = chip_smoke.matview_store(str(tmp_path / dev), cat, dev)
        before = gk.launches, jk.insert_launches, jk.probe_launches
        sess, report = chip_smoke.matview_batches(store, li, oracle, tables, dev)
        if dev == "cuda":
            assert all(after > b for after, b in zip(
                (gk.launches, jk.insert_launches, jk.probe_launches), before))
        assert len(report) == chip_smoke.MV_BATCHES
        rows[dev] = {v: sess.query(f"select * from {v}").rows() for v in chip_smoke.MV_SQL}
    for v in chip_smoke.MV_SQL:
        diff = chip_smoke.row_diff(rows["cuda"][v], rows["cpu"][v], ordered=(v == "v1"))
        assert diff is None, (v, diff)


@pytest.mark.cuda
@pytest.mark.parametrize("q", [3, 5, 9, 18])
def test_feedback_double_run_on_card_equals_cpu(cuda, sessions_sf001, monkeypatch, q):
    """With PRESTO_TPU_FEEDBACK=1 the first run on the card observes and
    the second plans from the observations; both equal the CPU."""
    from presto_tpu_torch.plan import history as H

    monkeypatch.setenv("PRESTO_TPU_FEEDBACK", "1")
    card, cpu = sessions_sf001
    want = cpu.query(QUERIES[q]).rows()
    records = H.HISTORY.stats.snapshot()["records"]
    for _run in range(2):
        got = card.query(QUERIES[q]).rows()
        assert chip_smoke.row_diff(got, want) is None, chip_smoke.row_diff(got, want)
    assert H.HISTORY.stats.snapshot()["records"] > records


@pytest.mark.cuda
def test_feedback_streamed_on_card_equals_materializing(cuda, sessions_sf001, monkeypatch):
    """A streamed Q3 at a budget that offloads, run twice with feedback on:
    the first run observes through a collector whose row counts lie on the
    card and on the host (read_counts reads each device once), and both
    runs equal the materializing session on the card."""
    from presto_tpu_torch.plan import history as H

    monkeypatch.setenv("PRESTO_TPU_FEEDBACK", "1")
    card, _cpu = sessions_sf001
    want = card.query(QUERIES[3]).rows()
    records = H.HISTORY.stats.snapshot()["records"]
    for _run in range(2):
        stream = Session(card.catalog, device="cuda", streaming=True, batch_rows=8192,
                         memory_budget=64 << 10, result_cache=False)
        got = stream.query(QUERIES[3]).rows()
        assert chip_smoke.row_diff(got, want) is None, chip_smoke.row_diff(got, want)
    assert H.HISTORY.stats.snapshot()["records"] > records


@pytest.mark.cuda
@pytest.mark.parametrize("threshold", [None, 0])
@pytest.mark.parametrize("q", [3, 5, 16, 18])
def test_mesh_on_card_equals_cpu(cuda, sessions_sf001, threshold, q):
    """TPC-H over an 8-worker mesh on the card (every worker on cuda:0),
    broadcast and repartitioned joins: the rows of the single-device CPU
    session, each worker's build and probe on the join kernels."""
    from presto_tpu_torch.parallel import default_mesh

    card, cpu = sessions_sf001
    mesh = Session(card.catalog, mesh=default_mesh(8), broadcast_threshold=threshold,
                   result_cache=False)
    want = cpu.query(QUERIES[q]).rows()
    before = jk.insert_launches, jk.probe_launches
    got = mesh.query(QUERIES[q]).rows()
    ordered = "order by" in QUERIES[q].lower()
    assert chip_smoke.row_diff(got, want, ordered) is None, chip_smoke.row_diff(got, want, ordered)
    assert jk.insert_launches > before[0] and jk.probe_launches > before[1]
