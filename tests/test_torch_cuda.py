"""presto_tpu_torch on an NVIDIA card: the groupby, join-insert,
join-probe and fused-Q1 kernels against their plain versions (the groupby
kernel also at the edges of its regimes and grid, chip_smoke.py's
GROUPBY_EDGES, and as one launch per call; the first-match join probe as
one launch, the table build with at most two host reads; the fused-Q1
kernel at the edges of its loads and grid, chip_smoke.py's Q1_EDGES, and
as one launch per call), and the 22 TPC-H queries, the analytic set of
chip_smoke.py (windows, set operations, ROLLUP, moments, TABLESAMPLE) and
the hand-coded pipelines on "cuda" against the same on "cpu".

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
from presto_tpu_torch.benchmark.tpch_sql import QUERIES
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
    res = chip_smoke.one_launch_check("count_below_n", call)
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
    res = chip_smoke.build_check("build_50k", build, key)
    assert res["launches"] == 1 and res["nonzero"] == 0 and res["dtoh"] <= 2
    jt = jk.build_table(build, key)
    h, prep = jk._probe_setup(probe, jt, key)
    res = chip_smoke.probe_launch_check("probe_200k", jt, h, probe.live_mask(), prep)
    assert res["launches"] == 1 and res["memcpy"] == 0 and res["stream_syncs"] == 0


@pytest.fixture(scope="module")
def sessions_sf001():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cat = TpchCatalog(0.01, device="cuda")
    return Session(cat, device="cuda"), Session(cat.with_device("cpu"), device="cpu")


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
    res = chip_smoke.one_launch_check("q1_sf01", call, "q1_partials")
    assert res["launches"] == 1 and res["memcpy"] == 0 and res["stream_syncs"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("pipeline", ["q1_local", "q1_local_kernel", "q6_local"])
def test_handcoded_on_card_equal_cpu(cuda, pipeline):
    before = ak.launches
    fn = getattr(handcoded, pipeline)
    got = fn(handcoded.lineitem_q1_page(0.01, device="cuda")).to_pylist()
    assert (ak.launches > before) == (pipeline == "q1_local_kernel")
    assert got == fn(handcoded.lineitem_q1_page(0.01, device="cpu")).to_pylist()
