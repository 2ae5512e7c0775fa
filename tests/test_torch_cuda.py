"""presto_tpu_torch on an NVIDIA card: the groupby, join-insert,
join-probe and fused-Q1 kernels against their plain versions, and TPC-H
queries and the hand-coded pipelines on "cuda" against the same on "cpu".

These tests import neither jax nor presto_tpu, so they also run where only
PyTorch is installed:

    python3 -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Without a CUDA device they skip.
"""

import numpy as np
import pytest
import torch

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


def _insert_inputs(cuda, n, bits, skew):
    rng = np.random.default_rng(17 + skew)
    tag_u = rng.integers(0, 0xFFFFFFFF, n, dtype=np.int64)
    if skew:  # one tag repeated 400 times: rows overflow, probes continue
        tag_u[rng.permutation(n)[:400]] = tag_u[0]
    tag = torch.from_numpy(tag_u.astype(np.uint32).view(np.int32).copy()).to(cuda)
    desired = torch.from_numpy((tag_u >> (32 - bits)).astype(np.int32)).to(cuda)
    row = torch.from_numpy(np.where(rng.random(n) < 0.95, np.arange(n), -1).astype(np.int32))
    return tag, row.to(cuda), desired


@pytest.mark.cuda
@pytest.mark.parametrize("skew", [False, True])
def test_join_kernels_match_plain(cuda, skew):
    n = 200_000
    bits = jk._pick_bits(n)
    tag, row, desired = _insert_inputs(cuda, n, bits, skew)
    before = jk.insert_launches, jk.probe_launches
    got = jk.join_insert(tag, row, desired, bits)
    plain = jk.join_insert_plain(tag, row, desired, bits)
    torch.cuda.synchronize()
    assert jk.insert_launches == before[0] + 1
    # any race winner is a valid placement: hold both to the invariants
    for out in (got, plain):
        assert jk.insert_invariant_errors(tag, row, desired, bits, *out) == []
    assert bool(got[2].any()) == skew
    # the probe: exact against its plain version on the kernel's table
    rng = np.random.default_rng(5)
    m = 300_000
    pick = torch.from_numpy(rng.integers(0, n, m)).to(cuda)
    ptag = torch.where(pick % 2 == 0, tag[pick], tag[pick] ^ 0x5A5A5A5A).contiguous()
    pdes = ((ptag.to(torch.int64) & 0xFFFFFFFF) >> (32 - bits)).to(torch.int32)
    start = torch.from_numpy(rng.integers(0, 3, m).astype(np.int32)).to(cuda)
    want = jk.join_probe_plain(got[0], got[1], ptag, pdes, start)
    have = jk.join_probe(got[0], got[1], ptag, pdes, start)
    torch.cuda.synchronize()
    assert jk.probe_launches == before[1] + 1
    for a, b in zip(have, want):
        assert torch.equal(a, b)
    assert bool((have[0] >= 0).any()) and (not skew or bool(have[2].any()))


@pytest.mark.cuda
@pytest.mark.parametrize("q", [1, 6, 3, 5, 17, 18])
def test_queries_on_card_equal_cpu(cuda, q):
    before = gk.launches, jk.insert_launches
    got = Session(TpchCatalog(0.01, device="cuda"), device="cuda").query(QUERIES[q]).rows()
    if q == 1:
        assert gk.launches > before[0]
    if q in (3, 5, 17, 18):
        assert jk.insert_launches > before[1]
    want = Session(TpchCatalog(0.01, device="cpu"), device="cpu").query(QUERIES[q]).rows()
    assert got == want


@pytest.mark.cuda
@pytest.mark.parametrize("count,cutoff", [(None, 10471), (300_000, 9131)])
def test_q1_kernel_matches_plain(cuda, count, cutoff):
    """The fused Q1 kernel over device-generated lineitem (SF 0.1), whole
    and cut by count and by a cutoff that empties the open groups."""
    page = handcoded.lineitem_q1_page(0.1, device="cuda")
    cols = [page.block(c).data for c in handcoded.Q1_COLUMNS]
    n_live = page.count if count is None else torch.tensor(count, dtype=torch.int32, device=cuda)
    cut = torch.tensor(cutoff, dtype=torch.int32, device=cuda)
    before = ak.launches
    got = ak.q1_sums(*cols, n_live, cut)
    want = ak.q1_sums_plain(*cols, n_live, cut)
    torch.cuda.synchronize()
    assert ak.launches == before + 1
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert (int(got["count"].sum()) < int(n_live)) and (cutoff > 9298 or int(got["count"][1]) == 0)


@pytest.mark.cuda
@pytest.mark.parametrize("pipeline", ["q1_local", "q1_local_kernel", "q6_local"])
def test_handcoded_on_card_equal_cpu(cuda, pipeline):
    before = ak.launches
    fn = getattr(handcoded, pipeline)
    got = fn(handcoded.lineitem_q1_page(0.01, device="cuda")).to_pylist()
    assert (ak.launches > before) == (pipeline == "q1_local_kernel")
    assert got == fn(handcoded.lineitem_q1_page(0.01, device="cpu")).to_pylist()
