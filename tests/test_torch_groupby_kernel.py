"""Parity: presto_tpu_torch's dense group-by strategy (ops/groupby_kernel.py)
against presto_tpu's.

The port runs on device="cpu", where its wrapper takes the plain version of
the CUDA kernel. The reference runs twice: its Pallas kernel in interpret
mode (`maybe_grouped_aggregate`), and its exact sorted strategy
(`grouped_aggregate_sorted`). The reference kernel needs
`jax.experimental.disable_x64`, which this JAX release lacks, so the test
supplies it (monkeypatch; presto_tpu is unchanged). Cases follow
tests/test_pallas_agg.py: G = 63, min/max with an empty group, a NULL key
group, and float64 sum/avg.

Tolerances: integers and decimals are exact. float64 sums match the exact
reference within 1e-9 relative, and the reference kernel (hi/lo f32 split)
within its documented sum|x| * 1e-6.
"""

import jax
import jax.experimental
import numpy as np
import pytest
import torch

from presto_tpu import types as RT
from presto_tpu.expr.ir import col as rcol
from presto_tpu.ops.aggregate import AggSpec as RAggSpec
from presto_tpu.ops.aggregate import grouped_aggregate_sorted as r_sorted
from presto_tpu.ops.pallas_groupby import maybe_grouped_aggregate as r_dense
from presto_tpu.page import Block as RBlock
from presto_tpu.page import Page as RPage
from presto_tpu_torch import types as T
from presto_tpu_torch.expr.ir import col
from presto_tpu_torch.ops import groupby_kernel as gk
from presto_tpu_torch.ops.aggregate import AggSpec
from presto_tpu_torch.page import Block, Page

# one torch thread: the suite runs in parallel worker processes
# (pytest-xdist), and a thread per core in each oversubscribes the host
torch.set_num_threads(1)

N = 20_000  # two of the reference kernel's 16,384-row blocks


def _case(name):
    """(columns {name: (data, valid, sql type, dictionary)}, aggs spec)."""
    rng = np.random.default_rng(sum(map(ord, name)))
    if name == "g63":
        d = tuple(f"k{i:02d}" for i in range(63))
        cols = {
            "g": (rng.integers(0, 63, N).astype(np.int32), None, "varchar", d),
            "v": (rng.integers(-1000, 1000, N), None, "bigint", None),
        }
        aggs = [("sum", "v", "bigint"), ("count_star", None, "bigint")]
    elif name == "minmax_empty_group":
        cols = {
            "g": (rng.integers(0, 3, N).astype(np.int32), None, "varchar", ("A", "N", "R", "Z")),
            "v": (rng.integers(-(10**9), 10**9, N), None, "bigint", None),
        }
        aggs = [("min", "v", "bigint"), ("max", "v", "bigint"), ("sum", "v", "bigint"),
                ("count_star", None, "bigint")]
    elif name == "null_key_group":
        cols = {
            "g": (rng.integers(0, 2, N).astype(np.int32), rng.random(N) < 0.9, "varchar",
                  ("A", "B")),
            "v": (rng.integers(0, 100, N), None, "bigint", None),
            "q": (rng.integers(0, 10**6, N), None, "decimal(12,2)", None),
        }
        aggs = [("sum", "v", "bigint"), ("count_star", None, "bigint"),
                ("sum", "q", "decimal(12,2)"), ("avg", "q", "decimal(12,2)")]
    else:  # f64_sum_avg
        cols = {
            "g": (rng.integers(0, 3, N).astype(np.int32), None, "varchar", ("A", "N", "R")),
            "d": (rng.random(N) * 1e6 - 5e5, None, "double", None),
            "v": (rng.integers(-1000, 1000, N), None, "bigint", None),
        }
        aggs = [("sum", "d", "double"), ("avg", "d", "double"), ("sum", "v", "bigint"),
                ("count", "v", "bigint")]
    return cols, aggs


def _inputs(name):
    cols, aggs = _case(name)
    rblocks, tblocks = [], []
    for cname, (data, valid, typ, dic) in cols.items():
        rblocks.append(RBlock.from_numpy(data, RT.parse_type(typ), valid=valid, dictionary=dic))
        tblocks.append(Block.from_numpy(data, T.parse_type(typ), valid=valid, dictionary=dic,
                                        device="cpu"))
    rpage = RPage.from_blocks(rblocks, list(cols))
    tpage = Page.from_blocks(tblocks, list(cols), device="cpu")
    raggs, taggs = [], []
    for i, (func, src, typ) in enumerate(aggs):
        rt, tt = RT.parse_type(typ), T.parse_type(typ)
        raggs.append(RAggSpec(func, None if src is None else rcol(src, rt), f"a{i}",
                              RAggSpec.infer_output_type(func, rt)))
        taggs.append(AggSpec(func, None if src is None else col(src, tt), f"a{i}",
                             AggSpec.infer_output_type(func, tt)))
    gtype = cols["g"][2]
    return (rpage, (rcol("g", RT.parse_type(gtype)),), tuple(raggs),
            tpage, (col("g", T.parse_type(gtype)),), tuple(taggs), cols)


def _rows(page):
    return sorted(page.to_pylist(), key=str)


def _close(got, want, rel):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for x, y in zip(g, w):
            if isinstance(y, float):
                assert abs(x - y) <= rel(y), (x, y)
            else:
                assert x == y


@pytest.fixture(scope="module")
def reference_kernel_x64():
    """The reference kernel's `disable_x64` for this JAX release."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jax.experimental, "disable_x64", lambda: jax.enable_x64(False), raising=False)
    yield
    mp.undo()


@pytest.mark.parametrize(
    "name", ["g63", "minmax_empty_group", "null_key_group", "f64_sum_avg"]
)
def test_dense_strategy_matches_reference(name, reference_kernel_x64):
    rpage, rkeys, raggs, tpage, tkeys, taggs, cols = _inputs(name)
    hits = gk.dense_hits
    got = gk.maybe_grouped_aggregate(tpage, tkeys, ("g",), taggs, None)
    assert got is not None and gk.dense_hits == hits + 1
    got = _rows(got)
    exact = _rows(r_sorted(rpage, rkeys, ("g",), raggs, 128))
    kernel = r_dense(rpage, rkeys, ("g",), raggs, None)
    assert kernel is not None  # the same shape is eligible in both packages
    kernel = _rows(kernel)
    # f64 sums: 1e-9 relative against the exact path; the reference
    # kernel's hi/lo f32 channels carry ~sum|x| * 1e-6
    _close(got, exact, lambda y: 1e-9 * max(abs(y), 1.0))
    if "d" in cols:
        mag = float(np.abs(cols["d"][0]).sum())
        _close(got, kernel, lambda y: mag * 1e-6)
    else:
        assert got == kernel


def test_ineligible_shapes_fall_through():
    """The reference's eligibility rules: non-dictionary keys, float
    min/max and more than 64 groups take the sorted strategy."""
    rng = np.random.default_rng(3)
    n = 100
    d65 = tuple(f"k{i:02d}" for i in range(65))
    page = Page.from_blocks(
        [
            Block.from_numpy(rng.integers(0, 65, n).astype(np.int32), T.VARCHAR,
                             dictionary=d65, device="cpu"),
            Block.from_numpy(rng.integers(0, 5, n), T.BIGINT, device="cpu"),
            Block.from_numpy(rng.random(n), T.DOUBLE, device="cpu"),
        ],
        ["g", "i", "d"],
    )
    s = AggSpec("sum", col("i", T.BIGINT), "s", T.BIGINT)
    m = AggSpec("min", col("d", T.DOUBLE), "m", T.DOUBLE)
    assert gk.maybe_grouped_aggregate(page, (col("g", T.VARCHAR),), ("g",), (s,), None) is None
    assert gk.maybe_grouped_aggregate(page, (col("i", T.BIGINT),), ("i",), (s,), None) is None
    small = Page.from_blocks(
        [Block.from_numpy(np.zeros(n, np.int32), T.VARCHAR, dictionary=("a",), device="cpu"),
         page.blocks[2]], ["g", "d"])
    assert gk.maybe_grouped_aggregate(small, (col("g", T.VARCHAR),), ("g",), (m,), None) is None


def _np_totals(gid, live, count, chans, kinds, sources, G):
    sel = live & (np.arange(len(gid)) < count)
    out = np.zeros((G, len(kinds)), chans.dtype if chans is not None else np.int64)
    for g in range(G):
        m = sel & (gid == g)
        for k, (kind, s) in enumerate(zip(kinds, sources)):
            if kind == gk.COUNT:
                out[g, k] = m.sum()
            elif kind == gk.ADD:
                out[g, k] = chans[s][m].sum()
            elif kind == gk.MIN:
                out[g, k] = chans[s][m].min() if m.any() else np.iinfo(np.int64).max
            else:
                out[g, k] = chans[s][m].max() if m.any() else np.iinfo(np.int64).min
    return out


def test_groupby_totals_plain_against_numpy():
    rng = np.random.default_rng(9)
    n, G = 5000, 7
    gid = rng.integers(0, G - 1, n).astype(np.int32)  # group G-1 stays empty
    live = rng.random(n) < 0.8
    chans = rng.integers(-(1 << 50), 1 << 50, (3, n))
    kinds, sources = [gk.COUNT, gk.ADD, gk.MIN, gk.MAX, gk.ADD], [-1, 0, 1, 2, 2]
    count = n - 17
    got = gk.groupby_totals(
        torch.from_numpy(gid), torch.from_numpy(live),
        torch.tensor(count, dtype=torch.int32), torch.from_numpy(chans), kinds, sources, G,
    )
    np.testing.assert_array_equal(got.numpy(), _np_totals(gid, live, count, chans, kinds,
                                                          sources, G))
