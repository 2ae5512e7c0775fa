"""Parity: presto_tpu_torch's row operators against presto_tpu's — hashing
(bit for bit: the port keeps uint64 hashes in int64), filter compaction,
sort / top-n / distinct, key packing, the sorted group-by and the global
aggregate. Inputs come from numpy with a fixed seed; device="cpu";
everything is exact (float sums agree within 1e-12 relative).
"""

import numpy as np
import pytest
import torch

from presto_tpu import types as RT
from presto_tpu.expr import ir as rir
from presto_tpu.ops import aggregate as ragg
from presto_tpu.ops import filter as rfilter
from presto_tpu.ops import hashing as rhash
from presto_tpu.ops import keypack as rkp
from presto_tpu.ops import sort as rsort
from presto_tpu.page import Block as RBlock
from presto_tpu.page import Page as RPage
from presto_tpu_torch import types as T
from presto_tpu_torch.expr import ir
from presto_tpu_torch.ops import aggregate as agg
from presto_tpu_torch.ops import filter as filt
from presto_tpu_torch.ops import hashing
from presto_tpu_torch.ops import keypack as kp
from presto_tpu_torch.ops import sort
from presto_tpu_torch.page import Block, Page

# one torch thread: the suite runs in parallel worker processes
# (pytest-xdist), and a thread per core in each oversubscribes the host
torch.set_num_threads(1)

N = 300


@pytest.fixture(scope="module")
def pages():
    """The same padded page in both packages: ints with NULLs, a small
    dictionary, doubles with NaN and -0.0, a date, a short decimal."""
    rng = np.random.default_rng(21)
    f = rng.normal(size=N)
    f[::17] = np.nan
    f[5] = -0.0
    cols = {
        "i": (rng.integers(-5, 5, N), rng.random(N) < 0.85, "bigint", None),
        "s": (rng.integers(0, 4, N).astype(np.int32), None, "varchar", ("a", "b", "c", "d")),
        "f": (f, None, "double", None),
        "d": (rng.integers(8000, 8100, N).astype(np.int32), None, "date", None),
        "m": (rng.integers(-10**6, 10**6, N), rng.random(N) < 0.9, "decimal(12,2)", None),
    }
    rb = [RBlock.from_numpy(a, RT.parse_type(t), valid=v, dictionary=d) for a, v, t, d in cols.values()]
    tb = [Block.from_numpy(a, T.parse_type(t), valid=v, dictionary=d, device="cpu")
          for a, v, t, d in cols.values()]
    from presto_tpu.page import _pad_block as rpad
    from presto_tpu_torch.page import _pad_block as tpad

    rp = RPage.from_blocks([rpad(b, 512) for b in rb], list(cols), count=N - 20)
    tp = Page.from_blocks([tpad(b, 512) for b in tb], list(cols), count=N - 20)
    return rp, tp, {k: t for k, (_a, _v, t, _d) in cols.items()}


def _refs(types, names):
    return [rir.col(n, RT.parse_type(types[n])) for n in names], [
        ir.col(n, T.parse_type(types[n])) for n in names
    ]


def test_hash_rows_bit_identical(pages):
    rp, tp, _ = pages
    for names in (["i"], ["s"], ["f"], ["d", "m"], ["i", "s", "f", "d", "m"]):
        want = np.asarray(rhash.hash_rows([rp.block(n) for n in names])).view(np.int64)
        got = hashing.hash_rows([tp.block(n) for n in names]).numpy()
        np.testing.assert_array_equal(got, want)


def test_filter_compact(pages):
    rp, tp, types = pages
    pred_r = rir.comparison("lt", rir.col("i", RT.BIGINT), rir.lit(2))
    pred_t = ir.comparison("lt", ir.col("i", T.BIGINT), ir.lit(2))
    r, t = rfilter.filter_page(rp, pred_r), filt.filter_page(tp, pred_t)
    assert int(t.count) == int(r.count) and _nan_eq(t.to_pylist(), r.to_pylist())


KEYSETS = [
    [("i", True, None), ("s", False, None)],
    [("f", True, None), ("d", False, True)],
    [("m", False, False), ("i", True, True), ("f", False, None)],
]


@pytest.mark.parametrize("keyset", range(len(KEYSETS)))
def test_sort_topn_and_packed(pages, keyset):
    rp, tp, types = pages
    names = [k for k, _, _ in KEYSETS[keyset]]
    rcols, tcols = _refs(types, names)
    rkeys = [rsort.SortKey(c, a, nf) for c, (_, a, nf) in zip(rcols, KEYSETS[keyset])]
    tkeys = [sort.SortKey(c, a, nf) for c, (_, a, nf) in zip(tcols, KEYSETS[keyset])]
    want = rsort.sort_page(rp, rkeys).to_pylist()
    assert _nan_eq(sort.sort_page(tp, tkeys).to_pylist(), want)
    assert _nan_eq(sort.top_n(tp, tkeys, 7).to_pylist(), rsort.top_n(rp, rkeys, 7).to_pylist())
    rinfos = [rkp.key_info_from_block(rp.block(n)) for n in names]
    tinfos = [kp.key_info_from_block(tp.block(n)) for n in names]
    rplan = rkp.plan_keypack(rkeys, rinfos, host_sort=False)
    tplan = kp.plan_keypack(tkeys, tinfos)
    assert (rplan is None) == (tplan is None)
    if tplan is None:
        return
    assert tplan.strategy == rplan.strategy and tplan.lanes == rplan.lanes
    rl, _ = rkp.pack_keys([rsort.evaluate(k.expr, rp) for k in rkeys], rplan, rp.live_mask())
    tl, _ = kp.pack_keys([sort.evaluate(k.expr, tp) for k in tkeys], tplan, tp.live_mask())
    for a, b in zip(tl, rl):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    got, ok = sort.sort_page_packed(tp, tkeys, tplan)
    assert ok is None and _nan_eq(got.to_pylist(), want)


def _nan_eq(a, b):
    def norm(rows):
        return [tuple("nan" if isinstance(x, float) and x != x else x for x in r) for r in rows]

    return norm(a) == norm(b)


def test_distinct_and_sorted_groupby(pages):
    rp, tp, types = pages
    sub_r, sub_t = rp.select(["i", "s"]), tp.select(["i", "s"])
    want = sorted(rsort.distinct_page(sub_r, 512).to_pylist(), key=str)
    assert sorted(sort.distinct_page(sub_t, 512).to_pylist(), key=str) == want
    keys = [ir.col("i", T.BIGINT), ir.col("s", T.VARCHAR)]
    plan = kp.plan_keypack(keys, [kp.key_info_from_block(tp.block(n)) for n in ("i", "s")],
                           equality_only=True, allow_hashed=True)
    out, ok = sort.distinct_packed(sub_t, plan)
    assert (ok is None or bool(ok)) and sorted(out.to_pylist(), key=str) == want
    rcols, tcols = _refs(types, ["s", "i"])
    specs = [("sum", "m"), ("avg", "m"), ("min", "f"), ("max", "d"), ("count", "i"),
             ("count_star", None), ("sum", "f")]
    raggs, taggs = [], []
    for j, (fn, src) in enumerate(specs):
        rin = None if src is None else rir.col(src, RT.parse_type(types[src]))
        tin = None if src is None else ir.col(src, T.parse_type(types[src]))
        raggs.append(ragg.AggSpec(fn, rin, f"a{j}", ragg.AggSpec.infer_output_type(fn, rin and rin.type)))
        taggs.append(agg.AggSpec(fn, tin, f"a{j}", agg.AggSpec.infer_output_type(fn, tin and tin.type)))
    r = ragg.grouped_aggregate_sorted(rp, rcols, ("s", "i"), raggs, 64)
    t = agg.grouped_aggregate_sorted(tp, tcols, ("s", "i"), taggs, 64)
    assert int(t.count) == int(r.count)
    _rows_close(sorted(t.to_pylist(), key=str), sorted(r.to_pylist(), key=str))
    mask_r = rir.comparison("gt", rir.col("d", RT.DATE), rir.lit(8050, RT.DATE))
    mask_t = ir.comparison("gt", ir.col("d", T.DATE), ir.lit(8050, T.DATE))
    _rows_close(agg.global_aggregate(tp, taggs, mask_t).to_pylist(),
                ragg.global_aggregate(rp, raggs, mask_r).to_pylist())


def _rows_close(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for x, y in zip(g, w):
            if isinstance(y, float) and y == y:
                assert abs(x - y) <= 1e-12 * max(abs(y), 1.0)
            else:
                assert _nan_eq([(x,)], [(y,)])
