"""Parity: presto_tpu_torch's join kernels and the modules around them
(ops/hashing.py value hashes, ops/join_kernel.py, ops/join.py,
exec/dynfilter.py, ops/groupby_kernel.py's hash-slot strategy) against
presto_tpu's.

The port runs on device="cpu", where the kernel wrappers take their plain
versions. The reference's Pallas join kernels run in interpret mode
(PRESTO_TPU_PALLAS_JOIN=interp) where the kernels themselves are compared,
its host path elsewhere; its hash-slot group-by runs in host mode and, with
PRESTO_TPU_PALLAS_GROUPBY_HASH=interp and the `disable_x64` shim of
tests/test_torch_groupby_kernel.py, through its Pallas kernel.

Tolerances: hashes, tags, probe outputs, join rows and integer or decimal
totals are exact. Slot arrays are never compared: any race winner is a
valid placement, so the inserts are held to the table invariants
(join_kernel.insert_invariant_errors) and to equal join results. Float
totals match within 1e-9 relative (host mode) and within the reference
kernel's hi/lo f32 split, sum|x| * 1e-6 (kernel mode).
"""

import jax
import jax.experimental
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from presto_tpu import types as RT
from presto_tpu.exec.dynfilter import derive_filter as r_derive
from presto_tpu.expr.ir import col as rcol
from presto_tpu.ops import join as rjoin
from presto_tpu.ops import pallas_join as rpj
from presto_tpu.ops.aggregate import AggSpec as RAggSpec
from presto_tpu.ops.hashing import np_hash_rows_values
from presto_tpu.ops.pallas_groupby import maybe_grouped_aggregate_hash as r_hash_groupby
from presto_tpu.page import Block as RBlock
from presto_tpu.page import Page as RPage
from presto_tpu_torch import types as T
from presto_tpu_torch.exec.dynfilter import derive_filter
from presto_tpu_torch.expr.ir import col
from presto_tpu_torch.ops import groupby_kernel as gk
from presto_tpu_torch.ops import join as tjoin
from presto_tpu_torch.ops import join_kernel as jk
from presto_tpu_torch.ops.aggregate import AggSpec
from presto_tpu_torch.ops.hashing import hash_rows_values
from presto_tpu_torch.page import Block, Page

# one torch thread: the suite runs in parallel worker processes
# (pytest-xdist), and a thread per core in each oversubscribes the host
torch.set_num_threads(1)


def _pages(cols, count=None):
    """The same columns as a reference page and a port page on the CPU:
    {name: (data, sql type, valid or None, dictionary or None)}."""
    rb, tb = [], []
    for data, typ, valid, dic in cols.values():
        rb.append(RBlock.from_numpy(data, RT.parse_type(typ), valid=valid, dictionary=dic))
        tb.append(Block.from_numpy(data, T.parse_type(typ), valid=valid, dictionary=dic,
                                   device="cpu"))
    n = len(next(iter(cols.values()))[0]) if count is None else count
    return (RPage.from_blocks(rb, list(cols), count=n),
            Page.from_blocks(tb, list(cols), count=n, device="cpu"))


def _keys(*specs):
    return (tuple(rcol(n, RT.parse_type(t)) for n, t in specs),
            tuple(col(n, T.parse_type(t)) for n, t in specs))


def _rows(page):
    return sorted(page.to_pylist(), key=repr)


# ---------------------------------------------------------------------------
# value hashes
# ---------------------------------------------------------------------------


def test_value_hash_bit_identical_to_reference():
    rng = np.random.default_rng(3)
    n = 3000
    d1 = tuple(sorted({f"s{i:03d}" for i in range(0, 400, 3)}))
    d2 = tuple(sorted({f"s{i:03d}" for i in range(0, 400, 2)} | {"é", ""}))
    lanes = np.stack([rng.integers(-(1 << 40), 1 << 40, n), rng.integers(0, 1 << 32, n)], 1)
    f = np.where(rng.random(n) < 0.05, np.nan, rng.normal(size=n))
    f[:7] = -0.0
    cols = {
        "i": (rng.integers(-(2 ** 50), 2 ** 50, n), "bigint", rng.random(n) > 0.1, None),
        "f": (f, "double", None, None),
        "a": (rng.integers(0, len(d1), n).astype(np.int32), "varchar", rng.random(n) > 0.2, d1),
        "b": (rng.integers(0, len(d2), n).astype(np.int32), "varchar", None, d2),
        "d": (lanes, "decimal(38,2)", rng.random(n) > 0.3, None),
        "s": (rng.integers(-30000, 30000, n).astype(np.int32), "integer", None, None),
    }
    rp, tp = _pages(cols)
    for names in (["i"], ["f"], ["a"], ["b"], ["d"], ["s"], ["a", "i", "d"], ["b", "f", "s"]):
        want = np_hash_rows_values([rp.block(c) for c in names])
        got = hash_rows_values([tp.block(c) for c in names])
        np.testing.assert_array_equal(got.numpy(), want.view(np.int64))
    # equal strings in two dictionaries hash alike
    common = sorted(set(d1) & set(d2))
    _, ta = _pages({"k": (np.array([d1.index(s) for s in common], np.int32), "varchar", None, d1)})
    _, tb = _pages({"k": (np.array([d2.index(s) for s in common], np.int32), "varchar", None, d2)})
    assert torch.equal(hash_rows_values(ta.blocks), hash_rows_values(tb.blocks))


# ---------------------------------------------------------------------------
# the kernels' plain versions against the reference's Pallas kernels
# ---------------------------------------------------------------------------


def _insert_inputs(rng, n, domain, skew):
    k = rng.integers(0, domain, n).astype(np.int64)
    if skew:
        k[rng.random(n) < 0.3] = 42  # one key repeated ~n/3 times: overflow
    rp, tp = _pages({"k": (k, "bigint", rng.random(n) > 0.05, None),
                     "v": (np.arange(n), "bigint", None, None)}, count=n - 9)
    return rp, tp


@pytest.mark.parametrize("skew", [False, True])
def test_insert_matches_reference_kernel(skew, monkeypatch):
    monkeypatch.setenv("PRESTO_TPU_PALLAS_JOIN", "interp")
    rng = np.random.default_rng(5 + skew)
    rp, tp = _insert_inputs(rng, 1500, 700, skew)
    (rk,), (tk,) = _keys(("k", "bigint"))
    rt = rpj.build_table(rp, (rk,))  # the reference insert kernel, interpreted
    tt = jk.build_table(tp, (tk,))
    assert rt.bits == tt.bits and rt.count == tt.count and len(rt.of_tag) == tt.of_tag.numel()
    assert (len(rt.of_tag) > 0) == skew
    # the port's insert inputs (row hashes, live rows with non-NULL keys),
    # held to the table invariants, for both tables (the reference's
    # carried across, its overflow rows as (tag, row) pairs)
    kv = tt.key_vals[0]
    h = hash_rows_values([kv])
    live = tp.live_mask() & kv.valid
    slots, overflow, last = jk.join_insert(h, live, tt.bits)
    assert jk.insert_invariant_errors(h, live, tt.bits, slots, overflow, last) == []
    carried = jk.JoinTable.from_numpy(rt.slot_tag, rt.slot_row, rt.bits, rt.of_tag, rt.of_row,
                                      tp, tt.key_vals, tt.key_exprs, rt.count, "cpu")
    rover = torch.full((tp.capacity, 2), -1, dtype=torch.int32)
    rover[:len(rt.of_row)] = torch.stack([carried.of_tag, carried.of_row], dim=1)
    assert jk.insert_invariant_errors(h, live, tt.bits, carried.slots, rover,
                                      torch.tensor(len(rt.of_row) - 1)) == []
    # overflow tags equal the reference's (same rows under the same tag)
    assert torch.equal(carried.of_tag, tt.of_tag)
    assert int(last) + 1 == len(rt.of_tag)
    # equal join results over either table
    rng2 = np.random.default_rng(9)
    _, probe = _pages({"k": (rng2.integers(0, 800, 2000).astype(np.int64), "bigint", None, None),
                       "w": (np.arange(2000), "bigint", None, None)})
    for kind in ("semi", "anti"):
        a = _rows(jk.table_join_n1(probe, tt, (tk,), (), (), kind))
        assert a == _rows(jk.table_join_n1(probe, carried, (tk,), (), (), kind))
    for kind in ("inner", "left"):
        a = _rows(_expand(tjoin, probe, tt, (tk,), kind))
        assert a == _rows(_expand(tjoin, probe, carried, (tk,), kind))


def test_probe_plain_equals_reference_kernel(monkeypatch):
    """join_probe_plain (the slot region) and the port's _probe_n1 (slot
    region, then the overflow region) against the reference's _probe_n1
    driving its Pallas probe kernel in interpret mode, on the reference's
    own table carried across: matched and the build row are equal."""
    monkeypatch.setenv("PRESTO_TPU_PALLAS_JOIN", "interp")
    rng = np.random.default_rng(7)
    rp, tp = _insert_inputs(rng, 600, 150, True)  # dups: long scans, overflow
    (rk,), (tk,) = _keys(("k", "bigint"))
    rt = rpj.build_table(rp, (rk,))
    jt = jk.JoinTable.from_numpy(rt.slot_tag, rt.slot_row, rt.bits, rt.of_tag, rt.of_row,
                                 tp, (jk.evaluate(tk, tp),), (tk,), rt.count, "cpu")
    assert jt.of_tag.numel() > 0
    m = 2000
    pk = np.concatenate([rp.block("k").data, rng.integers(0, 400, m - rp.capacity)])
    rpp, tpp = _pages({"k": (pk.astype(np.int64), "bigint", rng.random(m) > 0.1, None)},
                      count=m - 3)
    rkey, tkey = rpp.block("k"), jk.evaluate(tk, tpp)
    rlive = np.arange(m) < m - 3
    ptag, pdes = rpj._tag_desired(np_hash_rows_values([rkey]), rt.bits)
    want_m, want_b = rpj._probe_n1(rt, ptag, pdes, rlive, rpj._host_prepare_keys(rt, [rkey]),
                                   "interp")
    h = hash_rows_values([tkey])
    live = tpp.live_mask()
    prep = jk._prepare_keys(jt.key_vals, [tkey])
    matched, brow = jk._probe_n1(jt, h, live, prep)
    np.testing.assert_array_equal(matched.numpy(), want_m)
    np.testing.assert_array_equal(brow.numpy()[want_m], want_b[want_m])
    # the slot region alone: every match it finds is the reference's, and
    # any row it leaves that the reference matched is in the overflow region
    sm, sb = jk.join_probe_plain(jt.slots, h, live, jt.bits, prep)
    sm, sb = sm.numpy(), sb.numpy()
    assert (sm <= want_m).all() and (sb[sm] == want_b[sm]).all() and (sb[~sm] == -1).all()
    rest = want_m & ~sm
    assert np.isin(want_b[rest], jt.of_row.numpy()).all()
    assert sm.any() and (~want_m & rlive).any()
    # the port's tags and desired slots are the reference's
    t2, d2 = jk._tag_desired(h, rt.bits)
    np.testing.assert_array_equal(t2.numpy(), ptag.view(np.int32))
    np.testing.assert_array_equal(d2.numpy(), pdes)


# ---------------------------------------------------------------------------
# the join operators: the reference's property suite shapes
# ---------------------------------------------------------------------------


def _expand(mod, probe, bs, keys, kind):
    """mod.join_expand with the executor's retry on overflow."""
    cap = 1 << 10
    while True:
        out, ov = mod.join_expand(probe, bs, keys, ("w",), [("v", "bv")], cap, kind=kind)
        if int(ov) == 0:
            return out
        cap = 1 << (cap + int(ov) - 1).bit_length()


def _key_data(rng, dtype, n, domain, skew):
    if dtype == "bigint":
        k = rng.integers(0, domain, n).astype(np.int64) * 7919 - 1000
    elif dtype == "integer":
        k = rng.integers(0, domain, n).astype(np.int32)
    else:
        k = (rng.integers(0, domain, n) * 0.5).astype(np.float64)
    if skew:
        k = np.where(rng.random(n) < 0.7, k.flat[0], k)  # one key takes 70%
    return k


@pytest.mark.parametrize("dtype", ["bigint", "integer", "double"])
@pytest.mark.parametrize("nulls", [False, True])
@pytest.mark.parametrize("skew", [False, True])
def test_join_operators_match_reference(dtype, nulls, skew):
    rng = np.random.default_rng(sum(map(ord, dtype)) + 2 * nulls + skew)
    nb, np_ = (1200, 400) if skew else (300, 900)
    bk = _key_data(rng, dtype, nb, max(nb // 2, 2), skew)
    pk = _key_data(rng, dtype, np_, max(nb // 2, 2) + 5, False)
    rb, tb = _pages({"k": (bk, dtype, (rng.random(nb) > 0.2) if nulls else None, None),
                     "v": (np.arange(nb), "bigint", None, None)}, count=nb - 17)
    rpr, tpr = _pages({"k": (pk, dtype, (rng.random(np_) > 0.2) if nulls else None, None),
                       "w": (np.arange(np_), "bigint", None, None)}, count=np_ - 5)
    rkeys, tkeys = _keys(("k", dtype))
    rjt = rjoin.build(rb, rkeys)
    tjt = tjoin.build(tb, tkeys)
    assert isinstance(tjt, jk.JoinTable) and isinstance(rjt, rpj.JoinTable)
    assert (tjt.of_tag.numel() > 0) == skew
    tbs = tjoin.build_sorted(tb, tkeys)
    for kind in ("semi", "anti"):
        want = _rows(rjoin.join_n1(rpr, rjt, rkeys, (), (), kind=kind))
        assert _rows(tjoin.join_n1(tpr, tjt, tkeys, (), (), kind=kind)) == want, kind
        assert _rows(tjoin.join_n1(tpr, tbs, tkeys, (), (), kind=kind)) == want, kind
    # inner / left n1 pick THE match, so their build keys are unique
    uk = rng.permutation(np.unique(bk))
    ru, tu = _pages({"k": (uk, dtype, (rng.random(len(uk)) > 0.2) if nulls else None, None),
                     "v": (np.arange(len(uk)), "bigint", None, None)})
    for kind in ("inner", "left"):
        want = _rows(rjoin.join_n1(rpr, rjoin.build(ru, rkeys), rkeys, ("v",), ("v",), kind=kind))
        for bs in (tjoin.build(tu, tkeys), tjoin.build_sorted(tu, tkeys)):
            assert _rows(tjoin.join_n1(tpr, bs, tkeys, ("v",), ("v",), kind=kind)) == want, kind
    want_mask = np.asarray(rjoin.semi_match_mask(rpr, rjt, rkeys))
    assert (tjoin.semi_match_mask(tpr, tjt, tkeys).numpy() == want_mask).all()
    assert (tjoin.semi_match_mask(tpr, tbs, tkeys).numpy() == want_mask).all()
    for kind in ("inner", "left"):
        want = _rows(_expand(rjoin, rpr, rjt, rkeys, kind))
        for bs in (tjt, tbs):
            assert _rows(_expand(tjoin, tpr, bs, tkeys, kind)) == want, kind
    # a capacity too small reports the exact shortfall on the table path
    total = int(_expand(tjoin, tpr, tjt, tkeys, "inner").count)
    _, short = tjoin.join_expand(tpr, tjt, tkeys, ("w",), [("v", "bv")], 16)
    assert short == max(total - 16, 0)


def test_varchar_cross_dictionary_and_composite_keys():
    rng = np.random.default_rng(11)
    bd = tuple(f"s{i:03d}" for i in range(200))
    pd_ = tuple(sorted(f"s{i:03d}" for i in range(100, 260)))
    rb, tb = _pages({"k": (np.arange(200, dtype=np.int32), "varchar", None, bd),
                     "j": (np.arange(200) % 3, "bigint", None, None),
                     "v": (np.arange(200), "bigint", None, None)})
    rp, tp = _pages({"k": (rng.integers(0, len(pd_), 700).astype(np.int32), "varchar",
                           rng.random(700) > 0.1, pd_),
                     "j": (rng.integers(0, 3, 700), "bigint", None, None),
                     "w": (np.arange(700), "bigint", None, None)})
    for specs in ((("k", "varchar"),), (("k", "varchar"), ("j", "bigint"))):
        rkeys, tkeys = _keys(*specs)
        tjt = tjoin.build(tb, tkeys)
        assert isinstance(tjt, jk.JoinTable)
        want = _rows(rjoin.join_n1(rp, rjoin.build(rb, rkeys), rkeys, ("v",), ("bv",)))
        assert len(want) > 0
        assert _rows(tjoin.join_n1(tp, tjt, tkeys, ("v",), ("bv",))) == want
        assert _rows(tjoin.join_n1(tp, tjoin.build_sorted(tb, tkeys), tkeys, ("v",),
                                   ("bv",))) == want


def test_multiway_matches_reference_and_empty_sides():
    rng = np.random.default_rng(23)
    rf, tf = _pages({"k1": (rng.integers(0, 100, 2000), "bigint", None, None),
                     "k2": (rng.integers(-5, 60, 2000), "bigint", None, None),
                     "m": (np.arange(2000), "bigint", None, None)})
    r1, t1 = _pages({"a": (np.arange(100), "bigint", None, None),
                     "av": (np.arange(100) * 2, "bigint", None, None)})
    r2, t2 = _pages({"b": (np.arange(60), "bigint", None, None),
                     "bv": (np.arange(60) * 3, "bigint", None, None)})
    (ra,), (ta,) = _keys(("a", "bigint"))
    (rb_,), (tb_,) = _keys(("b", "bigint"))
    (rk1, rk2), (tk1, tk2) = _keys(("k1", "bigint"), ("k2", "bigint"))
    want = rpj.table_multiway_n1(rf, ((rpj.build_table(r1, (ra,)), (rk1,), ("av",), ("av",)),
                                      (rpj.build_table(r2, (rb_,)), (rk2,), ("bv",), ("bv",))))
    got = jk.table_multiway_n1(tf, ((jk.build_table(t1, (ta,)), (tk1,), ("av",), ("av",)),
                                    (jk.build_table(t2, (tb_,)), (tk2,), ("bv",), ("bv",))))
    assert _rows(got) == _rows(want) and int(got.count) > 0
    # an empty build and an empty probe
    _, e = _pages({"a": (np.zeros(8, np.int64), "bigint", None, None),
                   "av": (np.arange(8), "bigint", None, None)}, count=0)
    ejt = jk.build_table(e, (ta,))
    assert int(jk.table_join_n1(tf, ejt, (tk1,), ("av",), ("av",)).count) == 0
    assert int(jk.table_join_n1(tf, ejt, (tk1,), (), (), "anti").count) == 2000
    _, ep = _pages({"k1": (np.arange(16), "bigint", None, None)}, count=0)
    assert int(jk.table_join_n1(ep, jk.build_table(t1, (ta,)), (tk1,), ("av",),
                                ("av",)).count) == 0


# ---------------------------------------------------------------------------
# dynamic filters
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["inlist", "bloom", "empty", "varchar", "double_nan"])
def test_derive_filter_matches_reference(case):
    rng = np.random.default_rng(sum(map(ord, case)))
    n, m = 20_000, 30_000
    dic = None
    if case == "inlist":
        b, p, typ = rng.integers(0, 300, n) * 11, rng.integers(0, 4000, m), "bigint"
    elif case in ("bloom", "empty"):
        b, p, typ = rng.integers(0, 10 ** 9, n), rng.integers(0, 10 ** 9, m), "bigint"
        p[:5000] = b[:5000]
    elif case == "varchar":
        dic = tuple(f"v{i:04d}" for i in range(900))
        b = rng.integers(0, 300, n).astype(np.int32)
        p, typ = rng.integers(0, 900, m).astype(np.int32), "varchar"
    else:
        b = np.where(rng.random(n) < 0.1, np.nan, rng.integers(0, 500, n) * 0.25)
        p, typ = rng.integers(-20, 700, m) * 0.25, "double"
    bvalid = rng.random(n) > 0.1
    count = 0 if case == "empty" else n - 3
    rb, tb = _pages({"k": (b, typ, bvalid, dic)}, count=count)
    rp, tp = _pages({"k": (p, typ, rng.random(m) > 0.05, dic)})
    want = r_derive(rb.block("k"), rb.live_mask())
    got = derive_filter(tb.block("k"), tb.live_mask())
    assert got.strategy == want.strategy and got.describe() == want.describe()
    if want.bloom_words is not None:
        np.testing.assert_array_equal(got.bloom_words.numpy(), np.asarray(want.bloom_words))
    mask = got.mask(tp.block("k")).numpy()
    np.testing.assert_array_equal(mask, np.asarray(want.mask(rp.block("k"))))
    # no false negatives: every probe row whose key is a live build key
    bl = b[:count][bvalid[:count]]
    pv = tp.block("k").valid.numpy()
    member = np.isin(p, bl[~np.isnan(bl)] if typ == "double" else bl) & pv
    assert mask[member].all() and (case == "empty" or member.any())


# ---------------------------------------------------------------------------
# the hash-slot group-by
# ---------------------------------------------------------------------------


def _groupby_case(name):
    rng = np.random.default_rng(sum(map(ord, name)))
    n = 3000
    if name == "nulls":
        cols = {"k": ((rng.integers(0, 300, n) * 104729 - 7), "bigint", rng.random(n) > 0.1,
                      None),
                "v": (rng.integers(-(10 ** 9), 10 ** 9, n), "bigint", rng.random(n) > 0.15, None),
                "f": (rng.normal(size=n) * 1e3, "double", None, None)}
        keys = (("k", "bigint"),)
        aggs = [("count_star", None), ("count", "v"), ("sum", "v"), ("avg", "f"), ("min", "v"),
                ("max", "v")]
    elif name == "composite_nan":
        cols = {"a": (np.where(rng.random(n) < 0.1, np.nan, rng.integers(0, 20, n) * 1.0),
                      "double", None, None),
                "b": (rng.integers(0, 7, n), "bigint", None, None),
                "v": (rng.integers(0, 1000, n), "bigint", None, None)}
        keys = (("a", "double"), ("b", "bigint"))
        aggs = [("sum", "v"), ("count_star", None)]
    else:  # kernel: int32-safe min/max, decimal sums, a varchar key
        d = tuple(f"c{i:03d}" for i in range(10))  # 40 groups x 11 channels
        cols = {"g": (rng.integers(0, 10, n).astype(np.int32), "varchar", None, d),
                "h": (rng.integers(0, 3, n), "bigint", rng.random(n) > 0.1, None),
                "q": (rng.integers(0, 10 ** 7, n), "decimal(12,2)", None, None),
                "i": (rng.integers(-(10 ** 6), 10 ** 6, n).astype(np.int32), "integer",
                      rng.random(n) > 0.2, None),
                "f": (rng.normal(size=n) * 1e3, "double", None, None)}
        keys = (("g", "varchar"), ("h", "bigint"))
        aggs = [("sum", "q"), ("avg", "q"), ("min", "i"), ("max", "i"), ("count", "i"),
                ("sum", "f"), ("count_star", None)]
    rp, tp = _pages(cols, count=n - 11)
    rkeys, tkeys = _keys(*keys)
    raggs, taggs = [], []
    for i, (func, src) in enumerate(aggs):
        typ = None if src is None else cols[src][1]
        rt, tt = (None, None) if typ is None else (RT.parse_type(typ), T.parse_type(typ))
        raggs.append(RAggSpec(func, None if src is None else rcol(src, rt), f"a{i}",
                              RAggSpec.infer_output_type(func, rt)))
        taggs.append(AggSpec(func, None if src is None else col(src, tt), f"a{i}",
                             AggSpec.infer_output_type(func, tt)))
    names = tuple(k for k, _ in keys)
    return rp, tp, rkeys, tkeys, names, tuple(raggs), tuple(taggs)


def _close_rows(got, want, rel):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for x, y in zip(g, w):
            if isinstance(y, float) and y == y:
                assert abs(x - y) <= rel, (x, y)
            elif isinstance(y, float):
                assert x != x
            else:
                assert x == y


@pytest.mark.parametrize("name", ["nulls", "composite_nan", "kernel"])
def test_hash_groupby_host_mode_matches_reference(name):
    rp, tp, rkeys, tkeys, names, raggs, taggs = _groupby_case(name)
    hits = gk.hash_hits
    got = gk.maybe_grouped_aggregate_hash(tp, tkeys, names, taggs, None)
    assert got is not None and gk.hash_hits == hits + 1
    want = r_hash_groupby(rp, rkeys, names, raggs, None)
    assert want is not None
    _close_rows(_rows(got), _rows(want), 1e-9 * 1e6)


@pytest.fixture
def reference_kernel_mode(monkeypatch):
    """The reference hash-slot group-by through its Pallas kernel
    (interpret mode) with the `disable_x64` this JAX release lacks."""
    monkeypatch.setattr(jax.experimental, "disable_x64", lambda: jax.enable_x64(False),
                        raising=False)
    monkeypatch.setenv("PRESTO_TPU_PALLAS_GROUPBY_HASH", "interp")


def test_hash_groupby_kernel_mode_matches_reference_kernel(reference_kernel_mode):
    rp, tp, rkeys, tkeys, names, raggs, taggs = _groupby_case("kernel")
    got = gk.maybe_grouped_aggregate_hash(tp, tkeys, names, taggs, None, mode="kernel")
    want = r_hash_groupby(rp, rkeys, names, raggs, None)
    assert got is not None and want is not None
    mag = float(np.abs(tp.block("f").data.numpy()).sum())
    _close_rows(_rows(got), _rows(want), mag * 1e-6)
    # the kernel mode's gates are the reference kernel's: 64-bit min/max and
    # a (G, channels) tile past rows_pad 1024 both decline
    rp2, tp2, rk2, tk2, names2, raggs2, taggs2 = _groupby_case("nulls")
    assert gk.maybe_grouped_aggregate_hash(tp2, tk2, names2, taggs2, None, mode="kernel") is None
    assert r_hash_groupby(rp2, rk2, names2, raggs2, None) is None
    wide = taggs2[:3] * 4  # 12 count channels + 4 x 3 sum limbs for ~300 groups
    assert gk.maybe_grouped_aggregate_hash(tp2, tk2, names2, wide, None, mode="kernel") is None
    assert gk.maybe_grouped_aggregate_hash(tp2, tk2, names2, wide, None, mode="host") is not None
