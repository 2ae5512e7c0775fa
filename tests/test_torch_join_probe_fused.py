"""The fused join probe and the packed slot table of
presto_tpu_torch/ops/join_kernel.py on the CPU, against presto_tpu's join
(ops/pallas_join.py, host mode) and against a slot-by-slot scan written
here.

`join_probe` returns, for every live probe row, the first slot from its
desired slot (before the first vacant one) whose tag is the row's and
whose build row's keys equal the row's; on the CPU it runs
`join_probe_plain`. The cases cover each key kind the kernel compares
(int32, int64, float64 with -0.0 and NaN, two-lane long decimals,
varchar codes across two dictionaries), NULLs on either side and
composite keys. Also: the ctypes twins of csrc/join_insert.cu's and
csrc/join_probe.cu's parameter structs against their C layout, the key
capacity (every TPC-H join fits; more keys raise NotPortedError), the
packed slots and their strided views through `from_numpy` and
`_probe_all`, and the host work of `_probe_n1` and `build_table`.

Tolerances: none; every comparison is exact.
"""

import ctypes
import struct

import numpy as np
import pytest
import torch

from presto_tpu import types as RT
from presto_tpu.expr.ir import col as rcol
from presto_tpu.ops import pallas_join as rpj
from presto_tpu.page import Block as RBlock
from presto_tpu.page import Page as RPage
from presto_tpu_torch import types as T
from presto_tpu_torch.benchmark.tpch_sql import QUERIES
from presto_tpu_torch.connectors.tpch import TpchCatalog
from presto_tpu_torch.expr.functions import NotPortedError
from presto_tpu_torch.expr.ir import col
from presto_tpu_torch.ops import join_kernel as jk
from presto_tpu_torch.ops.hashing import hash_rows_values
from presto_tpu_torch.page import Block, Page
from presto_tpu_torch.plan import nodes as N
from presto_tpu_torch.session import Session

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


def _rows(page):
    """Rows as sorted reprs (NaN compares equal to itself by repr)."""
    return sorted(map(repr, page.to_pylist()))


# ---------------------------------------------------------------------------
# parameter structs: the ctypes twins against the C layout
# ---------------------------------------------------------------------------

# the structs under the C ABI of x86-64 and CUDA (natural alignment)
INSERT_LAYOUT = {"hash": (0, 8), "live": (8, 8), "slots": (16, 8), "overflow": (24, 8),
                 "n": (32, 8), "size": (40, 4), "bits": (44, 4)}
PROBE_LAYOUT = {"slots": (0, 8), "hash": (8, 8), "live": (16, 8), "matched": (24, 8),
                "brow": (32, 8), "m": (40, 8), "size": (48, 4), "bits": (52, 4),
                "num_keys": (56, 4), "key": (64, 40 * 8)}
KEY_LAYOUT = {"probe": (0, 8), "build": (8, 8), "probe_valid": (16, 8), "build_valid": (24, 8),
              "kind": (32, 4), "lanes": (36, 4)}


@pytest.mark.parametrize("struct_, layout, size", [
    (jk.InsertParams, INSERT_LAYOUT, 48), (jk.ProbeParams, PROBE_LAYOUT, 384),
    (jk.ProbeKey, KEY_LAYOUT, 40)])
def test_params_structs_match_the_c_layout(struct_, layout, size):
    assert ctypes.sizeof(struct_) == size <= 4096  # the kernel-parameter limit
    assert [f for f, _ in struct_._fields_] == list(layout)
    for name, (offset, width) in layout.items():
        field = getattr(struct_, name)
        assert (field.offset, field.size) == (offset, width), name
    # what chip_smoke.py compares with the card's build
    assert jk.ctypes_layout("join_insert") == [48] + [o for o, _ in INSERT_LAYOUT.values()]
    assert jk.ctypes_layout("join_probe") == (
        [384] + [o for o, _ in PROBE_LAYOUT.values()] + [40] + [o for o, _ in KEY_LAYOUT.values()])


def test_pack_probe_params_puts_each_key_where_c_reads_it():
    m, nb = 10, 6
    h = torch.arange(m, dtype=torch.int64)
    live = torch.ones(m, dtype=torch.bool)
    slots = torch.full((jk.table_size(4), 2), -1, dtype=torch.int32)
    matched, brow = torch.empty(m, dtype=torch.bool), torch.empty(m, dtype=torch.int32)
    prep = [(torch.zeros(m, dtype=torch.int32), torch.zeros(nb, dtype=torch.int64),
             torch.ones(m, dtype=torch.bool), None),
            (torch.zeros((m, 2), dtype=torch.int64), torch.zeros((nb, 2), dtype=torch.int64),
             None, torch.ones(nb, dtype=torch.bool)),
            (torch.zeros(m, dtype=torch.float64), torch.zeros(nb, dtype=torch.float64), None,
             None)]
    keys = jk._kernel_keys(prep)
    assert keys[0][0].dtype == keys[0][1].dtype == torch.int64  # promoted as `==` does
    p = jk.pack_probe_params(slots, h, live, matched, brow, 4, keys)
    raw = ctypes.string_at(ctypes.addressof(p), ctypes.sizeof(p))

    def at(off, fmt):
        return struct.unpack_from(fmt, raw, off)[0]

    assert [at(o, "<Q") for o in (0, 8, 16, 24, 32)] == [
        t.data_ptr() for t in (slots, h, live, matched, brow)]
    assert (at(40, "<q"), at(48, "<i"), at(52, "<i"), at(56, "<i")) == (
        m, jk.table_size(4), 4, 3)
    for k, (pd_, bd_, pv, bv) in enumerate(keys):
        base = 64 + 40 * k
        assert at(base, "<Q") == pd_.data_ptr() and at(base + 8, "<Q") == bd_.data_ptr()
        assert at(base + 16, "<Q") == (0 if pv is None else pv.data_ptr())
        assert at(base + 24, "<Q") == (0 if bv is None else bv.data_ptr())
    assert [(at(64 + 40 * k + 32, "<i"), at(64 + 40 * k + 36, "<i")) for k in range(3)] == [
        (jk.KEY_KINDS[torch.int64], 1), (jk.KEY_KINDS[torch.int64], 2),
        (jk.KEY_KINDS[torch.float64], 1)]
    assert all(at(64 + 40 * k, "<Q") == 0 for k in range(3, jk.MAX_KEYS))


# ---------------------------------------------------------------------------
# key kinds against the reference and against a slot-by-slot scan
# ---------------------------------------------------------------------------


def _case(name):
    """(build columns, probe columns, key (name, sql type) pairs)."""
    rng = np.random.default_rng(sum(map(ord, name)))
    nb, npr = 400, 900

    def ints(n, lo, hi, dtype):
        return rng.integers(lo, hi, n).astype(dtype)

    if name in ("int32", "int64", "nulls_probe", "nulls_build"):
        dt, typ = (np.int32, "integer") if name == "int32" else (np.int64, "bigint")
        bk = rng.permutation(nb).astype(dt) * 3 - 500
        pk = ints(npr, -600, 800, dt)
        bv = rng.random(nb) > 0.2 if name == "nulls_build" else None
        pv = rng.random(npr) > 0.2 if name == "nulls_probe" else None
        return ({"k": (bk, typ, bv, None)}, {"k": (pk, typ, pv, None)}, [("k", typ)])
    if name == "float64":
        bk = rng.permutation(nb) * 0.5 - 49.75  # unique, none of them 0
        bk[:3] = [-0.0, np.nan, np.inf]
        pk = rng.integers(-120, 250, npr) * 0.5 + 0.25
        pk[:6] = [0.0, -0.0, np.nan, np.nan, np.inf, -np.inf]
        return ({"k": (bk, "double", None, None)}, {"k": (pk, "double", None, None)},
                [("k", "double")])
    if name == "composite":
        a = rng.permutation(nb) // 4
        b = (np.arange(nb) % 4).astype(np.int32)
        pa, pb = ints(npr, 0, nb // 3, np.int64), ints(npr, 0, 5, np.int32)
        return ({"a": (a.astype(np.int64), "bigint", None, None),
                 "b": (b, "integer", rng.random(nb) > 0.1, None)},
                {"a": (pa, "bigint", rng.random(npr) > 0.1, None), "b": (pb, "integer", None, None)},
                [("a", "bigint"), ("b", "integer")])
    if name == "long_decimal":
        hi = rng.integers(-3, 3, nb)
        lo = rng.permutation(nb).astype(np.int64) * 1_000_003
        b = np.stack([hi, lo], 1)
        pick = rng.integers(0, nb, npr)
        p = b[pick].copy()
        p[::3, 0] += 1  # same low lane, another high lane: no match
        return ({"k": (b, "decimal(38,2)", rng.random(nb) > 0.1, None)},
                {"k": (p, "decimal(38,2)", None, None)}, [("k", "decimal(38,2)")])
    assert name == "varchar"
    bd = tuple(f"s{i:04d}" for i in range(nb))
    pd_ = tuple(sorted(f"s{i:04d}" for i in range(nb // 2, nb + 300)))
    return ({"k": (rng.permutation(nb).astype(np.int32), "varchar", None, bd)},
            {"k": (ints(npr, 0, len(pd_), np.int32), "varchar", rng.random(npr) > 0.1, pd_)},
            [("k", "varchar")])


KEY_CASES = ["int32", "int64", "float64", "nulls_probe", "nulls_build", "composite",
             "long_decimal", "varchar"]


def _scan(jt, h, live, prep):
    """The probe's function, one row and one slot at a time in numpy."""
    tag, desired = (t.numpy() for t in jk._tag_desired(h, jt.bits))
    st, sr = jt.slot_tag.numpy(), jt.slot_row.numpy()
    keys = [tuple(None if t is None else t.numpy() for t in k) for k in prep]
    matched = np.zeros(len(tag), bool)
    brow = np.full(len(tag), -1, np.int32)
    for i in np.flatnonzero(live.numpy()):
        s = desired[i]
        while st[s] != jk.EMPTY_TAG:
            r = sr[s]
            if st[s] == tag[i] and all(
                    np.all(pd_[i] == bd_[r]) and (pv is None or pv[i]) and (bv is None or bv[r])
                    for pd_, bd_, pv, bv in keys):
                matched[i], brow[i] = True, r
                break
            s += 1
    return matched, brow


@pytest.mark.parametrize("name", KEY_CASES)
def test_probe_key_kinds_match_reference_and_scan(name):
    bcols, pcols, keys = _case(name)
    bcols["v"] = (np.arange(len(next(iter(bcols.values()))[0])), "bigint", None, None)
    pcols["w"] = (np.arange(len(next(iter(pcols.values()))[0])), "bigint", None, None)
    rb, tb = _pages(bcols, count=len(bcols["v"][0]) - 7)
    rp, tp = _pages(pcols, count=len(pcols["w"][0]) - 5)
    rkeys = tuple(rcol(n, RT.parse_type(t)) for n, t in keys)
    tkeys = tuple(col(n, T.parse_type(t)) for n, t in keys)
    rjt, tjt = rpj.build_table(rb, rkeys), jk.build_table(tb, tkeys)
    assert tjt is not None and tjt.of_tag.numel() == 0
    # the probe's function, row by row
    h, prep = jk._probe_setup(tp, tjt, tkeys)
    live = tp.live_mask()
    matched, brow = jk.join_probe(tjt.slots, h, live, tjt.bits, prep)
    want_m, want_b = _scan(tjt, h, live, prep)
    np.testing.assert_array_equal(matched.numpy(), want_m)
    np.testing.assert_array_equal(brow.numpy(), want_b)
    assert 0 < int(matched.sum()) < int(live.sum())
    # the join results equal the reference's (unique build keys: inner too)
    for kind in ("inner", "semi", "anti"):
        out = ("v",) if kind == "inner" else ()
        want = _rows(rpj.table_join_n1(rp, rjt, rkeys, out, out, kind))
        assert _rows(jk.table_join_n1(tp, tjt, tkeys, out, out, kind)) == want, kind
    if name == "float64":  # -0.0 finds 0.0's row; NaN finds nothing
        got = dict(zip(tp.block("w").data[:6].tolist(), matched[:6].tolist()))
        assert got == {0: True, 1: True, 2: False, 3: False, 4: True, 5: False}


def test_probe_more_keys_than_the_kernel_carries_raises():
    """The probe kernel carries at most MAX_KEYS keys and raises past
    them; build_table leaves such a join to the sorted-hash layout."""
    n = jk.MAX_KEYS + 1
    cols = {f"k{i}": (np.arange(50) % (i + 2), "bigint", None, None) for i in range(n)}
    _, tp = _pages(cols)
    tkeys = tuple(col(f"k{i}", T.BIGINT) for i in range(n))
    assert jk.build_table(tp, tkeys) is None
    vals = [jk.evaluate(k, tp) for k in tkeys]
    with pytest.raises(NotPortedError, match="at most 8"):
        jk._kernel_keys(jk._prepare_keys(vals, vals))
    # exactly MAX_KEYS is taken
    assert int(jk.table_join_n1(tp, jk.build_table(tp, tkeys[:-1]), tkeys[:-1], (), (),
                                "semi").count) == 50


def test_every_tpch_join_fits_the_probe_kernel():
    sess = Session(TpchCatalog(0.01, device="cpu"), device="cpu")
    most = 0
    for q in sorted(QUERIES):
        stack = [sess.plan(QUERIES[q])]
        while stack:
            node = stack.pop()
            if isinstance(node, N.Join):
                most = max(most, len(node.left_keys))
            elif isinstance(node, N.SemiJoin):
                most = max(most, len(node.probe_keys))
            stack.extend(node.children)
    assert 2 <= most <= jk.MAX_KEYS


# ---------------------------------------------------------------------------
# the packed table: views, the reference's table carried across, host work
# ---------------------------------------------------------------------------


def test_packed_slots_through_from_numpy_and_probe_all():
    rng = np.random.default_rng(41)
    nb = 700
    bk = np.where(rng.random(nb) < 0.3, 42, rng.integers(0, 300, nb))  # dups and overflow
    rb, tb = _pages({"k": (bk.astype(np.int64), "bigint", rng.random(nb) > 0.05, None),
                     "v": (np.arange(nb), "bigint", None, None)})
    rp, tp = _pages({"k": (rng.integers(0, 320, 500).astype(np.int64), "bigint", None, None),
                     "w": (np.arange(500), "bigint", None, None)})
    (rk,), (tk,) = (rcol("k", RT.BIGINT),), (col("k", T.BIGINT),)
    rt = rpj.build_table(rb, (rk,))
    jt = jk.JoinTable.from_numpy(rt.slot_tag, rt.slot_row, rt.bits, rt.of_tag, rt.of_row, tb,
                                 (jk.evaluate(tk, tb),), (tk,), rt.count, "cpu")
    assert tuple(jt.slots.shape) == (jk.table_size(rt.bits), 2) and jt.slots.is_contiguous()
    for view, want in ((jt.slot_tag, rt.slot_tag.view(np.int32)), (jt.slot_row, rt.slot_row)):
        assert view.stride() == (2,) and view.untyped_storage().data_ptr() == \
            jt.slots.untyped_storage().data_ptr()
        np.testing.assert_array_equal(view.numpy(), want)
    assert jt.of_tag.numel() > 0
    # the all-matches scan over the strided views gives the reference's pairs
    h, prep = jk._probe_setup(tp, jt, (tk,))
    ptag, pdes = jk._tag_desired(h, jt.bits)
    pi, bi = jk._probe_all(jt, ptag, pdes, tp.live_mask(), prep)
    rh = rpj.np_hash_rows_values([rp.block("k")])
    rtag, rdes = rpj._tag_desired(rh, rt.bits)
    rpi, rbi = rpj._host_probe_all(rt, rtag, rdes, np.ones(500, bool),
                                   rpj._host_prepare_keys(rt, [rp.block("k")]))
    got = sorted(zip(pi.tolist(), bi.tolist()))
    assert got == sorted(zip(rpi.tolist(), rbi.tolist())) and len(got) > 500


def test_build_sorts_overflow_by_tag_then_row():
    rng = np.random.default_rng(43)
    n = 600
    k = np.where(rng.random(n) < 0.4, 7, rng.integers(100, 10_000, n))
    k[rng.random(n) < 0.1] = 9  # a second heavy key
    _, tb = _pages({"k": (k.astype(np.int64), "bigint", None, None)})
    jt = jk.build_table(tb, (col("k", T.BIGINT),))
    of = list(zip(jt.of_tag.tolist(), jt.of_row.tolist()))
    assert len(of) > 64 and of == sorted(of)
    assert set(jt.of_row.tolist()) <= set(np.flatnonzero(np.isin(k, (7, 9))).tolist())
    # the overflow pairs and the table keep the insert invariants
    h = hash_rows_values(jt.key_vals)
    over = torch.stack([jt.of_tag, jt.of_row], dim=1)
    assert jk.insert_invariant_errors(h, tb.live_mask(), jt.bits, jt.slots, over,
                                      torch.tensor(len(of) - 1)) == []


def test_probe_n1_and_build_host_work(monkeypatch):
    """Without an overflow region `_probe_n1` is one join_probe call and
    nothing else that reads the host; `build_table` is one join_insert
    call and no `nonzero`."""
    rng = np.random.default_rng(47)
    _, tb = _pages({"k": (rng.permutation(300).astype(np.int64), "bigint", None, None)})
    _, tp = _pages({"k": (rng.integers(0, 600, 800).astype(np.int64), "bigint", None, None)})
    key = (col("k", T.BIGINT),)
    calls = {"insert": 0, "probe": 0, "nonzero": 0}
    orig_insert, orig_nonzero = jk.join_insert, torch.nonzero

    def count(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    def insert(*a):
        calls["insert"] += 1
        before = calls["nonzero"]
        out = orig_insert(*a)
        calls["nonzero"] = before  # the plain version's own rounds; the kernel has none
        return out

    monkeypatch.setattr(jk, "join_insert", insert)
    monkeypatch.setattr(torch, "nonzero", count("nonzero", orig_nonzero))
    jt = jk.build_table(tb, key)
    assert calls == {"insert": 1, "probe": 0, "nonzero": 0} and jt.of_tag.numel() == 0
    # the probe's result made beforehand (the plain version's own rounds
    # read the host; on the card the kernel does not)
    h, prep = jk._probe_setup(tp, jt, key)
    live = tp.live_mask()
    result = jk.join_probe(jt.slots, h, live, jt.bits, prep)
    monkeypatch.setattr(jk, "join_probe", count("probe", lambda *a: result))
    monkeypatch.setattr(jk, "_probe_overflow", None)  # never reached without overflow
    calls["nonzero"] = 0
    matched, brow = jk._probe_n1(jt, h, live, prep)
    assert calls == {"insert": 1, "probe": 1, "nonzero": 0}
    want = np.isin(tp.block("k").data.numpy(), tb.block("k").data.numpy())
    np.testing.assert_array_equal(matched.numpy(), want)
    assert (tb.block("k").data.numpy()[brow.numpy()[want]] == tp.block("k").data.numpy()[want]).all()
