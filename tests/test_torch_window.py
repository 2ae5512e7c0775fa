"""Window functions: presto_tpu_torch against presto_tpu.

* The SQL cases of tests/test_window.py and tests/test_window_frames.py
  (SF 0.002), through presto_tpu_torch.Session (device="cpu") and
  presto_tpu.Session, each on the packed-key path (ops/keypack.py, where
  the executor plans one) and on the legacy path (packing turned off by a
  monkeypatch of the port's `keypack_enabled`).
* `window_op` itself on a seeded numpy page with NULL partition keys,
  NULL and tied order keys and NULL inputs, for every function family
  (ranking, offset, value, aggregate) and frame kind (ROWS and RANGE with
  every bound kind, the default frame, the whole partition, the running
  frame), against the reference's `window_op` on the same page. Both sort
  stably by the same keys, so even the functions that depend on the order
  of tied rows agree row for row.

Integers, decimals and NULLs compare exactly, doubles within the oracle's
tolerance (chip_smoke.row_diff).
"""

import numpy as np
import pytest
import torch

import chip_smoke
from presto_tpu import page as rpage
from presto_tpu import types as RT
from presto_tpu.connectors.tpch import TpchCatalog as RCatalog
from presto_tpu.expr import ir as rir
from presto_tpu.ops import sort as rsort
from presto_tpu.ops import window as rwin
from presto_tpu.session import Session as RSession
from presto_tpu_torch import types as T
from presto_tpu_torch.connectors.tpch import TpchCatalog
from presto_tpu_torch.expr import ir
from presto_tpu_torch.ops import keypack
from presto_tpu_torch.ops import sort as psort
from presto_tpu_torch.ops import window as pwin
from presto_tpu_torch.page import page_from_reference
from presto_tpu_torch.session import Session

# one torch thread: the suite runs in parallel worker processes
# (pytest-xdist), and a thread per core in each oversubscribes the host
torch.set_num_threads(1)

SF = 0.002

SQL = {
    # tests/test_window.py
    "ranking": """
        select o_custkey, o_orderkey,
               row_number() over (partition by o_custkey order by o_orderdate, o_orderkey) as rn,
               rank() over (partition by o_custkey order by o_orderdate) as rk,
               dense_rank() over (partition by o_custkey order by o_orderdate) as drk
        from orders where o_custkey < 50""",
    "partition_aggregate": """
        select o_orderkey, o_custkey,
               sum(o_totalprice) over (partition by o_custkey) as tot,
               count(*) over (partition by o_custkey) as cnt,
               min(o_totalprice) over (partition by o_custkey) as mn,
               max(o_totalprice) over (partition by o_custkey) as mx
        from orders where o_custkey < 100""",
    "running_sum": """
        select o_orderkey,
               sum(o_totalprice) over (partition by o_custkey order by o_orderkey) as running
        from orders where o_custkey < 100""",
    "running_min_max": """
        select o_orderkey,
               min(o_totalprice) over (partition by o_custkey order by o_orderkey) as rmn,
               max(o_totalprice) over (partition by o_custkey order by o_orderkey) as rmx
        from orders where o_custkey < 100""",
    "lag_lead": """
        select o_orderkey,
               lag(o_orderkey) over (partition by o_custkey order by o_orderkey) as prev_k,
               lead(o_orderkey, 2) over (partition by o_custkey order by o_orderkey) as next2
        from orders where o_custkey < 100""",
    "first_value": """
        select o_orderkey,
               first_value(o_orderdate) over (partition by o_custkey
                                              order by o_orderkey) as first_d
        from orders where o_custkey < 100""",
    "ntile_global_window": """
        select o_orderkey, ntile(4) over (order by o_orderkey) as q
        from orders where o_custkey < 40""",
    "rank_no_partition": "select s_suppkey, rank() over (order by s_nationkey) as rk from supplier",
    # tests/test_window_frames.py
    "rows_sliding_sum_avg_count": """
        select o_orderkey,
               sum(o_totalprice) over (partition by o_custkey order by o_orderkey
                   rows between 2 preceding and 1 following) as s,
               count(*) over (partition by o_custkey order by o_orderkey
                   rows between 2 preceding and 1 following) as c,
               avg(o_totalprice) over (partition by o_custkey order by o_orderkey
                   rows between 2 preceding and current row) as a
        from orders where o_custkey < 120""",
    "rows_min_max_sliding": """
        select o_orderkey,
               min(o_totalprice) over (order by o_orderkey
                   rows between 3 preceding and 3 following) as mn,
               max(o_totalprice) over (order by o_orderkey
                   rows between 3 preceding and 3 following) as mx
        from orders where o_custkey < 120""",
    "rows_unbounded_following": """
        select o_orderkey,
               sum(o_totalprice) over (partition by o_custkey order by o_orderkey
                   rows between current row and unbounded following) as tail
        from orders where o_custkey < 120""",
    "rows_empty_frame_is_null": """
        select o_orderkey,
               sum(o_totalprice) over (partition by o_custkey order by o_orderkey
                   rows between 3 following and 2 following) as s
        from orders where o_custkey < 60""",
    "range_value_offsets": """
        select o_orderkey,
               count(*) over (order by o_orderkey
                   range between 100 preceding and 100 following) as near,
               sum(o_totalprice) over (order by o_orderkey
                   range between 1000 preceding and current row) as s
        from orders where o_custkey < 120""",
    "range_default_frame_peers": """
        select o_custkey,
               sum(o_totalprice) over (partition by o_custkey order by o_orderdate) as s
        from orders where o_custkey < 200""",
    "first_last_nth_value_frames": """
        select o_orderkey,
               first_value(o_totalprice) over (partition by o_custkey
                   order by o_orderkey) as fv,
               last_value(o_totalprice) over (partition by o_custkey order by o_orderkey
                   rows between unbounded preceding and unbounded following) as lv,
               nth_value(o_totalprice, 2) over (partition by o_custkey order by o_orderkey
                   rows between unbounded preceding and unbounded following) as nv
        from orders where o_custkey < 120""",
    "lag_lead_default": """
        select o_orderkey,
               lag(o_totalprice, 1, 0) over (partition by o_custkey
                   order by o_orderkey) as lg,
               lead(o_totalprice, 2, -1) over (partition by o_custkey
                   order by o_orderkey) as ld
        from orders where o_custkey < 120""",
    "right_outer_join": """
        select c_custkey, c_name, o_orderkey
        from orders right outer join customer on o_custkey = c_custkey
        where c_custkey < 200
        order by c_custkey, o_orderkey""",
    "full_outer_join": """
        select a.c_custkey as k1, b.c_custkey as k2
        from (select c_custkey from customer where c_custkey < 100) a
        full outer join
             (select c_custkey from customer where c_custkey >= 50
              and c_custkey < 150) b
        on a.c_custkey = b.c_custkey
        order by k1, k2""",
    "left_join_with_residual": """
        select c_custkey, o_orderkey
        from customer left join orders
          on c_custkey = o_custkey and o_totalprice > 150000
        where c_custkey < 150
        order by c_custkey, o_orderkey""",
    "full_join_with_residual": """
        select c_custkey, o_orderkey
        from customer full outer join orders
          on c_custkey = o_custkey and o_totalprice > 150000
        where c_custkey < 100 or c_custkey is null
        order by c_custkey, o_orderkey""",
}

_REF_ROWS = {}


def _ref(catalog):
    """presto_tpu's session without plan and result caches, and without its
    dynamic filters: they only prune rows, and off they halve the kernels
    its jit compiles for a join query."""
    sess = RSession(catalog, plan_cache=False, result_cache=False)
    sess.executor.dynamic_filtering = False
    return sess


@pytest.fixture(scope="module")
def sessions():
    return (
        Session(TpchCatalog(SF, device="cpu"), device="cpu", result_cache=False),
        _ref(RCatalog(SF)),
    )


@pytest.mark.parametrize("path", ["packed", "legacy"])
@pytest.mark.parametrize("name", list(SQL))
def test_window_sql_equals_reference(name, path, sessions, monkeypatch):
    port, ref = sessions
    if name not in _REF_ROWS:
        _REF_ROWS[name] = ref.query(SQL[name]).rows()
    calls = {"packed": 0, "legacy": 0}
    packed_op, legacy_op = pwin.window_op_packed, pwin.window_op

    def spy_packed(*a, **k):
        calls["packed"] += 1
        return packed_op(*a, **k)

    def spy_legacy(*a, **k):
        calls["legacy"] += 1
        return legacy_op(*a, **k)

    monkeypatch.setattr(pwin, "window_op_packed", spy_packed)
    monkeypatch.setattr(pwin, "window_op", spy_legacy)
    if path == "legacy":
        monkeypatch.setattr(keypack, "keypack_enabled", lambda: False)
    got = port.query(SQL[name]).rows()
    ordered = "order by c_custkey" in SQL[name] or "order by k1" in SQL[name]
    diff = chip_smoke.row_diff(got, _REF_ROWS[name], ordered=ordered)
    assert diff is None, diff
    assert len(got) > 0
    if "join" in name:
        return
    # one call per window spec (Window node); every spec of these texts
    # packs into one lane
    if path == "legacy":
        assert calls["packed"] == 0 and calls["legacy"] >= 1
    else:
        assert calls["packed"] >= 1 and calls["legacy"] == 0


def test_range_miss_reruns_legacy_window(sessions, monkeypatch):
    """A packed key whose runtime range check fails (`ok` False: the
    sampled CBO bounds missed) makes the executor rerun window_op."""
    import torch

    port, _ = sessions
    name = "ranking"
    if name not in _REF_ROWS:
        _REF_ROWS[name] = sessions[1].query(SQL[name]).rows()
    calls = []
    pack, legacy_op = keypack.pack_keys, pwin.window_op

    def missed(vals, plan, live):
        lanes, _ok = pack(vals, plan, live)
        return lanes, torch.tensor(False)

    def spy_legacy(*a, **k):
        calls.append("legacy")
        return legacy_op(*a, **k)

    monkeypatch.setattr(pwin, "pack_keys", missed)
    monkeypatch.setattr(pwin, "window_op", spy_legacy)
    got = port.query(SQL[name]).rows()
    assert chip_smoke.row_diff(got, _REF_ROWS[name], ordered=False) is None
    assert calls == ["legacy", "legacy"]  # both window specs of the text


# -- window_op on a seeded page ----------------------------------------------

N_ROWS = 300
CAPACITY = 384  # dead rows past the live ones


def _seeded_columns():
    rng = np.random.default_rng(20261017)
    n = N_ROWS
    return {
        # partition key: 5 values and NULL
        "p": (rng.integers(0, 5, n), rng.random(n) > 0.1, "bigint"),
        # order key with many ties and NULLs
        "o": (rng.integers(0, 12, n), rng.random(n) > 0.15, "bigint"),
        # a unique tie-break
        "u": (rng.permutation(n), np.ones(n, bool), "bigint"),
        "x": (np.round(rng.normal(0.0, 100.0, n), 3), rng.random(n) > 0.2, "double"),
        "d": (rng.integers(-10**6, 10**6, n), rng.random(n) > 0.2, "decimal(12,2)"),
    }


def _pages():
    cols = _seeded_columns()
    blocks = {}
    for name, (data, valid, typ) in cols.items():
        rt = RT.parse_type(typ)
        data = np.asarray(data, np.float64 if typ == "double" else np.int64)
        blocks[name] = rpage.Block.from_numpy(data, rt, valid)
    ref = rpage.Page.from_dict(blocks, pad_to=CAPACITY)
    return ref, page_from_reference(ref, device="cpu")


def _types(typ):
    return RT.parse_type(typ), T.parse_type(typ)


def _cases():
    """(label, partition columns, order keys [(col, asc, nulls_first)],
    funcs [(func, input col or None, output type, kwargs)])."""
    rows_frames = [
        ("rows", "unbounded_preceding", 0, "current", 0),
        ("rows", "preceding", 2, "following", 1),
        ("rows", "current", 0, "unbounded_following", 0),
        ("rows", "following", 1, "following", 3),
        ("rows", "preceding", 3, "preceding", 1),
        ("rows", "following", 3, "following", 2),  # empty frames
    ]
    range_frames = [
        ("range", "unbounded_preceding", 0, "current", 0),
        ("range", "current", 0, "unbounded_following", 0),
        ("range", "preceding", 2, "following", 1),
        ("range", "current", 0, "following", 3),
        ("range", "preceding", 4, "current", 0),
    ]
    ranking = [(f, None, "bigint", {}) for f in ("row_number", "rank", "dense_rank")]
    ranking += [("ntile", None, "bigint", {"offset": 4}),
                ("percent_rank", None, "double", {}), ("cume_dist", None, "double", {})]
    offsets = [("lag", "x", "double", {}), ("lead", "d", "decimal(12,2)", {"offset": 2}),
               ("lag", "o", "bigint", {"offset": 3, "default": 7}),
               ("lead", "x", "double", {"default": -1.5})]

    def framed(frames):
        """Every other aggregate and value function over each frame, the
        two halves alternating from frame to frame."""
        funcs = (("sum", "x", "double"), ("avg", "x", "double"),
                 ("min", "x", "double"), ("max", "d", "decimal(12,2)"),
                 ("count", "x", "bigint"), ("count", None, "bigint"),
                 ("sum", "d", "decimal(38,2)"), ("avg", "d", "decimal(12,2)"),
                 ("first_value", "x", "double"), ("last_value", "d", "decimal(12,2)"),
                 ("nth_value", "x", "double"), ("min", "d", "decimal(12,2)"))
        out = []
        for j, fr in enumerate(frames):
            for func, col, typ in funcs[j % 2::2]:
                kw = {"frame": fr}
                if func == "nth_value":
                    kw["offset"] = 2
                out.append((func, col, typ, kw))
        return out

    whole = [(f, c, t, {}) for f, c, t in (
        ("sum", "x", "double"), ("avg", "d", "decimal(12,2)"), ("min", "d", "decimal(12,2)"),
        ("max", "x", "double"), ("count", None, "bigint"), ("first_value", "x", "double"),
        ("last_value", "o", "bigint"), ("nth_value", "d", "decimal(12,2)"))]
    running = [(f, c, t, {"running": True}) for f, c, t in (
        ("sum", "x", "double"), ("sum", "d", "decimal(38,2)"), ("avg", "x", "double"),
        ("min", "x", "double"), ("max", "d", "decimal(12,2)"), ("count", "x", "bigint"))]
    return [
        ("one_order_key", ["p"], [("o", True, None)],
         ranking + offsets + framed(rows_frames[:4] + range_frames) + [
             ("sum", "x", "double", {}), ("min", "x", "double", {}),
             ("first_value", "d", "decimal(12,2)", {})]),
        ("descending_key", ["p"], [("o", False, None)],
         ranking + framed(range_frames[1:] + range_frames[:1])),
        ("two_order_keys", ["p"], [("o", False, True), ("u", True, None)],
         ranking + offsets + framed(rows_frames[2:] + rows_frames[:2])),
        ("no_partition", [], [("o", True, False)], ranking + framed(range_frames[2:3])),
        ("whole_partition", ["p", "o"], [], whole),
        ("running_no_order", ["p"], [], running),
    ]


def _specs(pkg, partition, order, funcs):
    ir_, sort_, win_, ty = (rir, rsort, rwin, 0) if pkg == "ref" else (ir, psort, pwin, 1)
    cols = {n: _types(t)[ty] for n, (_, _, t) in _seeded_columns().items()}
    parts = tuple(ir_.ColumnRef(c, cols[c]) for c in partition)
    keys = tuple(sort_.SortKey(ir_.ColumnRef(c, cols[c]), asc, nf) for c, asc, nf in order)
    out = []
    for i, (func, col, typ, kw) in enumerate(funcs):
        kw = dict(kw)
        if "frame" in kw:
            kw["frame"] = win_.Frame(*kw["frame"])
        if "default" in kw:
            kw["default"] = ir_.Literal(kw["default"], cols[col])
        inp = None if col is None else ir_.ColumnRef(col, cols[col])
        out.append(win_.WindowFunc(func, inp, f"w{i}", _types(typ)[ty], **kw))
    return parts, keys, tuple(out)


@pytest.mark.parametrize("case", [c[0] for c in _cases()])
def test_window_op_matches_reference_on_seeded_page(case):
    label, partition, order, funcs = next(c for c in _cases() if c[0] == case)
    ref_page, port_page = _pages()
    want = rwin.window_op(ref_page, *_specs("ref", partition, order, funcs)).to_pylist()
    got = pwin.window_op(port_page, *_specs("port", partition, order, funcs)).to_pylist()
    diff = chip_smoke.row_diff(got, want)
    assert diff is None, diff
    assert len(got) == N_ROWS
