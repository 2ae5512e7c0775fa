"""On-card smoke run of presto_tpu_torch, the PyTorch/CUDA port.

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py [--profile [--profile-dir DIR]]

Phase 1 builds every CUDA kernel of the package from csrc/ (nvcc, sm_90a),
one nvcc per source, all started together.
Phase 3 (run before phase 2) drives the main paths at SF 1, each with every
kernel's launch count set to 0 just before it and read just after:
through `Session(TpchCatalog(1.0), device="cuda").query(...)`, TPC-H Q1
and Q6, then the join queries Q3, Q5, Q17 and Q18, each cold then twice
warm; then the benchmark path on data generated on the card
(`DeviceTpchCatalog(1.0)`): the hand-coded pipelines q1_local,
q1_local_kernel and q6_local three times each, SQL Q1/Q6, the
north-star Q3/Q5/Q17/Q18 over the device catalog (Q18 selects no order
there), Q18 with a HAVING threshold the generator reaches and the
Q18-shaped customer rollup (both must return rows), and the benchmark
entry point `benchmark.bench.run(1.0, "cuda")`, whose JSON line it prints.
Rows are checked against independent numpy computations over the same
generated columns (exact integer arithmetic; the device-generated data
through its host twin), and the script checks that Q1 launched the
group-by kernel, that join_insert launched on each join query and
join_probe on Q3, Q17 and Q18 (on both catalogs; on the device catalog
the reached Q18 in its place), and that q1_local_kernel, and only it,
launched the fused-Q1 kernel.
Phase 2 holds each kernel against its plain PyTorch version on the card:
the group-by kernel at Q1's shapes, two wider cases and Q18's hash-slot
call; join_insert and join_probe at the largest calls the join queries
make (captured in one more run of them), at the top of the table path's
range (4,194,304 build rows, 6,000,859 probe rows), with a skewed key and
with a varchar key; the fused-Q1 kernel on the SF 1 page, on SF 10's
60,000,000 rows generated on the card, with a count below capacity and a
cutoff that empties groups, and on a case whose sum of charge passes 2^63
(also held to exact Python-int totals). It times the kernel, the plain
version, one PyTorch library call where one computes the same function,
and the byte bound.
It prints the card's name and power limit, a `{"kernels": [...]}` JSON
line, and last `{"ok": true, "device": {...}}`. Any failed phase exits
nonzero. With --profile it also traces one warm Q1, Q6, Q3 and Q18 and
one warm run of each hand-coded pipeline with torch.profiler (device busy
time, idle share, host syncs, our kernels' device time, top ops; full
tables under DIR, by default profile_out/).
"""

import datetime
import json
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device-memory rate (NVIDIA data sheet)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, iters=20, warmup=3):
    """Mean device time of fn() in ms, CUDA events around `iters` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# -- phase 2: kernel against plain version ---------------------------------


def kernel_case(name, call, tol_fn):
    """Compare groupby_totals (kernel) with groupby_totals_plain on one
    call's inputs; returns a result dict."""
    import torch

    from presto_tpu_torch.ops import groupby_kernel as gk

    gid, live, count, chans, kinds, sources, G = call
    got = gk.groupby_totals(*call)
    want = gk.groupby_totals_plain(*call)
    torch.cuda.synchronize()
    err = (got.to(torch.float64) - want.to(torch.float64)).abs()
    max_err = float(err.max()) if err.numel() else 0.0
    tol = tol_fn(call)
    if not bool((err <= tol).all()):
        raise AssertionError(f"{name}: kernel disagrees with plain version, max err {max_err}")
    ms = cuda_ms(lambda: gk.groupby_totals(*call))
    plain_ms = cuda_ms(lambda: gk.groupby_totals_plain(*call), iters=5)
    # library yardstick: ONE index_add_ of the ADD channels into G+1 slots
    n = gid.shape[0]
    sel = live & (torch.arange(n, device=gid.device) < count)
    g = torch.where(sel, gid.to(torch.int64), G)
    add_rows = [s for k, s in zip(kinds, sources) if k == gk.ADD]
    library_ms = None
    if chans is not None and add_rows:
        src = chans[add_rows].contiguous()
        acc = torch.zeros((src.shape[0], G + 1), dtype=src.dtype, device=src.device)
        library_ms = cuda_ms(lambda: acc.zero_().index_add_(1, g, src))
    # least bytes: gid + live for every row, each data channel for the rows
    # this data selects, the (G, K) totals written once
    rows_used = int(sel.sum())
    d = 0 if chans is None else chans.shape[0]
    nbytes = n * (4 + 1) + 4 + rows_used * 8 * d + G * len(kinds) * 8
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    res = {
        "case": name, "n": n, "G": G, "K": len(kinds), "D": d, "dtype": str(got.dtype),
        "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
        "library_ms": library_ms, "bound_ms": bound_ms, "bytes": nbytes,
    }
    print("phase2", json.dumps(res), flush=True)
    return res


def phase2(q1_call):
    import numpy as np
    import torch

    from presto_tpu_torch.ops import groupby_kernel as gk

    exact = lambda call: 0.0  # noqa: E731 — integer totals are exact
    results = [kernel_case("q1_sf1", q1_call, exact)]
    rng = np.random.default_rng(7)
    n = 6_000_859
    dev = torch.device("cuda")
    # G = 64: int64 sum/min/max, a NULL key group (gid 63 = the null slot)
    gid = torch.from_numpy(rng.integers(0, 64, n).astype(np.int32)).to(dev)
    live = torch.from_numpy(rng.random(n) < 0.9).to(dev)
    vals = torch.from_numpy(rng.integers(-(1 << 40), 1 << 40, (3, n))).to(dev)
    count = torch.tensor([n - 1000], dtype=torch.int32, device=dev)
    call = (gid, live, count, vals.contiguous(), [gk.COUNT, gk.ADD, gk.MIN, gk.MAX],
            [-1, 0, 1, 2], 64)
    results.append(kernel_case("g64_int64_sum_min_max", call, exact))
    # float64 sums: shared-memory atomics add in no fixed order, so the
    # totals may differ from a sequential sum by rounding: 1e-12 * sum|x|
    fx = torch.from_numpy(rng.normal(0.0, 1e3, (2, n))).to(dev)
    fcall = (gid, live, count, fx.contiguous(), [gk.ADD, gk.ADD], [0, 1], 64)

    def f_tol(c):
        mag = gk.groupby_totals_plain(c[0], c[1], c[2], c[3].abs(), c[4], c[5], c[6])
        return 1e-12 * mag + 1e-9

    results.append(kernel_case("g64_f64_sum", fcall, f_tol))
    return results


# -- phase 3: Q1 and Q6 at SF 1 --------------------------------------------


def _days(y, m, d):
    return (datetime.date(y, m, d) - datetime.date(1970, 1, 1)).days


def numpy_q1(li):
    """TPC-H Q1 over the generated columns in exact integer arithmetic."""
    from decimal import Decimal

    import numpy as np

    c = li.columns
    ship = c["l_shipdate"].data
    keep = ship <= _days(1998, 12, 1) - 90
    rf, ls = c["l_returnflag"].data[keep], c["l_linestatus"].data[keep]
    qty = c["l_quantity"].data[keep]
    price = c["l_extendedprice"].data[keep]
    disc = c["l_discount"].data[keep]
    tax = c["l_tax"].data[keep]
    disc_price = price * (100 - disc)
    charge = disc_price * (100 + tax)
    rows = []
    rfd, lsd = c["l_returnflag"].dictionary, c["l_linestatus"].dictionary
    for r in range(len(rfd)):
        for s in range(len(lsd)):
            m = (rf == r) & (ls == s)
            cnt = int(m.sum())
            if not cnt:
                continue
            sq, sp = int(qty[m].sum()), int(price[m].sum())
            sd = int(disc[m].sum())

            def avg(total, scale):
                return Decimal((2 * total + cnt) // (2 * cnt)).scaleb(-scale)

            rows.append((
                rfd[r], lsd[s], Decimal(sq).scaleb(-2), Decimal(sp).scaleb(-2),
                Decimal(int(disc_price[m].sum())).scaleb(-4),
                Decimal(int(charge[m].sum())).scaleb(-6),
                avg(sq, 2), avg(sp, 2), avg(sd, 2), cnt,
            ))
    rows.sort(key=lambda t: (t[0], t[1]))
    assert np.all(qty >= 0)
    return rows


def numpy_q6(li):
    from decimal import Decimal

    c = li.columns
    ship = c["l_shipdate"].data
    disc = c["l_discount"].data
    m = (
        (ship >= _days(1994, 1, 1)) & (ship < _days(1995, 1, 1))
        & (disc >= 5) & (disc <= 7) & (c["l_quantity"].data < 2400)
    )
    return [(Decimal(int((c["l_extendedprice"].data[m] * disc[m]).sum())).scaleb(-4),)]


def q1_kernel_call(sess, cat):
    """The groupby_totals call Q1's Aggregate makes at SF 1."""
    from presto_tpu_torch.benchmark.tpch_sql import QUERIES
    from presto_tpu_torch.ops import groupby_kernel as gk
    from presto_tpu_torch.plan import nodes as N

    node = sess.plan(QUERIES[1])
    while not isinstance(node, N.Aggregate):
        node = node.children[0]
    page = sess.executor.run(node.children[0])
    dp = gk.dense_plan(page, node.group_exprs, node.aggs, node.mask)
    (call,) = dp.kernel_calls()
    return call




# -- independent numpy computations of the join queries ---------------------


def _code(col, value):
    """Dictionary code of `value` in a dictionary-coded host column."""
    return next(i for i, s in enumerate(col.dictionary) if s == value)


def _date(days):
    import numpy as np

    return np.datetime64("1970-01-01") + np.timedelta64(int(days), "D")


def _lookup(keys):
    """key -> row index array over a key column (keys are small ints)."""
    import numpy as np

    idx = np.full(int(keys.max()) + 1, -1, np.int64)
    idx[keys] = np.arange(len(keys))
    return idx


def numpy_q3(t):
    """TPC-H Q3 over the generated columns, in exact integer arithmetic."""
    from decimal import Decimal

    import numpy as np

    c, o, li = t["customer"].columns, t["orders"].columns, t["lineitem"].columns
    cut = _days(1995, 3, 15)
    cust_ok = np.zeros(int(c["c_custkey"].data.max()) + 1, bool)
    seg = c["c_mktsegment"]
    cust_ok[c["c_custkey"].data[seg.data == _code(seg, "BUILDING")]] = True
    o_ok = (o["o_orderdate"].data < cut) & cust_ok[o["o_custkey"].data]
    orow = _lookup(o["o_orderkey"].data)[li["l_orderkey"].data]
    m = (li["l_shipdate"].data > cut) & o_ok[orow]
    rev = li["l_extendedprice"].data[m] * (100 - li["l_discount"].data[m])
    keys, inv = np.unique(li["l_orderkey"].data[m], return_inverse=True)
    sums = np.zeros(len(keys), np.int64)
    np.add.at(sums, inv, rev)
    oi = _lookup(o["o_orderkey"].data)[keys]
    odate = o["o_orderdate"].data[oi]
    order = np.lexsort((odate, -sums))[:10]
    return [(int(keys[i]), Decimal(int(sums[i])).scaleb(-4), _date(odate[i]),
             int(o["o_shippriority"].data[oi[i]])) for i in order]


def numpy_q5(t):
    from decimal import Decimal

    import numpy as np

    c, o, li = t["customer"].columns, t["orders"].columns, t["lineitem"].columns
    s, n, r = t["supplier"].columns, t["nation"].columns, t["region"].columns
    asia = r["r_regionkey"].data[r["r_name"].data == _code(r["r_name"], "ASIA")][0]
    nat_ok = np.zeros(int(n["n_nationkey"].data.max()) + 1, bool)
    nat_ok[n["n_nationkey"].data[n["n_regionkey"].data == asia]] = True
    cnat = np.full(int(c["c_custkey"].data.max()) + 1, -1, np.int64)
    cnat[c["c_custkey"].data] = c["c_nationkey"].data
    snat = np.full(int(s["s_suppkey"].data.max()) + 1, -1, np.int64)
    snat[s["s_suppkey"].data] = s["s_nationkey"].data
    od = o["o_orderdate"].data
    o_ok = (od >= _days(1994, 1, 1)) & (od < _days(1995, 1, 1))
    orow = _lookup(o["o_orderkey"].data)[li["l_orderkey"].data]
    lcn = cnat[o["o_custkey"].data[orow]]
    lsn = snat[li["l_suppkey"].data]
    m = o_ok[orow] & (lcn == lsn) & nat_ok[np.maximum(lsn, 0)]
    rev = li["l_extendedprice"].data[m] * (100 - li["l_discount"].data[m])
    sums = np.zeros(len(nat_ok), np.int64)
    np.add.at(sums, lsn[m], rev)
    name_of = {int(k): n["n_name"].dictionary[int(cd)]
               for k, cd in zip(n["n_nationkey"].data, n["n_name"].data)}
    rows = [(name_of[k], Decimal(int(sums[k])).scaleb(-4))
            for k in range(len(sums)) if nat_ok[k] and sums[k]]
    return sorted(rows, key=lambda x: -x[1])


def numpy_q17(t):
    from decimal import Decimal

    import numpy as np

    p, li = t["part"].columns, t["lineitem"].columns
    pk = li["l_partkey"].data
    qty = li["l_quantity"].data
    n = int(pk.max()) + 1
    cnt = np.bincount(pk, minlength=n)
    tot = np.zeros(n, np.int64)
    np.add.at(tot, pk, qty)
    avg2 = (2 * tot + cnt) // (2 * np.maximum(cnt, 1))  # avg, scale 2, HALF_UP
    part_ok = np.zeros(n, bool)
    sel = (p["p_brand"].data == _code(p["p_brand"], "Brand#23")) & (
        p["p_container"].data == _code(p["p_container"], "MED BOX"))
    part_ok[p["p_partkey"].data[sel]] = True
    # l_quantity (scale 2) < 0.2 * avg (scale 3)
    m = part_ok[pk] & (qty * 10 < 2 * avg2[pk])
    total = int(li["l_extendedprice"].data[m].sum())  # scale 2
    # / 7.0 at scale 6: x = total * 10^(6 + 1 - 2), HALF_UP over 70
    x = total * 10 ** 5
    return [(Decimal((2 * x + 70) // 140).scaleb(-6),)]


def numpy_q18(t, with_name=True, having=30000):
    """TPC-H Q18; with_name=False drops c_name (the north-star text, over
    the benchmark generator, which has no c_name). `having` is the HAVING
    threshold on sum(l_quantity) at scale 2 (TPC-H's 300)."""
    from decimal import Decimal

    import numpy as np

    c, o, li = t["customer"].columns, t["orders"].columns, t["lineitem"].columns
    lk = li["l_orderkey"].data
    tot = np.zeros(int(lk.max()) + 1, np.int64)
    np.add.at(tot, lk, li["l_quantity"].data)
    big = np.flatnonzero(tot > having)  # sum(l_quantity) > having, scale 2
    oi = _lookup(o["o_orderkey"].data)[big]
    ci = _lookup(c["c_custkey"].data)[o["o_custkey"].data[oi]]
    price = o["o_totalprice"].data[oi]
    odate = o["o_orderdate"].data[oi]
    order = np.lexsort((odate, -price))[:100]
    rows = [(int(c["c_custkey"].data[ci[i]]), int(big[i]), _date(odate[i]),
             Decimal(int(price[i])).scaleb(-2), Decimal(int(tot[big[i]])).scaleb(-2))
            for i in order]
    if not with_name:
        return rows
    return [(c["c_name"].dictionary[int(c["c_name"].data[ci[i]])],) + r
            for i, r in zip(order, rows)]


def numpy_q18_shape(t):
    """scale.Q18_SHAPE: per customer with orders, sum(o_totalprice) and
    count(*), the top 100 by the sum. The text orders by the sum alone, so
    the check requires the 101 largest sums to be distinct."""
    from decimal import Decimal

    import numpy as np

    c, o = t["customer"].columns, t["orders"].columns
    m = np.isin(o["o_custkey"].data, c["c_custkey"].data)  # the inner join
    ck, price = o["o_custkey"].data[m], o["o_totalprice"].data[m]
    tp = np.zeros(int(ck.max()) + 1, np.int64)
    np.add.at(tp, ck, price)
    n = np.bincount(ck, minlength=len(tp))
    keys = np.flatnonzero(n)
    top = keys[np.argsort(-tp[keys], kind="stable")[:101]]
    if len(np.unique(tp[top])) != len(top):
        raise AssertionError("Q18_SHAPE: tied sums among the top 101, order undecided")
    return [(int(k), Decimal(int(tp[k])).scaleb(-2), int(n[k])) for k in top[:100]]


# the north-star Q18 selects no order over the benchmark generator (4 lines
# of at most 50 each per order, so sum(l_quantity) <= 200 < 300); this
# threshold selects about 1.4e-3 of the orders, so the path past the inner
# aggregate has rows to check
Q18_REACHED_HAVING = 180


JOIN_QUERIES = {3: numpy_q3, 5: numpy_q5, 17: numpy_q17, 18: numpy_q18}
TPCH_TABLES = ("region", "nation", "supplier", "part", "customer", "orders", "lineitem")


def make_session(sf=1.0, device="cuda"):
    """Session over TpchCatalog(sf) on `device`, the tables the queries read
    generated and uploaded (set-up, not query time)."""
    import torch

    from presto_tpu_torch.connectors.tpch import TpchCatalog
    from presto_tpu_torch.session import Session

    t0 = time.perf_counter()
    cat = TpchCatalog(sf, device=device)
    for name in TPCH_TABLES:
        cat.page(name)
    if device == "cuda":
        torch.cuda.synchronize()
    print(f"tables {TPCH_TABLES} generated+uploaded in {time.perf_counter() - t0:.3f} s "
          f"(lineitem rows={cat.exact_row_count('lineitem')})", flush=True)
    return Session(cat, device=device), cat


def _counts():
    from presto_tpu_torch.ops import agg_kernel as ak
    from presto_tpu_torch.ops import groupby_kernel as gk
    from presto_tpu_torch.ops import join_kernel as jk

    return {"groupby_partials": gk.launches, "join_insert": jk.insert_launches,
            "join_probe": jk.probe_launches, "q1_partials": ak.launches}


def _zero_counts():
    from presto_tpu_torch.ops import agg_kernel as ak
    from presto_tpu_torch.ops import groupby_kernel as gk
    from presto_tpu_torch.ops import join_kernel as jk

    gk.launches = jk.insert_launches = jk.probe_launches = ak.launches = 0


def run_path(sess, expect, runs=3, texts=None):
    """Each query `runs` times (cold, then warm), rows checked against
    `expect[q]`; the SQL is texts[q] (TPC-H's QUERIES[q] by default).
    Returns ({q: timing report}, {q: launches of the first run})."""
    from presto_tpu_torch.benchmark.tpch_sql import QUERIES

    texts = texts or QUERIES
    report, per_query = {}, {}
    for q, want in expect.items():
        label = f"Q{q}" if isinstance(q, int) else q
        walls = []
        for i in range(runs):
            before = _counts()
            t = time.perf_counter()
            rows = sess.query(texts[q]).rows()  # rows() syncs to the host
            walls.append(time.perf_counter() - t)
            if i == 0:
                per_query[q] = {k: v - before[k] for k, v in _counts().items()}
            if rows != want:
                raise AssertionError(f"{label} rows differ from numpy:\n{rows[:5]}\n{want[:5]}")
        report[q] = {"cold_ms": walls[0] * 1e3, "warm_ms": min(walls[1:]) * 1e3,
                     "result_rows": len(rows), "launches": per_query[q]}
        print(f"phase3 {label}", json.dumps(report[q]), flush=True)
    return report, per_query


# -- phase 3: the benchmark path on device-generated data -------------------


def run_pipelines(page, expect, runs=3):
    """Each hand-coded pipeline `runs` times (cold, then warm) over `page`,
    rows checked against expect[name]; returns ({name: timing report},
    {name: launches of the first run})."""
    from presto_tpu_torch.benchmark import handcoded

    report, per = {}, {}
    for name, want in expect.items():
        fn = getattr(handcoded, name)
        walls = []
        for i in range(runs):
            before = _counts()
            t = time.perf_counter()
            rows = fn(page).to_pylist()  # to_pylist() syncs to the host
            walls.append(time.perf_counter() - t)
            if i == 0:
                per[name] = {k: v - before[k] for k, v in _counts().items()}
            if rows != want:
                raise AssertionError(f"{name}: rows differ from numpy:\n{rows}\n{want}")
        report[name] = {"cold_ms": walls[0] * 1e3, "warm_ms": min(walls[1:]) * 1e3,
                        "result_rows": len(rows), "launches": per[name]}
        print(f"phase3 {name}", json.dumps(report[name]), flush=True)
    return report, per


def benchmark_path(sf=1.0, device="cuda", runs=3):
    """The benchmark path: every table of DeviceTpchCatalog(sf) and
    lineitem's Q1 page generated on `device`, the hand-coded pipelines,
    then SQL Q1/Q6, the north-star queries, Q18 with a HAVING threshold
    the generator reaches and scale.Q18_SHAPE through a Session over the
    device catalog, each checked against numpy over the host twin. The
    launch counts are set to 0 before the path and read after; returns
    ({label: timing report}, {label: launches of the first run}, path
    counts, the Q1 page)."""
    import torch

    from presto_tpu_torch.benchmark import handcoded, northstar, scale
    from presto_tpu_torch.benchmark.tpch_sql import QUERIES
    from presto_tpu_torch.connectors import tpch_device
    from presto_tpu_torch.session import Session

    t0 = time.perf_counter()
    dcat = tpch_device.DeviceTpchCatalog(sf, device=device)
    for name in TPCH_TABLES:
        dcat.page(name)
    page = handcoded.lineitem_q1_page(sf, device=device)
    if device == "cuda":
        torch.cuda.synchronize()
    print(f"phase3 generated on {device}: tables {TPCH_TABLES} and lineitem's Q1 page in "
          f"{time.perf_counter() - t0:.3f} s (lineitem rows={int(page.count)})", flush=True)
    t0 = time.perf_counter()
    twin = {name: tpch_device.table(name, sf) for name in TPCH_TABLES}
    q1, q6 = numpy_q1(twin["lineitem"]), numpy_q6(twin["lineitem"])
    expect = {"sql_Q1": q1, "sql_Q6": q6}
    texts = {"sql_Q1": QUERIES[1], "sql_Q6": QUERIES[6]}
    for name, text in northstar.QUERIES.items():
        q = int(name[1:])
        label = f"northstar_{name}"
        expect[label] = numpy_q18(twin, with_name=False) if q == 18 else JOIN_QUERIES[q](twin)
        texts[label] = text
    q18_reached = northstar.QUERIES["q18"].replace("> 300", f"> {Q18_REACHED_HAVING}")
    assert q18_reached != northstar.QUERIES["q18"]
    expect["q18_reached"] = numpy_q18(twin, with_name=False, having=Q18_REACHED_HAVING * 100)
    texts["q18_reached"] = q18_reached
    expect["q18_shape"], texts["q18_shape"] = numpy_q18_shape(twin), scale.Q18_SHAPE
    for label in ("q18_reached", "q18_shape"):
        if not expect[label]:
            raise AssertionError(f"{label}: the numpy check selects no rows")
    print(f"phase3 host twin and numpy checks in {time.perf_counter() - t0:.3f} s", flush=True)

    _zero_counts()
    report, per = run_pipelines(page, {"q1_local": q1, "q1_local_kernel": q1, "q6_local": q6},
                                runs)
    sql_report, per_sql = run_path(Session(dcat, device=device), expect, runs, texts)
    counts = _counts()
    report.update(sql_report)
    per.update(per_sql)
    if per["q1_local_kernel"]["q1_partials"] < 1:
        raise AssertionError("q1_local_kernel did not launch the q1_partials kernel")
    if counts["q1_partials"] != runs * per["q1_local_kernel"]["q1_partials"]:
        raise AssertionError(f"q1_partials launched outside q1_local_kernel: {per}")
    return report, per, counts, page


# -- phase 2: the join kernels against their plain versions -----------------


def capture_calls(sess, queries=(3, 5, 17, 18)):
    """One more run of the join queries with the kernel wrappers wrapped:
    the join_insert call with the most rows to insert and the join_probe
    call with the most probe rows (with the query each came from), and
    Q18's groupby_totals calls."""
    from presto_tpu_torch.benchmark.tpch_sql import QUERIES
    from presto_tpu_torch.ops import groupby_kernel as gk
    from presto_tpu_torch.ops import join_kernel as jk

    rec = {"insert": None, "probe": None, "q18_totals": []}
    orig = jk.join_insert, jk.join_probe, gk.groupby_totals
    cur = [None]

    def insert(tag, row, desired, bits):
        live = int((row >= 0).sum())
        if rec["insert"] is None or live > rec["insert"][2]:
            rec["insert"] = (cur[0], (tag, row, desired, bits), live)
        return orig[0](tag, row, desired, bits)

    def probe(slot_tag, slot_row, tag, desired, start, max_scan=jk.MAX_SCAN):
        if rec["probe"] is None or tag.shape[0] > rec["probe"][1][2].shape[0]:
            rec["probe"] = (cur[0], (slot_tag, slot_row, tag, desired, start))
        return orig[1](slot_tag, slot_row, tag, desired, start, max_scan)

    def totals(*call):
        if cur[0] == 18:
            rec["q18_totals"].append(call)
        return orig[2](*call)

    jk.join_insert, jk.join_probe, gk.groupby_totals = insert, probe, totals
    try:
        for q in queries:
            cur[0] = q
            sess.query(QUERIES[q]).rows()
    finally:
        jk.join_insert, jk.join_probe, gk.groupby_totals = orig
    return rec


def _random_bytes(accesses, array_bytes):
    """Least bytes of `accesses` random 4 B reads or writes into one array:
    a 32 B sector each, but never more than the whole array."""
    return min(32 * accesses, array_bytes)


def insert_bytes(row, bits):
    """Least bytes of one insert: tag, row and desired read and pending
    written once (16 B a row), both slot arrays set once by the memset
    (8 B a slot), then for each slot array one random 32 B sector per
    inserted row, capped at the array's bytes."""
    from presto_tpu_torch.ops import join_kernel as jk

    size = jk.table_size(bits)
    live = int((row >= 0).sum())
    return 16 * row.shape[0] + 8 * size + 2 * _random_bytes(live, 4 * size)


def probe_bytes(tag, pos, slots):
    """Least bytes of one probe launch: tag, desired and start read and
    pos, row and more written once (24 B a row), one random 32 B sector of
    slot tags per row and one of slot rows per tag match, each capped at
    its slot array's bytes (4 B a slot)."""
    return (24 * tag.shape[0] + _random_bytes(tag.shape[0], 4 * slots)
            + _random_bytes(int((pos >= 0).sum()), 4 * slots))


def find_every_row(slot_tag, slot_row, pending, tag, row, desired):
    """Probe the table with every inserted row's own tag through the probe
    kernel, relaunching past tag matches of other rows and after scans that
    need more, until each row finds itself or is lost; pending rows are
    looked up in the tag-sorted overflow region. Returns (probe rounds,
    found: bool per row, True where row < 0)."""
    import torch

    from presto_tpu_torch.ops import join_kernel as jk

    found = row < 0
    placed = torch.nonzero((row >= 0) & (pending == 0)).flatten()
    start = torch.zeros_like(tag)
    rounds = 0
    while placed.numel():
        pos, got, more = jk.join_probe(slot_tag, slot_row, tag[placed], desired[placed],
                                       start[placed])
        mine = got == row[placed]
        found[placed[mine]] = True
        lost = (pos < 0) & (more == 0)
        other = (pos >= 0) & ~mine
        start[placed] = torch.where(other, pos - desired[placed] + 1,
                                    torch.where(more.bool(), start[placed] + jk.MAX_SCAN,
                                                start[placed]))
        placed = placed[~mine & ~lost]
        rounds += 1
        if rounds > slot_tag.shape[0]:
            raise AssertionError("probe rounds do not end")
    left = torch.nonzero(pending).flatten()
    of_tag, order = torch.sort(tag[left], stable=True)
    of_row = row[left][order]
    lo = torch.searchsorted(of_tag, tag[left])
    hi = torch.searchsorted(of_tag, tag[left], right=True)
    ok = torch.zeros(left.numel(), dtype=torch.bool, device=tag.device)
    for k in range(int((hi - lo).max()) if left.numel() else 0):
        p = torch.clamp(lo + k, max=max(of_row.numel() - 1, 0))
        ok |= (lo + k < hi) & (of_row[p] == row[left])
    found[left] = ok
    return rounds, found


def insert_case(name, tag, row, desired, bits):
    """join_insert (kernel) against join_insert_plain. Slot placement may
    differ between two correct inserts, so the two are compared by what a
    join sees: both held to the table invariants, and every inserted row
    looked up by its own tag through the probe kernel in each table.
    max_abs_err is the largest |found(kernel) - found(plain)| over the rows
    (found = 1 when the row's tag leads to it); times."""
    import torch

    from presto_tpu_torch.ops import join_kernel as jk

    got = jk.join_insert(tag, row, desired, bits)
    plain = jk.join_insert_plain(tag, row, desired, bits)
    torch.cuda.synchronize()
    errs = {label: jk.insert_invariant_errors(tag, row, desired, bits, *out)
            for label, out in (("kernel", got), ("plain", plain))}
    rounds, found = find_every_row(*got, tag, row, desired)
    _, found_plain = find_every_row(*plain, tag, row, desired)
    not_found = int((~found).sum()) + int((~found_plain).sum())
    max_err = int((found.to(torch.int32) - found_plain.to(torch.int32)).abs().max())
    if errs["kernel"] or errs["plain"] or not_found or max_err:
        raise AssertionError(f"{name}: invariants {errs}, rows not found by their tag "
                             f"{not_found}, found(kernel) vs found(plain) max err {max_err}")
    ms = cuda_ms(lambda: jk.join_insert(tag, row, desired, bits))
    plain_ms = cuda_ms(lambda: jk.join_insert_plain(tag, row, desired, bits), iters=3, warmup=1)
    nbytes = insert_bytes(row, bits)
    res = {"case": name, "n": tag.shape[0], "bits": bits, "live": int((row >= 0).sum()),
           "pending": int(got[2].sum()), "plain_pending": int(plain[2].sum()),
           "find_rounds": rounds,
           "invariant_violations": len(errs["kernel"]) + len(errs["plain"]),
           "rows_not_found": not_found, "max_abs_err": float(max_err), "ms": ms,
           "plain_ms": plain_ms, "library_ms": None,
           "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bytes": nbytes}
    print("phase2", json.dumps(res), flush=True)
    return res, got


def probe_case(name, slot_tag, slot_row, tag, desired, start):
    """join_probe (kernel) against join_probe_plain on one table: exact."""
    import torch

    from presto_tpu_torch.ops import join_kernel as jk

    got = jk.join_probe(slot_tag, slot_row, tag, desired, start)
    want = jk.join_probe_plain(slot_tag, slot_row, tag, desired, start)
    torch.cuda.synchronize()
    err = max(int((a.to(torch.int64) - b.to(torch.int64)).abs().max()) if a.numel() else 0
              for a, b in zip(got, want))
    if err:
        raise AssertionError(f"{name}: probe kernel disagrees with its plain version")
    ms = cuda_ms(lambda: jk.join_probe(slot_tag, slot_row, tag, desired, start))
    plain_ms = cuda_ms(lambda: jk.join_probe_plain(slot_tag, slot_row, tag, desired, start),
                       iters=5)
    nbytes = probe_bytes(tag, got[0], slot_tag.shape[0])
    res = {"case": name, "m": tag.shape[0], "table_slots": slot_tag.shape[0],
           "matched": int((got[0] >= 0).sum()), "more": int(got[2].sum()),
           "max_abs_err": float(err), "ms": ms, "plain_ms": plain_ms, "library_ms": None,
           "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bytes": nbytes}
    print("phase2", json.dumps(res), flush=True)
    return res


def _tags(keys_h, bits):
    from presto_tpu_torch.ops import join_kernel as jk

    return jk._tag_desired(keys_h, bits)


def join_phase2(sess, dev="cuda", n_max=None, m_max=6_000_859, n_small=100_000):
    """The join kernels against their plain versions: the largest calls
    the four queries make, the top of the table path's range (a build of
    n_max rows, TABLE_MAX_BUILD by default, probed by m_max rows), a skewed
    key and a varchar key (n_small rows each). Returns (insert results,
    probe results, Q18's hash-slot groupby result)."""
    import numpy as np
    import torch

    from presto_tpu_torch import types as T
    from presto_tpu_torch.expr.ir import col
    from presto_tpu_torch.ops import join_kernel as jk
    from presto_tpu_torch.ops.hashing import hash_column, hash_rows_values
    from presto_tpu_torch.page import Block, Page

    dev = torch.device(dev)
    rec = capture_calls(sess)
    q_ins, (tag, row, desired, bits), _live = rec["insert"]
    q_pr, pcall = rec["probe"]
    print(f"phase2 largest build: Q{q_ins} n={tag.shape[0]} bits={bits}; largest n1 probe: "
          f"Q{q_pr} m={pcall[2].shape[0]} table slots={pcall[0].shape[0]}", flush=True)
    inserts = [insert_case(f"largest_build_q{q_ins}", tag, row, desired, bits)[0]]
    probes = [probe_case(f"largest_probe_q{q_pr}", *pcall)]

    # the top of the table path: TABLE_MAX_BUILD distinct keys (bits 23),
    # probed by 6,000,859 rows of which about half match
    rng = np.random.default_rng(11)
    n = n_max or jk.TABLE_MAX_BUILD
    keys = torch.from_numpy(rng.permutation(n).astype(np.int64) * 7 + 3).to(dev)
    bits = jk._pick_bits(n)
    tag, desired = _tags(hash_column(keys), bits)
    row = torch.arange(n, dtype=torch.int32, device=dev)
    res, (st, sr, _pend) = insert_case("max_build_4M", tag, row, desired, bits)
    inserts.append(res)
    m = m_max
    pick = torch.from_numpy(rng.integers(0, n, m)).to(dev)
    miss = torch.from_numpy(rng.random(m) < 0.5).to(dev)
    pkeys = torch.where(miss, keys[pick] + (1 << 40), keys[pick])
    ptag, pdes = _tags(hash_column(pkeys), bits)
    probes.append(probe_case("probe_6M_half_match", st, sr, ptag, pdes,
                             torch.zeros_like(ptag)))
    del st, sr

    # skew: one key repeated 1,000 times among 100,000 rows, so rows
    # overflow and probes continue past other rows' matches
    n = n_small
    keys = torch.from_numpy(np.where(rng.random(n) < 0.01, 7, rng.permutation(n) + 100)).to(dev)
    bits = jk._pick_bits(n)
    tag, desired = _tags(hash_column(keys), bits)
    row = torch.arange(n, dtype=torch.int32, device=dev)
    res, (st, sr, pend) = insert_case("skew_key_x1000", tag, row, desired, bits)
    inserts.append(res)
    if res["pending"] == 0 or res["find_rounds"] < 2:
        raise AssertionError("the skew case neither overflowed nor continued a probe")
    starts = torch.from_numpy(rng.integers(0, jk.R_MAX, n).astype(np.int32)).to(dev)
    probes.append(probe_case("probe_skew", st, sr, tag, desired, starts))

    # varchar keys in two dictionaries: the table join on the card equals
    # the same join on the CPU
    bdict = tuple(f"key{i:07d}" for i in range(n_small))
    pdict = tuple(sorted(f"key{i:07d}" for i in range(n_small // 2, 3 * n_small // 2)))
    bcodes = rng.permutation(len(bdict)).astype(np.int32)
    pcodes = rng.integers(0, len(pdict), 3 * n_small).astype(np.int32)
    pages = {}
    for d in (dev, torch.device("cpu")):
        build = Page.from_blocks([Block.from_numpy(bcodes, T.VARCHAR, dictionary=bdict, device=d),
                                  Block.from_numpy(np.arange(len(bdict)), T.BIGINT, device=d)],
                                 ["k", "v"])
        probe = Page.from_blocks([Block.from_numpy(pcodes, T.VARCHAR, dictionary=pdict, device=d),
                                  Block.from_numpy(np.arange(len(pcodes)), T.BIGINT, device=d)],
                                 ["k", "w"])
        pages[d.type] = (build, probe)
    key = (col("k", T.VARCHAR),)
    build, probe = pages[dev.type]
    kv = build.block("k")
    bits = jk._pick_bits(build.capacity)
    tag, desired = _tags(hash_rows_values([kv]), bits)
    row = torch.arange(build.capacity, dtype=torch.int32, device=dev)
    res, (st, sr, pend) = insert_case("varchar_key", tag, row, desired, bits)
    inserts.append(res)
    ptag, pdes = _tags(hash_rows_values([probe.block("k")]), bits)
    probes.append(probe_case("probe_varchar", st, sr, ptag, pdes, torch.zeros_like(ptag)))
    got = jk.table_join_n1(probe, jk.build_table(build, key), key, ("v",), ("v",))
    cb, cp = pages["cpu"]
    want = jk.table_join_n1(cp, jk.build_table(cb, key), key, ("v",), ("v",))
    if sorted(got.to_pylist()) != sorted(want.to_pylist()) or int(want.count) == 0:
        raise AssertionError("varchar table join on the card differs from the CPU")
    print(f"phase2 varchar join rows={int(got.count)} equal to the CPU", flush=True)

    # the hash-slot group-by call of Q18's outer aggregate
    (call,) = rec["q18_totals"]
    hash_res = kernel_case("q18_hash_slot", call, lambda c: 0.0)
    return inserts, probes, hash_res


# -- phase 2: the fused-Q1 kernel against its plain version -----------------

Q1_CUTOFF = _days(1998, 9, 2)  # Q1's shipdate cutoff


def _lanes_value(lanes) -> int:
    hi, lo = (int(x) for x in lanes)
    return hi * (1 << 32) + lo


def q1_kernel_case(name, cols, count, cutoff, exact=None):
    """q1_sums (kernel) against q1_sums_plain on one call's inputs: every
    field equal. `exact` maps a group to {field: Python-int total} the
    kernel must also equal. Times the kernel, the plain version, one
    index_add_ of a prepared (n, 8) channel tensor by group id (the
    library yardstick) and the byte bound: ship, returnflag and linestatus
    read for each row below count (12 B), the four int64 decimals by the
    32 B sectors (4 rows) that hold a selected row (selected rows are
    scattered, so a sector is read whole), the (6, 8) totals written."""
    import torch

    from presto_tpu_torch.ops import agg_kernel as ak

    dev = cols[0].device
    count = torch.tensor(count, dtype=torch.int32, device=dev) if isinstance(count, int) else count
    cutoff = torch.tensor(cutoff, dtype=torch.int32, device=dev)
    call = (*cols, count, cutoff)
    got = ak.q1_sums(*call)
    want = ak.q1_sums_plain(*call)
    torch.cuda.synchronize()
    err = max(int((got[k] - want[k]).abs().max()) for k in want)
    if err:
        raise AssertionError(f"{name}: q1_partials disagrees with its plain version, max err {err}")
    for g, fields in (exact or {}).items():
        for field, total in fields.items():
            value = got[field][g]
            value = _lanes_value(value) if value.ndim else int(value)
            if value != total:
                raise AssertionError(f"{name}: group {g} {field} {value} != exact {total}")
    ms = cuda_ms(lambda: ak.q1_sums(*call))
    plain_ms = cuda_ms(lambda: ak.q1_sums_plain(*call), iters=5)
    qty, price, disc, tax, rf, ls, ship = cols
    n = qty.shape[0]
    rows = min(n, int(count))
    live = (torch.arange(n, device=dev) < count) & (ship <= cutoff)
    g = torch.where(live, rf.to(torch.int64) * 2 + ls, ak.GROUPS)
    dp = price * (100 - disc)
    charge = dp * (100 + tax)
    mask = (1 << 32) - 1
    chans = torch.stack([torch.ones_like(qty), qty, price, disc, dp >> 32, dp & mask,
                         charge >> 32, charge & mask], dim=1)
    acc = torch.zeros((ak.GROUPS + 1, ak.CHANNELS), dtype=torch.int64, device=dev)
    library_ms = cuda_ms(lambda: acc.zero_().index_add_(0, g, chans))
    selected = int(live.sum())
    pad = torch.zeros((-n) % 4, dtype=torch.bool, device=dev)
    sectors = int(torch.cat([live, pad]).view(-1, 4).any(dim=1).sum())
    nbytes = 12 * rows + 4 * 32 * sectors + ak.GROUPS * ak.CHANNELS * 8
    del chans, dp, charge, g, live
    res = {"case": name, "n": n, "count": rows, "selected": selected, "sectors": sectors,
           "groups_empty": int((got["count"] == 0).sum()), "max_abs_err": float(err),
           "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
           "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bytes": nbytes}
    print("phase2", json.dumps(res), flush=True)
    return res


def q1_phase2(page, sf_big=10.0, n_wide=2_000_000, device="cuda"):
    """The fused-Q1 kernel against its plain version: (a) the SF 1 page of
    the benchmark path, (b) SF `sf_big`'s lineitem generated on the card,
    (c) a count below capacity and a cutoff (1995-01-01) that empties the
    open groups, (d) `n_wide` rows with prices near 2^31 - 1, most in one
    group, whose sum of charge passes 2^63, held also to Python-int totals."""
    import numpy as np
    import torch

    from presto_tpu_torch.benchmark import benchgen, handcoded

    cols = [page.block(c).data for c in handcoded.Q1_COLUMNS]
    results = [q1_kernel_case("q1_sf1_page", cols, page.count, Q1_CUTOFF)]

    t0 = time.perf_counter()
    big = benchgen.device_page("lineitem", sf_big, handcoded.Q1_COLUMNS, device=device)
    torch.cuda.synchronize()
    print(f"phase2 lineitem Q1 columns at SF {sf_big:g} generated on {device} in "
          f"{time.perf_counter() - t0:.3f} s (rows={big.capacity})", flush=True)
    results.append(q1_kernel_case(f"q1_sf{sf_big:g}", [big.block(c).data for c in
                                                      handcoded.Q1_COLUMNS], big.count,
                                  Q1_CUTOFF))
    del big

    res = q1_kernel_case("q1_count_and_cutoff", cols, int(page.capacity * 2 // 3),
                         _days(1995, 1, 1))
    if res["groups_empty"] < 3:
        raise AssertionError("the cutoff case emptied fewer than three groups")
    results.append(res)

    rng = np.random.default_rng(31)
    n = n_wide
    rf = rng.integers(0, 3, n).astype(np.int32)
    ls = rng.integers(0, 2, n).astype(np.int32)
    rf[: int(0.9 * n)] = 0
    ls[: int(0.9 * n)] = 0
    host = {"qty": rng.integers(1, 51, n) * 100,
            "price": (1 << 31) - 1 - rng.integers(0, 1000, n),
            "disc": rng.integers(0, 11, n), "tax": rng.integers(0, 9, n),
            "rf": rf, "ls": ls,
            "ship": rng.integers(Q1_CUTOFF - 2000, Q1_CUTOFF + 50, n).astype(np.int32)}
    keep = host["ship"] <= Q1_CUTOFF
    exact = {}
    for grp in (0, 3):
        m = keep & (rf * 2 + ls == grp)
        dp = host["price"][m] * (100 - host["disc"][m])
        exact[grp] = {"count": int(m.sum()), "sum_price": sum(host["price"][m].tolist()),
                      "sum_disc_price": sum(dp.tolist()),
                      "sum_charge": sum((dp * (100 + host["tax"][m])).tolist())}
    if exact[0]["sum_charge"] < 1 << 63:
        raise AssertionError("the wide case's sum of charge does not pass 2^63")
    wide = [torch.from_numpy(host[k]).to(device)
            for k in ("qty", "price", "disc", "tax", "rf", "ls", "ship")]
    results.append(q1_kernel_case("q1_sum_charge_past_2^63", wide, n, Q1_CUTOFF, exact))
    return results


def profile_runs(runs, warm_ms, out_dir):
    """torch.profiler over one warm call of each `runs[label]`: device
    busy time, its idle share of the unprofiled warm wall time
    `warm_ms[label]`, and the kernels that took the device time. The full
    table goes to <out_dir>/profile_<label>.txt."""
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(out_dir, exist_ok=True)
    for label, fn in runs.items():
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t) * 1e3
        events = prof.key_averages()
        # device-side events only (kernels, copies): the CPU-side aten ops
        # also report the device time of the kernels they launched
        device = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]

        def dev_us(e):
            return getattr(e, "self_device_time_total", None) or getattr(
                e, "self_cuda_time_total", 0)

        busy_ms = sum(dev_us(e) for e in device) / 1e3
        top = sorted(device, key=dev_us, reverse=True)[:8]
        ours = {k: sum(dev_us(e) for e in device if k in e.key) / 1e3
                for k in ("groupby_partials_kernel", "join_insert_kernel", "join_probe_kernel",
                          "q1_partials_kernel")}
        print(f"profile {label}", json.dumps({
            "profiled_wall_ms": wall_ms, "warm_wall_ms": warm_ms[label],
            "device_busy_ms": busy_ms,
            "idle_share_of_warm_wall": 1.0 - busy_ms / warm_ms[label],
            "device_launches": sum(e.count for e in device),
            "host_syncs": sum(e.count for e in device if "DtoH" in e.key),
            "our_kernels_device_ms": ours,
            "top_device_ms": {e.key[:70]: dev_us(e) / 1e3 for e in top},
        }), flush=True)
        with open(os.path.join(out_dir, f"profile_{label}.txt"), "w") as f:
            f.write(events.table(sort_by="self_cuda_time_total", row_limit=40))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from presto_tpu_torch import cuda_build
    from presto_tpu_torch.benchmark import bench

    # phase 1: build
    t0 = time.perf_counter()
    logs = cuda_build.build_all()
    secs = time.perf_counter() - t0
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "smem" in line or "error" in line.lower():
                print(f"phase1 {name}: {line.strip()}")
    print(f"phase1 built {len(logs)} kernel libraries in {secs:.3f} s", flush=True)

    sess, cat = make_session()
    tables = {name: cat.host_table(name) for name in TPCH_TABLES}

    # phase 3, the main paths, each with the launch counts at 0 just
    # before it and read just after: Q1/Q6, then the join queries
    t0 = time.perf_counter()
    li = tables["lineitem"]
    expect = {1: numpy_q1(li), 6: numpy_q6(li)}
    _zero_counts()
    report, per_query = run_path(sess, expect)
    path_counts = {"q1_q6": _counts()}
    expect = {q: fn(tables) for q, fn in JOIN_QUERIES.items()}
    _zero_counts()
    jreport, jper = run_path(sess, expect)
    path_counts["joins"] = _counts()
    report.update(jreport)
    per_query.update(jper)
    breport, per, path_counts["benchmark"], q1_page = benchmark_path()
    per_query.update(per)
    print(f"phase3 main-path launches {json.dumps(path_counts)} in "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    t0 = time.perf_counter()
    print("phase3 bench", json.dumps(bench.run(1.0, "cuda")), flush=True)
    print(f"phase3 bench done in {time.perf_counter() - t0:.3f} s", flush=True)
    if per_query[1]["groupby_partials"] < 1:
        raise AssertionError("Q1 did not launch the groupby kernel")
    for q in (3, 5, 17, 18):
        if per_query[q]["join_insert"] < 1:
            raise AssertionError(f"Q{q} did not launch join_insert")
    for q in (3, 17, 18):
        if per_query[q]["join_probe"] < 1:
            raise AssertionError(f"Q{q} did not launch join_probe")
    for label in ("northstar_q3", "northstar_q5", "northstar_q17", "northstar_q18",
                  "q18_reached", "q18_shape"):
        if per_query[label]["join_insert"] < 1:
            raise AssertionError(f"{label} did not launch join_insert")
    for label in ("northstar_q3", "northstar_q17", "q18_reached"):
        if per_query[label]["join_probe"] < 1:
            raise AssertionError(f"{label} did not launch join_probe")

    # phase 2: each kernel against its plain version, at the main paths'
    # shapes and at wider cases
    t0 = time.perf_counter()
    cases = phase2(q1_kernel_call(sess, cat))
    inserts, probes, hash_res = join_phase2(sess)
    cases.append(hash_res)
    q1_cases = q1_phase2(q1_page)
    print(f"phase2 done in {time.perf_counter() - t0:.3f} s", flush=True)

    args = sys.argv[1:]
    if "--profile" in args:
        from presto_tpu_torch.benchmark import handcoded
        from presto_tpu_torch.benchmark.tpch_sql import QUERIES

        out_dir = args[args.index("--profile-dir") + 1] if "--profile-dir" in args else "profile_out"
        runs = {f"Q{q}": (lambda q=q: sess.query(QUERIES[q]).rows()) for q in (1, 6, 3, 18)}
        warm = {f"Q{q}": report[q]["warm_ms"] for q in (1, 6, 3, 18)}
        for name in ("q1_local", "q1_local_kernel", "q6_local"):
            runs[name] = lambda fn=getattr(handcoded, name): fn(q1_page).to_pylist()
            warm[name] = breport[name]["warm_ms"]
        profile_runs(runs, warm, out_dir)
    del q1_page

    launches = {k: sum(c[k] for c in path_counts.values()) for k in _counts()}
    q1 = cases[0]

    def entry(name, source, replaces, case, cases, check):
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches[name], "max_abs_err": max(c["max_abs_err"] for c in cases),
                "check": check, "ms": case["ms"], "plain_ms": case["plain_ms"],
                "bound_ms": case["bound_ms"], "bound_by": "bytes",
                "library_ms": case["library_ms"]}

    kernels = [
        entry("groupby_partials", "presto_tpu_torch/csrc/groupby_partials.cu",
              "presto_tpu/ops/pallas_groupby.py:59", q1, cases,
              "totals against the plain version"),
        entry("join_insert", "presto_tpu_torch/csrc/join_insert.cu",
              "presto_tpu/ops/pallas_join.py:193", inserts[0], inserts,
              "table invariants of both tables (violations "
              f"{sum(c['invariant_violations'] for c in inserts)}); max_abs_err is "
              "|found(kernel) - found(plain)| of each row looked up by its own tag"),
        entry("join_probe", "presto_tpu_torch/csrc/join_probe.cu",
              "presto_tpu/ops/pallas_join.py:452", probes[0], probes,
              "pos, row and more against the plain version on the same table"),
        entry("q1_partials", "presto_tpu_torch/csrc/q1_partials.cu",
              "presto_tpu/ops/pallas_agg.py:45", q1_cases[0], q1_cases,
              "every field of q1_sums against the plain version (integers: exact)"),
    ]
    print("launches per query (first run): " + json.dumps(per_query))
    print(card_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
