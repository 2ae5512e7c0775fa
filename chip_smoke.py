"""On-card smoke run of presto_tpu_torch, the PyTorch/CUDA port.

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py [--profile [--profile-dir DIR]]

Phase 1 builds every CUDA kernel of the package from csrc/ (nvcc, sm_90a),
one nvcc per source, all started together, prints ptxas's registers and
spills of every kernel instance, and checks the group-by and join
kernels' parameter structs as the build lays them out against their
ctypes twins.
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
through its host twin), and the script checks that Q1, Q5 and Q18
launched the group-by kernel, that join_insert launched on each join query and
join_probe on Q3, Q17 and Q18 (on both catalogs; on the device catalog
the reached Q18 in its place), and that q1_local_kernel, and only it,
launched the fused-Q1 kernel.
Phase 2 holds each kernel against its plain PyTorch version on the card:
the group-by kernel at Q1's, Q5's and Q18's (hash-slot) calls, two wider
G 64 cases and the edges of its regimes and grid (GROUPBY_EDGES), and
shows under torch.profiler that one groupby_totals call is one kernel
launch with no host<->device copy or stream synchronise; join_insert and
join_probe at the largest calls the join queries make (captured in one
more run of them), at the top of the table path's range (4,194,304 build
rows, 6,000,859 probe rows), with a skewed key whose rows overflow and
whose scans pass other keys' tag matches, and with varchar (two
dictionaries), composite, float64 (-0.0, NaN) and long-decimal keys, each
join also against the CPU; inserts are held by the table invariants and
by finding every row through the probe kernel, probes exactly (matched,
build row); under torch.profiler a warm `_probe_n1` (at the largest
captured probe and at 6M rows) is one launch with no copy or stream
synchronise, and a warm `build_table` makes one insert launch, no
`nonzero` and at most two host reads; the fused-Q1 kernel on the SF 1 page, on SF 10's
60,000,000 rows generated on the card, with a count below capacity and a
cutoff that empties groups, and on a case whose sum of charge passes 2^63
(also held to exact Python-int totals). It times the kernel, the plain
version, one PyTorch library call where one computes the same function,
and the byte bound.
It prints the card's name and power limit, a `{"kernels": [...]}` JSON
line, and last `{"ok": true, "device": {...}}`. Any failed phase exits
nonzero. With --profile it also traces one warm Q1, Q6, Q3, Q5 and Q18
and one warm run of each hand-coded pipeline with torch.profiler (device
busy time, idle share, device-to-host and host-to-device copies, stream
synchronises, our kernels' device time, top ops; full tables under DIR,
by default profile_out/).
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


_LAUNCH_KEYS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC")
_MEMCPY_KEYS = ("cudaMemcpyAsync", "cudaMemcpy")


def _count_events(events, pred):
    return sum(e.count for e in events if pred(e))


def _trace(fn, counter, tries=3):
    """(key_averages, fn's result, the increase of counter()) of one call
    of fn under torch.profiler, synchronised. The profiler at times drops
    the last device records of a window (a kernel, a copy); a window with
    fewer device kernels than cudaLaunchKernel calls, or fewer device
    copies than cudaMemcpy calls, is incomplete and is traced again, at
    most `tries` times in all."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.autograd.DeviceType.CUDA
    for _ in range(tries):
        before = counter()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            out = fn()
            torch.cuda.synchronize()
        events = prof.key_averages()
        copies = _count_events(events, lambda e: e.device_type == cuda and "Memcpy" in e.key)
        kernels = _count_events(events, lambda e: e.device_type == cuda
                                and "Memcpy" not in e.key and "Memset" not in e.key)
        if (kernels >= _count_events(events, lambda e: e.key in _LAUNCH_KEYS)
                and copies >= _count_events(events, lambda e: e.key in _MEMCPY_KEYS)):
            break
    return events, out, counter() - before


# -- phase 2: kernel against plain version ---------------------------------


def exact(call):
    """Integer totals are exact."""
    return 0.0


def f64_tol(call):
    """float64 sums add in no fixed order (atomics, the cross-block fold),
    so the totals may differ from a sequential sum by rounding."""
    from presto_tpu_torch.ops import groupby_kernel as gk

    gid, live, count, chans, kinds, sources, G = call
    mag = gk.groupby_totals_plain(gid, live, count, [c.abs() for c in chans], kinds, sources, G)
    return 1e-12 * mag + 1e-9


def kernel_case(name, call, tol_fn, expect=None, one_launch=False):
    """Compare groupby_totals (kernel) with groupby_totals_plain on one
    call's inputs; `expect` may hold the "register" regime (True/False)
    and "blocks" the launch must take; `one_launch` adds
    one_launch_check. Returns a result dict."""
    import torch

    from presto_tpu_torch.ops import groupby_kernel as gk

    gid, live, count, chans, kinds, sources, G = call
    chans = [] if chans is None else list(chans)
    dtype = chans[0].dtype if chans else torch.int64
    n = gid.shape[0]
    regime, blocks = gk.launch_shape(gid.device, dtype, n, G, len(kinds)) if n else (None, 0)
    for key, got_v in (("register", regime is not None and regime != gk.ATOMIC),
                       ("blocks", blocks)):
        if expect and key in expect and expect[key] != got_v:
            raise AssertionError(f"{name}: {key} {got_v}, expected {expect[key]}")
    got = gk.groupby_totals(*call)
    want = gk.groupby_totals_plain(*call)
    torch.cuda.synchronize()
    err = (got.to(torch.float64) - want.to(torch.float64)).abs()
    max_err = float(err.max()) if err.numel() else 0.0
    tol = tol_fn(call)
    if got.dtype != want.dtype or got.shape != want.shape or not bool((err <= tol).all()):
        raise AssertionError(f"{name}: kernel disagrees with plain version, max err {max_err}")
    if tol_fn is exact and not torch.equal(got, want):
        raise AssertionError(f"{name}: integer totals differ from the plain version")
    ms = cuda_ms(lambda: gk.groupby_totals(*call))
    plain_ms = cuda_ms(lambda: gk.groupby_totals_plain(*call), iters=5)
    # library yardstick: ONE index_add_ of the ADD channels into G+1 slots
    sel = live & (gid >= 0) & (gid < G)
    if count is not None:
        sel = sel & (torch.arange(n, device=gid.device) < count)
    g = torch.where(sel, gid.to(torch.int64), G)
    add_rows = [s for k, s in zip(kinds, sources) if k == gk.ADD]
    library_ms = None
    if add_rows:
        src = torch.stack([chans[s] for s in add_rows])
        acc = torch.zeros((src.shape[0], G + 1), dtype=src.dtype, device=src.device)
        library_ms = cuda_ms(lambda: acc.zero_().index_add_(1, g, src))
        del src, acc
    # least bytes: gid + live for every row, each data channel for the rows
    # this data selects, the (G, K) totals written once
    rows_used = int(sel.sum())
    d = len(chans)
    nbytes = n * (4 + 1) + (0 if count is None else 4) + rows_used * 8 * d + G * len(kinds) * 8
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    res = {
        "case": name, "n": n, "G": G, "K": len(kinds), "D": d, "dtype": str(got.dtype),
        "regime": regime, "blocks": blocks, "max_abs_err": max_err, "ms": ms,
        "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": bound_ms, "bytes": nbytes,
    }
    print("phase2", json.dumps(res), flush=True)
    if one_launch:
        one_launch_check(name, call)
    return res


def one_launch_check(name, call):
    """One warm groupby_totals call under torch.profiler: exactly one
    kernel launch (the launch count +1, one cudaLaunchKernel, one device
    kernel: no fold after it), no host<->device copy and no
    cudaStreamSynchronize. The one cudaDeviceSynchronize is the check's own,
    closing the window."""
    import torch

    from presto_tpu_torch.ops import groupby_kernel as gk

    gk.groupby_totals(*call)
    torch.cuda.synchronize()
    events, _, launched = _trace(lambda: gk.groupby_totals(*call), lambda: gk.launches)

    def count(pred):
        return _count_events(events, pred)

    device = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    res = {
        "case": name, "launches": launched,
        "cuda_launch_kernel": count(lambda e: e.key in _LAUNCH_KEYS),
        "device_events": {e.key[:60]: e.count for e in device},
        "memcpy": count(lambda e: "Memcpy" in e.key or e.key.startswith("cudaMemcpy")),
        "stream_syncs": count(lambda e: e.key == "cudaStreamSynchronize"),
        "device_syncs": count(lambda e: e.key == "cudaDeviceSynchronize"),
    }
    print("phase2 one_launch", json.dumps(res), flush=True)
    ours = sum(c for k, c in res["device_events"].items() if "groupby_" in k)
    if (res["launches"] != 1 or res["cuda_launch_kernel"] != 1 or ours != 1
            or sum(res["device_events"].values()) != 1 or res["memcpy"] or res["stream_syncs"]):
        raise AssertionError(f"{name}: a groupby_totals call is not one launch without copies "
                             f"or syncs: {res}")
    return res


# names of groupby_edge_cases' cases, in order
GROUPBY_EDGES = (
    "register_limit_g8_k8", "above_register_limit_g13_k5", "n1", "one_block_share",
    "one_block_share_plus_1", "one_block_share_plus_1_atomic", "count_below_n", "every_row_dead",
    "empty_group_min_max", "int64_sums_past_2^53", "min_max_int64_extremes", "f64_channel_list",
    "f64_g64_channel_list", "unaligned_odd_n",
)


def groupby_edge_cases(dev, n_big=1_000_000):
    """{name: (call, tolerance, expect)}: groupby_totals calls at the edges
    of the kernel's regimes and grid (see GROUPBY_EDGES), from a seed."""
    import numpy as np
    import torch

    from presto_tpu_torch.ops import groupby_kernel as gk

    rng = np.random.default_rng(23)
    dev = torch.device(dev)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def rows(n, G, live_p=0.9, groups=None):
        return (t(rng.integers(0, groups or G, n).astype(np.int32)), t(rng.random(n) < live_p))

    def ints(n, d, lo=-(1 << 40), hi=1 << 40):
        return [t(rng.integers(lo, hi, n)) for _ in range(d)]

    C, A, MN, MX = gk.COUNT, gk.ADD, gk.MIN, gk.MAX
    q1_kinds, q1_src = [C, A, A, A, A, A], [-1, 0, 1, 2, 3, 4]
    share = gk.ROWS_PER_BLOCK
    cases = {}
    cases["register_limit_g8_k8"] = (
        (*rows(n_big, 8), None, ints(n_big, 4), [C, A, MN, MX, C, A, MN, MX],
         [-1, 0, 1, 2, -1, 3, 0, 1], 8), exact, {"register": True})
    cases["above_register_limit_g13_k5"] = (
        (*rows(n_big, 13), None, ints(n_big, 4), [C, A, MN, MX, A], [-1, 0, 1, 2, 3], 13),
        exact, {"register": False})
    cases["n1"] = ((t(np.array([3], np.int32)), t(np.array([True])), None, ints(1, 5), q1_kinds,
                    q1_src, 6), exact, {"register": True, "blocks": 1})
    for name, n, G, kinds, src, expect in (
        ("one_block_share", share, 6, q1_kinds, q1_src, {"register": True, "blocks": 1}),
        ("one_block_share_plus_1", share + 1, 6, q1_kinds, q1_src,
         {"register": True, "blocks": 2}),
        ("one_block_share_plus_1_atomic", share + 1, 75, [C, A], [-1, 0],
         {"register": False, "blocks": 2}),
    ):
        cases[name] = ((*rows(n, G), None, ints(n, max(src) + 1), kinds, src, G), exact, expect)
    count = t(np.array(n_big // 3, np.int32)).reshape(())
    cases["count_below_n"] = ((*rows(n_big, 6), count, ints(n_big, 5), q1_kinds, q1_src, 6),
                              exact, {"register": True})
    cases["every_row_dead"] = ((*rows(n_big, 6, live_p=0.0), None, ints(n_big, 3),
                                [C, A, MN, MX], [-1, 0, 1, 2], 6), exact, None)
    cases["empty_group_min_max"] = ((*rows(n_big, 8, groups=7), None, ints(n_big, 2),
                                     [C, MN, MX], [-1, 0, 1], 8), exact, None)
    # 1M values in [2^40, 2^41) over 4 groups: each sum near 2^58
    cases["int64_sums_past_2^53"] = ((*rows(n_big, 4), None, ints(n_big, 2, 1 << 40, 1 << 41),
                                      [C, A, A], [-1, 0, 1], 4), exact, {"register": True})
    ext = rng.integers(-(1 << 63), (1 << 63) - 1, (2, n_big), dtype=np.int64, endpoint=True)
    ext[:, rng.integers(0, n_big, 64)] = np.iinfo(np.int64).min
    ext[:, rng.integers(0, n_big, 64)] = np.iinfo(np.int64).max
    cases["min_max_int64_extremes"] = ((*rows(n_big, 6), None, [t(ext[0]), t(ext[1])],
                                        [MN, MX, MN, MX], [0, 0, 1, 1], 6), exact, None)
    fx = [t(rng.normal(0.0, 1e3, n_big)) for _ in range(2)]
    cases["f64_channel_list"] = ((*rows(n_big, 6), None, fx, [A, A, C], [0, 1, -1], 6), f64_tol,
                                 {"register": True})
    cases["f64_g64_channel_list"] = ((*rows(n_big, 64), None, fx, [A, A, C], [0, 1, -1], 64),
                                     f64_tol, {"register": False})
    # odd n: rows of a (D, n) tensor are not 16-byte aligned, so the
    # kernel takes its one-row loads
    n = n_big + 1
    cases["unaligned_odd_n"] = ((*rows(n, 6), None, t(rng.integers(-(1 << 40), 1 << 40, (3, n))),
                                 [C, A, MN, MX], [-1, 0, 1, 2], 6), exact, None)
    assert tuple(cases) == GROUPBY_EDGES
    return cases


def phase2(q1_call):
    import numpy as np
    import torch

    from presto_tpu_torch.ops import groupby_kernel as gk

    results = [kernel_case("q1_sf1", q1_call, exact, {"register": True}, one_launch=True)]
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
    fx = torch.from_numpy(rng.normal(0.0, 1e3, (2, n))).to(dev)
    fcall = (gid, live, count, fx.contiguous(), [gk.ADD, gk.ADD], [0, 1], 64)
    results.append(kernel_case("g64_f64_sum", fcall, f64_tol))
    del gid, live, vals, fx, call, fcall
    for name, (call, tol, expect) in groupby_edge_cases(dev).items():
        results.append(kernel_case(name, call, tol, expect))
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
    the join_insert call and the first-match probe (`_probe_n1`) with the
    most live rows (with the query each came from), and Q5's and Q18's
    groupby_totals calls."""
    from presto_tpu_torch.benchmark.tpch_sql import QUERIES
    from presto_tpu_torch.ops import groupby_kernel as gk
    from presto_tpu_torch.ops import join_kernel as jk

    rec = {"insert": None, "probe": None, "q5_totals": [], "q18_totals": []}
    orig = jk.join_insert, jk._probe_n1, gk.groupby_totals
    cur = [None]

    def insert(h, live, bits):
        n_live = int(live.sum())
        if rec["insert"] is None or n_live > rec["insert"][2]:
            rec["insert"] = (cur[0], (h, live, bits), n_live)
        return orig[0](h, live, bits)

    def probe_n1(jt, h, live, prep):
        n_live = int(live.sum())
        if rec["probe"] is None or n_live > rec["probe"][2]:
            rec["probe"] = (cur[0], (jt, h, live, prep), n_live)
        return orig[1](jt, h, live, prep)

    def totals(*call):
        if cur[0] in (5, 18):
            rec[f"q{cur[0]}_totals"].append(call)
        return orig[2](*call)

    jk.join_insert, jk._probe_n1, gk.groupby_totals = insert, probe_n1, totals
    try:
        for q in queries:
            cur[0] = q
            sess.query(QUERIES[q]).rows()
    finally:
        jk.join_insert, jk._probe_n1, gk.groupby_totals = orig
    return rec


def _random_bytes(accesses, array_bytes):
    """Least bytes of `accesses` random reads or writes of at most 32 B
    into one array: a 32 B sector each, but never more than the array."""
    return min(32 * accesses, array_bytes)


def insert_bytes(live, bits, overflow):
    """Least bytes of one insert: each row's 1 B live flag and each live
    row's 8 B hash read once, the table and its counter set once by the
    memset (8 B a word), one random 32 B sector per inserted row (capped at
    the table's bytes) and 8 B per overflow pair written."""
    from presto_tpu_torch.ops import join_kernel as jk

    size = jk.table_size(bits)
    n_live = int(live.sum())
    return (live.shape[0] + 8 * n_live + 8 * (size + 1)
            + _random_bytes(n_live, 8 * size) + 8 * overflow)


def probe_bytes(h, live, slots, prep, matched):
    """Least bytes of one probe: each row's 1 B live flag read and 5 B of
    results written, each live row's 8 B hash and 1 B per nullable probe
    key read, once; one random 32 B slot sector per live row (capped at
    the table's bytes); per matched row, its probe key values and one
    random sector of each build key column and build validity mask (each
    capped at its bytes)."""
    m, n_live = h.shape[0], int(live.sum())
    nbytes = 6 * m + 8 * n_live + _random_bytes(n_live, 8 * slots.shape[0])
    k = int(matched.sum())
    for pd_, bd_, pvld, bvld in prep:
        nbytes += (n_live if pvld is not None else 0) + k * pd_[:1].numel() * pd_.element_size()
        nbytes += _random_bytes(k, bd_.numel() * bd_.element_size())
        if bvld is not None:
            nbytes += _random_bytes(k, bvld.numel())
    return nbytes


def passed_other_matches(slots, h, live, bits, got):
    """Rows whose scan met a tag match of another key before its own
    verified match (or its vacant slot): a probe with no keys stops at the
    first tag match, so those are the rows where it stopped elsewhere."""
    from presto_tpu_torch.ops import join_kernel as jk

    first, frow = jk.join_probe(slots, h, live, bits, [])
    return int((first & (~got[0] | (frow != got[1]))).sum())


def find_every_row(slots, overflow, last, h, live, bits):
    """Every inserted row looked up through the probe kernel by its own
    hash, with its row number as its key, so a row matches only its own
    slot. Returns (found: bool per row, True where the row was matched in
    the slot region or is an overflow pair and not both, and where
    live is false; rows whose scan passed another row's slot of their
    tag)."""
    import torch

    from presto_tpu_torch.ops import join_kernel as jk

    n = h.shape[0]
    ids = torch.arange(n, dtype=torch.int32, device=h.device)
    got = jk.join_probe(slots, h, live, bits, [(ids, ids, None, None)])
    over = torch.zeros(n, dtype=torch.bool, device=h.device)
    over[overflow[:int(last) + 1, 1].to(torch.int64)] = True
    found = ~live | (got[0] != over)
    return found, passed_other_matches(slots, h, live, bits, got)


def insert_case(name, h, live, bits):
    """join_insert (kernel) against join_insert_plain. Slot placement may
    differ between two correct inserts, so the two are compared by what a
    join sees: both held to the table invariants, and every inserted row
    looked up by its own hash through the probe kernel in each table.
    max_abs_err is the largest |found(kernel) - found(plain)| over the rows
    (found = 1 when the row's hash leads to it); times."""
    import torch

    from presto_tpu_torch.ops import join_kernel as jk

    got = jk.join_insert(h, live, bits)
    plain = jk.join_insert_plain(h, live, bits)
    torch.cuda.synchronize()
    errs = {label: jk.insert_invariant_errors(h, live, bits, *out)
            for label, out in (("kernel", got), ("plain", plain))}
    found, passed = find_every_row(*got, h, live, bits)
    found_plain, _ = find_every_row(*plain, h, live, bits)
    not_found = int((~found).sum()) + int((~found_plain).sum())
    max_err = int((found.to(torch.int32) - found_plain.to(torch.int32)).abs().max())
    if errs["kernel"] or errs["plain"] or not_found or max_err:
        raise AssertionError(f"{name}: invariants {errs}, rows not found by their hash "
                             f"{not_found}, found(kernel) vs found(plain) max err {max_err}")
    ms = cuda_ms(lambda: jk.join_insert(h, live, bits))
    plain_ms = cuda_ms(lambda: jk.join_insert_plain(h, live, bits), iters=3, warmup=1)
    overflow = int(got[2]) + 1
    nbytes = insert_bytes(live, bits, overflow)
    res = {"case": name, "n": h.shape[0], "bits": bits, "live": int(live.sum()),
           "overflow": overflow, "plain_overflow": int(plain[2]) + 1,
           "scans_past_other_rows": passed,
           "invariant_violations": len(errs["kernel"]) + len(errs["plain"]),
           "rows_not_found": not_found, "max_abs_err": float(max_err), "ms": ms,
           "plain_ms": plain_ms, "library_ms": None,
           "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bytes": nbytes}
    print("phase2", json.dumps(res), flush=True)
    return res, got


def probe_case(name, slots, h, live, bits, prep):
    """join_probe (kernel) against join_probe_plain on one table: matched
    and the build row exactly equal (the first verified match in slot
    order is one row whatever the build keys)."""
    import torch

    from presto_tpu_torch.ops import join_kernel as jk

    got = jk.join_probe(slots, h, live, bits, prep)
    want = jk.join_probe_plain(slots, h, live, bits, prep)
    torch.cuda.synchronize()
    err = max(int((a.to(torch.int64) - b.to(torch.int64)).abs().max()) if a.numel() else 0
              for a, b in zip(got, want))
    if err or not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
        raise AssertionError(f"{name}: probe kernel disagrees with its plain version")
    ms = cuda_ms(lambda: jk.join_probe(slots, h, live, bits, prep))
    plain_ms = cuda_ms(lambda: jk.join_probe_plain(slots, h, live, bits, prep), iters=5)
    nbytes = probe_bytes(h, live, slots, prep, got[0])
    res = {"case": name, "m": h.shape[0], "table_slots": slots.shape[0], "keys": len(prep),
           "key_dtypes": [str(k[1].dtype) + ("x2" if k[1].ndim == 2 else "") for k in prep],
           "matched": int(got[0].sum()),
           "scans_past_other_keys": passed_other_matches(slots, h, live, bits, got),
           "max_abs_err": float(err), "ms": ms, "plain_ms": plain_ms, "library_ms": None,
           "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bytes": nbytes}
    print("phase2", json.dumps(res), flush=True)
    return res


def probe_launch_check(name, jt, h, live, prep):
    """One warm `_probe_n1` on a table with no overflow region under
    torch.profiler: one kernel launch (the count +1, one cudaLaunchKernel,
    one device kernel), no memcpy and no cudaStreamSynchronize."""
    import torch

    from presto_tpu_torch.ops import join_kernel as jk

    if jt.of_tag.numel():
        raise AssertionError(f"{name}: the table has an overflow region")
    jk._probe_n1(jt, h, live, prep)
    torch.cuda.synchronize()
    events, _, launched = _trace(lambda: jk._probe_n1(jt, h, live, prep),
                                 lambda: jk.probe_launches)
    device = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    res = {"case": name, "launches": launched,
           "cuda_launch_kernel": _count_events(events, lambda e: e.key in _LAUNCH_KEYS),
           "device_events": {e.key[:60]: e.count for e in device},
           "memcpy": _count_events(events, lambda e: "Memcpy" in e.key
                                   or e.key.startswith("cudaMemcpy")),
           "stream_syncs": _count_events(events, lambda e: e.key == "cudaStreamSynchronize")}
    print("phase2 probe_one_launch", json.dumps(res), flush=True)
    ours = sum(c for k, c in res["device_events"].items() if "join_probe" in k)
    if (res["launches"] != 1 or res["cuda_launch_kernel"] != 1 or ours != 1
            or sum(res["device_events"].values()) != 1 or res["memcpy"] or res["stream_syncs"]):
        raise AssertionError(f"{name}: _probe_n1 is not one launch without copies or syncs: "
                             f"{res}")
    return res


def build_check(name, page, key_exprs):
    """One warm `build_table` under torch.profiler: one join_insert launch,
    no `nonzero`, and at most two device-to-host reads (the live count that
    sizes the table, the overflow count)."""
    import torch

    from presto_tpu_torch.ops import join_kernel as jk

    jk.build_table(page, key_exprs)
    torch.cuda.synchronize()
    events, jt, launched = _trace(lambda: jk.build_table(page, key_exprs),
                                  lambda: jk.insert_launches)
    res = {"case": name, "launches": launched,
           "overflow": jt.of_tag.numel(),
           "nonzero": _count_events(events, lambda e: e.key == "aten::nonzero"),
           "dtoh": _count_events(events, lambda e: e.device_type == torch.autograd.DeviceType.CUDA
                                 and "DtoH" in e.key),
           "device_launches": _count_events(
               events, lambda e: e.device_type == torch.autograd.DeviceType.CUDA)}
    print("phase2 build_check", json.dumps(res), flush=True)
    if res["launches"] != 1 or res["nonzero"] or res["dtoh"] > 2:
        raise AssertionError(f"{name}: build_table is not one insert launch with at most two "
                             f"host reads and no nonzero: {res}")
    return res


def _page(cols, device):
    """A Page on `device` from {name: (numpy data, sql type, valid or None,
    dictionary or None)}."""
    from presto_tpu_torch import types as T
    from presto_tpu_torch.page import Block, Page

    return Page.from_blocks([Block.from_numpy(d, T.parse_type(t), valid=v, dictionary=dic,
                                              device=device)
                             for d, t, v, dic in cols.values()], list(cols))


def join_case(name, bcols, pcols, keys, dev, inserts, probes, cpu_check=True, unique=True,
              probe_name=None):
    """One table join from numpy columns: join_insert against its plain
    version on the build keys, join_probe against its plain version on the
    probe keys (on the table build_table makes), and, with cpu_check,
    table_join_n1 on the card equal to the CPU: inner and semi where the
    build keys are unique (an n1 inner join takes THE match), else semi
    and anti. Returns (table, probe hashes, probe live mask, prepared
    keys)."""
    import torch

    from presto_tpu_torch import types as T
    from presto_tpu_torch.expr.ir import col
    from presto_tpu_torch.ops import join_kernel as jk
    from presto_tpu_torch.ops.hashing import hash_rows_values

    key_exprs = tuple(col(n, T.parse_type(t)) for n, t in keys)
    build, probe = _page(bcols, dev), _page(pcols, dev)
    bvals = [jk.evaluate(e, build) for e in key_exprs]
    live = build.live_mask()
    for v in bvals:
        if v.valid is not None:
            live = live & v.valid
    res, _ = insert_case(name, hash_rows_values(bvals), live, jk._pick_bits(int(build.count)))
    inserts.append(res)
    jt = jk.build_table(build, key_exprs)
    h, prep = jk._probe_setup(probe, jt, key_exprs)
    plive = probe.live_mask()
    probes.append(probe_case(probe_name or f"probe_{name}", jt.slots, h, plive, jt.bits, prep))
    if cpu_check:
        cpu = torch.device("cpu")
        cb, cp = _page(bcols, cpu), _page(pcols, cpu)
        cjt = jk.build_table(cb, key_exprs)
        out = list(bcols)[-1]
        kinds = ((("inner", (out,), (f"build_{out}",)), ("semi", (), ())) if unique
                 else (("semi", (), ()), ("anti", (), ())))
        for kind, names, outs in kinds:
            got = jk.table_join_n1(probe, jt, key_exprs, names, outs, kind)
            want = jk.table_join_n1(cp, cjt, key_exprs, names, outs, kind)
            rows = sorted(map(repr, want.to_pylist()))
            if sorted(map(repr, got.to_pylist())) != rows or not rows:
                raise AssertionError(f"{name}: {kind} table join on the card differs from the "
                                     f"CPU (or is empty)")
        print(f"phase2 {name} join rows={int(got.count)} equal to the CPU", flush=True)
    return jt, h, plive, prep


def colliding_keys(n_pairs, dev):
    """int64 key pairs (a, b), a != b, whose 32-bit tags are equal: from the
    hashes of 2^21 candidate keys (about 500 colliding pairs by the birthday
    bound), at most n_pairs of them."""
    import torch

    from presto_tpu_torch.ops import join_kernel as jk
    from presto_tpu_torch.ops.hashing import hash_column

    cand = torch.arange(1 << 21, dtype=torch.int64, device=dev) * 7919 + 1_000_003
    tag, _ = jk._tag_desired(hash_column(cand), jk._MAX_BITS)
    order = torch.argsort(tag)
    st = tag[order]
    at = torch.nonzero(st[1:] == st[:-1]).flatten()[:n_pairs]
    return cand[order[at]], cand[order[at + 1]]


def join_phase2(sess, dev="cuda", n_max=None, m_max=6_000_859, n_small=100_000):
    """The join kernels against their plain versions: the largest calls
    the four queries make, the top of the table path's range (a build of
    n_max rows, TABLE_MAX_BUILD by default, probed by m_max rows), a skewed
    key with colliding tags, varchar keys in two dictionaries, a composite
    key, a float64 key with -0.0 and NaN and a long-decimal key (n_small
    build rows each), and the host work of `_probe_n1` and `build_table`.
    Returns (insert results, probe results, launch checks, group-by results
    at Q18's hash-slot call and Q5's dense call)."""
    import numpy as np
    import torch

    from presto_tpu_torch.ops import join_kernel as jk

    dev = torch.device(dev)
    rec = capture_calls(sess)
    q_ins, (h, live, bits), n_live = rec["insert"]
    q_pr, (jt, ph, plive, prep), _ = rec["probe"]
    # the hash-slot group-by call of Q18's outer aggregate, and Q5's dense
    # call (revenue by nation, G 25)
    (call,) = rec["q18_totals"]
    groupby = [kernel_case("q18_hash_slot", call, exact, {"register": False, "blocks": 1},
                           one_launch=True)]
    (call,) = rec["q5_totals"]
    groupby.append(kernel_case("q5_dense", call, exact, {"register": True}, one_launch=True))
    print(f"phase2 largest build: Q{q_ins} n={h.shape[0]} live={n_live} bits={bits}; largest "
          f"n1 probe: Q{q_pr} m={ph.shape[0]} live={int(plive.sum())} table slots="
          f"{jt.slots.shape[0]}", flush=True)
    inserts = [insert_case(f"largest_build_q{q_ins}", h, live, bits)[0]]
    probes = [probe_case(f"largest_probe_q{q_pr}", jt.slots, ph, plive, jt.bits, prep)]
    checks = [probe_launch_check(f"largest_probe_q{q_pr}", jt, ph, plive, prep)]
    rng = np.random.default_rng(11)
    nq = h.shape[0]
    # build_table's host work, checked last (after every one-launch check)
    builds = [(f"build_{nq}_rows", _page({"k": (rng.permutation(nq).astype(np.int64) * 7 + 3,
                                                "bigint", None, None)}, dev),
               (_key("k", "bigint"),))]

    # the top of the table path: TABLE_MAX_BUILD distinct keys (bits 23),
    # probed by 6,000,859 rows of which about half match
    n, m = n_max or jk.TABLE_MAX_BUILD, m_max
    keys = rng.permutation(n).astype(np.int64) * 7 + 3
    pkeys = keys[rng.integers(0, n, m)] + np.where(rng.random(m) < 0.5, 1 << 40, 0)
    big = join_case("max_build_4M", {"k": (keys, "bigint", None, None)},
                    {"k": (pkeys, "bigint", None, None)}, [("k", "bigint")], dev, inserts,
                    probes, cpu_check=False, probe_name="probe_6M_half_match")
    checks.append(probe_launch_check("probe_6M_half_match", *big))
    del big

    # skew: one key repeated ~1,000 times among n_small rows (rows overflow,
    # rows of that key scan past each other), and key pairs with equal
    # tags (probes scan past the other key's slot)
    a, b = (x.cpu().numpy() for x in colliding_keys(400, dev))
    n = n_small
    bk = np.where(rng.random(n) < 0.01, 7, rng.permutation(n) * 11 + 100)
    bk[:2 * len(a)] = np.concatenate([a, b])
    pk = np.concatenate([bk, rng.integers(0, 11 * n, n)])
    skew = {"k": (bk, "bigint", None, None), "v": (np.arange(n), "bigint", None, None)}
    join_case("skew_key_x1000", skew, {"k": (pk, "bigint", None, None)}, [("k", "bigint")], dev,
              inserts, probes, unique=False)
    if (inserts[-1]["overflow"] == 0 or inserts[-1]["scans_past_other_rows"] == 0
            or probes[-1]["scans_past_other_keys"] == 0):
        raise AssertionError("the skew case did not overflow, or no scan passed another "
                             "row's or key's tag match")
    builds.append(("build_skew_with_overflow", _page(skew, dev), (_key("k", "bigint"),)))

    # varchar keys in two dictionaries
    bdict = tuple(f"key{i:07d}" for i in range(n_small))
    pdict = tuple(sorted(f"key{i:07d}" for i in range(n_small // 2, 3 * n_small // 2)))
    join_case("varchar_key",
              {"k": (rng.permutation(len(bdict)).astype(np.int32), "varchar", None, bdict),
               "v": (np.arange(len(bdict)), "bigint", None, None)},
              {"k": (rng.integers(0, len(pdict), 3 * n_small).astype(np.int32), "varchar",
                     rng.random(3 * n_small) > 0.05, pdict)},
              [("k", "varchar")], dev, inserts, probes)

    # a composite key (bigint, integer with NULLs on both sides), unique
    perm = rng.permutation(n_small)
    ka, kb = perm // 4, (perm % 4).astype(np.int32)
    m = 3 * n_small
    join_case("composite_key",
              {"a": (ka.astype(np.int64), "bigint", None, None),
               "b": (kb, "integer", rng.random(n_small) > 0.05, None)},
              {"a": (rng.integers(0, n_small // 3, m), "bigint", None, None),
               "b": (rng.integers(0, 5, m).astype(np.int32), "integer", rng.random(m) > 0.05,
                     None)},
              [("a", "bigint"), ("b", "integer")], dev, inserts, probes)

    # float64 keys with -0.0, NaN and infinities
    fb = rng.permutation(n_small) * 0.25 - 99.875  # unique, none of them 0
    fb[:4] = [-0.0, np.nan, np.inf, np.nan]
    fp = fb[rng.integers(4, n_small, m)] + np.where(rng.random(m) < 0.5, 0.0, 0.0625)
    fp[:6] = [0.0, -0.0, np.nan, np.inf, -np.inf, np.nan]
    join_case("float64_key", {"k": (fb, "double", None, None)},
              {"k": (fp, "double", None, None)}, [("k", "double")], dev, inserts, probes)

    # long decimals: two int64 lanes; probes that share the low lane only
    lanes = np.stack([rng.integers(-3, 3, n_small),
                      rng.permutation(n_small).astype(np.int64) * 1_000_003], 1)
    plan = lanes[rng.integers(0, n_small, m)].copy()
    plan[::3, 0] += 1
    join_case("long_decimal_key",
              {"k": (lanes, "decimal(38,2)", rng.random(n_small) > 0.05, None)},
              {"k": (plan, "decimal(38,2)", None, None)}, [("k", "decimal(38,2)")], dev,
              inserts, probes)

    checks += [build_check(*args) for args in builds]
    return inserts, probes, checks, groupby


def _key(name, typ):
    from presto_tpu_torch import types as T
    from presto_tpu_torch.expr.ir import col

    return col(name, T.parse_type(typ))


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
    `warm_ms[label]`, the kernels that took the device time, and the host
    syncs: `host_syncs` counts device-to-host copies (as in PR 3's
    records), `htod_copies` host-to-device copies, and `stream_syncs` the
    CPU-side cudaStreamSynchronize / cudaDeviceSynchronize calls, less the
    one that closes the profiled window. The full table goes to
    <out_dir>/profile_<label>.txt."""
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
                for k in ("groupby_tile_kernel", "groupby_atomic_kernel", "join_insert_kernel",
                          "join_probe_kernel", "q1_partials_kernel")}
        syncs = sum(e.count for e in events
                    if e.key in ("cudaStreamSynchronize", "cudaDeviceSynchronize"))
        print(f"profile {label}", json.dumps({
            "profiled_wall_ms": wall_ms, "warm_wall_ms": warm_ms[label],
            "device_busy_ms": busy_ms,
            "idle_share_of_warm_wall": 1.0 - busy_ms / warm_ms[label],
            "device_launches": sum(e.count for e in device),
            "host_syncs": sum(e.count for e in device if "DtoH" in e.key),
            "htod_copies": sum(e.count for e in device if "HtoD" in e.key),
            "stream_syncs": syncs - 1,
            "our_kernels_device_ms": ours,
            "top_device_ms": {e.key[:70]: dev_us(e) / 1e3 for e in top},
        }), flush=True)
        with open(os.path.join(out_dir, f"profile_{label}.txt"), "w") as f:
            f.write(events.table(sort_by="self_cuda_time_total", row_limit=40))


def check_params_layout():
    """The kernels' parameter structs as the card's build lays them out
    (sizeof, then each field's offset): the group-by kernel's
    GroupbyParams, the join kernels' InsertParams and ProbeParams (with
    ProbeKey), each against the ctypes struct that packs it."""
    import ctypes

    from presto_tpu_torch.ops import groupby_kernel as gk
    from presto_tpu_torch.ops import join_kernel as jk

    want = [ctypes.sizeof(gk.GroupbyParams)] + [
        getattr(gk.GroupbyParams, f).offset for f, _ in gk.GroupbyParams._fields_]
    layouts = {"GroupbyParams": (gk.params_layout(), want)}
    for name in ("join_insert", "join_probe"):
        layouts[name] = (jk.params_layout(name), jk.ctypes_layout(name))
    for name, (got, want) in layouts.items():
        print(f"phase1 {name} params layout (size, offsets) {got}", flush=True)
        if got != want:
            raise AssertionError(f"{name}: C layout {got} != ctypes {want}")


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
            if any(w in line for w in ("Compiling entry", "registers", "spill")) or (
                    "error" in line.lower()):
                print(f"phase1 {name}: {line.strip()}")
    print(f"phase1 built {len(logs)} kernel libraries in {secs:.3f} s", flush=True)
    check_params_layout()

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
    for q in (1, 5, 18):
        if per_query[q]["groupby_partials"] < 1:
            raise AssertionError(f"Q{q} did not launch the groupby kernel")
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
    inserts, probes, launch_checks, groupby = join_phase2(sess)
    cases += groupby
    q1_cases = q1_phase2(q1_page)
    print(f"phase2 done in {time.perf_counter() - t0:.3f} s", flush=True)

    args = sys.argv[1:]
    if "--profile" in args:
        from presto_tpu_torch.benchmark import handcoded
        from presto_tpu_torch.benchmark.tpch_sql import QUERIES

        out_dir = args[args.index("--profile-dir") + 1] if "--profile-dir" in args else "profile_out"
        runs = {f"Q{q}": (lambda q=q: sess.query(QUERIES[q]).rows()) for q in (1, 6, 3, 5, 18)}
        warm = {f"Q{q}": report[q]["warm_ms"] for q in (1, 6, 3, 5, 18)}
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
              "|found(kernel) - found(plain)| of each row looked up by its own hash"),
        entry("join_probe", "presto_tpu_torch/csrc/join_probe.cu",
              "presto_tpu/ops/pallas_join.py:452", probes[0], probes,
              "matched and build row (first verified match) against the plain version on "
              f"the same table; _probe_n1 one launch, no copy or sync in "
              f"{len([c for c in launch_checks if 'cuda_launch_kernel' in c])} checks"),
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
