"""On-card smoke run of presto_tpu_torch, the PyTorch/CUDA port.

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py [--profile [--profile-dir DIR]]

Phase 1 builds every CUDA kernel of the package from csrc/ (nvcc, sm_90a),
one nvcc per source, all started together, prints ptxas's registers and
spills of every kernel instance, and checks the kernels' parameter
structs as the build lays them out against their ctypes twins (group-by,
join insert and probe, fused Q1).
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
launched the fused-Q1 kernel, once a run.
Then this slice's two phase-3 paths, on the same SF 1 session: `tpch22`,
all 22 TPC-H queries and a Q20 variant (Q20 selects nothing over this
generator, see q20_variant) each held against the same query through the
port on the CPU over the same host tables (doubles within the tolerance
of presto_tpu/testing/oracle.py, copied in row_diff; everything else
exactly), with rows, kernel launches, cold and warm wall and the CPU's
time per query; and `analytic`, windows over all of lineitem (W1) and
orders (W2) and over an aggregate of two joins (W3), INTERSECT and EXCEPT
(S1), ROLLUP with grouping() (R1), stddev/variance/skewness (M1) and
TABLESAMPLE BERNOULLI (T1, its count from the plan's seed through a
numpy splitmix64), each held against an independent numpy computation.
Both paths must launch kernels 1-3. One warm run of each of their
queries is then traced (device busy time, idle share, launches,
device-to-host reads).
Then `coordinator`, the control plane on the same session: a
CoordinatorServer over it (wrapped over SystemCatalog, one query at a
time) and a Client; the 23 `tpch22` texts through POST /v1/statement and
their nextUri pages, cold then warm, each held to the `tpch22` card rows
as the JSON carries them, with warm ms against `tpch22`'s, phase ms and
trace id; the 9-key self-join of lineitem and its EXISTS form (past the
probe kernel's 8 keys), each lineitem's row count; with the admission
gate shut, a query waiting in the resource group's queue, the next
rejected (queue full) and the waiting one cancelled by DELETE; reads of
system.runtime.queries, tasks and metrics that find the texts just run;
EXPLAIN ANALYZE of Q5 with its `-- trace:` and `-- kernels:` footers,
every launch of kernels 1-3 timed by a CUDA-event pair. The path must
launch kernels 1-3. Then the cost of tracing (`phase3 coordinator
trace`): Q1, Q3, Q5, Q10, Q18 and Q21 warm with PRESTO_TPU_TRACE=0 and
=1 alternating, two runs of each, and Q5's host syncs under
torch.cuda.set_sync_debug_mode with tracing on and off, which must be
equal.
After `coordinator`, the `http22` worker processes and the CPU pool of
`tpcds` start, and run beside every path from `streaming22` to `http22`.
Then the streaming executor's paths (exec/stream.py): `streaming22`, the
same 23 texts through a streaming session over the same catalog under a
12 MiB device budget, each run once and held to the `tpch22` card rows (the outer
joins of Q13, Q20 and the variant raise MemoryExceededError past the
budget and rerun at 4x; a raise anywhere else fails), with its
spill tags, disk bytes, hybrid parts, pool.peak and the card's peak
allocation; then the overlap check, `tpch22`'s texts warm again on the
same session beside the pool and the workers (both sums, per text, and
the host's load average after `tpch22` and now); then `sf10`, scale.QUERIES q6/q1/q3/q5/q17/q18 streamed from
ChunkedTpchCatalog(10) (batches generated on the card) under 512 MiB,
each held to numpy over the same columns generated on the host (in a
process spawned at the start), with the card's peak allocation below the
bytes of the lineitem columns it reads. Both launch kernels 1-3.
Then `files22`, the storage connectors on the card: the eight tables of
the TPC-H SF 1 catalog copied to the host once and written into a Hive
warehouse (Parquet; orders and lineitem bucketed on the order key into 8
buckets, lineitem_by_mode partitioned by l_shipmode into 7), with its
bytes on disk and write seconds; a catalog directory (hive, blackhole,
sqlite with nation and region) loaded by `load_catalog_store(dir,
device="cuda")`; after `USE hive.default` the 22 texts and the Q20
variant, each planned once on cold column stats (first plan ms) then run
cold and warm, held to the `tpch22` card rows in order, with launches of
kernels 1-3 (all three required); a cross-catalog join of
sqlite.default.nation and hive.default.customer against the TPC-H
session; on a Session over the HiveCatalog itself, a streamed Q12 with
`l_shipmode = 'MAIL'` over lineitem_by_mode (EXPLAIN ANALYZE `files: 1
read, 6 pruned`) and a streamed orders-lineitem join grouped over both
sides that takes `grouped_bucket_join` under 16 MiB (below the card
bytes of the whole orders build, above its largest bucket's, both
measured), both against the TPC-H session (whose rows are computed
before the path's counts are set to 0), and Q1 and Q6 timed with scans
that read only their columns against whole pages; a CTAS of Q1 into the
warehouse read back through the store after USE, an INSERT of lineitem
into a blackhole table (6,000,859 rows reported); lineitem as
RCFile (Q1, Q6), customer, orders and lineitem as ORC and as shard-store
shards (Q3; organize() keeps the rows and table_version), customer as
CSV (Q10's customers' columns against the TPC-H session).
Then `matview`: a ShardStoreCatalog on the card holding orders, customer,
nation, region and lineitem's first 90 % of rows (each with its TPC-H
primary key declared), three materialized views (V1 Q1 with its mergeable
aggregates, the aggregate kind; V2 a filtered projection of lineitem, the
append kind; V3 Q3's join and group-by, recompute-only), then the other
10 % of lineitem in 2 append_batch calls of 4 pages each; after each,
V1's and V2's texts run fresh (the shard store's per-version work paid
there), REFRESH of the three (V1 and V2 delta, V3 full with its reason), each
view against numpy over the rows ingested so far (decimals exact),
REFRESH FULL of V1 and V2 equal to their delta-maintained rows, and V1's
text through the result cache patched (patches + 1) and equal to a run
without the cache, with append, refresh and lookup walls and launches a
batch; then the fallbacks: an upsert of 4 rows (after an observed query
with feedback on, every history entry over lineitem invalidated) and a
batch past DELTA_MAX_FRAC refresh in full with the rewrite reason, and
organize() keeps every table_version while a later delta refresh works.
The path must launch kernels 1-3. Then `feedback`, with
PRESTO_TPU_FEEDBACK=1 for it only: the 23 `tpch22` texts twice on the SF 1
session (the first run observing, the second planned from the
observations), both held to the `tpch22` card rows in order, the plans
that changed counted, EXPLAIN ANALYZE of Q5 with `-- feedback:` hits > 0;
then Q18 at the streaming budget and Q9 at 6 MiB streamed twice, each
from an empty store, every join frame that recursed in the first run
starting the second with its partitions times 2^depth (at most 64). It
must launch kernels 2 and 3.
Then `dist22`, distributed execution over default_mesh(8): eight logical
workers, all on the one card, driven by one process (exec/dist.py over
plan/fragment.py's plans): the 23 `tpch22` texts under the cost-based
join distribution and Q3, Q5, Q10, Q17 and Q18 with every join
repartitioned, each cold then warm and held to the `tpch22` card rows (in
order under ORDER BY, as multisets otherwise), a line per text with the
launches of kernels 1-3, the host syncs torch reports under
torch.cuda.set_sync_debug_mode and the exchange (repartitions, rows, host
ms to the count reads); then the JAX package's dryrun_multichip checks:
the sort in order, approx_percentile within its sketch bound of the
single-device value, Q3 with every join bucketed under a 50,000-byte
exchange budget, Q3 with PRESTO_TPU_DYNFILTER_FORCE=1 pruning rows; NOT IN
(N1, N2) over TpcdsCatalog(1.0) through a mesh session against numpy;
handcoded.q1_distributed over the benchmark path's lineitem page against
its numpy Q1. Kernels 2 and 3 must launch in both regimes, in Q3 each.
Then `http22`, the HTTP cluster data plane: two worker processes, each
started after `tpch22` as `chip_smoke.py --http-worker 1.0` (a
WorkerServer over its own TpchCatalog(1.0) on cuda:0, generated and
uploaded while the paths before `http22` run, which stops and prints its kernel
launch counts when its standard input closes), and an HttpClusterSession
in this process over the TPC-H session's catalog: the 23 `tpch22` texts
under the cost-based distribution and Q3, Q5, Q10, Q17 and Q18 with every
join repartitioned through the hierarchical exchange, each cold then warm
and held to the `tpch22` card rows, with warm ms against `tpch22`'s, wire
bytes, pages, exchange and task ms and device-to-host copies a text, and
Q5's ragged pages and their bytes; the repartitioned Q5 and the
cost-based Q10 served through a CoordinatorServer over those sessions
and held to the `tpch22` card rows, each stage's consumer wait from the
merged trace split into the pullers' HTTP and decode walls and the
producers' executor, emit and encode walls and their results handlers'
serving walls (wait_split), and one worker's /v1/metrics holding the
exchange and kernel series; lineitem's SF 1 page through the wire onto
the card under each codec and PTP1, equal to the page, with bytes, ratio,
ms each way and copies a page; then, on a small in-process cluster on the
card (SF 0.01), Q5 beside a fault_rate=1.0 worker equal to the CPU's rows
with the retries seen, and a query past a worker's memory_limit killed
with the structured "ran out of memory" TaskFailure and the pools at 0.
Kernels 1-3 must launch in the worker processes; a worker that dies or
exits non-zero fails the run.
Then the TPC-DS paths, over `TpcdsCatalog(1.0)` on the card: `tpcds`, the
103 TPC-DS texts, each cold then warm, each run held against the
same text through the port on the CPU (computed by CPU_WORKERS spawned
processes, started after `tpch22`, over tables generated from the same
seeds; rows in order, as
`tpch22`), with rows, launches of kernels 1-3, walls and the CPU's
time per text, the weak checks listed (no rows, or a ROLLUP with only its
grand-total row), a summary line, and kernels 1-3 required; `functions`,
one SELECT per family of the scalar function library (FUNCTION_SQL) held
against the CPU over the same host tables; `not_in` (NOT_IN_SQL, NOT IN
over a nullable key, against numpy). One warm run of each of the
TRACE_TPCDS_TEXTS `tpcds` texts with the slowest warm walls and of every
`functions` family is traced in a
new process (`start_traces`), while the CPU side finishes.
Then `collections` on the TPC-H SF 1 session (COLLECTION_SQL): ARRAY and
MAP values, C1 array_agg into 10,000 suppliers (the collection-width
retry 128 -> 1,024, required) unnested back with ordinality, C2 the map
aggregates over customer join orders read back by the map functions, C3
lambdas over ~100,000 per-customer arrays, C4 split and unnest with
ordinality over part with the array functions, C5 a regression per
return flag and C5r its models applied to lineitem, C6 a nested-loop
spatial join of 25 triangles and 150,000 points, C7 the 11 CDFs and the
sketch states as rows, each cold then twice warm and held against the
same text through the port on the CPU (computed in the `tpcds` pool),
C1, C5 and C6 also against numpy; the path must launch kernels 2 and 3,
and one warm run of each text is traced with the others.
Then `statements`, the statement layer: statement_steps() (S1 a CTAS of
Q1's sums; S2 a CTAS of orders joined to customer, 1,500,000 rows; S3 an
INSERT ... SELECT with a join and a date filter; S4 a DELETE with an IN
subquery over lineitem; S5 ALTER TABLE add, rename and drop column; S6 a
transaction rolled back and one committed; S7 PREPARE and EXECUTE, the
second value rebinding the plan skeleton and the repeated one served by
the result cache with no launch; S8 SET SESSION pallas_groupby and
dynamic_filtering with EXPLAIN ANALYZE of Q1 and Q5; S10 SHOW STATS,
FUNCTIONS and SESSION; S11 GRANT and REVOKE under an access control) twice
on the card, each time over a new MemoryCatalog of the TPC-H session's
pages, every statement held against the same sequence through the port
on the CPU (in the `tpcds` pool) and S2-S4, S6 and S8 against numpy;
then S9, EXPLAIN ANALYZE of Q5 on the TPC-H session, its per-node rows
against the CPU's, and traced in the trace process beside plain Q5 (at
most 2 device-to-host copies more). One `phase3 statements` line a step
(statements, rows, launches of kernels 1-4, cold and warm ms, the CPU's
ms) and a summary line; the path must launch kernels 1-3.
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
`nonzero` and at most two host reads; the fused-Q1 kernel on the SF 1 page
(where, under torch.profiler, a warm q1_sums call is one launch with no
copy or stream synchronise), on SF 10's 60,000,000 rows generated on the
card, with a count below capacity and a cutoff that empties groups, on a
case whose sum of charge passes 2^63 (also held to exact Python-int
totals), and at the edges of its loads and grid (Q1_EDGES: unaligned
columns, a partial last step, fewer rows than a block's step, count 0,
count past n), each call raising the launch count by one; and kernels 1-3
at the largest calls the TPC-DS texts make (capture_calls: the
largest build and first-match probe, and the largest group-by whose keys
hold NULLs). It times the kernel, the plain
version, one PyTorch library call where one computes the same function,
and the byte bound. The torch.profiler checks of phase 2 (one launch, no
copy or synchronise) are gathered with their inputs and made together
in one new process (`launch_checks_in_child`).
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


def _complete(events):
    """Whether a traced window holds a device record for every launch and
    copy: torch.profiler at times drops device records (a kernel, a
    copy), so a window with fewer device kernels than cudaLaunchKernel
    calls, or fewer device copies than cudaMemcpy calls, is incomplete."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    copies = _count_events(events, lambda e: e.device_type == cuda and "Memcpy" in e.key)
    kernels = _count_events(events, lambda e: e.device_type == cuda
                            and "Memcpy" not in e.key and "Memset" not in e.key)
    return (kernels >= _count_events(events, lambda e: e.key in _LAUNCH_KEYS)
            and copies >= _count_events(events, lambda e: e.key in _MEMCPY_KEYS))


def _trace(fn, counter, tries=3):
    """(key_averages, fn's result, the increase of counter()) of one call
    of fn under torch.profiler, synchronised; an incomplete window
    (_complete) is traced again, at most `tries` times in all."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(tries):
        before = counter()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            out = fn()
            torch.cuda.synchronize()
        events = prof.key_averages()
        if _complete(events):
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


def kernel_case(name, call, tol_fn, expect=None, checks=None):
    """Compare groupby_totals (kernel) with groupby_totals_plain on one
    call's inputs; `expect` may hold the "register" regime (True/False)
    and "blocks" the launch must take; a `checks` list gathers this
    call's one_launch_check (see launch_checks_in_child). Returns a
    result dict."""
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
    if checks is not None:
        checks.append(("one_launch", name, (call,)))
    return res


def one_launch_check(name, call, kernel="groupby_partials"):
    """One warm call of `kernel`'s wrapper (groupby_totals, or q1_sums for
    "q1_partials") under torch.profiler: exactly one kernel launch (the
    launch count +1, one cudaLaunchKernel, one device kernel: no fold after
    it), no host<->device copy and no cudaStreamSynchronize. The one
    cudaDeviceSynchronize is the check's own, closing the window."""
    import torch

    from presto_tpu_torch.ops import agg_kernel as ak
    from presto_tpu_torch.ops import groupby_kernel as gk

    fn, counter, symbol = {
        "groupby_partials": (gk.groupby_totals, lambda: gk.launches, "groupby_"),
        "q1_partials": (ak.q1_sums, lambda: ak.launches, "q1_partials_kernel"),
    }[kernel]
    fn(*call)
    torch.cuda.synchronize()
    events, _, launched = _trace(lambda: fn(*call), counter)

    def count(pred):
        return _count_events(events, pred)

    device = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    res = {
        "case": name, "kernel": kernel, "launches": launched,
        "cuda_launch_kernel": count(lambda e: e.key in _LAUNCH_KEYS),
        "device_events": {e.key[:60]: e.count for e in device},
        "memcpy": count(lambda e: "Memcpy" in e.key or e.key.startswith("cudaMemcpy")),
        "stream_syncs": count(lambda e: e.key == "cudaStreamSynchronize"),
        "device_syncs": count(lambda e: e.key == "cudaDeviceSynchronize"),
    }
    print("phase2 one_launch", json.dumps(res), flush=True)
    ours = sum(c for k, c in res["device_events"].items() if symbol in k)
    if (res["launches"] != 1 or res["cuda_launch_kernel"] != 1 or ours != 1
            or sum(res["device_events"].values()) != 1 or res["memcpy"] or res["stream_syncs"]):
        raise AssertionError(f"{name}: a {kernel} call is not one launch without copies "
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


def phase2(q1_call, checks):
    import numpy as np
    import torch

    from presto_tpu_torch.ops import groupby_kernel as gk

    results = [kernel_case("q1_sf1", q1_call, exact, {"register": True}, checks=checks)]
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




# -- row comparison (the port on the card against the port on the CPU, and
# the port against the JAX package in the tests) --------------------------


def _value_close(a, b, tol=1e-6):
    """presto_tpu/testing/oracle.py's tolerance for two doubles, copied:
    an absolute 1e-6 or a relative 1e-9, whichever is larger."""
    return abs(a - b) <= max(tol, 1e-9 * max(abs(a), abs(b)))


def _row_key(row):
    from decimal import Decimal

    out = []
    for v in row:
        if v is None:
            out.append((0, ""))
        elif isinstance(v, (int, float, Decimal)):
            out.append((1, round(float(v), 4)))
        else:
            out.append((2, str(v)))
    return tuple(out)


def row_diff(got, want, ordered=True):
    """None when the rows agree, else the first difference: doubles within
    the oracle's tolerance, every other value (integers, decimals, dates,
    strings, NULL) exactly and of the same Python type. Unordered rows are
    sorted first."""
    if not ordered:
        got, want = sorted(got, key=_row_key), sorted(want, key=_row_key)
    if len(got) != len(want):
        return f"{len(got)} rows != {len(want)}: {got[:3]} / {want[:3]}"
    for i, (g, w) in enumerate(zip(got, want)):
        if len(g) != len(w) or not all(same_value(a, b) for a, b in zip(g, w)):
            return f"row {i}: {g} != {w}"
    return None


def same_value(a, b) -> bool:
    """row_diff's equality of one value: doubles within the oracle's
    tolerance (NaN equal to NaN), every other value exactly and of the same
    Python type; lists element by element in order, dicts key by key."""
    import math

    if isinstance(a, float) and isinstance(b, float):
        return (math.isnan(a) and math.isnan(b)) or _value_close(a, b)
    if isinstance(a, list) and isinstance(b, list):
        return len(a) == len(b) and all(same_value(x, y) for x, y in zip(a, b))
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(same_value(a[k], b[k]) for k in a)
    return type(a) is type(b) and a == b


def q20_variant(text):
    """TPC-H Q20 with `p_name like '%forest%'`: the generator draws
    p_name's first word from the first 24 colours, which do not hold
    'forest', so Q20 itself selects no part at any scale factor (and no
    widening of its date range can change that)."""
    assert "'forest%'" in text
    return text.replace("'forest%'", "'%forest%'")


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
    generated and uploaded (set-up, not query time); without the result
    cache, so every warm run executes (the `statements` path exercises it)."""
    import torch

    from presto_tpu_torch.connectors.tpch import TpchCatalog
    from presto_tpu_torch.session import Session

    t0 = time.perf_counter()
    cat = TpchCatalog(sf, device=device)
    for name in TPCH_TABLES + ("partsupp",):
        cat.page(name)
    if device == "cuda":
        torch.cuda.synchronize()
    print(f"tables {TPCH_TABLES + ('partsupp',)} generated+uploaded in {time.perf_counter() - t0:.3f} s "
          f"(lineitem rows={cat.exact_row_count('lineitem')})", flush=True)
    return Session(cat, device=device, result_cache=False), cat


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


# -- phase 3: all 22 TPC-H queries, and the analytic set --------------------

# the analytic set: windows, set operations, grouping sets, moments and
# TABLESAMPLE at full SF 1, each held against an independent numpy
# computation over the host tables (ANALYTIC_CHECKS)
W_SPEC = "partition by l_orderkey order by l_extendedprice desc, l_linenumber"
O_SPEC = "partition by o_custkey order by o_orderdate, o_orderkey"
S1_SQL = ("select c_custkey from customer where c_mktsegment = 'BUILDING' {op} "
          "select o_custkey from orders where o_orderdate >= date '1995-01-01' "
          "and o_orderdate < date '1996-01-01'")
ANALYTIC_SQL = {
    "W1": (f"select l_orderkey, l_linenumber, row_number() over ({W_SPEC}) rn, "
           f"rank() over ({W_SPEC}) rk, sum(l_quantity) over ({W_SPEC}) s from lineitem"),
    "W2": (f"select o_orderkey, sum(o_totalprice) over ({O_SPEC} rows between 2 preceding "
           f"and current row) s3, lag(o_totalprice) over ({O_SPEC}) prev from orders"),
    # a window over an aggregate over two joins (kernels 1-3 on this path)
    "W3": ("select n_name, o_orderpriority, c, rank() over (partition by n_name order by c desc) "
           "rk from (select n_name, o_orderpriority, count(*) c from orders "
           "join customer on o_custkey = c_custkey join nation on c_nationkey = n_nationkey "
           "group by n_name, o_orderpriority) t"),
    "S1_intersect": S1_SQL.format(op="intersect"),
    "S1_except": S1_SQL.format(op="except"),
    "R1": ("select l_returnflag, l_linestatus, grouping(l_returnflag, l_linestatus) g, "
           "sum(l_quantity) q, count(*) c from lineitem "
           "group by rollup(l_returnflag, l_linestatus)"),
    "M1": ("select l_returnflag, stddev(l_extendedprice) sd, variance(l_discount) vr, "
           "skewness(l_quantity) sk from lineitem group by l_returnflag"),
    "T1": "select count(*) c, sum(l_quantity) q from lineitem tablesample bernoulli (10)",
}
# the queries whose whole result is checked as columns (millions of rows),
# with the columns that order their rows
COLUMN_RESULTS = {"W1": ("l_orderkey", "l_linenumber"), "W2": ("o_orderkey",)}
T1_SEED = 20261017  # seeds Python's `random`, which draws the plan's sample seed


def host_columns(page):
    """{name: (data, valid or None)} of a page's live rows on the host;
    decimal(38) lanes joined into int64 values."""
    import numpy as np

    from presto_tpu_torch.page import to_numpy

    n = int(page.count)
    out = {}
    for name, b in zip(page.names, page.blocks):
        data = to_numpy(b.data[:n])
        if data.ndim == 2:
            data = data[:, 0].astype(np.int64) * (1 << 32) + data[:, 1]
        out[name] = (data, None if b.valid is None else to_numpy(b.valid[:n]))
    return out


def sample_seed(sess, sql):
    """The seed the planner draws for the query's Sample node after
    random.seed(T1_SEED)."""
    import random

    from presto_tpu_torch.plan import nodes as N

    random.seed(T1_SEED)
    node = sess.plan(sql)
    while not isinstance(node, N.Sample):
        node = node.children[0]
    return node.seed


def run_analytic(sess, name):
    """One run of an analytic query: its result on the host (columns or
    rows). T1 reseeds `random` first, so every run samples the same rows."""
    import random

    if name == "T1":
        random.seed(T1_SEED)
    res = sess.query(ANALYTIC_SQL[name])
    return host_columns(res.page) if name in COLUMN_RESULTS else res.rows()


def _partition_starts(keys):
    import numpy as np

    start = np.r_[True, keys[1:] != keys[:-1]]
    pos = np.arange(len(keys))
    return start, np.maximum.accumulate(np.where(start, pos, 0))


def numpy_w1(t):
    import numpy as np

    li = t["lineitem"].columns
    ok, ln = li["l_orderkey"].data, li["l_linenumber"].data
    order = np.lexsort((ln, -li["l_extendedprice"].data, ok))
    q = li["l_quantity"].data[order]
    _, first = _partition_starts(ok[order])
    rn = np.arange(len(order)) - first + 1
    c = np.cumsum(q)
    # (price, linenumber) has no ties within an order: rank is row_number,
    # and the default RANGE frame ends at the current row
    return {"l_orderkey": ok[order], "l_linenumber": ln[order], "rn": rn, "rk": rn,
            "s": c - (c - q)[first]}


def numpy_w2(t):
    import numpy as np

    o = t["orders"].columns
    cust, ok = o["o_custkey"].data, o["o_orderkey"].data
    order = np.lexsort((ok, o["o_orderdate"].data, cust))
    x, cs = o["o_totalprice"].data[order], cust[order]
    p1 = np.r_[False, cs[1:] == cs[:-1]]
    p2 = np.r_[False, False, cs[2:] == cs[:-2]]
    x1 = np.r_[0, x[:-1]]
    x2 = np.r_[0, 0, x[:-2]]
    return {"o_orderkey": ok[order], "s3": x + np.where(p1, x1, 0) + np.where(p2, x2, 0),
            "prev": (np.where(p1, x1, 0), p1)}


def numpy_w3(t):
    import numpy as np

    o, c, n = t["orders"].columns, t["customer"].columns, t["nation"].columns
    cnat = c["c_nationkey"].data[_lookup(c["c_custkey"].data)[o["o_custkey"].data]]
    pr = o["o_orderpriority"]
    counts = np.zeros((int(cnat.max()) + 1, len(pr.dictionary)), np.int64)
    np.add.at(counts, (cnat, pr.data), 1)
    names = n["n_name"]
    nrow = _lookup(n["n_nationkey"].data)
    rows = []
    for nk in range(counts.shape[0]):
        for p in np.nonzero(counts[nk])[0]:
            cnt = counts[nk, p]
            rows.append((names.dictionary[names.data[nrow[nk]]], pr.dictionary[p], int(cnt),
                         int((counts[nk] > cnt).sum()) + 1))
    return rows


def numpy_s1(t, op):
    import numpy as np

    c, o = t["customer"].columns, t["orders"].columns
    seg = c["c_mktsegment"]
    building = set(c["c_custkey"].data[seg.data == _code(seg, "BUILDING")].tolist())
    d = o["o_orderdate"].data
    in95 = set(o["o_custkey"].data[(d >= _days(1995, 1, 1)) & (d < _days(1996, 1, 1))].tolist())
    keys = building & in95 if op == "intersect" else building - in95
    return [(int(k),) for k in sorted(keys)]


def numpy_r1(t):
    from decimal import Decimal

    import numpy as np

    li = t["lineitem"].columns
    rf, ls, q = li["l_returnflag"], li["l_linestatus"], li["l_quantity"].data
    rows = []
    for a in np.unique(rf.data):
        m = rf.data == a
        for b in np.unique(ls.data[m]):
            mm = m & (ls.data == b)
            rows.append((rf.dictionary[a], ls.dictionary[b], 0,
                         Decimal(int(q[mm].sum())).scaleb(-2), int(mm.sum())))
        rows.append((rf.dictionary[a], None, 1, Decimal(int(q[m].sum())).scaleb(-2),
                     int(m.sum())))
    rows.append((None, None, 3, Decimal(int(q.sum())).scaleb(-2), len(q)))
    return rows


def numpy_m1(t):
    import numpy as np

    li = t["lineitem"].columns
    rf = li["l_returnflag"]
    rows = []
    for a in np.unique(rf.data):
        m = rf.data == a
        x = li["l_extendedprice"].data[m] / 100.0
        y = li["l_discount"].data[m] / 100.0
        z = li["l_quantity"].data[m] / 100.0
        d = z - z.mean()
        skew = np.sqrt(len(z)) * (d**3).sum() / (d**2).sum() ** 1.5
        rows.append((rf.dictionary[a], float(np.std(x, ddof=1)), float(np.var(y, ddof=1)),
                     float(skew)))
    return rows


def numpy_sample_mask(capacity, fraction, seed, offset=0):
    """ops/filter.py sample_page's mask in numpy uint64: splitmix64 of
    (position + offset + seed), kept below `fraction`."""
    import numpy as np

    with np.errstate(over="ignore"):
        z = (np.arange(capacity, dtype=np.uint64) + np.uint64(offset)
             + np.uint64(seed)) * np.uint64(0x9E3779B97F4A7C15)
        z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        z = z ^ (z >> np.uint64(31))
    return (z >> np.uint64(11)).astype(np.float64) * (1.0 / (1 << 53)) < fraction


def numpy_t1(t, seed, capacity):
    from decimal import Decimal

    q = t["lineitem"].columns["l_quantity"].data
    keep = numpy_sample_mask(capacity, 0.1, seed)[:len(q)]
    return [(int(keep.sum()), Decimal(int(q[keep].sum())).scaleb(-2))]


def _column_diff(got, want, sort_by):
    """None, or the first column of `got` (host_columns) that differs from
    the numpy arrays `want` (name -> data, or (data, valid)), both ordered
    by the `sort_by` columns."""
    import numpy as np

    want = {k: w if isinstance(w, tuple) else (w, None) for k, w in want.items()}
    order = np.lexsort(tuple(got[c][0] for c in reversed(sort_by)))
    ref_order = np.lexsort(tuple(want[c][0] for c in reversed(sort_by)))
    for name, (wd, wv) in want.items():
        data, valid = got[name]
        data, wd = data[order], wd[ref_order]
        valid = np.ones(len(data), bool) if valid is None else valid[order]
        wv = np.ones(len(wd), bool) if wv is None else wv[ref_order]
        if len(data) != len(wd) or not np.array_equal(valid, wv) or not np.array_equal(
                data[valid], wd[wv]):
            return f"column {name} differs"
    return None


def result_diff(name, got, want):
    """None when two results of analytic query `name` (run_analytic) agree."""
    if name in COLUMN_RESULTS:
        return _column_diff(got, want, COLUMN_RESULTS[name])
    return row_diff(got, want, ordered=False)


def analytic_checks(tables, sess):
    """{name: function(result) -> None or the first difference}."""
    capacity = sess.catalog.page("lineitem").capacity
    t1 = numpy_t1(tables, sample_seed(sess, ANALYTIC_SQL["T1"]), capacity)
    want = {"W3": numpy_w3(tables), "S1_intersect": numpy_s1(tables, "intersect"),
            "S1_except": numpy_s1(tables, "except"), "R1": numpy_r1(tables),
            "M1": numpy_m1(tables), "T1": t1}
    w1, w2 = numpy_w1(tables), numpy_w2(tables)
    checks = {"W1": lambda got: _column_diff(got, w1, COLUMN_RESULTS["W1"]),
              "W2": lambda got: _column_diff(got, w2, COLUMN_RESULTS["W2"])}
    for name, rows in want.items():
        checks[name] = lambda got, rows=rows: row_diff(got, rows, ordered=False)
    return checks


_RUNTIME_KEYS = _LAUNCH_KEYS + _MEMCPY_KEYS + ("cudaMemsetAsync",)
_SYNC_KEYS = ("cudaStreamSynchronize", "cudaDeviceSynchronize")
_OUR_KERNELS = ("groupby_tile_kernel", "groupby_atomic_kernel", "join_insert_kernel",
                "join_probe_kernel", "q1_partials_kernel")


_WINDOW = "chip_smoke.window"  # the record_function range around a traced call
_PAD_LAUNCHES = 32


def _window_summary(events, wall_ms, warm_ms):
    """profile_one's summary of one traced window, from the profiler's raw
    records (`kineto_results.events()`: one pass, without building the
    profiler's event tree, which took most of the trace step's time on
    windows of tens of thousands of launches). Only the runtime calls made
    inside the `_WINDOW` range count, and only the device records that
    match one of them by CUPTI correlation id."""
    import collections

    import torch

    cuda = torch.autograd.DeviceType.CUDA
    host = [e for e in events if e.device_type() != cuda]
    start = min(e.start_ns() for e in host if e.name() == _WINDOW)
    calls, runtime, pad = collections.Counter(), set(), set()
    for e in host:
        name = e.name()
        if e.start_ns() < start:
            if name in _RUNTIME_KEYS:
                pad.add(e.correlation_id())
        elif name in _RUNTIME_KEYS or name in _SYNC_KEYS:
            calls[name] += 1
            if name in _RUNTIME_KEYS:
                runtime.add(e.correlation_id())
    dev_ms, dev_n, have = collections.Counter(), collections.Counter(), set()
    for e in events:
        if e.device_type() == cuda:
            have.add(e.correlation_id())
            if e.correlation_id() in runtime:
                dev_ms[e.name()] += e.duration_ns() / 1e6
                dev_n[e.name()] += 1
    missing = len(runtime - have)
    busy_ms = sum(dev_ms.values())
    return {
        "complete": missing == 0, "missing_device_records": missing,
        "pad_records_lost": len(pad - have),
        "profiled_wall_ms": wall_ms, "warm_wall_ms": warm_ms,
        "device_busy_ms": busy_ms, "idle_share_of_warm_wall": 1.0 - busy_ms / warm_ms,
        "device_launches": sum(dev_n.values()),
        "launch_calls": sum(calls[k] for k in _LAUNCH_KEYS),
        "memcpy_calls": sum(calls[k] for k in _MEMCPY_KEYS),
        "host_syncs": sum(n for k, n in dev_n.items() if "DtoH" in k),
        "htod_copies": sum(n for k, n in dev_n.items() if "HtoD" in k),
        "stream_syncs": sum(calls[k] for k in _SYNC_KEYS) - 1,
        "our_kernels_device_ms": {k: sum(ms for n, ms in dev_ms.items() if k in n)
                                  for k in _OUR_KERNELS},
        "top_device_ms": {n[:70]: ms for n, ms in dev_ms.most_common(8)},
    }


def profile_one(fn, warm_ms, tries=3):
    """One warm call of fn under torch.profiler: (summary, the profiler).
    The summary holds device busy ms, its idle share of the unprofiled warm
    wall `warm_ms`, device launches, device-to-host copies (each a host
    read), host-to-device copies, the host-side copy calls and CPU-side
    stream synchronises (less the one that closes the window; both seen on
    the host, so no device record they lack can hide them), our kernels'
    device ms, and the runtime calls (launches, copies, memsets) whose
    device record is missing, matched by CUPTI correlation id; a window
    with any is not "complete" and is traced again, at most `tries` times
    in all. `_PAD_LAUNCHES` small kernels run first, outside the window's
    range, since the device records torch.profiler loses are the first
    ones after it starts ("pad_records_lost" counts them)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    pad = torch.zeros(1, device="cuda")
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(_PAD_LAUNCHES):
                pad.add_(1)
            torch.cuda.synchronize()
            with record_function(_WINDOW):
                t = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t) * 1e3
        summary = _window_summary(prof.profiler.kineto_results.events(), wall_ms, warm_ms)
        if summary["complete"]:
            break
    return summary, prof


def _timed_runs(fn, runs, check, label):
    """fn() `runs` times (cold, then warm), each result checked; returns
    (cold ms, best warm ms, our kernels' launches in the first run, the
    last result)."""
    walls = []
    for i in range(runs):
        before = _counts()
        t = time.perf_counter()
        out = fn()
        walls.append(time.perf_counter() - t)
        if i == 0:
            launches = {k: v - before[k] for k, v in _counts().items() if k != "q1_partials"}
        diff = check(out)
        if diff is not None:
            raise AssertionError(f"{label}: {diff}")
    return walls[0] * 1e3, min(walls[1:]) * 1e3, launches, out


def tpch22_texts():
    """{label: SQL} of the `tpch22` path: Q1-Q22 and the Q20 variant."""
    from presto_tpu_torch.benchmark.tpch_sql import QUERIES

    texts = {f"Q{q}": QUERIES[q] for q in range(1, 23)}
    texts["Q20_variant"] = q20_variant(QUERIES[20])
    return texts


# label -> the card rows of the `tpch22` path, which `streaming22` is held to
TPCH22_ROWS = {}


def tpch22_path(sess, cpu_sess, runs=3):
    """All 22 TPC-H queries and the Q20 variant through Session.query on
    the card, each held against the same query through the port on the
    CPU over the same generated tables. Q20 returns no rows over this
    generator (q20_variant), and must do so on both devices; its variant
    must return rows. Returns {label: report}."""
    report = {}
    for label, text in tpch22_texts().items():
        t = time.perf_counter()
        want = cpu_sess.query(text).rows()
        cpu_ms = (time.perf_counter() - t) * 1e3
        cold, warm, launches, rows = _timed_runs(
            lambda: sess.query(text).rows(), runs, lambda got: row_diff(got, want),
            f"{label} on the card against the CPU")
        TPCH22_ROWS[label] = rows
        if (len(rows) == 0) != (label == "Q20"):
            raise AssertionError(f"{label} returned {len(rows)} rows")
        report[label] = {"result_rows": len(rows), "launches": launches, "cold_ms": cold,
                         "warm_ms": warm, "cpu_ms": cpu_ms}
        print(f"phase3 tpch22 {label}", json.dumps(report[label]), flush=True)
    print("phase3 tpch22 Q20 returns no rows over this generator at SF 1 on the card and "
          "on the CPU (p_name never starts with 'forest'); its variant "
          f"(p_name like '%forest%') returned {report['Q20_variant']['result_rows']} rows, "
          "equal to the CPU's", flush=True)
    return report


def overlap_check(sess, tpch22, tpch22_load, cpu_rows, runs=2):
    """`tpch22`'s texts again on the same session, each warm `runs` times
    (best) and held to TPCH22_ROWS, while the CPU pool and the `http22`
    workers run beside this process: the warm walls of the same texts on
    the same host without and with that overlap. Prints both sums, their
    ratio, the pool's finished tasks and the host's load average at each
    point (`tpch22_load` just after `tpch22`); returns {label: warm ms}."""
    import os

    texts = tpch22_texts()
    load = os.getloadavg()[0]
    done = sum(f.done() for f in cpu_rows.values())
    warm = {}
    for label, text in texts.items():
        walls = []
        for _ in range(runs):
            t = time.perf_counter()
            rows = sess.query(text).rows()
            walls.append((time.perf_counter() - t) * 1e3)
            diff = row_diff(rows, TPCH22_ROWS[label])
            if diff is not None:
                raise AssertionError(f"overlap check {label}: {diff}")
        warm[label] = min(walls)
    before = sum(r["warm_ms"] for r in tpch22.values())
    after = sum(warm.values())
    print("phase3 overlap", json.dumps({
        "tpch22_warm_ms_sum": before, "tpch22_load_avg_1m": tpch22_load,
        "overlapped_warm_ms_sum": after, "ratio": after / before,
        "overlapped_load_avg_1m": [load, os.getloadavg()[0]], "host_cores": os.cpu_count(),
        "cpu_pool_tasks_done": [done, sum(f.done() for f in cpu_rows.values())],
        "cpu_pool_tasks": len(cpu_rows),
        "per_text": {q: [tpch22[q]["warm_ms"], warm[q]] for q in texts}}), flush=True)
    return warm


def analytic_path(sess, tables, runs=3):
    """The analytic set (ANALYTIC_SQL) through Session.query on the card,
    each held against its numpy computation. Returns {name: report}."""
    t0 = time.perf_counter()
    checks = analytic_checks(tables, sess)
    print(f"phase3 analytic numpy checks computed in {time.perf_counter() - t0:.3f} s",
          flush=True)
    report = {}
    for name in ANALYTIC_SQL:
        cold, warm, launches, out = _timed_runs(
            lambda: run_analytic(sess, name), runs, checks[name], f"{name} against numpy")
        if name in COLUMN_RESULTS:
            n = len(next(iter(out.values()))[0])
            shown = {k: [v.item() for v in d[:3]] for k, (d, _v) in out.items()}
        else:
            n, shown = len(out), [tuple(str(v) for v in r) for r in out[:8]]
        report[name] = {"result_rows": n, "rows": shown, "launches": launches,
                        "cold_ms": cold, "warm_ms": warm}
    return report


def trace_paths(sess, tpch22, analytic):
    """profile_one over one warm run of every query of the two paths: the
    launches, device-to-host reads and idle share that PERF.md records."""
    texts = tpch22_texts()
    for label, rep in tpch22.items():
        summary, _ = profile_one(lambda: sess.query(texts[label]).rows(), rep["warm_ms"])
        rep["profile"] = summary
        print(f"phase3 tpch22 {label} profile", json.dumps(summary), flush=True)
    for name, rep in analytic.items():
        summary, _ = profile_one(lambda: run_analytic(sess, name), rep["warm_ms"])
        rep["profile"] = summary
        print(f"phase3 analytic {name}", json.dumps(rep), flush=True)


# -- phase 3: the coordinator's control plane (server/coordinator.py) -------

# admission of the `coordinator` path: one query runs, one waits, the next
# is rejected; a gate the path holds shut keeps its queue test deterministic
COORD_GROUPS = {"name": "global", "hard_concurrency_limit": 1, "max_queued": 1}
NINE_KEYS = ("l_orderkey", "l_linenumber", "l_partkey", "l_suppkey", "l_quantity",
             "l_extendedprice", "l_discount", "l_tax", "l_shipdate")
_NINE_ON = " and ".join(f"a.{k} = b.{k}" for k in NINE_KEYS)
# a self-join of lineitem on 9 keys (past the probe kernel's 8: the build
# takes the sorted-hash layout), and its EXISTS form; both count lineitem,
# since the keys hold (l_orderkey, l_linenumber)
NINE_KEY_SQL = {
    "join9": f"select count(*) from lineitem a join lineitem b on {_NINE_ON}",
    "exists9": ("select count(*) from lineitem a where exists (select 1 from lineitem b "
                f"where {_NINE_ON})"),
}
TRACE_COST_TEXTS = ("Q1", "Q3", "Q5", "Q10", "Q18", "Q21")
_KERNEL_LINE = r"(groupby_partials|join_insert|join_probe|q1_partials) (\d+) \((\d+) timed, ([\d,.]+)ms device\)"


def json_rows(rows):
    """Rows as the coordinator's QueryResults JSON carries them (decimals
    and dates as strings, NULL as null), for comparing a Client's rows
    with a Session's."""
    from presto_tpu_torch.server.coordinator import _json_default

    return json.loads(json.dumps([list(r) for r in rows], default=_json_default))


def coord_run(client, srv, sql):
    """(rows, wall ms, QueryInfo) of `sql` through POST /v1/statement and
    its nextUri pages."""
    t = time.perf_counter()
    _cols, rows = client.execute(sql)
    ms = (time.perf_counter() - t) * 1e3
    info = max((i for i in srv.manager.list_queries() if i.sql == sql),
               key=lambda i: i.created_at)
    return rows, ms, info


def kernel_footer(text):
    """{kernel: (launches, timed, device ms)} of an EXPLAIN ANALYZE's
    `-- kernels:` footer."""
    import re

    line = next((ln for ln in text.split("\n") if ln.startswith("-- kernels: ")), "")
    return {m.group(1): (int(m.group(2)), int(m.group(3)), float(m.group(4).replace(",", "")))
            for m in re.finditer(_KERNEL_LINE, line)}


def _post(uri, sql):
    import urllib.request

    req = urllib.request.Request(uri + "/v1/statement", data=sql.encode(), method="POST")
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


def coordinator_admission(srv, gate, client, sql):
    """With the admission gate shut: a query waits in the group's queue,
    the next is rejected (queue full), the waiting one is cancelled by
    DELETE; then the gate opens and `sql` runs. Returns the states seen."""
    gate.set()
    try:
        waiting = _post(srv.uri, sql)
        rejected = _post(srv.uri, sql)
        cancelled = client.cancel(waiting["id"])
    finally:
        gate.clear()
    info_w = srv.manager.get(waiting["id"])
    info_r = srv.manager.get(rejected["id"])
    out = {"waiting_state": info_w.state, "rejected_state": info_r.state,
           "rejected_error": (info_r.error or "")[:120], "cancelled": cancelled,
           "deferrals": srv.manager.groups.pressure_deferrals}
    if not (cancelled and info_w.state == "CANCELED" and info_r.state == "FAILED"
            and "queue full" in (info_r.error or "")):
        raise AssertionError(f"coordinator admission: {out}")
    return out


def coordinator_path(sess, cat, tpch22, runs=2):
    """The `coordinator` path: a CoordinatorServer over the TPC-H session
    (wrapped over SystemCatalog, on the card), one query at a time, and a
    Client: the 23 `tpch22` texts through POST /v1/statement, cold then
    warm, each held to TPCH22_ROWS (as the JSON carries them), with the
    warm ms against `tpch22`'s, phase ms and trace id; the 9-key self-join
    of lineitem and its EXISTS form, each lineitem's row count; a query
    rejected past the group's queue and one cancelled by DELETE; reads of
    system.runtime.queries, tasks and metrics that find the texts just
    run; EXPLAIN ANALYZE of Q5 with its `-- trace:` and `-- kernels:`
    footers (kernels 1-3 launched, every launch timed by CUDA events).
    Returns {label: report}."""
    import threading

    from presto_tpu_torch.server import Client, CoordinatorServer

    gate = threading.Event()
    srv = CoordinatorServer(sess, resource_groups=COORD_GROUPS,
                            cluster_pressure=gate.is_set).start()
    report = {}
    try:
        client = Client(srv.uri, timeout=600)
        texts = tpch22_texts()
        for label, text in texts.items():
            want = json_rows(TPCH22_ROWS[label])
            walls = []
            for _ in range(runs):
                rows, ms, info = coord_run(client, srv, text)
                diff = row_diff(rows, want)
                if diff is not None:
                    raise AssertionError(f"coordinator {label}: {diff}")
                walls.append(ms)
            if not info.trace_id or set(info.phase_ms or ()) != {"plan", "execute"}:
                raise AssertionError(f"coordinator {label}: no trace ({info.trace_id}, "
                                     f"{info.phase_ms})")
            report[label] = {"result_rows": len(rows), "cold_ms": walls[0],
                             "warm_ms": min(walls[1:]),
                             "tpch22_warm_ms": tpch22[label]["warm_ms"],
                             "phase_ms": info.phase_ms, "trace_id": info.trace_id}
            print(f"phase3 coordinator {label}", json.dumps(report[label]), flush=True)
        n = cat.exact_row_count("lineitem")
        for label, text in NINE_KEY_SQL.items():
            rows, ms, info = coord_run(client, srv, text)
            if rows != [[n]]:
                raise AssertionError(f"coordinator {label}: {rows} != [[{n}]]")
            report[label] = {"rows": rows, "ms": ms, "phase_ms": info.phase_ms}
            print(f"phase3 coordinator {label}", json.dumps(report[label]), flush=True)
        report["admission"] = coordinator_admission(srv, gate, client, texts["Q1"])
        print("phase3 coordinator admission", json.dumps(report["admission"]), flush=True)
        report["system"] = coordinator_system_reads(client, texts)
        print("phase3 coordinator system", json.dumps(report["system"]), flush=True)
        rows, ms, _info = coord_run(client, srv, "explain analyze " + texts["Q5"])
        text = "\n".join(r[0] for r in rows)
        footer = kernel_footer(text)
        trace = [ln for ln in text.split("\n") if ln.startswith("-- trace: trace ")]
        for k in ("groupby_partials", "join_insert", "join_probe"):
            launched, timed, dev_ms = footer.get(k, (0, 0, 0.0))
            if not (launched >= 1 and timed == launched and dev_ms > 0):
                raise AssertionError(f"coordinator EXPLAIN ANALYZE Q5: {k} {footer.get(k)} "
                                     f"in\n{text}")
        if not trace:
            raise AssertionError(f"coordinator EXPLAIN ANALYZE Q5 without -- trace:\n{text}")
        report["explain_analyze_q5"] = {"ms": ms, "kernels": footer, "trace": trace[0]}
        for ln in text.split("\n"):
            if ln.startswith("-- trace: ") or ln.startswith("-- kernels: "):
                print(f"phase3 coordinator Q5 {ln}", flush=True)
    finally:
        srv.stop()
    print("phase3 coordinator summary", json.dumps({
        "texts": len(texts), "warm_ms_total": sum(report[q]["warm_ms"] for q in texts),
        "tpch22_warm_ms_total": sum(report[q]["tpch22_warm_ms"] for q in texts)}), flush=True)
    return report


def coordinator_system_reads(client, texts):
    """system.runtime.queries, tasks and metrics through the coordinator:
    every `tpch22` text FINISHED at least twice, a query span of each
    text's trace, presto_queries_total at least the queries seen."""
    _c, rows = client.execute("select query, state from system.runtime.queries")
    finished = {}
    for q, state in rows:
        if state == "FINISHED":
            finished[q] = finished.get(q, 0) + 1
    missing = [label for label, text in texts.items() if finished.get(text, 0) < 2]
    _c, spans = client.execute("select trace_id, name, status from system.runtime.tasks "
                               "where name = 'query'")
    _c, total = client.execute("select sum(value) from system.runtime.metrics "
                               "where name = 'presto_queries_total'")
    out = {"queries": len(rows), "finished_texts": len(texts) - len(missing),
           "query_spans": len(spans), "queries_total": total[0][0]}
    if missing or len(spans) < len(texts) or total[0][0] < 2 * len(texts):
        raise AssertionError(f"coordinator system tables: {out}, missing {missing}")
    return out


def profile_cost(n=262_144, bits=19, calls=200):
    """What the kernel profile adds to a launch: join_insert at Q5's
    largest build (n rows, 87 % live) called back to back, with
    PRESTO_TPU_TRACE=0 and =1 alternating twice: host microseconds a call
    (`calls` calls, then a synchronize) and the device ms a call as
    phase 2 measures it (cuda_ms); then the time to read the parked pairs.
    Returns {"host_us", "cuda_ms", "drain_ms", "pairs_read"}."""
    import os

    import torch

    from presto_tpu_torch.obs.kernelprof import KERNEL_PROFILE
    from presto_tpu_torch.ops import join_kernel as jk

    if not torch.cuda.is_available():
        return None
    g = torch.Generator(device="cuda").manual_seed(16)
    h = torch.randint(-2 ** 62, 2 ** 62, (n,), dtype=torch.int64, device="cuda", generator=g)
    live = torch.rand(n, device="cuda", generator=g) < 0.87
    before = os.environ.get("PRESTO_TPU_TRACE")
    out = {"host_us": {"0": [], "1": []}, "cuda_ms": {"0": [], "1": []}}
    try:
        for flag in ("0", "1", "1", "0"):
            os.environ["PRESTO_TPU_TRACE"] = flag
            torch.cuda.synchronize()
            t = time.perf_counter()
            for _ in range(calls):
                jk.join_insert(h, live, bits)
            torch.cuda.synchronize()
            out["host_us"][flag].append((time.perf_counter() - t) / calls * 1e6)
            out["cuda_ms"][flag].append(cuda_ms(lambda: jk.join_insert(h, live, bits)))
    finally:
        if before is None:
            os.environ.pop("PRESTO_TPU_TRACE", None)
        else:
            os.environ["PRESTO_TPU_TRACE"] = before
    torch.cuda.synchronize()
    t = time.perf_counter()
    out["pairs_read"] = KERNEL_PROFILE.drain()
    out["drain_ms"] = (time.perf_counter() - t) * 1e3
    return out


def trace_cost(sess, runs=2):
    """TRACE_COST_TEXTS warm on the session with PRESTO_TPU_TRACE=0 and =1
    alternating (0, 1, then 1, 0), `runs` runs of each, every run held to
    TPCH22_ROWS; then Q5's host syncs under torch.cuda.set_sync_debug_mode
    with tracing on and off (after one uncounted call), which must be
    equal; and profile_cost. Prints the `phase3 coordinator trace` line;
    returns it."""
    import os

    texts = tpch22_texts()
    walls = {"0": {q: [] for q in TRACE_COST_TEXTS}, "1": {q: [] for q in TRACE_COST_TEXTS}}
    before = os.environ.get("PRESTO_TPU_TRACE")
    syncs = {}
    try:
        for r in range(runs):
            for flag in (("0", "1") if r % 2 == 0 else ("1", "0")):
                os.environ["PRESTO_TPU_TRACE"] = flag
                for label in TRACE_COST_TEXTS:
                    t = time.perf_counter()
                    rows = sess.query(texts[label]).rows()
                    walls[flag][label].append((time.perf_counter() - t) * 1e3)
                    diff = row_diff(rows, TPCH22_ROWS[label])
                    if diff is not None:
                        raise AssertionError(f"trace cost {label} trace={flag}: {diff}")
        # the first call under the sync debug mode in a process reports one
        # more sync, at torch's own set_sync_debug_mode line, whatever the
        # trace switch: an uncounted call goes first, with tracing off
        os.environ["PRESTO_TPU_TRACE"] = "0"
        _rows, first, _sites = _host_syncs(lambda: sess.query(texts["Q5"]).rows(), where=True)
        where = {}
        for flag in ("1", "0"):
            os.environ["PRESTO_TPU_TRACE"] = flag
            _rows, syncs[flag], where[flag] = _host_syncs(
                lambda: sess.query(texts["Q5"]).rows(), where=True)
    finally:
        if before is None:
            os.environ.pop("PRESTO_TPU_TRACE", None)
        else:
            os.environ["PRESTO_TPU_TRACE"] = before
    best = {f: {q: min(w) for q, w in walls[f].items()} for f in walls}
    wrapper = profile_cost()
    line = {"texts": list(TRACE_COST_TEXTS), "runs": runs,
            "trace_off_ms_sum": sum(best["0"].values()),
            "trace_on_ms_sum": sum(best["1"].values()),
            "ratio": sum(best["1"].values()) / sum(best["0"].values()),
            "per_text": {q: [best["0"][q], best["1"][q]] for q in TRACE_COST_TEXTS},
            "all_runs_ms_sum": {f: sum(sum(w) for w in walls[f].values()) for f in walls},
            "q5_host_syncs": {"trace_on": syncs["1"], "trace_off": syncs["0"],
                              "first_call_trace_off": first},
            "insert_wrapper": wrapper}
    print("phase3 coordinator trace", json.dumps(line), flush=True)
    if syncs["1"] != syncs["0"]:
        diff = {k: (where["1"].get(k, 0), where["0"].get(k, 0))
                for k in set(where["1"]) | set(where["0"])
                if where["1"].get(k, 0) != where["0"].get(k, 0)}
        raise AssertionError(f"tracing changed Q5's host syncs: {syncs}, by site {diff}")
    return line


# -- phase 3: the streaming executor and its memory ladder (exec/stream.py) --

STREAM_BATCH = 1 << 20  # streaming22: rows per batch
# streaming22's device budget B: 12 MiB makes Q3's, Q5's and Q21's largest
# builds (about 7.5-9.9 MiB at SF 1 in the port's plans; an inner build may
# hold half the budget left) offload, and leaves Q13's 40 MiB outer build
# (an outer join raises past the budget, as in the JAX package) room at
# 4 x B on its rerun (the CPU rehearsal at SF 1, PERF.md)
STREAM_BUDGET = 12 << 20
# the texts whose state offloads at B (the CPU rehearsal at SF 1), and how
STREAM_MUST_OFFLOAD = {"Q3": "join_build", "Q4": "semijoin_source", "Q5": "join_build",
                       "Q7": "join_build", "Q8": "join_build", "Q9": "join_build",
                       "Q10": "join_build", "Q12": "join_build", "Q18": "aggregate",
                       "Q21": "join_build", "Q22": "semijoin_source"}
# the texts whose outer-join build exceeds B: they raise MemoryExceededError
# at B and rerun at 4 x B; a raise from any other text fails the path
STREAM_MAY_RAISE = ("Q13", "Q20", "Q20_variant")
SF10 = 10.0
SF10_BATCH = 1 << 22  # run_sf100's defaults
SF10_BUDGET = 512 << 20
SF10_QUERIES = ("q6", "q1", "q3", "q5", "q17", "q18")


def _ladder(ex):
    """The spill tags and counters of one streaming run."""
    st = ex.spill_stats
    return {"spill": sorted(set(ex.spill_events)), "disk_bytes": st["disk_bytes"],
            "hybrid_parts": st["hybrid_parts"], "hybrid_depth": st["hybrid_depth"],
            "chunk_fallbacks": st["chunk_fallbacks"], "ragged_pages": st["ragged_pages"],
            "agg_hash_batches": st["agg_hash_batches"],
            "agg_dense_batches": st["agg_dense_batches"], "pool_peak": ex.pool.peak}


def streaming_run(cat, sql, budget, batch_rows, device="cuda"):
    """One query in a new streaming session over `cat`. Returns (rows, wall
    ms, ladder, the card's peak allocated bytes above the allocation before
    the query, launches of kernels 1-3)."""
    import torch

    from presto_tpu_torch.session import Session

    sess = Session(cat, device=device, streaming=True, batch_rows=batch_rows,
                   memory_budget=budget, result_cache=False)
    base = 0
    if device == "cuda":
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    before = _counts()
    t = time.perf_counter()
    rows = sess.query(sql).rows()  # rows() syncs to the host
    wall = (time.perf_counter() - t) * 1e3
    peak = torch.cuda.max_memory_allocated() - base if device == "cuda" else 0
    launches = {k: v - before[k] for k, v in _counts().items() if k != "q1_partials"}
    return rows, wall, _ladder(sess.executor), peak, launches


def streaming22_path(cat, budget=STREAM_BUDGET, device="cuda"):
    """The 22 TPC-H texts and the Q20 variant through a streaming session
    over the `tpch22` session's catalog under the device budget `budget`,
    each held to the `tpch22` path's card rows of this run (in order, the
    same tolerance). An outer join whose build exceeds the budget raises
    MemoryExceededError, as in the JAX package: exactly the texts of
    STREAM_MAY_RAISE must raise so, and each reruns at 4x the budget,
    where it must be equal. Every run's pool.peak stays within its budget,
    and no spill file is left. Returns {label: report}."""
    from presto_tpu_torch.exec import spillspace
    from presto_tpu_torch.exec.memory import MemoryExceededError

    report = {}
    for label, text in tpch22_texts().items():
        want = TPCH22_ROWS[label]
        b, raised = budget, None
        try:
            rows, cold, ladder, peak, launches = streaming_run(cat, text, b, STREAM_BATCH, device)
        except MemoryExceededError as e:
            raised = str(e)
            if label not in STREAM_MAY_RAISE or "outer join" not in raised:
                raise AssertionError(f"streaming22 {label} raised at B={budget}: {raised}")
            b = 4 * budget
            rows, cold, ladder, peak, launches = streaming_run(cat, text, b, STREAM_BATCH, device)
        if label in STREAM_MAY_RAISE and raised is None:
            raise AssertionError(f"streaming22 {label} no longer raises at B={budget}")
        diff = row_diff(rows, want)
        if diff is not None:
            raise AssertionError(f"streaming22 {label} differs from tpch22: {diff}")
        # one run a text (a second, warm, run until the `dist22` path came:
        # see TRACE_TPCDS_TEXTS)
        if ladder["pool_peak"] > b:
            raise AssertionError(f"streaming22 {label}: pool.peak {ladder['pool_peak']} > {b}")
        report[label] = {"result_rows": len(rows), "budget": b, "raised": raised,
                         "launches": launches, "cold_ms": cold, "card_peak_bytes": peak,
                         **ladder}
        print(f"phase3 streaming22 {label}", json.dumps(report[label]), flush=True)
    if spillspace.all_active_bytes() or spillspace.all_active_files():
        raise AssertionError("streaming22 left spill files behind")
    missing = [q for q, tag in STREAM_MUST_OFFLOAD.items() if tag not in report[q]["spill"]]
    if missing:
        raise AssertionError(f"streaming22: {missing} did not offload at B={budget}")
    if not any("hybrid_hash_join" in r["spill"] for r in report.values()):
        raise AssertionError("streaming22: no text took the hybrid hash join")
    return report


class _HostColumn:
    def __init__(self, data, dictionary):
        self.data, self.dictionary = data, dictionary


class _HostTable:
    def __init__(self, columns):
        self.columns = columns


def chunked_host_tables(sf):
    """Every table of ChunkedTpchCatalog(sf) generated once on the HOST (its
    CPU twin, bit-identical to the card's batches), in the layout the numpy
    checks read."""
    from presto_tpu_torch.benchmark.scale import ChunkedTpchCatalog

    host = ChunkedTpchCatalog(sf, device="cpu")
    out = {}
    for name in host.table_names():
        page = host.scan(name, 0, host.row_count(name))
        out[name] = _HostTable({c: _HostColumn(b.data.numpy(), b.dictionary)
                                for c, b in zip(page.names, page.blocks)})
    return out


def numpy_scale_q1(li):
    """scale.Q1 (sum_qty, sum_base_price, sum_disc_price, avg_qty, avg_disc,
    count_order) from numpy_q1's columns."""
    return [r[:5] + (r[6], r[8], r[9]) for r in numpy_q1(li)]


SF10_CHECKS = {
    "q6": lambda t: numpy_q6(t["lineitem"]),
    "q1": lambda t: numpy_scale_q1(t["lineitem"]),
    "q3": numpy_q3,
    "q5": numpy_q5,
    "q17": numpy_q17,
    "q18": lambda t: numpy_q18(t, with_name=False),
}


def lineitem_bytes_read(sess, sql, n_rows):
    """Device bytes of the lineitem columns the plan of `sql` scans, at
    `n_rows` rows (storage widths; a column scanned twice counts once)."""
    import torch

    from presto_tpu_torch.plan import nodes as N

    cols = {}

    def walk(node):
        if isinstance(node, N.TableScan) and node.table == "lineitem":
            for _ch, col, typ in node.columns:
                cols[col] = torch.empty((), dtype=typ.storage_dtype).element_size() * (
                    2 if getattr(typ, "is_long", False) else 1)
        for c in node.children:
            walk(c)

    walk(sess.plan(sql))
    return sum(cols.values()) * n_rows, sorted(cols)


def sf10_expect(sf):
    """The numpy checks of the `sf10` queries over ChunkedTpchCatalog(sf)'s
    columns generated on the host, and the seconds the generation and the
    checks took."""
    import torch

    torch.set_num_threads(4)
    t0 = time.perf_counter()
    tables = chunked_host_tables(sf)
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    expect = {q: SF10_CHECKS[q](tables) for q in SF10_QUERIES}
    return expect, gen_s, time.perf_counter() - t0


def start_sf10_expect(sf=None):
    """sf10_expect in one new (spawned) process, so the host side overlaps
    the card paths before `sf10`. Returns (pool, future)."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    pool = ProcessPoolExecutor(1, mp_context=multiprocessing.get_context("spawn"))
    return pool, pool.submit(sf10_expect, SF10 if sf is None else sf)


def sf10_path(expect_future=None, device="cuda"):
    """scale.QUERIES q6, q1, q3, q5, q17, q18 (run_sf100's texts and
    defaults) streamed from ChunkedTpchCatalog(10) on the card, each cold
    then warm, held to the numpy checks over the same columns generated on
    the host (`expect_future`, from start_sf10_expect; computed here when
    None). pool.peak stays within the budget, the card's peak allocation
    of every query stays below the bytes of the lineitem columns it reads
    (the table is never resident), and at least one query offloads.
    Returns {query: report}."""
    import torch

    from presto_tpu_torch.benchmark.scale import QUERIES, ChunkedTpchCatalog
    from presto_tpu_torch.exec import spillspace
    from presto_tpu_torch.session import Session

    cat = ChunkedTpchCatalog(SF10, device=device)
    n = cat.row_count("lineitem")
    t0 = time.perf_counter()
    expect, gen_s, check_s = (expect_future.result() if expect_future is not None
                              else sf10_expect(SF10))
    print(f"phase3 sf10 lineitem rows={n}, host tables generated in {gen_s:.3f} s, numpy "
          f"checks in {check_s:.3f} s (waited {time.perf_counter() - t0:.3f} s)", flush=True)
    planner = Session(cat, device=device, result_cache=False)
    report = {q: sf10_query(cat, planner, q, QUERIES[q], expect[q], n, device)
              for q in SF10_QUERIES}
    if spillspace.all_active_bytes() or spillspace.all_active_files():
        raise AssertionError("sf10 left spill files behind")
    if not any(r["spill"] for r in report.values()):
        raise AssertionError("sf10: no query offloaded")
    del cat
    if device == "cuda":
        torch.cuda.empty_cache()
    return report


def sf10_query(cat, planner, q, sql, want, n, device):
    """One sf10 query, cold then warm, checked; returns its report."""
    li_bytes, li_cols = lineitem_bytes_read(planner, sql, n)
    runs = [streaming_run(cat, sql, SF10_BUDGET, SF10_BATCH, device) for _ in range(2)]
    for i, (rows, _wall, ladder, peak, _l) in enumerate(runs):
        if rows != want:
            raise AssertionError(f"sf10 {q} run {i} differs from numpy:\n{rows[:3]}\n"
                                 f"{want[:3]}")
        if ladder["pool_peak"] > SF10_BUDGET:
            raise AssertionError(f"sf10 {q}: pool.peak {ladder['pool_peak']} > budget")
        if device == "cuda" and peak >= li_bytes:
            raise AssertionError(f"sf10 {q}: card peak {peak} >= lineitem bytes {li_bytes}")
    (rows, cold, ladder, peak, launches), (_r2, warm, _l2, peak2, _) = runs
    report = {"result_rows": len(rows), "launches": launches, "cold_ms": cold,
              "warm_ms": warm, "lineitem_rows_per_s": n / (warm / 1e3),
              "lineitem_bytes_read": li_bytes, "lineitem_columns": li_cols,
              "card_peak_bytes": max(peak, peak2), **ladder}
    print(f"phase3 sf10 {q}", json.dumps(report), flush=True)
    return report


# NOT IN over a nullable foreign key (web_sales.ws_ship_customer_sk is NULL
# on about 4 % of the rows): NULL probe rows are dropped (N1), and a
# subquery that holds a NULL selects nothing, the classic pitfall (N2)
NOT_IN_SQL = {
    "N1": "select count(*), sum(ws_quantity) from web_sales where ws_ship_customer_sk not in "
          "(select c_customer_sk from customer where c_birth_year < 1950)",
    "N2": "select count(*) from customer where c_customer_sk not in "
          "(select ws_ship_customer_sk from web_sales where ws_quantity > 95)",
}


def not_in_checks(cat):
    """N1 and N2 in numpy over the TPC-DS host tables (three-valued NOT IN)."""
    import numpy as np

    ws, c = (cat.host_table(n).columns for n in ("web_sales", "customer"))

    def valid(col):
        return np.ones(len(col.data), bool) if col.valid is None else col.valid

    by = c["c_birth_year"]
    s1 = c["c_customer_sk"].data[valid(by) & (by.data < 1950) & valid(c["c_customer_sk"])]
    key, qty = ws["ws_ship_customer_sk"], ws["ws_quantity"]
    keep = valid(key) & ~np.isin(key.data, s1)
    out = {"N1": [(int(keep.sum()), int(qty.data[keep & valid(qty)].sum()))]}
    sel = valid(qty) & (qty.data > 95)
    probe = c["c_customer_sk"]
    if not sel.any():
        n2 = len(probe.data)  # an empty subquery keeps every row, NULLs too
    elif (sel & ~valid(key)).any():
        n2 = 0  # a NULL in the subquery: no row is TRUE
    else:
        n2 = int((valid(probe) & ~np.isin(probe.data, key.data[sel])).sum())
    out["N2"] = [(n2,)]
    return out


def not_in_path(sess, cat, runs=2):
    """NOT_IN_SQL on the TPC-DS session, held to numpy. Returns {label: report}."""
    want = not_in_checks(cat)
    report = {}
    for label, sql in NOT_IN_SQL.items():
        cold, warm, launches, rows = _timed_runs(
            lambda: sess.query(sql).rows(), runs, lambda got: row_diff(got, want[label]),
            f"{label} against numpy")
        report[label] = {"rows": [list(r) for r in rows], "launches": launches,
                         "cold_ms": cold, "warm_ms": warm}
        print(f"phase3 not_in {label}", json.dumps(report[label]), flush=True)
    return report


# -- phase 3: the storage connectors (`files22`) -----------------------------

FILES_BUCKETS = 8  # orders and lineitem bucketed on their order key
# the grouped bucket join's device budget: below orders' whole build
# (o_orderkey, o_orderpriority, o_totalprice on the card, about 30 MB at
# SF 1) and above its largest bucket's (about 1/8 of it); files_hive_checks
# measures both
FILES_JOIN_BUDGET = 16 << 20
FILES_JOIN_BUILD = ("o_orderkey", "o_orderpriority", "o_totalprice")
FILES_JOIN_SQL = ("select o_orderpriority, l_returnflag, count(*) as n, sum(l_quantity) as q, "
                  "sum(o_totalprice) as p from orders, lineitem where o_orderkey = l_orderkey "
                  "group by o_orderpriority, l_returnflag order by o_orderpriority, l_returnflag")
CROSS_SQL = ("select n_name, count(*) as n, sum(c_acctbal) as b from {nation}, {customer} "
             "where n_nationkey = c_nationkey group by n_name order by n_name")
CSV_SQL = ("select c_custkey, c_name, {acctbal}, c_address, c_phone, c_comment from customer "
           "where c_custkey in ({keys}) order by c_custkey")


def files22_expected(sess):
    """The TPC-H session's rows for the `files22` checks that have no
    tpch22 text: the Q12 variant, the orders-lineitem join, the
    cross-catalog join and the CSV customers. main computes them before
    it sets the counts to 0, so that files22's launches come from queries
    over files only."""
    from presto_tpu_torch.benchmark.tpch_sql import QUERIES

    keys = ", ".join(str(r[0]) for r in TPCH22_ROWS["Q10"])
    return {"q12_mail": sess.query(q12_mail(QUERIES[12])).rows(),
            "join": sess.query(FILES_JOIN_SQL).rows(),
            "cross": sess.query(CROSS_SQL.format(nation="nation", customer="customer")).rows(),
            "csv": sess.query(CSV_SQL.format(acctbal="cast(c_acctbal as double)",
                                             keys=keys)).rows()}


def q12_mail(text):
    """TPC-H Q12 with `l_shipmode = 'MAIL'` in place of its IN list (the
    Hive connector prunes partitions on eq/lt/le/gt/ge hints, not on `in`,
    as in the JAX package)."""
    assert "l_shipmode in ('MAIL', 'SHIP')" in text
    return text.replace("l_shipmode in ('MAIL', 'SHIP')", "l_shipmode = 'MAIL'")


def _dir_bytes(path):
    import os

    return sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(path) for f in fs)


def write_warehouse(root, host, device):
    """The eight tables into a Hive warehouse under `root` (Parquet),
    orders and lineitem bucketed on their order key into FILES_BUCKETS
    buckets, plus lineitem_by_mode partitioned by l_shipmode. Returns
    (the HiveCatalog, write seconds)."""
    from presto_tpu_torch.connectors.hive import HiveCatalog

    t0 = time.perf_counter()
    wh = HiveCatalog(root, device=device)
    keys = {"orders": "o_orderkey", "lineitem": "l_orderkey"}
    for name, page in host.items():
        schema = {n: b.type for n, b in zip(page.names, page.blocks)}
        bucketed = [keys[name]] if name in keys else []
        wh.create_partitioned_table(name, schema, bucketed_by=bucketed,
                                    bucket_count=FILES_BUCKETS if bucketed else 0)
        wh.append(name, page)
    li = host["lineitem"]
    wh.create_partitioned_table("lineitem_by_mode", {n: b.type for n, b in
                                                     zip(li.names, li.blocks)},
                                partitioned_by=["l_shipmode"])
    wh.append("lineitem_by_mode", li)
    return wh, time.perf_counter() - t0


def write_catalog_dir(cdir, warehouse, host):
    """hive.properties, blackhole.properties and sqlite.properties under
    `cdir`; the SQLite file holds nation and region."""
    import os
    import sqlite3

    db = os.path.join(cdir, "federated.db")
    conn = sqlite3.connect(db)
    for name in ("nation", "region"):
        page = host[name]
        decl = ", ".join(f"{c} {'INTEGER' if str(b.type) == 'bigint' else 'TEXT'}"
                         for c, b in zip(page.names, page.blocks))
        conn.execute(f"create table {name} ({decl})")
        conn.executemany(f"insert into {name} values ({', '.join('?' * len(page.names))})",
                         page.to_pylist())
    conn.commit()
    conn.close()
    for name, props in (("hive", f"hive.warehouse-dir={warehouse}"), ("blackhole", ""),
                        ("sqlite", f"connection-url=jdbc:sqlite:{db}")):
        with open(os.path.join(cdir, f"{name}.properties"), "w") as f:
            f.write(f"connector.name={name}\n{props}\n")


def files_store_runs(sess, runs):
    """The 22 texts and the Q20 variant through the catalog store after
    USE hive.default, each held to TPCH22_ROWS in order. Returns {label:
    report} (first plan ms: Session.plan on cold column stats)."""
    report = {}
    for label, text in tpch22_texts().items():
        t = time.perf_counter()
        sess.plan(text)
        plan_ms = (time.perf_counter() - t) * 1e3
        want = TPCH22_ROWS[label]
        cold, warm, launches, rows = _timed_runs(
            lambda: sess.query(text).rows(), runs, lambda got: row_diff(got, want),
            f"files22 {label} against tpch22")
        report[label] = {"result_rows": len(rows), "launches": launches, "first_plan_ms": plan_ms,
                         "cold_ms": cold, "warm_ms": warm}
        print(f"phase3 files22 {label}", json.dumps(report[label]), flush=True)
    return report


def files_hive_checks(hive, want, device):
    """On a Session over the HiveCatalog itself: the Q12 variant over
    lineitem_by_mode streamed (rows equal to want["q12_mail"]; EXPLAIN
    ANALYZE prunes 6 of 7 partitions), and the streamed orders-lineitem
    join that takes the grouped bucket join under FILES_JOIN_BUDGET (rows
    equal to want["join"]), the budget held between the measured card
    bytes of orders' build columns in its largest bucket and in whole."""
    from presto_tpu_torch.benchmark.tpch_sql import QUERIES
    from presto_tpu_torch.exec.stats import page_device_bytes
    from presto_tpu_torch.session import Session

    out = {}
    over = q12_mail(QUERIES[12]).replace("lineitem", "lineitem_by_mode")
    stream = lambda **kw: Session(hive, device=device, streaming=True,  # noqa: E731
                                  batch_rows=STREAM_BATCH, result_cache=False, **kw)
    t = time.perf_counter()
    diff = row_diff(stream().query(over).rows(), want["q12_mail"])
    out["q12_mail_ms"] = (time.perf_counter() - t) * 1e3
    if diff is not None or not want["q12_mail"]:
        raise AssertionError(f"files22 Q12 over lineitem_by_mode: {diff}")
    plan = stream().explain_analyze(over)
    line = [ln.strip() for ln in plan.splitlines() if "files:" in ln]
    if not any("files: 1 read, 6 pruned" in ln for ln in line):
        raise AssertionError(f"files22 Q12: no 'files: 1 read, 6 pruned' in\n{plan}")
    out["q12_pruning"] = line
    js = stream(memory_budget=FILES_JOIN_BUDGET)
    t = time.perf_counter()
    diff = row_diff(js.query(FILES_JOIN_SQL).rows(), want["join"])
    out["grouped_join_ms"] = (time.perf_counter() - t) * 1e3
    if diff is not None:
        raise AssertionError(f"files22 grouped bucket join: {diff}")
    cols = list(FILES_JOIN_BUILD)
    whole = page_device_bytes(hive.page_columns("orders", cols))
    bucket = max(sum(page_device_bytes(hive.scan("orders", lo, hi, columns=cols))
                     for lo, hi in hive.bucket_row_ranges("orders", b))
                 for b in range(FILES_BUCKETS))
    ladder = _ladder(js.executor)
    if "grouped_bucket_join" not in js.executor.spill_events or not (
            bucket < FILES_JOIN_BUDGET < whole) or ladder["pool_peak"] > FILES_JOIN_BUDGET:
        raise AssertionError(f"files22 grouped bucket join: {js.executor.spill_events} "
                             f"bucket {bucket} budget {FILES_JOIN_BUDGET} whole {whole} "
                             f"peak {ladder['pool_peak']}")
    out["grouped_join"] = {"budget": FILES_JOIN_BUDGET, "whole_build_bytes": whole,
                           "largest_bucket_build_bytes": bucket, **ladder}
    return out


def files_scan_columns(hive, device, runs=2):
    """Q1 and Q6 on a Session over the HiveCatalog, scans reading only
    their columns (page_columns) against every column (page()), `runs`
    times each, rows held to TPCH22_ROWS. Returns {q: {mode: cold and warm
    ms}}."""
    from presto_tpu_torch.benchmark.tpch_sql import QUERIES
    from presto_tpu_torch.connectors.jdbc import MultiCatalog
    from presto_tpu_torch.session import Session

    class WholePages(MultiCatalog):
        def page_columns(self, table, columns):
            return self.page(table)

    sessions = {"columns": Session(hive, device=device, result_cache=False),
                "whole": Session(WholePages([hive]), device=device, result_cache=False)}
    out = {}
    for q in (1, 6):
        out[f"Q{q}"] = {}
        for mode, s in sessions.items():
            cold, warm, _, _ = _timed_runs(
                lambda: s.query(QUERIES[q]).rows(), runs,
                lambda got: row_diff(got, TPCH22_ROWS[f"Q{q}"]), f"files22 Q{q} {mode}")
            out[f"Q{q}"][mode] = {"cold_ms": cold, "warm_ms": warm}
    print("phase3 files22 scan columns", json.dumps(out), flush=True)
    return out


def files_writes(store_sess, hive, device):
    """CTAS of Q1 on a Session over the warehouse, read back through the
    store after USE hive.default; an INSERT of lineitem into a blackhole
    table on a session whose writes go to the store's blackhole catalog
    and whose reads resolve in the warehouse, which must report every row
    (the store itself takes no writes)."""
    from presto_tpu_torch.benchmark.tpch_sql import QUERIES
    from presto_tpu_torch.connectors.jdbc import MultiCatalog
    from presto_tpu_torch.session import Session

    class SinkOverWarehouse(MultiCatalog):
        def __init__(self, sink, source):
            super().__init__([sink, source])
            self.wrapped = sink

        def create_table_from_page(self, table, page):
            self.wrapped.create_table_from_page(table, page)

        def append(self, table, page):
            self.wrapped.append(table, page)

    out = {}
    t = time.perf_counter()
    Session(hive, device=device, result_cache=False).query("create table q1_out as "
                                                           + QUERIES[1])
    store_sess.query("use hive.default")
    back = store_sess.query("select * from q1_out").rows()
    out["ctas_ms"] = (time.perf_counter() - t) * 1e3
    diff = row_diff(back, TPCH22_ROWS["Q1"])
    if diff is not None:
        raise AssertionError(f"files22 CTAS q1_out read back: {diff}")
    n = hive.exact_row_count("lineitem")
    sink = store_sess.catalog.catalogs["blackhole"]
    bs = Session(SinkOverWarehouse(sink, hive), device=device, result_cache=False)
    bs.query("create table sink as select * from lineitem limit 0")
    t = time.perf_counter()
    got = bs.query("insert into sink select * from lineitem").rows()
    out["blackhole_insert_ms"] = (time.perf_counter() - t) * 1e3
    written = sink.rows_written["sink"]
    if got != [(n,)] or written != n:
        raise AssertionError(f"files22 blackhole insert reported {got}, wrote {written}, not {n}")
    out["blackhole_rows"] = written
    return out


def files_formats(tmp, host, want_csv, device):
    """RCFile (lineitem: Q1 and Q6), ORC and the shard store (customer,
    orders, lineitem: Q3; organize() keeps the rows and table_version),
    and CSV (customer: Q10's customer columns, against `want_csv`) against
    the TPC-H rows."""
    import csv
    import os

    from presto_tpu_torch.benchmark.tpch_sql import QUERIES
    from presto_tpu_torch.connectors.localfile import LocalFileCatalog
    from presto_tpu_torch.connectors.orc import OrcCatalog
    from presto_tpu_torch.connectors.rcfile import RcFileCatalog
    from presto_tpu_torch.connectors.shardstore import ShardStoreCatalog
    from presto_tpu_torch.page import Page
    from presto_tpu_torch.session import Session

    out = {}

    def check(label, cat, texts):
        s = Session(cat, device=device, result_cache=False)
        for q, key in texts:
            t = time.perf_counter()
            diff = row_diff(s.query(QUERIES[q]).rows(), TPCH22_ROWS[key])
            out[f"{label}_q{q}_ms"] = (time.perf_counter() - t) * 1e3
            if diff is not None:
                raise AssertionError(f"files22 {label} Q{q}: {diff}")

    for label, make in (("rcfile", lambda d: RcFileCatalog({}, directory=d, device=device)),
                        ("orc", lambda d: OrcCatalog({}, directory=d, device=device))):
        d = os.path.join(tmp, label)
        os.makedirs(d)
        cat = make(d)
        t = time.perf_counter()
        names = ("lineitem",) if label == "rcfile" else ("customer", "orders", "lineitem")
        for name in names:
            cat.create_table_from_page(name, host[name])
        out[f"{label}_write_s"] = time.perf_counter() - t
        out[f"{label}_bytes"] = _dir_bytes(d)
        check(label, cat, ((1, "Q1"), (6, "Q6")) if label == "rcfile" else ((3, "Q3"),))
    ss = ShardStoreCatalog(os.path.join(tmp, "shards"), device=device)
    t = time.perf_counter()
    for name in ("customer", "orders", "lineitem"):
        page = host[name]
        ss.create_table(name, {n: b.type for n, b in zip(page.names, page.blocks)})
        n = int(page.count)
        step = -(-n // 6)  # six shards a table: organize() has runs to merge
        for lo in range(0, n, step):
            hi = min(lo + step, n)
            ss.append(name, Page(tuple(b.take_rows(slice(lo, hi)) for b in page.blocks),
                                 page.names, page.count.new_tensor(hi - lo)))
    out["shardstore_write_s"] = time.perf_counter() - t
    check("shardstore", ss, ((3, "Q3"),))
    versions = {name: ss.table_version(name) for name in ("customer", "orders", "lineitem")}
    shards = {name: ss.shard_count(name) for name in versions}
    out["organize"] = ss.organize()
    after = {name: ss.shard_count(name) for name in versions}
    if not out["organize"] or any(ss.table_version(n) != v for n, v in versions.items()):
        raise AssertionError(f"files22 organize: {out['organize']} {shards} -> {after}")
    out["shards"] = {"before": shards, "after": after}
    check("shardstore_organized", ss, ((3, "Q3"),))
    d = os.path.join(tmp, "csv")
    os.makedirs(d)
    cust = host["customer"]
    cols = [[None if v is None else str(v) for v in col] for col in zip(*cust.to_pylist())]
    with open(os.path.join(d, "customer.csv"), "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(cust.names)
        w.writerows(zip(*cols))
    keys = ", ".join(str(r[0]) for r in TPCH22_ROWS["Q10"])
    got = Session(LocalFileCatalog(d, device=device), device=device, result_cache=False).query(
        CSV_SQL.format(acctbal="c_acctbal", keys=keys)).rows()
    diff = row_diff(got, want_csv)
    if diff is not None or len(want_csv) != len(TPCH22_ROWS["Q10"]):
        raise AssertionError(f"files22 CSV customer: {diff}")
    return out


def files22_path(cat, want, runs=2, device="cuda"):
    """The storage connectors on the card (`files22`): the eight tables of
    `cat` copied to the host once and written into a Hive warehouse; a
    catalog directory (hive, blackhole, sqlite) loaded with
    load_catalog_store on `device`; after USE hive.default the 22 texts and
    the Q20 variant, `runs` times each, held to TPCH22_ROWS in order; a
    cross-catalog join (sqlite nation x hive customer) against
    want["cross"]; the Hive-session checks (files_hive_checks); Q1 and Q6
    with and without page_columns (files_scan_columns); the writes
    (files_writes); and the other formats (files_formats). `want` is
    files22_expected's: no query here runs over generated tables.
    Returns (report, {check: result})."""
    import os
    import tempfile

    import torch

    from presto_tpu_torch.server.catalog_store import load_catalog_store
    from presto_tpu_torch.session import Session

    t0 = time.perf_counter()
    host = {name: cat.page(name).to("cpu") for name in TPCH_TABLES + ("partsupp",)}
    copy_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        wh_dir, cdir = os.path.join(tmp, "warehouse"), os.path.join(tmp, "catalog")
        os.makedirs(cdir)
        hive, write_s = write_warehouse(wh_dir, host, device)
        write_catalog_dir(cdir, wh_dir, host)
        parts = sorted(e.partition[0][1] for e in hive._manifest["lineitem_by_mode"])
        info = {"copy_to_host_s": copy_s, "write_s": write_s, "bytes_on_disk": _dir_bytes(wh_dir),
                "files": {n: len(hive._manifest[n]) for n in hive.table_names()},
                "lineitem_by_mode_partitions": parts}
        print("phase3 files22 warehouse", json.dumps(info), flush=True)
        if len(parts) != 7 or info["files"]["lineitem"] != FILES_BUCKETS:
            raise AssertionError(f"files22 warehouse layout: {info}")
        store = load_catalog_store(cdir, device=device)
        for name, c in store.catalogs.items():
            if getattr(c, "device", None) != torch.device(device):
                raise AssertionError(f"files22: catalog {name} is on {c.device}")
        store_sess = Session(store, device=device, result_cache=False)
        store_sess.query("use hive.default")
        report = files_store_runs(store_sess, runs)
        checks = {"warehouse": info}
        got = store_sess.query(CROSS_SQL.format(nation="sqlite.default.nation",
                                                customer="hive.default.customer")).rows()
        diff = row_diff(got, want["cross"])
        if diff is not None or len(got) != 25:
            raise AssertionError(f"files22 cross-catalog join: {diff}")
        checks["cross_catalog_rows"] = len(got)
        checks.update(files_hive_checks(store.catalogs["hive"], want, device))
        checks["scan_columns"] = files_scan_columns(store.catalogs["hive"], device)
        checks.update(files_writes(store_sess, store.catalogs["hive"], device))
        checks.update(files_formats(tmp, host, want["csv"], device))
    print("phase3 files22 checks", json.dumps(checks, default=str), flush=True)
    return report, checks


# -- phase 3: materialized views and history-based feedback ----------------

# lineitem's first 90 % of rows loaded before the batches, then 2
# append_batch calls of 5 % each (80 % and 8 batches until the `dist22`
# path came, 4 batches until the `http22` path came: see TRACE_TPCDS_TEXTS)
MV_BASE_FRAC = 0.9
MV_BATCHES = 2
MV_PAGES = 4  # pages per append_batch call
# the shard store's tables and their TPC-H primary keys, declared so that
# the planner takes n:1 joins (the probe kernel) over them
MV_KEYS = {"lineitem": ["l_orderkey", "l_linenumber"], "orders": ["o_orderkey"],
           "customer": ["c_custkey"], "nation": ["n_nationkey"], "region": ["r_regionkey"]}
MV_KEY_OFFSET = 1 << 40  # l_orderkey offset of the fallbacks' new rows (no order matches)
MV_SQL = {
    # V1, the aggregate kind: Q1 with its mergeable aggregates only
    "v1": ("select l_returnflag, l_linestatus, count(*) as count_order, "
           "sum(l_quantity) as sum_qty, sum(l_extendedprice) as sum_base_price, "
           "sum(l_extendedprice * (1 - l_discount)) as sum_disc_price, "
           "min(l_discount) as min_disc, max(l_tax) as max_tax from lineitem "
           "where l_shipdate <= date '1998-12-01' - interval '90' day "
           "group by l_returnflag, l_linestatus order by l_returnflag, l_linestatus"),
    # V2, the append kind: a filtered projection of lineitem
    "v2": ("select l_orderkey, l_linenumber, l_quantity, l_extendedprice, l_discount, l_shipdate "
           "from lineitem where l_quantity >= 50 and l_discount >= 0.09"),
    # V3, recompute-only: Q3's join and group-by without its TopN
    "v3": ("select l_orderkey, sum(l_extendedprice * (1 - l_discount)) as revenue, o_orderdate, "
           "o_shippriority from customer, orders, lineitem where c_mktsegment = 'BUILDING' "
           "and c_custkey = o_custkey and l_orderkey = o_orderkey "
           "and o_orderdate < date '1995-03-15' and l_shipdate > date '1995-03-15' "
           "group by l_orderkey, o_orderdate, o_shippriority"),
}
MV_KIND = {"v1": "aggregate", "v2": "append", "v3": None}
# V3's recompute-only reason: its select list reorders the group keys, so a
# Project sits on the Aggregate and the classifier meets the Aggregate (over
# the joins) inside a per-row pipeline, as the JAX package's does
MV_V3_REASON = "Aggregate"
MV_COLUMNS = ("l_orderkey", "l_linenumber", "l_quantity", "l_extendedprice", "l_discount",
              "l_tax", "l_returnflag", "l_linestatus", "l_shipdate")


def _rows_page(page, lo, hi):
    """Rows [lo, hi) of a page."""
    from presto_tpu_torch.page import Page

    return Page(tuple(b.take_rows(slice(lo, hi)) for b in page.blocks), page.names, hi - lo)


def _with_column(page, name, data):
    """`page` with column `name`'s values replaced by `data`."""
    import dataclasses

    from presto_tpu_torch.page import Page

    blocks = tuple(dataclasses.replace(b, data=data) if n == name else b
                   for n, b in zip(page.names, page.blocks))
    return Page(blocks, page.names, page.count)


class MvOracle:
    """The lineitem rows the shard store holds, as numpy columns in storage
    units (decimals scaled integers, varchars dictionary codes, dates
    days), grown by every page written to the store: the input of the
    views' numpy computations."""

    def __init__(self, first):
        import numpy as np

        self.cols = {c: np.empty(0, first.block(c).data.numpy().dtype) for c in MV_COLUMNS}
        self.dicts = {c: first.block(c).dictionary for c in ("l_returnflag", "l_linestatus")}

    def extend(self, page):
        import numpy as np

        n = int(page.count)
        for c in MV_COLUMNS:
            b = page.block(c)
            if c in self.dicts:
                assert b.dictionary == self.dicts[c]
            self.cols[c] = np.concatenate([self.cols[c], b.data[:n].numpy()])

    def upsert(self, page):
        """Rows of `page` replace the rows with their (l_orderkey,
        l_linenumber): the store's upsert."""
        import numpy as np

        n = int(page.count)
        key = self.cols["l_orderkey"] * 8 + self.cols["l_linenumber"]
        new = (page.block("l_orderkey").data[:n].numpy() * 8
               + page.block("l_linenumber").data[:n].numpy())
        keep = ~np.isin(key, new)
        for c in MV_COLUMNS:
            self.cols[c] = self.cols[c][keep]
        self.extend(page)

    @property
    def num_rows(self):
        return len(self.cols["l_orderkey"])


def numpy_v1(o):
    """V1 over the oracle's rows, exactly (decimals as scaled integers)."""
    from decimal import Decimal

    c = o.cols
    keep = c["l_shipdate"] <= _days(1998, 12, 1) - 90
    rf, ls = c["l_returnflag"][keep], c["l_linestatus"][keep]
    qty, price = c["l_quantity"][keep], c["l_extendedprice"][keep]
    disc, tax = c["l_discount"][keep], c["l_tax"][keep]
    rfd, lsd = o.dicts["l_returnflag"], o.dicts["l_linestatus"]
    rows = []
    for r in range(len(rfd)):
        for s in range(len(lsd)):
            m = (rf == r) & (ls == s)
            if not m.any():
                continue
            rows.append((rfd[r], lsd[s], int(m.sum()), Decimal(int(qty[m].sum())).scaleb(-2),
                         Decimal(int(price[m].sum())).scaleb(-2),
                         Decimal(int((price[m] * (100 - disc[m])).sum())).scaleb(-4),
                         Decimal(int(disc[m].min())).scaleb(-2),
                         Decimal(int(tax[m].max())).scaleb(-2)))
    return sorted(rows, key=lambda t: (t[0], t[1]))


def numpy_v2(o):
    from decimal import Decimal

    c = o.cols
    m = (c["l_quantity"] >= 5000) & (c["l_discount"] >= 9)
    return [(int(k), int(n), Decimal(int(q)).scaleb(-2), Decimal(int(p)).scaleb(-2),
             Decimal(int(d)).scaleb(-2), _date(s))
            for k, n, q, p, d, s in zip(*(c[x][m] for x in (
                "l_orderkey", "l_linenumber", "l_quantity", "l_extendedprice", "l_discount",
                "l_shipdate")))]


def numpy_v3(o, tables):
    """V3 (Q3's join and group-by, every group) over the oracle's rows."""
    from decimal import Decimal

    import numpy as np

    c, od = tables["customer"].columns, tables["orders"].columns
    cut = _days(1995, 3, 15)
    cust_ok = np.zeros(int(c["c_custkey"].data.max()) + 1, bool)
    seg = c["c_mktsegment"]
    cust_ok[c["c_custkey"].data[seg.data == _code(seg, "BUILDING")]] = True
    o_ok = (od["o_orderdate"].data < cut) & cust_ok[od["o_custkey"].data]
    lk = o.cols["l_orderkey"]
    omax = int(od["o_orderkey"].data.max())
    known = lk <= omax
    orow = np.full(len(lk), -1, np.int64)
    orow[known] = _lookup(od["o_orderkey"].data)[lk[known]]
    ok = orow >= 0
    ok[ok] = o_ok[orow[ok]]
    m = (o.cols["l_shipdate"] > cut) & ok
    rev = o.cols["l_extendedprice"][m] * (100 - o.cols["l_discount"][m])
    keys, inv = np.unique(lk[m], return_inverse=True)
    sums = np.zeros(len(keys), np.int64)
    np.add.at(sums, inv, rev)
    oi = _lookup(od["o_orderkey"].data)[keys]
    return [(int(k), Decimal(int(s)).scaleb(-4), _date(d), int(p)) for k, s, d, p in
            zip(keys, sums, od["o_orderdate"].data[oi], od["o_shippriority"].data[oi])]


def mv_expect(o, tables):
    return {"v1": numpy_v1(o), "v2": numpy_v2(o), "v3": numpy_v3(o, tables)}


def mv_check(sess, expect, label):
    """Each view's stored rows against `expect` (V1 in its ORDER BY, the
    others as sets). Returns {view: rows}."""
    out = {}
    for v in MV_SQL:
        rows = sess.query(f"select * from {v}").rows()
        diff = row_diff(rows, expect[v], ordered=(v == "v1"))
        if diff is not None:
            raise AssertionError(f"matview {label}: {v} differs from numpy: {diff}")
        out[v] = rows
    return out


def _timed(fn):
    t = time.perf_counter()
    out = fn()
    return out, (time.perf_counter() - t) * 1e3


def mv_refresh(sess, view, full=False, mode=None, reason=None):
    """REFRESH [FULL] one view, timed; its last_mode (and last_reason) must
    be `mode` (`reason`). Returns ms."""
    _, ms = _timed(lambda: sess.query(f"refresh materialized view {view}{' full' if full else ''}"))
    mv = sess.matviews_mgr.views[view]
    if (mode and mv.last_mode != mode) or (reason and mv.last_reason != reason):
        raise AssertionError(f"matview: {view} refreshed {mv.last_mode} ({mv.last_reason}), "
                             f"expected {mode} ({reason})")
    return ms


def matview_store(root, cat, device):
    """The shard store under `root` on `device`: orders, customer, nation,
    region whole, lineitem as its first MV_BASE_FRAC of rows, each with
    its primary key declared (MV_KEYS). Returns (store, lineitem's host page, the
    oracle, seconds)."""
    from presto_tpu_torch.connectors.shardstore import ShardStoreCatalog

    t0 = time.perf_counter()
    store = ShardStoreCatalog(root, device=device)
    li = None
    for name, key in MV_KEYS.items():
        page = cat.page(name).to("cpu")
        store.create_table(name, {n: b.type for n, b in zip(page.names, page.blocks)},
                           unique_columns=key)
        if name == "lineitem":
            li = page
            page = _rows_page(page, 0, int(int(page.count) * MV_BASE_FRAC))
        store.append(name, page)
    oracle = MvOracle(li)
    oracle.extend(_rows_page(li, 0, int(int(li.count) * MV_BASE_FRAC)))
    return store, li, oracle, time.perf_counter() - t0


def matview_batches(store, li, oracle, tables, device, batches=MV_BATCHES):
    """Create V1-V3, then `batches` appends, each followed by V1's
    and V2's texts run fresh (the first touch after the append), REFRESH
    of all three (V1 and V2 delta, V3 full with its reason), the views
    against numpy over the rows so far, REFRESH FULL of V1 and V2 equal to
    their delta-maintained rows, and V1's text run fresh, then through
    the result cache patched (patches + 1) and equal to the fresh rows.
    Returns (the store session, [per-batch report])."""
    from presto_tpu_torch.exec import qcache
    from presto_tpu_torch.session import Session

    sess = Session(store, device=device, result_cache=False)
    for v, sql in MV_SQL.items():
        sess.query(f"create materialized view {v} as {sql}")
        mv = sess.matviews_mgr.views[v]
        kind = None if mv.mplan is None else mv.mplan.kind
        if kind != MV_KIND[v] or (v == "v3" and mv.reason != MV_V3_REASON):
            raise AssertionError(f"matview: {v} classified {kind} ({mv.reason})")
    mv_check(sess, mv_expect(oracle, tables), "create")
    cached = Session(store, device=device, result_cache=True)
    cached.query(MV_SQL["v1"])
    n, n0 = int(li.count), oracle.num_rows
    step = -(-(n - n0) // batches)
    report = []
    for i in range(batches):
        lo, hi = n0 + i * step, min(n0 + (i + 1) * step, n)
        cuts = [lo + (hi - lo) * j // MV_PAGES for j in range(MV_PAGES + 1)]
        pages = [_rows_page(li, a, b) for a, b in zip(cuts, cuts[1:])]
        before = _counts()
        rows, append_ms = _timed(lambda: store.append_batch("lineitem", pages))
        if rows != hi - lo:
            raise AssertionError(f"matview batch {i}: append_batch wrote {rows} rows")
        for p in pages:
            oracle.extend(p)
        # the first query over lineitem after an append pays the shard
        # store's per-version work (the table-wide dictionaries and the
        # column-stats sample are rebuilt): V1's and V2's texts run fresh
        # first, so the refreshes and lookups below compare warm
        first = {v: _timed(lambda v=v: sess.query(MV_SQL[v]).rows())[1] for v in ("v1", "v2")}
        rep = {"batch": i, "rows": rows, "lineitem_rows": oracle.num_rows,
               "append_batch_s": append_ms / 1e3, "first_v1_ms": first["v1"],
               "first_v2_ms": first["v2"],
               "v1_delta_ms": mv_refresh(sess, "v1", mode="delta"),
               "v2_delta_ms": mv_refresh(sess, "v2", mode="delta"),
               "v3_full_ms": mv_refresh(sess, "v3", mode="full", reason=MV_V3_REASON)}
        expect = mv_expect(oracle, tables)
        delta_rows = mv_check(sess, expect, f"batch {i}")
        rep["v1_full_ms"] = mv_refresh(sess, "v1", full=True, mode="full", reason="forced full")
        rep["v2_full_ms"] = mv_refresh(sess, "v2", full=True, mode="full", reason="forced full")
        # the recomputed rows equal the delta-maintained ones exactly (so
        # numpy's too); V2's in key order
        for v in ("v1", "v2"):
            full = sess.query(f"select * from {v}").rows()
            want = delta_rows[v]
            if v == "v2":
                full, want = sorted(full), sorted(want)
            if full != want:
                raise AssertionError(f"matview batch {i}: {v} full != delta: "
                                     f"{row_diff(full, want)}")
        fresh, rep["fresh_ms"] = _timed(lambda: sess.query(MV_SQL["v1"]).rows())
        p0 = qcache.RESULT_CACHE.stats.snapshot()["patches"]
        got, rep["patched_ms"] = _timed(lambda: cached.query(MV_SQL["v1"]).rows())
        if qcache.RESULT_CACHE.stats.snapshot()["patches"] != p0 + 1:
            raise AssertionError(f"matview batch {i}: the cached V1 text was not patched")
        for a, b in ((got, fresh), (got, expect["v1"])):
            diff = row_diff(a, b)
            if diff is not None:
                raise AssertionError(f"matview batch {i}: patched V1 text differs: {diff}")
        rep["launches"] = {k: v - before[k] for k, v in _counts().items() if k != "q1_partials"}
        rep["view_rows"] = {v: len(r) for v, r in delta_rows.items()}
        report.append(rep)
        print("phase3 matview batch", json.dumps(rep), flush=True)
    return sess, report


def matview_fallbacks(sess, store, li, oracle, tables, device):
    """The checks after the batches: organize() merges the batches' shards
    and keeps every table_version, and a later delta refresh works; an
    upsert of 4 rows (feedback on for a query over lineitem first: the
    upsert must invalidate every history entry over lineitem) makes V1
    and V2 refresh in full with the rewrite reason; a batch past
    DELTA_MAX_FRAC refreshes in full. Each step holds the views against
    numpy. Returns {check: result}."""
    import os

    import torch

    from presto_tpu_torch.matview import maintenance
    from presto_tpu_torch.plan import history as H
    from presto_tpu_torch.session import Session

    out = {}
    rewrite = "delta not applicable (rewrite/large delta/race)"
    versions = {t: store.table_version(t) for t in store.table_names()}
    shards = {t: store.shard_count(t) for t in store.table_names()}
    merged, ms = _timed(store.organize)
    after = {t: store.table_version(t) for t in store.table_names()}
    shards_after = {t: store.shard_count(t) for t in store.table_names()}
    if after != versions or not merged:
        raise AssertionError(f"matview organize: {merged}, versions kept {after == versions}")
    late = _rows_page(li, 10_000, 15_000)
    late = _with_column(late, "l_orderkey", late.block("l_orderkey").data + 2 * MV_KEY_OFFSET)
    store.append_batch("lineitem", [late])
    oracle.extend(late)
    out["organize"] = {"organize_ms": ms, "merged": merged, "shards_before": shards,
                       "shards_after": shards_after,
                       "v1_delta_ms": mv_refresh(sess, "v1", mode="delta"),
                       "v2_delta_ms": mv_refresh(sess, "v2", mode="delta")}
    mv_refresh(sess, "v3", mode="full", reason=MV_V3_REASON)
    mv_check(sess, mv_expect(oracle, tables), "after organize")
    old = os.environ.get("PRESTO_TPU_FEEDBACK")
    os.environ["PRESTO_TPU_FEEDBACK"] = "1"
    try:
        H.HISTORY.reset()
        Session(store, device=device, result_cache=False).query(
            "select count(*) from lineitem where l_quantity * 1 >= 0")
        fps = [fp for fp, e in H.HISTORY.rows_snapshot() if "lineitem" in e.tables]
        inv0 = H.HISTORY.stats.snapshot()["invalidations"]
        up = _rows_page(li, 0, 4)
        up = _with_column(up, "l_quantity", up.block("l_quantity").data + 100)
        res, ms = _timed(lambda: store.upsert("lineitem", up))
        if res != {"appended": 0, "updated": 4}:
            raise AssertionError(f"matview upsert: {res}")
        live = [fp for fp in fps if H.HISTORY.lookup(fp, store) is not None]
        inv = H.HISTORY.stats.snapshot()["invalidations"] - inv0
        if not fps or live or inv < len(fps):
            raise AssertionError(f"matview upsert: {len(live)} of {len(fps)} lineitem history "
                                 f"entries live, {inv} invalidations")
    finally:
        if old is None:
            os.environ.pop("PRESTO_TPU_FEEDBACK")
        else:
            os.environ["PRESTO_TPU_FEEDBACK"] = old
        H.HISTORY.reset()
    oracle.upsert(up)
    out["upsert"] = {"upsert_s": ms / 1e3, "history_entries_invalidated": len(fps),
                     "v1_ms": mv_refresh(sess, "v1", mode="full", reason=rewrite),
                     "v2_ms": mv_refresh(sess, "v2", mode="full", reason=rewrite)}
    mv_refresh(sess, "v3", mode="full", reason=MV_V3_REASON)
    mv_check(sess, mv_expect(oracle, tables), "after the upsert")

    big = _rows_page(li, 0, 10_000)
    big = _with_column(big, "l_orderkey", big.block("l_orderkey").data + MV_KEY_OFFSET)
    frac = maintenance.DELTA_MAX_FRAC
    maintenance.DELTA_MAX_FRAC = 0.001
    try:
        store.append_batch("lineitem", [big])
        oracle.extend(big)
        out["too_large"] = {"rows": 10_000, "delta_max_frac": maintenance.DELTA_MAX_FRAC,
                            "v1_ms": mv_refresh(sess, "v1", mode="full", reason=rewrite),
                            "v2_ms": mv_refresh(sess, "v2", mode="full", reason=rewrite)}
    finally:
        maintenance.DELTA_MAX_FRAC = frac
    mv_refresh(sess, "v3", mode="full", reason=MV_V3_REASON)
    mv_check(sess, mv_expect(oracle, tables), "after the large batch")

    if device == "cuda":
        torch.cuda.synchronize()
    return out


def matview_path(cat, tables, device="cuda"):
    """The `matview` path: the shard store built from `cat`'s TPC-H tables
    (matview_store), the batches (matview_batches), the fallbacks
    (matview_fallbacks). `tables` are the host tables of the numpy
    checks. Returns (report, fallbacks)."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        store, li, oracle, build_s = matview_store(tmp, cat, device)
        print(f"phase3 matview store built in {build_s:.3f} s (lineitem rows="
              f"{oracle.num_rows} of {int(li.count)})", flush=True)
        sess, report = matview_batches(store, li, oracle, tables, device)
        falls = matview_fallbacks(sess, store, li, oracle, tables, device)
        falls["matview_footer"] = sess.explain_analyze("select count(*) from v1").split(
            "-- matview: ")[1].split("\n")[0]
        print("phase3 matview fallbacks", json.dumps(falls, default=str), flush=True)
    return report, falls


# the texts the `feedback` path streams twice, and at which budget: Q18 at
# STREAM_BUDGET, and Q9 at 6 MiB, where one of its hybrid joins recursed
# once with 17 partitions in the CPU rehearsal at SF 1
FEEDBACK_STREAM = {"Q18": STREAM_BUDGET, "Q9": 6 << 20}


def _plan_text(sess, text):
    from presto_tpu_torch.plan import nodes as N

    return N.plan_tree_str(sess.plan(text))


def observed_streaming_run(cat, text, budget, device="cuda"):
    """`text` in a new streaming session over `cat` at `budget`, with
    feedback on. Returns (rows, wall ms, the ladder of the executor that
    ran — a run that observes goes through a new collector-attached
    executor, Session._run_observed — and [(join fingerprint, partitions,
    recursion depth)] of every hybrid join, in the order they finished)."""
    from presto_tpu_torch.exec.stream import StreamingExecutor
    from presto_tpu_torch.plan import history as H
    from presto_tpu_torch.session import Session

    sess = Session(cat, device=device, streaming=True, batch_rows=STREAM_BATCH,
                   memory_budget=budget, result_cache=False)
    made, joins = [], []
    new_executor = sess._new_executor
    sess._new_executor = lambda collector=None: made.append(new_executor(collector)) or made[-1]
    record = StreamingExecutor._record_hybrid_outcome

    def spy(ex, node, P, depth_before):
        d = ex.spill_stats["hybrid_depth"]
        joins.append((H.fingerprint(node), P, max(d - depth_before, 0)))
        return record(ex, node, P, depth_before)

    StreamingExecutor._record_hybrid_outcome = spy
    try:
        rows, ms = _timed(lambda: sess.query(text).rows())
    finally:
        StreamingExecutor._record_hybrid_outcome = record
    return rows, ms, _ladder(made[-1] if made else sess.executor), joins


def feedback_path(sess, cat, device="cuda"):
    """The `feedback` path, with PRESTO_TPU_FEEDBACK=1 for it only (the
    store reset before and after): the 23 tpch22 texts on `sess` twice,
    the first run observing and the second planning from the
    observations, both held to TPCH22_ROWS in order; the plans that
    changed; EXPLAIN ANALYZE of Q5 with `-- feedback:` hits > 0; then each
    FEEDBACK_STREAM text streamed twice over `cat` at its budget from an
    empty store, with its hybrid parts and depth per run: every join frame
    that recursed in the first run (Q9's must) starts the second with at
    least min(P0 * 2^depth, 64) partitions. Returns {label: report}."""
    import os

    from presto_tpu_torch.benchmark.tpch_sql import QUERIES
    from presto_tpu_torch.plan import history as H

    old = os.environ.get("PRESTO_TPU_FEEDBACK")
    os.environ["PRESTO_TPU_FEEDBACK"] = "1"
    H.HISTORY.reset()
    try:
        report = {}
        texts = tpch22_texts()
        for run in (1, 2):
            for label, text in texts.items():
                plan = _plan_text(sess, text)
                before = _counts()
                rows, ms = _timed(lambda: sess.query(text).rows())
                diff = row_diff(rows, TPCH22_ROWS[label])
                if diff is not None:
                    raise AssertionError(f"feedback {label} run {run} differs from tpch22: {diff}")
                launches = {k: v - before[k] for k, v in _counts().items() if k != "q1_partials"}
                if run == 1:
                    report[label] = {"first_ms": ms, "first_launches": launches, "plan": plan}
                else:
                    rep = report[label]
                    rep.update(second_ms=ms, second_launches=launches,
                               plan_changed=plan != rep.pop("plan"))
                    print(f"phase3 feedback {label}", json.dumps(rep), flush=True)
        changed = sorted(lb for lb, r in report.items() if r["plan_changed"])
        txt = sess.explain_analyze(QUERIES[5])
        (line,) = [ln for ln in txt.split("\n") if ln.startswith("-- feedback:")]
        hits = int(line.split("hits=")[1].split()[0])
        if hits <= 0:
            raise AssertionError(f"feedback: EXPLAIN ANALYZE of Q5 shows no hits: {line}")
        store = H.HISTORY.stats.snapshot()
        print(f"phase3 feedback plans changed {len(changed)} of {len(texts)}: {changed}; Q5 "
              f"EXPLAIN ANALYZE {line[3:]}; store {json.dumps(store)}", flush=True)
        for label, budget in FEEDBACK_STREAM.items():
            # from an empty store, so that the first run plans statically
            # (the runs above recorded the text's frames on this catalog)
            H.HISTORY.reset()
            runs = []
            for run in (1, 2):
                rows, ms, ladder, joins = observed_streaming_run(cat, texts[label], budget, device)
                diff = row_diff(rows, TPCH22_ROWS[label])
                if diff is not None:
                    raise AssertionError(f"feedback streamed {label} run {run}: {diff}")
                runs.append({"ms": ms, "hybrid_parts": ladder["hybrid_parts"],
                             "hybrid_depth": ladder["hybrid_depth"], "spill": ladder["spill"],
                             "joins": joins})
            # each join frame that recursed in the first run starts the
            # second with its partitions scaled by 2^depth (capped at 64)
            second = {fp: p for fp, p, _d in runs[1]["joins"]}
            rescaled = [(fp, p, d, second[fp]) for fp, p, d in runs[0]["joins"]
                        if d > 0 and fp in second]
            bad = [r for r in rescaled if r[3] < min(r[1] << r[2], 64)]
            if bad or (label == "Q9" and not rescaled):
                raise AssertionError(f"feedback streamed {label}: rescaled {rescaled}, runs {runs}")
            report[f"stream_{label}"] = {"budget": budget, "runs": runs, "rescaled": rescaled}
            print(f"phase3 feedback streamed {label} at B={budget}",
                  json.dumps(report[f"stream_{label}"]), flush=True)
        report["summary"] = {"plans_changed": changed, "q5_hits": hits, "store": store}
        return report
    finally:
        if old is None:
            os.environ.pop("PRESTO_TPU_FEEDBACK")
        else:
            os.environ["PRESTO_TPU_FEEDBACK"] = old
        H.HISTORY.reset()


# -- phase 3: distributed execution over a worker mesh (`dist22`) ----------

DIST_WORKERS = 8  # logical workers of the mesh, all on the one card
DIST_REPARTITIONED = ("Q3", "Q5", "Q10", "Q17", "Q18")
DIST_SORT_SQL = "select o_orderkey from orders order by o_orderkey"
DIST_PERCENTILE_SQL = "select approx_percentile(o_totalprice, 0.5) from orders"
DIST_EXCHANGE_BUDGET = 50_000  # bytes per worker: Q3's joins run bucketed
# the benchmark path's numpy Q1 over the DeviceTpchCatalog(1.0) twin, which
# `dist22` holds q1_distributed to
BENCHMARK_Q1 = []


def _ordered(text):
    return "order by" in text.lower()


def _host_syncs(fn, where=False):
    """(fn(), the synchronizing CUDA calls torch reports in it under
    torch.cuda.set_sync_debug_mode: the host reads of device values, the
    device-to-host copies that stall the host); with `where`, also
    {"file:line": count} of the Python lines they came from."""
    import warnings

    import torch

    if not torch.cuda.is_available():
        return (fn(), 0, {}) if where else (fn(), 0)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode(1)
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    syncs = [w for w in caught if "synchronizing" in str(w.message)]
    if not where:
        return out, len(syncs)
    sites = {}
    for w in syncs:
        key = f"{w.filename}:{w.lineno}"
        sites[key] = sites.get(key, 0) + 1
    return out, len(syncs), sites


def _exchange_summary(ex):
    reparts = [e for e in ex.exchange_events if e.get("kind") == "repartition"]
    return {"repartitions": len(reparts), "rows": sum(e["rows"] for e in reparts),
            "collective_ms": sum(e["collective_ms"] for e in reparts),
            "buckets": [e["buckets"] for e in ex.exchange_events if "buckets" in e]}


def dist_runs(sess, texts, want_rows, label_prefix, runs=2):
    """Each {label: SQL} on the mesh session `sess`: `runs` runs (cold,
    then warm) held to want_rows[label] (in order under ORDER BY, as
    multisets otherwise); the cold run also counts the host syncs.
    Returns {label: report}."""
    report = {}
    for label, text in texts.items():
        ordered = _ordered(text)
        syncs = []

        def run(text=text, syncs=syncs):
            if syncs:
                return sess.query(text).rows()
            rows, n = _host_syncs(lambda: sess.query(text).rows())
            syncs.append(n)
            return rows

        cold, warm, launches, rows = _timed_runs(
            run, runs, lambda got: row_diff(got, want_rows[label], ordered),
            f"{label_prefix} {label} against the single-device card rows")
        report[label] = {"result_rows": len(rows), "launches": launches, "cold_ms": cold,
                         "warm_ms": warm, "host_syncs": syncs[0],
                         "exchange": _exchange_summary(sess.executor)}
        print(f"phase3 {label_prefix} {label}", json.dumps(report[label]), flush=True)
    return report


def dist_checks(sess, cat, mesh, device):
    """`dryrun_multichip`'s other checks over the mesh: the sort in order,
    approx_percentile within its sketch bound of the single-device value,
    Q3 bucketed under an exchange budget, and Q3 with the dynamic filters
    forced pruning rows. Returns {check: report}."""
    import os

    from presto_tpu_torch.benchmark.tpch_sql import QUERIES
    from presto_tpu_torch.ops import qsketch
    from presto_tpu_torch.session import Session

    local = Session(cat, device=device, result_cache=False)
    out = {}
    want = local.query(DIST_SORT_SQL).rows()
    rows, ms = _timed(lambda: sess.query(DIST_SORT_SQL).rows())
    diff = row_diff(rows, want)
    if diff is not None:
        raise AssertionError(f"dist22 sort against the single-device session: {diff}")
    out["sort"] = {"rows": len(rows), "cold_ms": ms}
    got_p = float(sess.query(DIST_PERCENTILE_SQL).rows()[0][0])
    want_p = float(local.query(DIST_PERCENTILE_SQL).rows()[0][0])
    tol = 1.0 / (2 * qsketch.SUB) + 0.005
    if not abs(got_p - want_p) <= tol * abs(want_p):
        raise AssertionError(f"dist22 approx_percentile {got_p} vs {want_p} past {tol}")
    out["percentile"] = {"mesh": got_p, "single": want_p, "rel_tol": tol}
    want3 = TPCH22_ROWS["Q3"]
    gx = Session(cat, mesh=mesh, broadcast_threshold=0, exchange_budget=DIST_EXCHANGE_BUDGET,
                 result_cache=False)
    before = _counts()
    rows, ms = _timed(lambda: gx.query(QUERIES[3]).rows())
    launches = {k: v - before[k] for k, v in _counts().items() if k != "q1_partials"}
    diff = row_diff(rows, want3)
    buckets = [e["buckets"] for e in gx.executor.exchange_events if "buckets" in e]
    if diff is not None or not buckets or max(buckets) <= 1:
        raise AssertionError(f"dist22 bucketed Q3: {diff}, buckets {buckets}")
    out["grouped_q3"] = {"buckets": buckets, "cold_ms": ms, "launches": launches,
                         "peak_bytes": [e["per_shard_bytes"] for e in gx.executor.exchange_events
                                        if "buckets" in e]}
    old = os.environ.get("PRESTO_TPU_DYNFILTER_FORCE")
    os.environ["PRESTO_TPU_DYNFILTER_FORCE"] = "1"
    try:
        df = Session(cat, mesh=mesh, result_cache=False)
        diff = row_diff(df.query(QUERIES[3]).rows(), want3)
        pruned = df.executor.dyn_ctx.total_pruned()
    finally:
        if old is None:
            os.environ.pop("PRESTO_TPU_DYNFILTER_FORCE")
        else:
            os.environ["PRESTO_TPU_DYNFILTER_FORCE"] = old
    if diff is not None or pruned <= 0:
        raise AssertionError(f"dist22 Q3 with forced dynamic filters: {diff}, pruned {pruned}")
    out["dynfilter_q3"] = {"pruned": pruned}
    print("phase3 dist22 checks", json.dumps(out), flush=True)
    return out


def dist22_path(cat, q1_page, device="cuda", n_workers=DIST_WORKERS, tpcds_sf=1.0):
    """The `dist22` path over default_mesh(n_workers) (every worker on the
    one card): (a) the 23 tpch22 texts under the cost-based join
    distribution and (b) DIST_REPARTITIONED with every join repartitioned,
    each held to TPCH22_ROWS; (c) dist_checks; (d) NOT_IN_SQL over
    TpcdsCatalog(tpcds_sf) through a mesh session, held to numpy; (e)
    handcoded.q1_distributed over the benchmark path's lineitem page, held
    to its numpy Q1. The join kernels must launch in (a) and (b), Q3 in
    each. Returns {part: report}."""
    from presto_tpu_torch.benchmark import handcoded
    from presto_tpu_torch.connectors.tpcds import TpcdsCatalog
    from presto_tpu_torch.parallel import default_mesh
    from presto_tpu_torch.session import Session

    mesh = default_mesh(n_workers, device=device)
    texts = tpch22_texts()
    report = {}
    for part, threshold, labels in (("cost", None, list(texts)),
                                    ("repartitioned", 0, DIST_REPARTITIONED)):
        sess = Session(cat, mesh=mesh, broadcast_threshold=threshold, result_cache=False)
        before = _counts()
        runs = dist_runs(sess, {lb: texts[lb] for lb in labels}, TPCH22_ROWS,
                         f"dist22 {part}")
        counts = {k: v - before[k] for k, v in _counts().items()}
        for k in ("join_insert", "join_probe"):
            if device == "cuda" and (counts[k] < 1 or runs["Q3"]["launches"][k] < 1):
                raise AssertionError(f"dist22 {part}: {k} launched {counts[k]} times, "
                                     f"Q3 {runs['Q3']['launches']}")
        report[part] = {"runs": runs, "launches": counts}
    report["checks"] = dist_checks(Session(cat, mesh=mesh, result_cache=False), cat, mesh,
                                   device)
    ds = TpcdsCatalog(tpcds_sf, device=device)
    want = not_in_checks(ds)
    ds_sess = Session(ds, mesh=mesh, result_cache=False)
    report["not_in"] = {}
    for label, sql in NOT_IN_SQL.items():
        cold, warm, launches, rows = _timed_runs(
            lambda: ds_sess.query(sql).rows(), 2, lambda got: row_diff(got, want[label]),
            f"dist22 {label} against numpy")
        report["not_in"][label] = {"rows": [list(r) for r in rows], "cold_ms": cold,
                                   "warm_ms": warm, "launches": launches}
    print("phase3 dist22 not_in", json.dumps(report["not_in"]), flush=True)
    want_q1 = BENCHMARK_Q1[0]
    cold, warm, launches, rows = _timed_runs(
        lambda: handcoded.q1_distributed(mesh, q1_page).to_pylist(), 3,
        lambda got: None if got == want_q1 else f"{got} != {want_q1}",
        "dist22 q1_distributed against numpy")
    report["q1_distributed"] = {"cold_ms": cold, "warm_ms": warm, "launches": launches}
    print("phase3 dist22 q1_distributed", json.dumps(report["q1_distributed"]), flush=True)
    cost = report["cost"]["runs"]
    print("phase3 dist22 summary", json.dumps({
        "workers": n_workers, "texts": len(cost),
        "warm_ms_total": sum(r["warm_ms"] for r in cost.values()),
        "launches": {p: report[p]["launches"] for p in ("cost", "repartitioned")}}), flush=True)
    return report


# -- phase 3: the HTTP cluster data plane -------------------------------------

HTTP_WORKERS = 2  # worker processes, both on cuda:0
HTTP_SF = 1.0
HTTP_FAULT_SF = 0.01  # the in-process fault and memory checks
# the wire checks: lineitem's page in a v2 frame as the wire sends it
# (its encodings shrink it past the compress-once ratio, so no codec runs),
# under each codec of a v2 frame with the codec forced, and in a PTP1 frame
HTTP_WIRE_CAPS = {
    "v2_default": {"version": 2, "codecs": ["lz4", "zlib", "raw"]},
    "lz4": {"version": 2, "codecs": ["lz4", "raw"]},
    "zlib": {"version": 2, "codecs": ["zlib", "raw"]},
    "raw": {"version": 2, "codecs": ["raw"]},
    "ptp1_lz4": {"version": 1, "codecs": ["lz4", "raw"]},
}
HTTP_BIG_SQL = ("select l_orderkey, sum(l_extendedprice * (1 - l_discount)) rev "
                "from lineitem, orders where l_orderkey = o_orderkey "
                "group by l_orderkey order by rev desc limit 10")


def http_worker_main(sf) -> int:
    """One `http22` worker process (`chip_smoke.py --http-worker SF`):
    WorkerServer(TpchCatalog(sf, device="cuda")) with every table generated
    and uploaded, one JSON line {"uri", "setup_s"} when it serves, then
    serve until standard input closes; then stop and print {"counts": the
    kernel launches of this process}."""
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("http22 worker: no CUDA device")
    from presto_tpu_torch.connectors.tpch import TpchCatalog
    from presto_tpu_torch.server import WorkerServer

    t0 = time.perf_counter()
    cat = TpchCatalog(float(sf), device="cuda")
    for name in TPCH_TABLES + ("partsupp",):
        cat.page(name)
    torch.cuda.synchronize()
    setup = time.perf_counter() - t0
    worker = WorkerServer(cat).start()
    print(json.dumps({"uri": worker.uri, "setup_s": setup}), flush=True)
    sys.stdin.read()
    worker.stop()
    print(json.dumps({"counts": _counts()}), flush=True)
    return 0


def start_http_workers(n=HTTP_WORKERS, sf=HTTP_SF):
    """Start the `http22` worker processes; they generate and upload their
    catalogs while the paths before `http22` run. Their standard error is
    this process's."""
    import os

    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=here + os.pathsep + os.environ.get("PYTHONPATH", ""))
    return [subprocess.Popen([sys.executable, os.path.join(here, "chip_smoke.py"),
                              "--http-worker", str(sf)], cwd=here, env=env,
                             stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
            for _ in range(n)]


def http_workers_ready(procs):
    """[(uri, setup_s)] of the started workers, once each serves."""
    out = []
    for p in procs:
        line = p.stdout.readline()
        if not line:
            raise AssertionError(f"http22 worker {p.pid} exited with {p.wait()} before serving")
        info = json.loads(line)
        out.append((info["uri"], info["setup_s"]))
    return out


def stop_http_workers(procs, timeout=120):
    """Close the workers' standard input, wait for them, and return each
    one's launch counts; a worker that dies or exits non-zero fails."""
    counts, failed = [], []
    for p in procs:
        if not p.stdin.closed:
            p.stdin.close()
    for p in procs:
        try:
            p.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
            failed.append(f"worker {p.pid} did not stop within {timeout} s")
            continue
        out = p.stdout.read()
        p.stdout.close()
        if p.returncode != 0:
            failed.append(f"worker {p.pid} exited with {p.returncode}")
            continue
        lines = [ln for ln in out.splitlines() if ln.startswith("{")]
        counts.append(json.loads(lines[-1])["counts"])
    if failed:
        raise AssertionError("http22: " + "; ".join(failed))
    return counts


def _pages_equal(a, b):
    """Every live value of two pages on the card equal, block by block
    (dictionaries by their entries)."""
    import torch

    from presto_tpu_torch.page import dictionary_by_id

    n = int(a.count)
    if int(b.count) != n or a.names != b.names:
        return f"count {int(b.count)} != {n} or names differ"
    for name, x, y in zip(a.names, a.blocks, b.blocks):
        if not torch.equal(x.data[:n], y.data[:n]):
            return f"column {name} differs"
        if (x.valid is None) != (y.valid is None) or (
                x.valid is not None and not torch.equal(x.valid[:n], y.valid[:n])):
            return f"column {name}'s nulls differ"
        if (x.dict_id is None) != (y.dict_id is None) or (
                x.dict_id is not None and tuple(dictionary_by_id(x.dict_id))
                != tuple(dictionary_by_id(y.dict_id))):
            return f"column {name}'s dictionary differs"
    return None


def http_wire_checks(cat, device="cuda"):
    """Lineitem's SF 1 page on the card through serialize_page and
    deserialize_page (onto the card) under each of HTTP_WIRE_CAPS (the
    named codec forced past the compress-once ratio), each result equal to
    the page, and the frame's codec byte that of the named codec: bytes,
    the ratio, ms each way and the copies between the card and the host a
    page. Returns {label: report}."""
    import torch

    from presto_tpu_torch.server.serde import WireStats, deserialize_page, serialize_page

    page = cat.page("lineitem")
    out = {}
    for label, caps in HTTP_WIRE_CAPS.items():
        stats = WireStats()
        torch.cuda.synchronize()
        t = time.perf_counter()
        data = serialize_page(page, caps=caps, stats=stats,
                              compress_once=label == "v2_default")
        ser = (time.perf_counter() - t) * 1e3
        t = time.perf_counter()
        back = deserialize_page(data, device=device, stats=stats)
        torch.cuda.synchronize()
        de = (time.perf_counter() - t) * 1e3
        diff = _pages_equal(page, back)
        if diff is not None:
            raise AssertionError(f"http22 wire {label}: {diff}")
        codec = {0: "raw", 1: "zlib", 2: "lz4", 3: "zstd"}[data[4]]
        if label != "v2_default" and codec != caps["codecs"][0]:
            raise AssertionError(f"http22 wire {label}: a {codec} frame")
        snap = stats.snapshot()
        out[label] = {"rows": int(page.count), "raw_bytes": snap["raw_bytes"],
                      "wire_bytes": len(data), "ratio": snap["compression_ratio"],
                      "serialize_ms": ser, "deserialize_ms": de,
                      "d2h_copies": snap["d2h_copies"], "h2d_copies": snap["h2d_copies"],
                      "encodings": snap["encodings"], "frame": bytes(data[:4]).decode(),
                      "codec": codec}
        del data, back
    print("phase3 http22 wire", json.dumps(out), flush=True)
    return out


def http_fault_checks(device="cuda"):
    """On a small in-process cluster (TpchCatalog(HTTP_FAULT_SF) on
    `device`): Q5 with a worker at fault_rate=1.0 beside a healthy one
    equals the CPU's rows and SchedulerStats shows the retry; HTTP_BIG_SQL
    past a worker memory_limit fails with the structured "ran out of
    memory" TaskFailure and every worker pool drains to 0."""
    from presto_tpu_torch.benchmark.tpch_sql import QUERIES
    from presto_tpu_torch.connectors.tpch import TpchCatalog
    from presto_tpu_torch.server import HttpClusterSession, NodeManager, TaskFailure, WorkerServer
    from presto_tpu_torch.session import Session

    cat = TpchCatalog(HTTP_FAULT_SF, device=device)
    want = Session(cat.with_device("cpu"), device="cpu", result_cache=False).query(
        QUERIES[5]).rows()
    out = {}
    workers = [WorkerServer(TpchCatalog(HTTP_FAULT_SF, device=device)).start(),
               WorkerServer(TpchCatalog(HTTP_FAULT_SF, device=device), fault_rate=1.0).start()]
    try:
        nodes = NodeManager([w.uri for w in workers], interval=3600, task_failure_threshold=50)
        sess = HttpClusterSession(cat, nodes, result_cache=False,
                                  scheduler_opts={"backoff_base": 0.01, "backoff_cap": 0.1})
        rows, ms = _timed(lambda: sess.query(QUERIES[5]).rows())
        diff = row_diff(rows, want)
        st = sess.scheduler.stats_snapshot()
        if diff is not None or st["task_retries"] < 1:
            raise AssertionError(f"http22 fault_rate=1.0: {diff}, retries {st['task_retries']}")
        out["fault_rate"] = {"ms": ms, "task_retries": st["task_retries"],
                             "query_retries": st["query_retries"],
                             "tasks_failed": st["tasks_failed"]}
    finally:
        for w in workers:
            w.stop()
    workers = [WorkerServer(TpchCatalog(HTTP_FAULT_SF, device=device), memory_limit=2_000).start()
               for _ in range(2)]
    sess = None
    try:
        nodes = NodeManager([w.uri for w in workers], interval=3600)
        sess = HttpClusterSession(cat, nodes, memory_manager=True, result_cache=False)
        t = time.perf_counter()
        try:
            sess.query(HTTP_BIG_SQL).rows()
        except TaskFailure as e:
            if "ran out of memory" not in str(e):
                raise
        else:
            raise AssertionError("http22: the query past memory_limit completed")
        killed_ms = (time.perf_counter() - t) * 1e3
        deadline = time.time() + 10
        while time.time() < deadline and any(w.pool.snapshot()["reserved"] for w in workers):
            time.sleep(0.05)
        left = [w.pool.snapshot()["reserved"] for w in workers]
        if any(left) or not sess.memory_manager.killed:
            raise AssertionError(f"http22 low-memory kill: pools {left}, "
                                 f"killed {sess.memory_manager.killed}")
        out["memory_kill"] = {"ms": killed_ms, "killed": sess.memory_manager.killed,
                              "pools_after": left}
    finally:
        if sess is not None:
            sess.close()
        for w in workers:
            w.stop()
    print("phase3 http22 faults", json.dumps(out), flush=True)
    return out


# served through a CoordinatorServer over the HttpClusterSession: (part, text)
HTTP_COORD_TEXTS = (("repartitioned", "Q5"), ("cost", "Q10"))


def wait_split(trace):
    """Per consuming stage of a merged cluster trace (obs/span.py): its
    tasks' wait on empty staging and, beside it, their pullers' HTTP and
    decode walls; its producers' (the tasks of the stages it pulls from)
    executor, emit and encode walls, and their results handlers' walls
    blocked for a page and sending. The coordinator's gathers count as a
    stage ("root") over the stages under the same attempt. Returns
    [{stage, tasks, wait_ms, pull_ms, decode_ms, producers, exec_ms,
    emit_ms, encode_ms, serve_wait_ms, serve_send_ms}]."""
    spans = trace.spans()
    kids = {}
    for sp in spans:
        kids.setdefault(sp.parent_id, []).append(sp)

    def tasks_of(stage):
        return [t for d in kids.get(stage.span_id, ()) if d.name.startswith("dispatch ")
                for t in kids.get(d.span_id, ()) if t.name.startswith("task ")]

    def wall(task, *path):
        node = [task]
        for name in path:
            node = [c for n in node for c in kids.get(n.span_id, ()) if c.name == name]
        return sum(n.wall_s for n in node) * 1e3

    def producers(stages):
        tasks = [t for st in stages for t in tasks_of(st)]
        return {"producers": len(tasks),
                "exec_ms": sum(wall(t, "exec") for t in tasks),
                "emit_ms": sum(wall(t, "emit") for t in tasks),
                "encode_ms": sum(wall(t, "emit", "encode") for t in tasks),
                "serve_wait_ms": sum(float(t.attrs.get("serve_wait_ms", 0)) for t in tasks),
                "serve_send_ms": sum(float(t.attrs.get("serve_send_ms", 0)) for t in tasks)}

    out = []
    for st in (sp for sp in spans if sp.name.startswith("stage ")):
        below = [c for c in kids.get(st.span_id, ()) if c.name.startswith("stage ")]
        if not below:
            continue
        tasks = tasks_of(st)
        out.append(dict({"stage": st.name, "tasks": len(tasks),
                         "wait_ms": sum(wall(t, "exec", "wait") for t in tasks),
                         "pull_ms": sum(wall(t, "exec", "wait", "pull") for t in tasks),
                         "decode_ms": sum(wall(t, "exec", "wait", "decode") for t in tasks)},
                        **producers(below)))
    for attempt in (sp for sp in spans if sp.name.startswith("attempt ")):
        gathers = [c for c in kids.get(attempt.span_id, ()) if c.name.startswith("exchange ")]
        below = [c for c in kids.get(attempt.span_id, ()) if c.name.startswith("stage ")]
        out.append(dict({"stage": "root", "tasks": 1,
                         "wait_ms": sum(float(g.attrs.get("wait_ms", 0)) for g in gathers),
                         "pull_ms": sum(float(g.attrs.get("wire_ms", 0)) for g in gathers),
                         "decode_ms": sum(float(g.attrs.get("decode_ms", 0)) for g in gathers)},
                        **producers(below)))
    return out


def http_coordinator(sessions, uris, runs=1):
    """HTTP_COORD_TEXTS through a CoordinatorServer over each part's
    HttpClusterSession and a Client, `runs` times (once: the sessions ran
    each text cold and warm just before; two runs took ~5 s more),
    held to TPCH22_ROWS; the last run's merged trace split by
    wait_split; then one worker's
    /v1/metrics, which must hold presto_exchange_* and presto_kernel_*
    series. Returns {label: report} and the scrape's kernel lines."""
    import urllib.request

    from presto_tpu_torch.obs import TRACES
    from presto_tpu_torch.server import Client, CoordinatorServer

    texts = tpch22_texts()
    out = {}
    for part, label in HTTP_COORD_TEXTS:
        srv = CoordinatorServer(sessions[part]).start()
        try:
            client = Client(srv.uri, timeout=600)
            walls = []
            for _ in range(runs):
                rows, ms, info = coord_run(client, srv, texts[label])
                diff = row_diff(rows, json_rows(TPCH22_ROWS[label]), _ordered(texts[label]))
                if diff is not None:
                    raise AssertionError(f"http22 coordinator {part} {label}: {diff}")
                walls.append(ms)
        finally:
            srv.stop()
        trace = TRACES.get(info.trace_id)
        if trace is None or trace.orphans():
            raise AssertionError(f"http22 coordinator {part} {label}: trace {info.trace_id} "
                                 f"missing or with orphans")
        names = [sp.name for sp in trace.spans()]
        out[f"{part} {label}"] = {
            "ms": walls, "phase_ms": info.phase_ms,
            "trace_id": info.trace_id, "spans": len(names),
            "task_spans": sum(n.startswith("task ") for n in names),
            "stages": wait_split(trace)}
        print(f"phase3 http22 coordinator {part} {label}", json.dumps(out[f"{part} {label}"]),
              flush=True)
    with urllib.request.urlopen(uris[0] + "/v1/metrics", timeout=60) as r:
        text = r.read().decode()
    exch = [ln for ln in text.splitlines() if ln.startswith("presto_exchange_")]
    kern = [ln for ln in text.splitlines() if ln.startswith("presto_kernel_")]
    if not exch or not kern:
        raise AssertionError(f"http22 worker /v1/metrics without exchange or kernel series:\n"
                             f"{text[:2000]}")
    print("phase3 http22 worker metrics", json.dumps({"exchange": exch, "kernel": kern}),
          flush=True)
    return out, kern


def http22_path(cat, procs, tpch22=None, device="cuda"):
    """The `http22` path: HttpClusterSession over the worker processes of
    start_http_workers (each WorkerServer(TpchCatalog(HTTP_SF)) on the
    card), the coordinator in this process over `cat`: (a) the 23 tpch22
    texts under the cost-based distribution and (b) DIST_REPARTITIONED
    with every join repartitioned, each cold then warm and held to
    TPCH22_ROWS, with warm ms against `tpch22`'s, wire bytes and exchange
    ms a text, and Q5's ragged pages; (c) http_coordinator, the texts of
    HTTP_COORD_TEXTS served by a CoordinatorServer over the sessions of
    (a) and (b), their consumer waits split, and a worker's metrics; (d)
    http_wire_checks; (e) http_fault_checks. The workers stop at the end;
    their launch counts are returned per worker with the report."""
    from presto_tpu_torch.server import HttpClusterSession, NodeManager

    report = {}
    try:
        ready = http_workers_ready(procs)
        print("phase3 http22 workers", json.dumps(
            [{"uri": u, "catalog_setup_s": s} for u, s in ready]), flush=True)
        nodes = NodeManager([u for u, _ in ready], interval=3600)
        texts = tpch22_texts()
        sessions = {}
        for part, threshold, labels in (("cost", None, list(texts)),
                                        ("repartitioned", 0, DIST_REPARTITIONED)):
            sess = sessions[part] = HttpClusterSession(cat, nodes, broadcast_threshold=threshold,
                                                       result_cache=False)
            runs = {}
            for label in labels:
                text = texts[label]
                cold, warm, launches, rows = _timed_runs(
                    lambda text=text: sess.query(text).rows(), 2,
                    lambda got, label=label, text=text: row_diff(
                        got, TPCH22_ROWS[label], _ordered(text)),
                    f"http22 {part} {label} against the tpch22 card rows")
                st = sess.scheduler.stats_snapshot()
                wire = st["wire"]
                runs[label] = {
                    "result_rows": len(rows), "cold_ms": cold, "warm_ms": warm,
                    "tpch22_warm_ms": (tpch22 or {}).get(label, {}).get("warm_ms"),
                    "wire_bytes": wire.get("wire_bytes"), "raw_bytes": wire.get("raw_bytes"),
                    "pages": wire.get("pages"), "exchange_ms": wire.get("pull_ms"),
                    "consumer_wait_ms": wire.get("wait_ms"), "task_exec_ms": wire.get("exec_ms"),
                    "task_emit_ms": wire.get("emit_ms"),
                    "encode_ms": wire.get("encode_ms"), "d2h_copies": wire.get("d2h_copies"),
                    "coordinator_launches": launches,
                    "query_retries": st["query_retries"], "task_retries": st["task_retries"]}
                if part == "repartitioned" and label == "Q5":
                    runs[label]["hier"] = st["hier"]
                    if not st["hier"].get("wire_pages"):
                        raise AssertionError(f"http22 repartitioned Q5 shipped no ragged "
                                             f"pages: {st['hier']}")
                print(f"phase3 http22 {part} {label}", json.dumps(runs[label]), flush=True)
            report[part] = runs
        report["coordinator"], _kern = http_coordinator(sessions, [u for u, _ in ready])
        report["wire"] = http_wire_checks(cat, device)
        report["faults"] = http_fault_checks(device)
    finally:
        worker_counts = stop_http_workers(procs)
    print("phase3 http22 worker launches", json.dumps(worker_counts), flush=True)
    for k in ("groupby_partials", "join_insert", "join_probe"):
        if sum(c[k] for c in worker_counts) < 1:
            raise AssertionError(f"http22: no worker process launched {k}: {worker_counts}")
    cost = report["cost"]
    print("phase3 http22 summary", json.dumps({
        "workers": len(worker_counts), "texts": len(cost),
        "warm_ms_total": sum(r["warm_ms"] for r in cost.values()),
        "tpch22_warm_ms_total": sum(r["tpch22_warm_ms"] or 0.0 for r in cost.values()),
        "wire_bytes_total": sum(r["wire_bytes"] or 0 for r in cost.values())}), flush=True)
    return report, worker_counts


# -- phase 3: TPC-DS at SF 1, and the scalar function library ---------------

TPCDS_SF = 1.0
# processes computing the CPU side of `tpcds` (8 host cores). They start
# after `tpch22` and overlap the paths from `streaming22` to `http22`,
# beside this process and the `http22` workers: 3 (5 when the pool started
# at `tpcds`) finish the ~1,370 s of CPU before `tpcds` needs it and leave
# the overlapped paths more of the cores; `phase3 overlap` measures the cost
CPU_WORKERS = 3
# the TPC-DS texts slowest on the CPU (some over a minute at SF 1 on one
# core), submitted to the pool first
CPU_SLOW_FIRST = ("Q14", "Q22", "Q39", "Q139", "Q114", "Q4", "Q123", "Q23", "Q64", "Q11",
                  "Q74", "Q78", "Q47", "Q57")
# the `tpcds` texts phase 2 captures kernel calls from: the star joins of
# inventory and of the three sales channels, the ROLLUP texts (planned as a
# union of one aggregation per level, so no level groups by a NULL
# literal), and the functions path's store_sales aggregates, which group by
# ss_store_sk, a foreign key the generator leaves NULL in about 4 % of rows
TPCDS_CAPTURE = ("Q3", "Q5", "Q7", "Q14", "Q18", "Q21", "Q22", "Q27", "Q36", "Q37", "Q39",
                 "Q67", "Q70", "Q72", "Q76", "Q77", "Q80", "Q82", "Q86", "math", "bitwise")
# `tpcds` traces the texts with the slowest warm walls, this many. Every
# text above 20 ms traced 91 of the 103 on the H100; with the `dist22` path
# the script came within 140 s of its time limit, and the traces (a cold
# and a profiled run each, in their own process) were its longest step, so
# only texts above 250 ms were traced, 15-20 of them. When walls grow more
# texts pass a fixed threshold and the step grows with them (72-137 s of
# traces over the runs that added the `http22` path, whose whole script
# took 828-1,190 s on the same code, within 11 s of the limit; those runs
# did not tell a slower host from the overlap with the CPU pool, which
# then started after phase 1), so a fixed count. The same cuts
# run each `tpcds` text once warm after its cold run (twice before
# `dist22`), each `streaming22` text once (twice before `dist22`) and
# `matview` in 2 batches (8 before `dist22`, 4 before `http22`). The
# `coordinator` path and `http22`'s coordinator checks added ~20 s (the
# whole script 1,062 s on a host whose `files22` took 200.7 s, against
# 227.6 s on the host of the 1,110 s run before them), so 3 texts are
# traced (6 before the `coordinator` path); the traces are the step
# after the card runs that the script waits for.
TRACE_TPCDS_TEXTS = 3


def make_tpcds_session(sf=TPCDS_SF, device="cuda"):
    """Session over TpcdsCatalog(sf) on `device`, all 24 tables generated and
    uploaded (set-up, not query time); without the result cache, as
    make_session."""
    import torch

    from presto_tpu_torch.connectors.tpcds import TABLE_NAMES, TpcdsCatalog
    from presto_tpu_torch.session import Session

    t0 = time.perf_counter()
    cat = TpcdsCatalog(sf, device=device)
    for name in TABLE_NAMES:
        cat.page(name)
    if device == "cuda":
        torch.cuda.synchronize()
    rows = {n: cat.exact_row_count(n)
            for n in ("inventory", "store_sales", "catalog_sales", "web_sales")}
    print(f"phase3 tpcds SF {sf} tables generated+uploaded in "
          f"{time.perf_counter() - t0:.3f} s, fact rows {json.dumps(rows)}", flush=True)
    return Session(cat, device=device, result_cache=False), cat


def tpcds_texts():
    """{label: SQL} of the `tpcds` path: the 103 TPC-DS texts."""
    from presto_tpu_torch.benchmark.tpcds_sql import QUERIES

    return {f"Q{q}": QUERIES[q] for q in sorted(QUERIES)}


_CPU_SESSION = None
_CPU_TPCH = None  # a worker's TPC-H session, made on its first TPC-H text
_TPCH_SF = 1.0


def _cpu_worker_init(sf):
    import torch

    from presto_tpu_torch.connectors.tpcds import TpcdsCatalog
    from presto_tpu_torch.session import Session

    global _CPU_SESSION
    torch.set_num_threads(1)
    _CPU_SESSION = Session(TpcdsCatalog(sf, device="cpu"), device="cpu", result_cache=False)


def _cpu_rows(label, text, tpch=False):
    sess = _cpu_tpch() if tpch else _CPU_SESSION
    t = time.perf_counter()
    rows = sess.query(text).rows()
    return label, rows, (time.perf_counter() - t) * 1e3


def start_cpu_rows(texts, sf=TPCDS_SF, workers=CPU_WORKERS, tpch_texts=None, statements=False):
    """The port's rows of every text on the CPU, computed in `workers` new
    processes (spawned, one torch thread each; each generates the tables
    its queries read, from the same seeds, so they are the card's tables)
    while this process drives the card: the TPC-DS `texts` and, first, the
    `statements` path's CPU side (_cpu_statements, under the label
    "statements") and the `tpch_texts` over TPC-H at SF 1. Returns (pool,
    {label: future})."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    pool = ProcessPoolExecutor(workers, mp_context=multiprocessing.get_context("spawn"),
                               initializer=_cpu_worker_init, initargs=(sf,))
    futures = {"statements": pool.submit(_cpu_statements)} if statements else {}
    futures.update({label: pool.submit(_cpu_rows, label, text, True)
                    for label, text in (tpch_texts or {}).items()})
    order = [q for q in CPU_SLOW_FIRST if q in texts] + [q for q in texts
                                                         if q not in CPU_SLOW_FIRST]
    futures.update({label: pool.submit(_cpu_rows, label, texts[label]) for label in order})
    return pool, futures


def weak_checks(texts, report):
    """The texts whose result checks little: no rows, or a ROLLUP whose only
    row is the grand total. A global aggregate's one row is a real check."""
    empty = [q for q, r in report.items() if r["result_rows"] == 0]
    total_only = [q for q, r in report.items()
                  if r["result_rows"] == 1 and "rollup" in texts[q].lower()]
    return {"empty": empty, "rollup_grand_total_only": total_only}


def tpcds_card_runs(sess, runs=3):
    """The 103 TPC-DS texts through Session.query on the card, each cold then
    warm. Returns ({label: report}, {label: the rows of each run})."""
    report, outs = {}, {}
    t0 = time.perf_counter()
    for label, text in tpcds_texts().items():
        outs[label] = []
        cold, warm, launches, rows = _timed_runs(
            lambda: sess.query(text).rows(), runs, lambda got: outs[label].append(got),
            f"{label} on the card")
        report[label] = {"result_rows": len(rows), "launches": launches, "cold_ms": cold,
                         "warm_ms": warm}
    print(f"phase3 tpcds card runs {time.perf_counter() - t0:.3f} s", flush=True)
    return report, outs


def tpcds_summary(report, traces):
    """Totals and spreads of the `tpcds` path over its texts (report, from
    tpcds_card_runs and tpcds_compare) and its traced windows (traces, from
    finish_traces): the line PERF.md's summary reads."""
    import statistics

    def spread(vals):
        vals = sorted(vals)
        return {"n": len(vals), "sum": sum(vals), "median": statistics.median(vals),
                "p90": vals[int(0.9 * (len(vals) - 1))], "max": vals[-1]}

    prof = [g for (section, _), g in traces.items() if section == "tpcds"]
    # device busy, idle and device-to-host counts only from complete
    # windows; copies and synchronises are host-side, counted in every one
    whole = [g for g in prof if g["complete"]]
    out = {
        "warm_ms": spread([r["warm_ms"] for r in report.values()]),
        "cold_ms": spread([r["cold_ms"] for r in report.values()]),
        "cpu_ms": spread([r["cpu_ms"] for r in report.values()]),
        "slowest_warm": sorted(report, key=lambda q: -report[q]["warm_ms"])[:10],
        "launches": {k: sum(r["launches"][k] for r in report.values())
                     for k in ("groupby_partials", "join_insert", "join_probe")},
        "traced": len(prof), "complete_windows": len(whole),
        "incomplete_windows": sorted((q for (section, q), g in traces.items()
                                      if section == "tpcds" and not g["complete"]),
                                     key=lambda q: int(q[1:])),
        "missing_device_records": sum(g["missing_device_records"] for g in prof),
        "host_copy_calls": spread([g["memcpy_calls"] for g in prof]),
        "host_stream_syncs": spread([g["stream_syncs"] for g in prof]),
    }
    if whole:
        out.update(device_busy_ms=spread([g["device_busy_ms"] for g in whole]),
                   idle_share=spread([g["idle_share_of_warm_wall"] for g in whole]),
                   device_launches=spread([g["device_launches"] for g in whole]),
                   dtoh_copies=spread([g["host_syncs"] for g in whole]))
    print("phase3 tpcds summary", json.dumps(out), flush=True)
    return out


def tpcds_compare(report, outs, cpu_rows):
    """Each run's rows (tpcds_card_runs) against the port's rows on the CPU
    (`cpu_rows`, {label: future} from start_cpu_rows). Returns the weak
    checks."""
    texts = tpcds_texts()
    t0 = time.perf_counter()
    for label in texts:
        _, want, cpu_ms = cpu_rows[label].result()
        for got in outs.pop(label):
            diff = row_diff(got, want)
            if diff is not None:
                raise AssertionError(f"{label} on the card against the CPU: {diff}")
        report[label]["cpu_ms"] = cpu_ms
        print(f"phase3 tpcds {label}", json.dumps(report[label]), flush=True)
    weak = weak_checks(texts, report)
    held = [q for q in texts if q not in weak["empty"] + weak["rollup_grand_total_only"]]
    print(f"phase3 tpcds waited {time.perf_counter() - t0:.3f} s for the CPU rows; "
          f"{len(held)} of {len(texts)} texts held, weak checks {json.dumps(weak)}", flush=True)
    return weak


# the `functions` path: one SELECT per family of the scalar function library
# over TPC-DS columns (dates from date_dim and time_dim, strings from
# customer and item, numbers from store_sales)
FUNCTION_SQL = {
    "dates": "select d_date_sk, date_add('month', 1, d_date), date_add('day', -3, d_date), "
             "date_diff('day', d_date, date '2002-01-01'), date_diff('month', d_date, date '2001-07-31'), "
             "date_trunc('quarter', d_date), date_trunc('week', d_date), "
             "date_format(d_date, '%Y-%m-%d %a %b %j'), format_datetime(d_date, 'yyyy/MM/dd EEE'), "
             "to_iso8601(d_date), week(d_date), year_of_week(d_date), last_day_of_month(d_date), "
             "to_unixtime(d_date), hour(d_date), from_iso8601_date(d_date_id) is null "
             "from date_dim where d_year between 1998 and 2002 order by d_date_sk",
    "timestamps": "select t_time_sk, from_unixtime(t_time + 946684800), "
             "hour(from_unixtime(t_time)), minute(from_unixtime(t_time)), "
             "second(from_unixtime(t_time)), millisecond(from_unixtime(t_time + 0.25)), "
             "date_trunc('hour', from_unixtime(t_time)), "
             "date_add('minute', 90, from_unixtime(t_time)), "
             "date_diff('second', from_unixtime(t_time), from_unixtime(86399)), "
             "year_of_week(from_unixtime(t_time)), timezone_hour(from_unixtime(t_time)) "
             "from time_dim where t_time_sk % 997 = 0 "
             "order by t_time_sk",
    "math": "select ss_store_sk, count(*), sum(greatest(ss_quantity, ss_item_sk % 7)), "
            "sum(least(ss_quantity, 50)), sum(width_bucket(ss_sales_price, 0, 200, 10)), "
            "sum(truncate(ss_net_profit)), max(cbrt(ss_quantity)), max(log(2, ss_quantity + 1)), "
            "min(atan2(ss_net_profit, ss_sales_price + 1)), max(pow(ss_quantity, 2)), "
            "max(expm1(ss_quantity / 100.0)), max(log1p(ss_quantity)), max(asinh(ss_quantity)), "
            "max(cot(ss_quantity + 0.5)), max(ceiling(ss_sales_price)), "
            "max(wilson_interval_upper(ss_quantity, 100, 1.96)) "
            "from store_sales group by ss_store_sk order by ss_store_sk",
    "bitwise": "select ss_store_sk, sum(bitwise_and(ss_ticket_number, 255)), "
               "sum(bitwise_or(ss_item_sk, 3)), sum(bitwise_xor(ss_ticket_number, ss_item_sk)), "
               "sum(bit_count(ss_ticket_number, 64)), sum(bitwise_not(ss_item_sk)), "
               "sum(bitwise_left_shift(ss_item_sk, 3)), "
               "sum(bitwise_right_shift(-ss_ticket_number, 60)), "
               "sum(bitwise_arithmetic_shift_right(-ss_ticket_number, 2)), "
               "sum(bitwise_logical_shift_right(-ss_item_sk, 61)) "
               "from store_sales group by ss_store_sk order by ss_store_sk",
    "strings": "select c_customer_sk, lpad(c_first_name, 12, '*'), rpad(c_last_name, 4), "
               "reverse(c_last_name), replace(c_email_address, 'email', 'mail:'), "
               "split_part(c_first_name, 'a', 2), ltrim(c_salutation), ucase(c_first_name), "
               "levenshtein_distance(c_first_name, 'John'), strrpos(c_last_name, 'e'), "
               "position('a' in c_first_name), codepoint(c_last_name), chr(65), "
               "translate(c_last_name, 'aeiou', 'AEIOU'), concat_ws('-', c_first_name, c_last_name), "
               "char_length(c_email_address), hamming_distance(c_birth_country, 'CHILE') "
               "from customer where c_customer_sk % 97 = 0 order by c_customer_sk",
    "regexp": "select i_item_sk, regexp_like(i_item_desc, '^[A-M]'), "
              "regexp_replace(i_brand, '([a-z]+)', '<$1>'), regexp_extract(i_class, '(\\w+) class', 1), "
              "regexp_count(i_item_desc, 'e'), word_stem(i_category), normalize(i_color) "
              "from item where i_item_sk % 13 = 0 order by i_item_sk",
    "json_url": "select c_customer_sk, "
                "json_extract_scalar(concat(concat('{\"id\": \"', c_last_name), '\", \"n\": [1, 2]}'), '$.id'), "
                "json_array_length(json_extract(concat(concat('{\"id\": \"', c_last_name), '\", \"n\": [1, 2]}'), '$.n')), "
                "json_size(concat(concat('{\"id\": \"', c_last_name), '\", \"n\": [1, 2]}'), '$.n'), "
                "json_array_get(concat(concat('[\"', c_first_name), '\", 3]'), 0), "
                "is_json_scalar(c_first_name), json_format(concat(concat('[', c_birth_country), ']')), "
                "url_extract_host(concat(concat('https://', c_first_name), '.example.com:8443/p/q?id=7#top')), "
                "url_extract_port(concat(concat('https://', c_first_name), '.example.com:8443/p/q?id=7#top')), "
                "url_extract_parameter(concat(concat('https://h/p?id=', c_last_name), '&x=1'), 'id'), "
                "url_encode(c_email_address), url_decode(url_encode(c_first_name)) "
                "from customer where c_customer_sk % 89 = 0 order by c_customer_sk",
    "digests": "select i_item_sk, md5(i_item_id), sha1(i_brand), sha256(i_category), "
               "substr(sha512(i_item_id), 1, 16), crc32(i_item_id), xxhash64(i_item_id), "
               "spooky_hash_v2_64(i_item_id), to_hex(i_category), from_hex(to_hex(i_category)), "
               "to_base64(i_brand), from_base64(to_base64(i_brand)), hmac_sha256(i_item_id, 'k'), "
               "from_base(substr(i_item_id, 10, 7), 10), char2hexint(i_size) "
               "from item where i_item_sk % 11 = 0 order by i_item_sk",
    "constants": "select count(*), sum(pi() * d_moy), max(e()), typeof(max(d_date)), "
                 "max(to_base(255, 16)), max(human_readable_seconds(86461)), "
                 "max(current_timezone()), sum(if(d_date <= current_date(), 1, 0)) "
                 "from date_dim where d_year = 2000",
}


def functions_path(sess, cpu_sess, runs=3):
    """FUNCTION_SQL through Session.query on the card, each run held against
    the port on the CPU over the same host tables. Returns {family: report}."""
    report = {}
    for family, text in FUNCTION_SQL.items():
        t = time.perf_counter()
        want = cpu_sess.query(text).rows()
        cpu_ms = (time.perf_counter() - t) * 1e3
        cold, warm, launches, rows = _timed_runs(
            lambda: sess.query(text).rows(), runs, lambda got: row_diff(got, want),
            f"functions {family} on the card against the CPU")
        if not rows:
            raise AssertionError(f"functions {family} returned no rows")
        report[family] = {"result_rows": len(rows), "launches": launches, "cold_ms": cold,
                          "warm_ms": warm, "cpu_ms": cpu_ms}
        print(f"phase3 functions {family}", json.dumps(report[family]), flush=True)
    return report


# -- phase 3: collections (ARRAY and MAP values) at TPC-H SF 1 --------------

def _nation_triangles():
    """One triangle per nation as WKT coordinate text, picked by
    n_nationkey + 1 from an array literal: the points (x, y) of C6 are
    (c_acctbal + 1000, c_custkey % 1000), x in [0, 11000), and neighbouring
    triangles overlap."""
    tri = [f"'{k * 440} 0, {k * 440 + 880} 0, {k * 440 + 440} 999, {k * 440} 0'"
           for k in range(25)]
    return "array[" + ", ".join(tri) + "]"


# the `collections` path: ARRAY and MAP values on TPC-H SF 1 (C1-C7)
COLLECTION_SQL = {
    # array_agg into 10,000 groups of ~600 (the width retry 128 -> 1,024),
    # unnested back with ordinality: the element order within a group is
    # the rows' order, so sum(k * o) holds it
    "C1": "select count(*), sum(k), sum(k * o), count(distinct s) from (select l_suppkey s, "
          "array_agg(l_orderkey) a from lineitem group by l_suppkey) q "
          "cross join unnest(a) with ordinality as u(k, o)",
    # the map aggregates over customer join orders by nation, each map read
    # back by element_at, map_keys, map_values and transform_values
    "C2": "with j as (select c_nationkey n, c_mktsegment seg, o_orderstatus st, "
          "o_orderpriority pr, o_totalprice tp from customer join orders on c_custkey = o_custkey), "
          "h as (select n, histogram(pr) hp, map_agg(st, pr) ma, numeric_histogram(10, tp) nh "
          "from j group by n), "
          "mm as (select n, multimap_agg(st, pr) mm from (select distinct n, st, pr from j) d "
          "group by n), "
          "mu as (select n, map_union(m) mu from (select n, seg, map_agg(st, c) m from "
          "(select n, seg, st, count(*) c from j group by n, seg, st) x group by n, seg) y "
          "group by n) "
          "select h.n, element_at(hp, '1-URGENT'), map_keys(hp), map_values(hp), ma, "
          "transform_values(hp, (k, c) -> c * 2), map_values(nh), "
          "reduce(map_keys(nh), 0.0, (s, x) -> s + x, s -> s), "
          "mm, element_at(mu, 'F'), "
          "map_keys(mu) from h join mm on h.n = mm.n join mu on h.n = mu.n order by h.n",
    # lambdas over ~100,000 per-customer arrays
    "C3": "select count(*), sum(cardinality(filter(a, x -> x > 200000))), "
          "sum(reduce(transform(a, x -> x * 2), 0.0, (s, x) -> s + x, s -> s)), "
          "sum(reduce(zip_with(a, b, (x, y) -> x * y), 0.0, (s, x) -> s + x, s -> s)), "
          "count_if(any_match(a, x -> x > 450000)), sum(element_at(a, 1)) from "
          "(select o_custkey, array_agg(o_totalprice) a, array_agg(o_shippriority + 1) b "
          "from orders group by o_custkey) q",
    # words of p_name by position, with the array functions over the words
    "C4": "select w, o, count(*), sum(cardinality(array_distinct(parts))), "
          "count_if(contains(slice(parts, 2, 3), w)), sum(array_position(parts, w)), "
          "count_if(contains(parts, 'green')) from (select split(p_name, ' ') parts from part) p "
          "cross join unnest(parts) with ordinality as u(w, o) group by w, o order by w, o",
    # a regression per return flag, then the models applied to lineitem
    "C5": "select l_returnflag, learn_regressor(l_extendedprice, array[l_quantity, l_discount, "
          "l_tax]) from lineitem group by l_returnflag order by l_returnflag",
    "C5r": "with m as (select l_returnflag f, learn_regressor(l_extendedprice, "
           "array[l_quantity, l_discount, l_tax]) model from lineitem group by l_returnflag) "
           "select f, count(*), sum(regress(array[l_quantity, l_discount, l_tax], model)) "
           "from lineitem join m on l_returnflag = f group by f order by f",
    # a nested-loop spatial join: 25 triangles against 150,000 points
    "C6": "with g as (select n_nationkey nk, st_polygon(concat(concat('POLYGON((', "
          f"element_at({_nation_triangles()}, n_nationkey + 1)), '))')) poly from nation) "
          "select nk, count(*) from g, customer where st_contains(poly, "
          "st_point(c_acctbal + 1000, c_custkey % 1000)) group by nk order by nk",
    # the 11 CDFs: the closed forms and torch.special ones over every
    # lineitem row, the incomplete-beta ones over the distinct (discount,
    # quantity) pairs weighted by their counts
    "C7": "select sum(normal_cdf(25, 10, l_quantity)), "
          "sum(inverse_normal_cdf(0, 1, l_discount * 9 + 0.05)), "
          "sum(cauchy_cdf(25, 5, l_quantity)), sum(gamma_cdf(2, 10, l_quantity)), "
          "sum(laplace_cdf(25, 8, l_quantity)), sum(weibull_cdf(1.5, 20, l_quantity)), "
          "sum(chi_squared_cdf(5, l_tax * 100)), sum(poisson_cdf(25, l_quantity)) "
          "from lineitem",
    "C7b": "select sum(c * beta_cdf(2, 5, d * 8)), sum(c * binomial_cdf(50, 0.5, q)), "
           "sum(c * inverse_beta_cdf(2, 5, d * 8 + 0.05)), count(*) from "
           "(select l_discount d, l_quantity q, count(*) c from lineitem group by 1, 2) x",
    # sketch states as rows, read by value_at_quantile and cardinality
    "C7s": "select qdigest_agg(l_quantity), approx_set(l_partkey), "
           "value_at_quantile(qdigest_agg(l_quantity), 0.5), "
           "cardinality(approx_set(l_partkey)) from lineitem",
    "C7m": "select cardinality(merge(s)), count(*) from (select l_returnflag, "
           "approx_set(l_partkey) s from lineitem group by l_returnflag) x",
}


def numpy_c1(t):
    """C1 over lineitem: the rows, sum(l_orderkey), the sum of l_orderkey
    times its 1-based position among its supplier's rows in row order, and
    the number of suppliers."""
    import numpy as np

    c = t["lineitem"].columns
    key = c["l_orderkey"].data.astype(np.int64)
    supp = c["l_suppkey"].data.astype(np.int64)
    order = np.argsort(supp, kind="stable")
    s_sorted = supp[order]
    starts = np.flatnonzero(np.r_[True, s_sorted[1:] != s_sorted[:-1]])
    run = np.repeat(starts, np.diff(np.r_[starts, len(order)]))
    pos = np.arange(len(order)) - run + 1
    return [(len(key), int(key.sum()), int((key[order] * pos).sum()), len(starts))]


def numpy_c5(t):
    """C5's weights by numpy's least squares: {flag: (w_quantity,
    w_discount, w_tax, intercept)} over logical (unscaled) values."""
    import numpy as np

    c = t["lineitem"].columns
    x = np.stack([c[n].data / 100.0 for n in ("l_quantity", "l_discount", "l_tax")]
                 + [np.ones(t["lineitem"].num_rows)], axis=1)
    y = c["l_extendedprice"].data / 100.0
    flags = c["l_returnflag"]
    out = {}
    for code, flag in enumerate(flags.dictionary):
        m = flags.data == code
        out[flag] = np.linalg.lstsq(x[m], y[m], rcond=None)[0]
    return out


def numpy_c6(t):
    """C6 by an even-odd ray cast in numpy over the same triangles and
    points (a point on an edge or a vertex counts as inside)."""
    import numpy as np

    c = t["customer"].columns
    px = c["c_acctbal"].data / 100.0 + 1000.0
    py = (c["c_custkey"].data % 1000).astype(np.float64)
    rows = []
    for k in range(25):
        v = np.array([[k * 440, 0], [k * 440 + 880, 0], [k * 440 + 440, 999], [k * 440, 0]],
                     np.float64)
        inside = np.zeros(len(px), bool)
        edge = np.zeros(len(px), bool)
        for (ax, ay), (bx, by) in zip(v[:-1], v[1:]):
            if (ay > py).any() or (by > py).any():
                straddle = (ay > py) != (by > py)
                with np.errstate(divide="ignore", invalid="ignore"):
                    xint = ax + (py - ay) / (by - ay) * (bx - ax)
                inside ^= straddle & (px < xint)
            cross = (bx - ax) * (py - ay) - (by - ay) * (px - ax)
            within = ((px >= min(ax, bx)) & (px <= max(ax, bx))
                      & (py >= min(ay, by)) & (py <= max(ay, by)))
            edge |= (np.abs(cross) <= 1e-9 * np.hypot(bx - ax, by - ay)) & within
        n = int((inside | edge).sum())
        if n:
            rows.append((k, n))
    return rows


def collection_checks(tables):
    """{label: check(rows) -> None or the difference} against numpy for
    C1, C5 (the weights within 1e-6 relative: numpy's least squares and
    the normal equations round differently) and C6."""
    c1, c5, c6 = numpy_c1(tables), numpy_c5(tables), numpy_c6(tables)

    def check_c5(rows):
        from presto_tpu_torch.ops.mlreg import K_MAX

        for flag, model in rows:
            got = [model[0], model[1], model[2], model[K_MAX]]
            want = c5[flag]
            if any(abs(g - w) > 1e-6 * max(abs(w), 1.0) for g, w in zip(got, want)):
                return f"C5 {flag}: weights {got} != numpy lstsq {list(want)}"
        return None if len(rows) == len(c5) else f"C5: {len(rows)} models != {len(c5)}"

    return {"C1": lambda rows: row_diff(rows, c1), "C5": check_c5,
            "C6": lambda rows: row_diff(rows, c6)}


def collections_path(sess, tables, runs=3):
    """The COLLECTION_SQL texts through Session.query on the card, each cold
    then warm, C1, C5 and C6 also held against numpy; C1 must take the
    collection-width retry. Returns ({label: report}, {label: the rows of
    each run}) for collections_compare."""
    t0 = time.perf_counter()
    checks = collection_checks(tables)
    print(f"phase3 collections numpy checks computed in {time.perf_counter() - t0:.3f} s",
          flush=True)
    report, outs = {}, {}
    for label, text in COLLECTION_SQL.items():
        outs[label] = []
        retries = len(sess.executor.width_retries)

        def check(got, label=label):
            outs[label].append(got)
            return checks[label](got) if label in checks else None

        cold, warm, launches, rows = _timed_runs(
            lambda: sess.query(text).rows(), runs, check, f"{label} on the card")
        widths = sess.executor.width_retries[retries:]
        report[label] = {"result_rows": len(rows), "launches": launches, "cold_ms": cold,
                         "warm_ms": warm, "width_retries": widths[:len(widths) // runs]}
    if not report["C1"]["width_retries"]:
        raise AssertionError("C1 did not take the collection-width retry on the card")
    return report, outs


def collections_compare(report, outs, cpu_rows):
    """Each card run's rows against the port's rows on the CPU (futures
    from start_cpu_rows' TPC-H texts), in order."""
    for label in COLLECTION_SQL:
        _, want, cpu_ms = cpu_rows[label].result()
        for got in outs.pop(label):
            diff = row_diff(got, want)
            if diff is not None:
                raise AssertionError(f"{label} on the card against the CPU: {diff}")
        report[label]["cpu_ms"] = cpu_ms
        print(f"phase3 collections {label}", json.dumps(report[label]), flush=True)


# -- phase 3: the statement layer (`statements`) -----------------------------

# the tables of the `statements` path: a MemoryCatalog over the TPC-H
# session's pages (statements_catalog), rev and co written into it
Q1_CTAS = ("create table rev as select l_returnflag, l_linestatus, sum(l_quantity) sum_qty, "
           "sum(l_extendedprice) sum_base_price, "
           "sum(l_extendedprice * (1 - l_discount)) sum_disc_price, count(*) count_order "
           "from lineitem where l_shipdate <= date '1998-09-02' "
           "group by l_returnflag, l_linestatus")
CO_COLUMNS = "o_orderkey, o_custkey, o_orderdate, o_totalprice, {}, c_nationkey, c_mktsegment"
CO_JOIN = " from orders, customer where o_custkey = c_custkey"
CO_FINGERPRINT = ("select count(*), sum(o_orderkey), sum(o_custkey), sum(o_totalprice), "
                  "sum(c_nationkey) from co")
S3_FROM = (1998, 1, 1)  # INSERT's date filter
S4_QUANTITY = 49  # DELETE's semi-join filter
S6_DAY = (1995, 6, 17)  # the rolled-back INSERT's day
S6_BEFORE = (1993, 1, 1)  # the committed DELETE's cutoff


def _sql_date(ymd):
    return "date '%04d-%02d-%02d'" % ymd


def statement_steps():
    """{step: (statement, ...)} of the `statements` path, run in order; a
    statement is SQL, or (SQL, user) for the access-controlled session of
    S11. Each co write is followed by CO_FINGERPRINT."""
    from presto_tpu_torch.benchmark.tpch_sql import QUERIES

    co = CO_COLUMNS.format("o_orderpriority, c_name")
    renamed = CO_COLUMNS.format("c_name")  # after S5: cust_name, no o_orderpriority
    q1, q5 = QUERIES[1], QUERIES[5]
    return {
        "S1": (Q1_CTAS, "select * from rev order by l_returnflag, l_linestatus"),
        "S2": (f"create table co as select {co}{CO_JOIN}", CO_FINGERPRINT),
        "S3": (f"insert into co select {co}{CO_JOIN} and o_orderdate >= {_sql_date(S3_FROM)}",
               CO_FINGERPRINT),
        "S4": ("delete from co where o_orderkey in (select l_orderkey from lineitem "
               f"where l_quantity >= {S4_QUANTITY})", CO_FINGERPRINT),
        "S5": ("alter table co add column note varchar",
               "alter table co rename column c_name to cust_name",
               "alter table co drop column o_orderpriority", "show columns from co"),
        "S6": ("start transaction",
               f"insert into co select {renamed}, 'staged'{CO_JOIN} "
               f"and o_orderdate = {_sql_date(S6_DAY)}",
               "select count(*), count(note) from co", "rollback", "select count(*) from co",
               "start transaction", f"delete from co where o_orderdate < {_sql_date(S6_BEFORE)}",
               "commit", CO_FINGERPRINT),
        "S7": ("prepare p from select c_nationkey, count(*), sum(o_totalprice) from co "
               "where o_custkey < ? group by 1 order by 1",
               "execute p using 50000", "execute p using 100000", "execute p using 100000",
               "describe input p", "describe output p"),
        "S8": ("set session pallas_groupby = false", "explain analyze " + q1, q1,
               "reset session pallas_groupby", "explain analyze " + q1,
               "set session dynamic_filtering = false", "explain analyze " + q5, q5,
               "reset session dynamic_filtering"),
        "S10": ("show stats for lineitem", "show functions", "show session"),
        "S11": (("select count(*) from rev", "bob"), ("grant select on rev to bob", "admin"),
                ("select count(*) from rev", "bob"), ("revoke select on rev from bob", "admin"),
                ("select count(*) from rev", "bob")),
    }


def statements_catalog(cat, device):
    """A MemoryCatalog over the TPC-H catalog's pages (no copy) with its
    declared keys, on `device`."""
    from presto_tpu_torch.connectors.memory import MemoryCatalog

    names = TPCH_TABLES + ("partsupp",)
    return MemoryCatalog({n: cat.page(n) for n in names},
                         unique={n: cat.unique_columns(n) for n in names}, device=device)


def analyze_summary(lines):
    """What EXPLAIN ANALYZE's text holds that does not depend on timing:
    each node's indented name, rows in and out and strategy (the
    hash-table join's mode, `pallas` on the card and `host` on the CPU,
    left out), and whether it has a dynamic-filters line."""
    import re

    pat = re.compile(r"^(\s*- \S+).*\[[\d,.]+ms, in ([\d,]+) rows, out ([\d,]+) rows(.*)\]$")
    nodes = []
    for line in lines:
        m = pat.match(line)
        if m:
            strategy = re.search(r"strategy=([^;\]]+)", m.group(4))
            note = None if strategy is None else re.sub(r"\((pallas|host)\)", "",
                                                        strategy.group(1).split(" occ=")[0])
            nodes.append([m.group(1), int(m.group(2).replace(",", "")),
                          int(m.group(3).replace(",", "")), note])
    n_nodes = sum(1 for ln in lines if ln.lstrip().startswith("- "))
    return {"nodes": nodes, "bracketed": len(nodes) == n_nodes,
            "dynamic_filters": any(ln.startswith("-- dynamic filters:") for ln in lines)}


def acl_session(catalog, device):
    """A session over `catalog` under a RuleBasedAccessControl granting
    admin everything and nobody else anything (S11)."""
    from presto_tpu_torch.security import RuleBasedAccessControl
    from presto_tpu_torch.session import Session

    return Session(catalog, device=device, user="admin",
                   access_control=RuleBasedAccessControl([{"user": "admin",
                                                           "privileges": "all"}]))


def run_statements(catalog, device):
    """Every step of statement_steps() in order over `catalog`: per step
    its wall ms and launches, and per statement its rows (EXPLAIN ANALYZE:
    analyze_summary; a denied statement: "denied"), and how many plan- and
    result-cache hits and kernel launches it made."""
    from presto_tpu_torch.exec import qcache
    from presto_tpu_torch.security import AccessDeniedError
    from presto_tpu_torch.session import Session

    sess, acl = Session(catalog, device=device), acl_session(catalog, device)
    out = {}
    for label, stmts in statement_steps().items():
        t0 = time.perf_counter()
        recs = []
        for item in stmts:
            sql, user = item if isinstance(item, tuple) else (item, None)
            hits0 = {k: s["hits"] for k, s in qcache.snapshot_all().items()}
            launches0 = _counts()
            try:
                rows = (acl if user else sess).query(sql, user=user).rows()
            except AccessDeniedError:
                rows = "denied"
            if sql.startswith("explain analyze"):
                rows = analyze_summary([r[0] for r in rows])
            hits = {k: s["hits"] - hits0[k] for k, s in qcache.snapshot_all().items()}
            recs.append({"sql": sql, "rows": rows, "plan_hits": hits["plan"],
                         "result_hits": hits["result"],
                         "launches": {k: v - launches0[k] for k, v in _counts().items()}})
        out[label] = {"ms": (time.perf_counter() - t0) * 1e3, "statements": recs}
    return out


def _cpu_tpch():
    """The pool worker's TPC-H SF 1 session on the CPU, made on first use."""
    global _CPU_TPCH
    if _CPU_TPCH is None:
        from presto_tpu_torch.connectors.tpch import TpchCatalog
        from presto_tpu_torch.session import Session

        _CPU_TPCH = Session(TpchCatalog(_TPCH_SF, device="cpu"), device="cpu",
                            result_cache=False)
    return _CPU_TPCH


def _cpu_statements():
    """The CPU side of `statements` in a pool worker: run_statements over a
    MemoryCatalog of the worker's TPC-H tables, and EXPLAIN ANALYZE of Q5
    on its TPC-H session (S9)."""
    from presto_tpu_torch.benchmark.tpch_sql import QUERIES

    tpch = _cpu_tpch()
    t = time.perf_counter()
    q5 = analyze_summary(tpch.explain_analyze(QUERIES[5]).split("\n"))
    q5_ms = (time.perf_counter() - t) * 1e3
    return run_statements(statements_catalog(tpch.catalog, "cpu"), "cpu"), q5, q5_ms


def _statement_rows(run, label, i):
    return run[label]["statements"][i]["rows"]


def statement_numpy_checks(run, tables, q1_rows, q5_rows):
    """S2-S4 and S6 against numpy counts over the host tables, and S8's
    queries against numpy's Q1 and Q5; the first difference or None."""
    import numpy as np

    o, li = tables["orders"].columns, tables["lineitem"].columns
    od = o["o_orderdate"].data
    n_orders = len(od)  # every order has its customer
    late = int((od >= _days(*S3_FROM)).sum())
    big = np.unique(li["l_orderkey"].data[li["l_quantity"].data >= S4_QUANTITY * 100])
    gone = np.isin(o["o_orderkey"].data, big)
    kept_dates = np.concatenate([od[~gone], od[(od >= _days(*S3_FROM)) & ~gone]])
    n4 = len(kept_dates)
    staged = int((od == _days(*S6_DAY)).sum())
    dropped = int((kept_dates < _days(*S6_BEFORE)).sum())
    want = {
        ("S2", 0): [(n_orders,)], ("S3", 0): [(late,)],
        ("S4", 0): [(n_orders + late - n4,)],
        ("S6", 1): [(staged,)], ("S6", 2): [(n4 + staged, staged)], ("S6", 4): [(n4,)],
        ("S6", 6): [(dropped,)],
    }
    counts = {"S2": n_orders, "S3": n_orders + late, "S4": n4, "S6": n4 - dropped}
    for (label, i), rows in want.items():
        if _statement_rows(run, label, i) != rows:
            return f"{label} statement {i}: {_statement_rows(run, label, i)} != numpy {rows}"
    for label, n in counts.items():
        got = _statement_rows(run, label, -1)[0][0]
        if got != n:
            return f"{label} fingerprint count {got} != numpy {n}"
    for i, want_rows in ((2, q1_rows), (7, q5_rows)):
        diff = row_diff(_statement_rows(run, "S8", i), want_rows)
        if diff is not None:
            return f"S8 statement {i} against numpy: {diff}"
    return None


def statement_checks(run):
    """What the path requires of one run on the card; the first failure or
    None."""
    def rec(label, i):
        return run[label]["statements"][i]

    def launched(label, i, k):
        return rec(label, i)["launches"][k]

    if launched("S1", 0, "groupby_partials") < 1:
        return "S1's CTAS did not launch the group-by kernel"
    for label in ("S2", "S4"):
        for k in ("join_insert", "join_probe"):
            if launched(label, 0, k) < 1:
                return f"{label} did not launch {k}"
    if rec("S7", 2)["plan_hits"] != 1:
        return f"S7's second EXECUTE made {rec('S7', 2)['plan_hits']} plan-cache hits, not 1"
    third = rec("S7", 3)
    if third["result_hits"] != 1 or any(third["launches"].values()):
        return f"S7's repeated EXECUTE was no result-cache hit: {third}"
    if rec("S7", 3)["rows"] != rec("S7", 2)["rows"]:
        return "S7's repeated EXECUTE changed its rows"
    off, on = rec("S8", 1)["rows"], rec("S8", 4)["rows"]
    agg = [n for n in off["nodes"] if n[0].strip() == "- Aggregate"]
    note = agg[0][3] if agg else None
    k1 = launched("S8", 1, "groupby_partials")
    if note not in ("hash-slot", "hash-sort") or k1 != (1 if note == "hash-slot" else 0):
        return f"S8 with pallas_groupby off: Aggregate strategy {note}, {k1} group-by launches"
    if [n for n in on["nodes"] if n[0].strip() == "- Aggregate"][0][3] != "pallas":
        return "S8 after RESET: the Aggregate does not note pallas"
    if rec("S8", 6)["rows"]["dynamic_filters"]:
        return "S8 with dynamic_filtering off still printed dynamic filters"
    if not all(rec("S8", i)["rows"]["bracketed"] for i in (1, 4, 6)):
        return "S8: a plan node of EXPLAIN ANALYZE has no bracket"
    if [r["rows"] for r in run["S11"]["statements"]][::2] != ["denied", [(4,)], "denied"]:
        return f"S11: {[r['rows'] for r in run['S11']['statements']]}"
    return None


def _shown(rec):
    """A statement's result on its step line: the row count a write
    reports, the rows a query returns, EXPLAIN ANALYZE's plan nodes, or
    "denied"."""
    rows = rec["rows"]
    if isinstance(rows, str):
        return rows
    if isinstance(rows, dict):
        return f"{len(rows['nodes'])} nodes"
    if rec["sql"].split()[0] in ("create", "insert", "delete"):
        return f"count {rows[0][0]}"
    return len(rows)


def _same_result(a, b):
    if isinstance(a, list) and isinstance(b, list):
        return row_diff(a, b) is None
    return a == b


def statements_path(sess, cat, tables, runs=2):
    """The statement layer on the card: statement_steps() `runs` times,
    each over a new MemoryCatalog of the TPC-H session's pages (the first
    run cold, the next warm), each run held by statement_checks and
    against numpy (statement_numpy_checks); then EXPLAIN ANALYZE of Q5 on
    the TPC-H session itself (S9), cold then warm. Returns the report for
    statements_compare."""
    from presto_tpu_torch.benchmark.tpch_sql import QUERIES

    q1_rows, q5_rows = numpy_q1(tables["lineitem"]), numpy_q5(tables)
    card = []
    for _ in range(runs):
        run = run_statements(statements_catalog(cat, "cuda"), "cuda")
        fault = statement_checks(run) or statement_numpy_checks(run, tables, q1_rows, q5_rows)
        if fault is not None:
            raise AssertionError(f"statements on the card: {fault}")
        card.append(run)
    walls, q5 = [], None
    for _ in range(runs):
        before = _counts()
        t = time.perf_counter()
        text = sess.explain_analyze(QUERIES[5])
        walls.append((time.perf_counter() - t) * 1e3)
        summary = analyze_summary(text.split("\n"))
        if q5 is None:
            q5 = {"summary": summary, "launches": {k: v - before[k] for k, v in _counts().items()}}
        if not summary["bracketed"] or summary["nodes"] != q5["summary"]["nodes"]:
            raise AssertionError(f"S9 EXPLAIN ANALYZE of Q5: {summary}")
    for k in ("groupby_partials", "join_insert", "join_probe"):
        if q5["launches"][k] < 1:
            raise AssertionError(f"S9 EXPLAIN ANALYZE of Q5 did not launch {k}")
    q5.update(cold_ms=walls[0], warm_ms=min(walls[1:]))
    return {"card": card, "S9": q5}


def statements_compare(report, cpu_future, traced):
    """Every statement of every card run against the CPU's (rows, EXPLAIN
    ANALYZE summaries with their strategies, denials, and the plan- and
    result-cache hits each made), S9's per-node rows against the CPU's
    EXPLAIN ANALYZE of Q5, and S9's traces: EXPLAIN ANALYZE of Q5 may make
    at most 2 device-to-host copies more than plain Q5. Prints one line a
    step and a summary line."""
    cpu, cpu_q5, cpu_q5_ms = cpu_future.result()
    for run in report["card"]:
        for label, step in run.items():
            for got, want in zip(step["statements"], cpu[label]["statements"]):
                for key in ("rows", "plan_hits", "result_hits"):
                    if not _same_result(got[key], want[key]):
                        raise AssertionError(f"statements {label} {got['sql'][:80]!r} {key} on "
                                             f"the card {got[key]} != CPU {want[key]}")
    q5 = report["S9"]
    if q5["summary"] != cpu_q5:
        raise AssertionError(f"S9 EXPLAIN ANALYZE of Q5 on the card {q5['summary']} != "
                             f"CPU {cpu_q5}")
    plain, analyzed = traced[("statements", "Q5")], traced[("statements", "Q5_explain_analyze")]
    extra = analyzed["host_syncs"] - plain["host_syncs"]
    if not (plain["complete"] and analyzed["complete"]) or extra > 2:
        raise AssertionError(f"S9: EXPLAIN ANALYZE of Q5 made {extra} device-to-host copies "
                             f"more than Q5 (complete windows: {plain['complete']}, "
                             f"{analyzed['complete']})")
    cold, warm = report["card"][0], report["card"][-1]
    for label, step in cold.items():
        recs = step["statements"]
        line = {"statements": [r["sql"][:60] for r in recs],
                "rows": [_shown(r) for r in recs],
                "launches": {k: sum(r["launches"][k] for r in recs) for k in _counts()},
                "cold_ms": step["ms"], "warm_ms": warm[label]["ms"], "cpu_ms": cpu[label]["ms"]}
        print(f"phase3 statements {label}", json.dumps(line), flush=True)
    print("phase3 statements S9", json.dumps({
        "statement": "explain analyze Q5 (TpchCatalog SF 1)", "nodes": len(q5["summary"]["nodes"]),
        "launches": q5["launches"], "cold_ms": q5["cold_ms"], "warm_ms": q5["warm_ms"],
        "cpu_ms": cpu_q5_ms, "q5_dtoh": plain["host_syncs"],
        "explain_analyze_dtoh": analyzed["host_syncs"],
        "idle_share": analyzed["idle_share_of_warm_wall"]}), flush=True)
    n = sum(len(step["statements"]) for step in cold.values())
    print(f"phase3 statements summary: {len(cold)} steps and S9, {n} statements a run, "
          f"{len(report['card'])} runs on the card each held against the CPU and numpy; "
          f"EXPLAIN ANALYZE of Q5 {extra:+d} device-to-host copies against Q5", flush=True)


def run_tpcds_traces(path):
    """The new process of start_traces: profile_one over one warm run of
    each (section, label, SQL, warm ms) item of the job at `path`, on a new
    TPC-DS session on the card, each window traced once (the summary
    leaves an incomplete window out of its device-side spreads)."""
    with open(path) as f:
        job = json.load(f)
    sess, _ = make_tpcds_session(job["sf"])
    tpch = None  # the `collections` and `statements` texts read TPC-H
    for section, label, text, warm_ms in job["items"]:
        on = sess
        if section in ("collections", "statements"):
            if tpch is None:
                tpch, _ = make_session(_TPCH_SF)
            on = tpch
        # the `statements` pair is compared by device-to-host copies, so
        # an incomplete window is traced again
        tries = 3 if section == "statements" else 1
        summary, _ = profile_one(lambda: on.query(text).rows(), warm_ms, tries=tries)
        print(f"phase3 {section} {label} profile", json.dumps(summary), flush=True)


def start_traces(items, tmp, sf=TPCDS_SF):
    """profile_one over the (section, label, SQL, warm ms) items in one new
    process (late in a long process torch.profiler loses device records:
    launch_checks_in_child), started now and read by finish_traces; the
    job file goes in the directory `tmp`."""
    import os

    path = os.path.join(tmp, "traces.json")
    with open(path, "w") as f:
        json.dump({"sf": sf, "items": items}, f)
    proc = subprocess.Popen(
        [sys.executable, "-c", f"import chip_smoke; chip_smoke.run_tpcds_traces({path!r})"],
        cwd=os.path.dirname(os.path.abspath(__file__)), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    return proc, len(items), time.perf_counter()


def finish_traces(handle, timeout=900):
    """The lines of start_traces' process, relayed; {(section, label):
    summary}."""
    proc, n_items, t0 = handle
    try:
        stdout, stderr = proc.communicate(timeout=timeout)
    finally:
        proc.kill()
    got = {}
    for line in stdout.splitlines():
        if line.startswith("phase3"):
            print(line, flush=True)
        if line.startswith("phase3") and " profile {" in line:
            section, label = line.split()[1:3]
            got[(section, label)] = json.loads(line[line.index("{"):])
    if proc.returncode != 0:
        raise AssertionError(f"the traces failed:\n{stdout[-3000:]}\n{stderr[-3000:]}")
    if len(got) != n_items:
        raise AssertionError(f"{n_items} traces asked for, {len(got)} made")
    complete = sum(g["complete"] for g in got.values())
    missing = sum(g["missing_device_records"] for g in got.values())
    pad = sum(g["pad_records_lost"] for g in got.values())
    print(f"phase3 {len(got)} traces ({complete} complete windows, {missing} device records "
          f"missing, {pad} lost before the windows) made in a new process in "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    return got


def tpcds_phase2(sess):
    """Kernels 1-3 against their plain versions at the largest calls of the
    TPC-DS texts TPCDS_CAPTURE (capture_calls). Returns (group-by, insert,
    probe) results."""
    from presto_tpu_torch.benchmark.tpcds_sql import QUERIES

    rec = capture_calls(sess, {label: FUNCTION_SQL[label] if label in FUNCTION_SQL
                               else QUERIES[int(label[1:])] for label in TPCDS_CAPTURE})
    if rec["null_key_totals"] is None:
        raise AssertionError("no TPC-DS group-by with NULL keys reached the group-by kernel")
    q_g, call, n = rec["null_key_totals"]
    q_i, (h, live, bits), n_live = rec["insert"]
    q_p, (jt, ph, plive, prep), _ = rec["probe"]
    print(f"phase2 tpcds largest build: {q_i} n={h.shape[0]} live={n_live} bits={bits}; "
          f"largest n1 probe: {q_p} m={ph.shape[0]} live={int(plive.sum())} table slots="
          f"{jt.slots.shape[0]}; largest group-by with NULL keys: {q_g} n={n} G={call[6]}",
          flush=True)
    tol = exact if call[3] is None or not call[3][0].is_floating_point() else f64_tol
    groupby = kernel_case(f"tpcds_null_keys_{q_g.lower()}", call, tol)
    insert = insert_case(f"tpcds_largest_build_{q_i.lower()}", h, live, bits)[0]
    probe = probe_case(f"tpcds_largest_probe_{q_p.lower()}", jt.slots, ph, plive, jt.bits, prep)
    return groupby, insert, probe


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
    BENCHMARK_Q1[:] = [q1]
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
    sql_report, per_sql = run_path(Session(dcat, device=device, result_cache=False), expect,
                                       runs, texts)
    counts = _counts()
    report.update(sql_report)
    per.update(per_sql)
    if per["q1_local_kernel"]["q1_partials"] != 1:
        raise AssertionError("q1_local_kernel did not launch the q1_partials kernel once: "
                             f"{per['q1_local_kernel']}")
    if counts["q1_partials"] != runs * per["q1_local_kernel"]["q1_partials"]:
        raise AssertionError(f"q1_partials launched outside q1_local_kernel: {per}")
    return report, per, counts, page


# -- phase 2: the join kernels against their plain versions -----------------


def capture_calls(sess, texts, totals_of=()):
    """One more run of each {label: SQL} of `texts` with the kernel wrappers
    wrapped: the join_insert call and the first-match probe (`_probe_n1`)
    with the most live rows, the groupby_totals calls of the labels
    `totals_of`, and the groupby_totals call with the most rows among those
    whose group keys hold NULLs (each with the label it came from)."""
    from presto_tpu_torch.expr.compiler import evaluate
    from presto_tpu_torch.ops import groupby_kernel as gk
    from presto_tpu_torch.ops import join_kernel as jk

    rec = {"insert": None, "probe": None, "totals": {label: [] for label in totals_of},
           "null_key_totals": None}
    orig = (jk.join_insert, jk._probe_n1, gk.groupby_totals, gk.maybe_grouped_aggregate,
            gk.maybe_grouped_aggregate_hash)
    cur, null_keys = [None], [False]

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
        if cur[0] in rec["totals"]:
            rec["totals"][cur[0]].append(call)
        n = call[0].shape[0]
        if null_keys[0] and (rec["null_key_totals"] is None or n > rec["null_key_totals"][2]):
            rec["null_key_totals"] = (cur[0], call, n)
        return orig[2](*call)

    def grouped(which):
        def wrapper(page, group_exprs, *args, **kwargs):
            live = page.live_mask()
            null_keys[0] = any(
                v.valid is not None and bool((live & ~v.valid).any())
                for v in (evaluate(e, page) for e in group_exprs))
            try:
                return orig[which](page, group_exprs, *args, **kwargs)
            finally:
                null_keys[0] = False
        return wrapper

    (jk.join_insert, jk._probe_n1, gk.groupby_totals, gk.maybe_grouped_aggregate,
     gk.maybe_grouped_aggregate_hash) = insert, probe_n1, totals, grouped(3), grouped(4)
    try:
        for label, text in texts.items():
            cur[0] = label
            sess.query(text).rows()
    finally:
        (jk.join_insert, jk._probe_n1, gk.groupby_totals, gk.maybe_grouped_aggregate,
         gk.maybe_grouped_aggregate_hash) = orig
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


def join_phase2(sess, checks, dev="cuda", n_max=None, m_max=6_000_859, n_small=100_000):
    """The join kernels against their plain versions: the largest calls
    the four queries make, the top of the table path's range (a build of
    n_max rows, TABLE_MAX_BUILD by default, probed by m_max rows), a skewed
    key with colliding tags, varchar keys in two dictionaries, a composite
    key, a float64 key with -0.0 and NaN and a long-decimal key (n_small
    build rows each), and the host work of `_probe_n1` and `build_table`,
    whose profiler checks `checks` gathers. Returns (insert results, probe
    results, group-by results at Q18's hash-slot call and Q5's dense
    call)."""
    import numpy as np
    import torch

    from presto_tpu_torch.ops import join_kernel as jk

    dev = torch.device(dev)
    from presto_tpu_torch.benchmark.tpch_sql import QUERIES

    rec = capture_calls(sess, {f"Q{q}": QUERIES[q] for q in JOIN_QUERIES},
                        totals_of=("Q5", "Q18"))
    q_ins, (h, live, bits), n_live = rec["insert"]
    q_pr, (jt, ph, plive, prep), _ = rec["probe"]
    # the hash-slot group-by call of Q18's outer aggregate, and Q5's dense
    # call (revenue by nation, G 25)
    (call,) = rec["totals"]["Q18"]
    groupby = [kernel_case("q18_hash_slot", call, exact, {"register": False, "blocks": 1},
                           checks=checks)]
    (call,) = rec["totals"]["Q5"]
    groupby.append(kernel_case("q5_dense", call, exact, {"register": True}, checks=checks))
    print(f"phase2 largest build: {q_ins} n={h.shape[0]} live={n_live} bits={bits}; largest "
          f"n1 probe: {q_pr} m={ph.shape[0]} live={int(plive.sum())} table slots="
          f"{jt.slots.shape[0]}", flush=True)
    inserts = [insert_case(f"largest_build_{q_ins.lower()}", h, live, bits)[0]]
    probes = [probe_case(f"largest_probe_{q_pr.lower()}", jt.slots, ph, plive, jt.bits, prep)]
    checks.append(("probe", f"largest_probe_{q_pr.lower()}", (jt, ph, plive, prep)))
    rng = np.random.default_rng(11)
    nq = h.shape[0]
    # build_table's host work
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
    checks.append(("probe", "probe_6M_half_match", big))
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

    checks += [("build", name, (page, keys)) for name, page, keys in builds]
    return inserts, probes, groupby


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
    field equal, and the launch count up by exactly 1. `exact` maps a group
    to {field: Python-int total} the kernel must also equal. Times the
    kernel, the plain version, one index_add_ of a prepared (n, 8) channel
    tensor by group id (the library yardstick) and the byte bound
    (benchmark/q1bench.py's bound_bytes: ship, returnflag and linestatus
    for each row below count, the int64 decimals by the 32 B sectors that
    hold a selected row, the totals)."""
    import torch

    from presto_tpu_torch.benchmark import q1bench
    from presto_tpu_torch.ops import agg_kernel as ak

    dev = cols[0].device
    count = torch.tensor(count, dtype=torch.int32, device=dev) if isinstance(count, int) else count
    cutoff = torch.tensor(cutoff, dtype=torch.int32, device=dev)
    call = (*cols, count, cutoff)
    before = ak.launches
    got = ak.q1_sums(*call)
    launched = ak.launches - before
    want = ak.q1_sums_plain(*call)
    torch.cuda.synchronize()
    if launched != 1:
        raise AssertionError(f"{name}: one q1_sums call launched {launched} kernels")
    err = max(int((got[k] - want[k]).abs().max()) for k in want)
    if err or set(got) != set(want) or any(
            got[k].dtype != want[k].dtype or got[k].shape != want[k].shape for k in want):
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
    live = (torch.arange(n, device=dev) < count) & (ship <= cutoff)
    g = torch.where(live, rf.to(torch.int64) * 2 + ls, ak.GROUPS)
    dp = price * (100 - disc)
    charge = dp * (100 + tax)
    mask = (1 << 32) - 1
    chans = torch.stack([torch.ones_like(qty), qty, price, disc, dp >> 32, dp & mask,
                         charge >> 32, charge & mask], dim=1)
    acc = torch.zeros((ak.GROUPS + 1, ak.CHANNELS), dtype=torch.int64, device=dev)
    library_ms = cuda_ms(lambda: acc.zero_().index_add_(0, g, chans))
    del chans, dp, charge, g, live
    bound = q1bench.bound_bytes(cols, count, cutoff)
    res = {"case": name, **{k: bound[k] for k in ("n", "count", "selected", "sectors")},
           "paired_loads": ak.paired_loads(cols),
           "groups_empty": int((got["count"] == 0).sum()), "max_abs_err": float(err),
           "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
           "bound_ms": bound["bytes"] / HBM_BYTES_PER_S * 1e3, "bytes": bound["bytes"]}
    print("phase2", json.dumps(res), flush=True)
    return res


# names of q1_edge_cases' cases, in order
Q1_EDGES = ("unaligned_view", "one_column_unaligned", "ragged_n", "tiny_n", "count_0",
            "count_past_n")


def q1_edge_cases(cols):
    """{name: (columns, count)}: q1_sums calls at the edges of the fused-Q1
    kernel's loads and grid (Q1_EDGES), cut from Q1's columns `cols`."""
    import torch

    n = cols[0].shape[0]
    m = n // 3 * 2 + 1  # odd: a warp's last step is partial
    # one column one row into a buffer of its own: 4 bytes off the 8 the
    # paired int32 loads need
    ship = torch.empty(n + 1, dtype=cols[6].dtype, device=cols[6].device)
    ship[1:] = cols[6]
    cases = {
        # every column one row in: int64 8 and int32 4 bytes off alignment
        "unaligned_view": ([c[1:] for c in cols], n - 1),
        "one_column_unaligned": ([*cols[:6], ship[1:]], n),
        "ragged_n": ([c[:m] for c in cols], m),
        "tiny_n": ([c[:37] for c in cols], 37),  # less than a block's step: one block
        "count_0": (list(cols), 0),
        "count_past_n": ([c[:m] for c in cols], m + 5000),
    }
    assert tuple(cases) == Q1_EDGES
    return cases


# -- the profiler checks, made in a new process ---------------------------


def run_launch_checks(path):
    """Load the (kind, name, args) checks `path` holds and make each one:
    one_launch_check, probe_launch_check or build_check."""
    import torch

    fns = {"one_launch": one_launch_check, "probe": probe_launch_check, "build": build_check}
    for kind, name, args in torch.load(path, weights_only=False):
        fns[kind](name, *args)


def launch_checks_in_child(checks):
    """The profiler checks gathered in phase 2, made in one new process on
    their saved inputs; their lines are relayed and returned parsed, each
    with its "check" (one_launch, probe_one_launch or build_check). After
    this script's paths, torch.profiler (torch 2.11 on an NVIDIA H100 80GB
    HBM3) returned 13 of 20 one-kernel windows without the kernel's
    device record, padded or not, while a new process returned all 40
    with it (presto_tpu_torch/benchmark/profwindows.py)."""
    import os
    import tempfile

    import torch

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "launch_checks.pt")
        torch.save(checks, path)
        out = subprocess.run(
            [sys.executable, "-c", f"import chip_smoke; chip_smoke.run_launch_checks({path!r})"],
            cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True, text=True,
            timeout=300)
    results = []
    for line in out.stdout.splitlines():
        if line.startswith("phase2"):
            print(line, flush=True)
            results.append({"check": line.split()[1], **json.loads(line[line.index("{"):])})
    if out.returncode != 0:
        raise AssertionError(f"a launch check failed:\n{out.stdout[-3000:]}\n{out.stderr[-3000:]}")
    if len(results) != len(checks):
        raise AssertionError(f"{len(checks)} launch checks gathered, {len(results)} made")
    print(f"phase2 {len(results)} launch checks made in a new process in "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    return results


def q1_phase2(page, checks, sf_big=10.0, n_wide=2_000_000, device="cuda"):
    """The fused-Q1 kernel against its plain version: (a) the SF 1 page of
    the benchmark path (whose one_launch_check `checks` gathers), (b) SF `sf_big`'s
    lineitem generated on the card, (c) a count below capacity and a cutoff
    (1995-01-01) that empties the open groups, (d) `n_wide` rows with
    prices near 2^31 - 1, most in one group, whose sum of charge passes
    2^63, held also to Python-int totals, (e) the Q1_EDGES cases cut from
    the SF 1 page (the unaligned ones must take the one-row loads)."""
    import numpy as np
    import torch

    from presto_tpu_torch.benchmark import benchgen, handcoded

    cols = [page.block(c).data for c in handcoded.Q1_COLUMNS]
    results = [q1_kernel_case("q1_sf1_page", cols, page.count, Q1_CUTOFF)]
    cutoff = torch.tensor(Q1_CUTOFF, dtype=torch.int32, device=device)
    checks.append(("one_launch", "q1_sf1_page", ((*cols, page.count, cutoff), "q1_partials")))

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
    del wide

    for name, (ecols, ecount) in q1_edge_cases(cols).items():
        res = q1_kernel_case(f"q1_{name}", ecols, ecount, Q1_CUTOFF)
        if res["paired_loads"] == (name in ("unaligned_view", "one_column_unaligned")):
            raise AssertionError(f"q1_{name}: paired loads {res['paired_loads']}")
        results.append(res)
    return results


def profile_runs(runs, warm_ms, out_dir):
    """profile_one over one warm call of each `runs[label]` (its idle share
    against the unprofiled warm wall `warm_ms[label]`); the full table goes
    to <out_dir>/profile_<label>.txt."""
    import os

    os.makedirs(out_dir, exist_ok=True)
    for label, fn in runs.items():
        summary, prof = profile_one(fn, warm_ms[label])
        print(f"profile {label}", json.dumps(summary), flush=True)
        with open(os.path.join(out_dir, f"profile_{label}.txt"), "w") as f:
            f.write(prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=40))


def check_params_layout():
    """The kernels' parameter structs as the card's build lays them out
    (sizeof, then each field's offset): the group-by kernel's
    GroupbyParams, the join kernels' InsertParams and ProbeParams (with
    ProbeKey) and the fused-Q1 kernel's Q1Params, each against the ctypes
    struct that packs it."""
    import ctypes

    from presto_tpu_torch.ops import agg_kernel as ak
    from presto_tpu_torch.ops import groupby_kernel as gk
    from presto_tpu_torch.ops import join_kernel as jk

    want = [ctypes.sizeof(gk.GroupbyParams)] + [
        getattr(gk.GroupbyParams, f).offset for f, _ in gk.GroupbyParams._fields_]
    layouts = {"GroupbyParams": (gk.params_layout(), want),
               "Q1Params": (ak.params_layout(), ak.ctypes_layout())}
    for name in ("join_insert", "join_probe"):
        layouts[name] = (jk.params_layout(name), jk.ctypes_layout(name))
    for name, (got, want) in layouts.items():
        print(f"phase1 {name} params layout (size, offsets) {got}", flush=True)
        if got != want:
            raise AssertionError(f"{name}: C layout {got} != ctypes {want}")


def main() -> int:
    import os

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

    # sf10's numpy checks run in a new process, overlapping the paths
    # before sf10
    sf10_pool, sf10_future = start_sf10_expect()
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

    # phase 3, this slice's paths: all 22 TPC-H queries against the port on
    # the CPU (the same generated tables, served from host memory), then the
    # analytic set against numpy; the counts at 0 just before each
    from presto_tpu_torch.session import Session

    t0 = time.perf_counter()
    cpu_sess = Session(cat.with_device("cpu"), device="cpu", result_cache=False)
    _zero_counts()
    tpch22 = tpch22_path(sess, cpu_sess)
    path_counts["tpch22"] = _counts()
    tpch22_load = os.getloadavg()[0]
    del cpu_sess
    _zero_counts()
    analytic = analytic_path(sess, tables)
    path_counts["analytic"] = _counts()
    print(f"phase3 tpch22 and analytic launches {json.dumps(path_counts['tpch22'])} "
          f"{json.dumps(path_counts['analytic'])} in {time.perf_counter() - t0:.3f} s",
          flush=True)
    for path in ("tpch22", "analytic"):
        for k in ("groupby_partials", "join_insert", "join_probe"):
            if path_counts[path][k] < 1:
                raise AssertionError(f"the {path} path did not launch {k}")
    t0 = time.perf_counter()
    trace_paths(sess, tpch22, analytic)
    print(f"phase3 tpch22 and analytic traced in {time.perf_counter() - t0:.3f} s", flush=True)

    # phase 3, the coordinator's control plane: the TPC-H session served by a
    # CoordinatorServer, the texts through a Client; then the cost of
    # tracing on the same session; the counts at 0 just before it
    t0 = time.perf_counter()
    _zero_counts()
    coordinator_path(sess, cat, tpch22)
    path_counts["coordinator"] = _counts()
    trace_cost(sess)
    print(f"phase3 coordinator launches {json.dumps(path_counts['coordinator'])} in "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    for k in ("groupby_partials", "join_insert", "join_probe"):
        if path_counts["coordinator"][k] < 1:
            raise AssertionError(f"the coordinator path did not launch {k}")

    # after the yardstick of the TPC-H paths that follow (`tpch22`'s warm
    # walls), the `http22` worker processes generate their catalogs and the
    # pool of new processes computes the CPU rows of `tpcds`, `collections`
    # and `statements`, both overlapping the paths from `streaming22` to
    # `http22`; overlap_check measures what that overlap costs
    http_procs = start_http_workers()
    _CLEANUP.append(lambda: [p.kill() for p in http_procs if p.poll() is None])
    pool, cpu_rows = start_cpu_rows(tpcds_texts(), tpch_texts=COLLECTION_SQL, statements=True)
    _CLEANUP.append(lambda: pool.shutdown(cancel_futures=True))

    # phase 3, the streaming executor (exec/stream.py): the 22 texts over
    # the same catalog under a device budget that forces every rung of the
    # ladder, then SF 10 streamed from the chunked catalog; the counts at 0
    # just before each
    t0 = time.perf_counter()
    _zero_counts()
    streaming22_path(cat)
    path_counts["streaming22"] = _counts()
    print(f"phase3 streaming22 launches {json.dumps(path_counts['streaming22'])} in "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    overlap_check(sess, tpch22, tpch22_load, cpu_rows)
    t0 = time.perf_counter()
    _zero_counts()
    try:
        sf10_path(sf10_future)
    finally:
        sf10_pool.shutdown(cancel_futures=True)
    path_counts["sf10"] = _counts()
    print(f"phase3 sf10 launches {json.dumps(path_counts['sf10'])} in "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    for path in ("streaming22", "sf10"):
        for k in ("groupby_partials", "join_insert", "join_probe"):
            if path_counts[path][k] < 1:
                raise AssertionError(f"the {path} path did not launch {k}")

    # phase 3, the storage connectors: the TPC-H tables written as files
    # (a Hive warehouse through the catalog store, RCFile, ORC, the shard
    # store, CSV), the 23 texts held to tpch22's card rows; the counts at 0
    # just before it
    want = files22_expected(sess)
    t0 = time.perf_counter()
    _zero_counts()
    files22_path(cat, want)
    path_counts["files22"] = _counts()
    print(f"phase3 files22 launches {json.dumps(path_counts['files22'])} in "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    for k in ("groupby_partials", "join_insert", "join_probe"):
        if path_counts["files22"][k] < 1:
            raise AssertionError(f"the files22 path did not launch {k}")

    # phase 3, materialized views over a shard store built from the TPC-H
    # tables with lineitem streamed in, then history-based feedback on the
    # TPC-H session; the counts at 0 just before each
    t0 = time.perf_counter()
    _zero_counts()
    matview_path(cat, tables)
    path_counts["matview"] = _counts()
    print(f"phase3 matview launches {json.dumps(path_counts['matview'])} in "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    t0 = time.perf_counter()
    _zero_counts()
    feedback_path(sess, cat)
    path_counts["feedback"] = _counts()
    print(f"phase3 feedback launches {json.dumps(path_counts['feedback'])} in "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    for path, kernels in (("matview", ("groupby_partials", "join_insert", "join_probe")),
                          ("feedback", ("join_insert", "join_probe"))):
        for k in kernels:
            if path_counts[path][k] < 1:
                raise AssertionError(f"the {path} path did not launch {k}")

    # phase 3, distributed execution: the TPC-H session's catalog over a
    # mesh of 8 workers on the card, the counts at 0 just before it
    t0 = time.perf_counter()
    _zero_counts()
    dist22_path(cat, q1_page)
    path_counts["dist22"] = _counts()
    print(f"phase3 dist22 launches {json.dumps(path_counts['dist22'])} in "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    for k in ("join_insert", "join_probe"):
        if path_counts["dist22"][k] < 1:
            raise AssertionError(f"the dist22 path did not launch {k}")

    # phase 3, the HTTP cluster data plane: HttpClusterSession over the two
    # worker processes started after `tpch22` (their counts start at 0 and
    # count only this path), the counts here at 0 just before it
    t0 = time.perf_counter()
    _zero_counts()
    _http, worker_counts = http22_path(cat, http_procs, tpch22)
    path_counts["http22"] = {k: v + sum(c[k] for c in worker_counts)
                             for k, v in _counts().items()}
    print(f"phase3 http22 launches {json.dumps(path_counts['http22'])} (workers "
          f"{json.dumps(worker_counts)}) in {time.perf_counter() - t0:.3f} s", flush=True)

    # phase 3, TPC-DS at SF 1: the 103 texts on the card, then the scalar
    # function library against the CPU over the same host tables, the
    # counts at 0 just before each path; then one traced warm run of each
    # in a new process, while the pool started after `tpch22` finishes the
    # TPC-DS texts on the CPU for the comparison
    import tempfile

    t0 = time.perf_counter()
    ds_texts = tpcds_texts()
    try:
        ds_sess, ds_cat = make_tpcds_session()
        _zero_counts()
        # cold and one warm run a text (two warm runs until the `dist22`
        # path came; see TRACE_TPCDS_TEXTS)
        tpcds, outs = tpcds_card_runs(ds_sess, runs=2)
        path_counts["tpcds"] = _counts()
        ds_cpu = Session(ds_cat.with_device("cpu"), device="cpu", result_cache=False)
        _zero_counts()
        functions = functions_path(ds_sess, ds_cpu)
        path_counts["functions"] = _counts()
        del ds_cpu
        _zero_counts()
        not_in_path(ds_sess, ds_cat)
        path_counts["not_in"] = _counts()
        for k in ("join_insert", "join_probe"):
            if path_counts["not_in"][k] < 1:
                raise AssertionError(f"the not_in path did not launch {k}")
        slowest = sorted(tpcds, key=lambda q: -tpcds[q]["warm_ms"])[:TRACE_TPCDS_TEXTS]
        items = [("tpcds", q, ds_texts[q], tpcds[q]["warm_ms"]) for q in slowest]
        items += [("functions", f, FUNCTION_SQL[f], r["warm_ms"])
                  for f, r in functions.items()]
        # the `collections` path on the TPC-H SF 1 session (its CPU rows
        # come from the same pool)
        t1 = time.perf_counter()
        _zero_counts()
        coll, coll_outs = collections_path(sess, tables)
        path_counts["collections"] = _counts()
        print(f"phase3 collections card runs {time.perf_counter() - t1:.3f} s", flush=True)
        items += [("collections", c, COLLECTION_SQL[c], r["warm_ms"]) for c, r in coll.items()]
        # the `statements` path on a MemoryCatalog over the same session's
        # pages, then EXPLAIN ANALYZE of Q5 on the session; its CPU side
        # in the same pool
        from presto_tpu_torch.benchmark.tpch_sql import QUERIES

        t1 = time.perf_counter()
        _zero_counts()
        stmts = statements_path(sess, cat, tables)
        path_counts["statements"] = _counts()
        print(f"phase3 statements card runs {time.perf_counter() - t1:.3f} s", flush=True)
        warm = stmts["S9"]["warm_ms"]
        items += [("statements", "Q5", QUERIES[5], warm),
                  ("statements", "Q5_explain_analyze", "explain analyze " + QUERIES[5], warm)]
        with tempfile.TemporaryDirectory() as tmp:
            traces = start_traces(items, tmp)
            tpcds_compare(tpcds, outs, cpu_rows)
            traced = finish_traces(traces)
            tpcds_summary(tpcds, traced)
            for (section, label), summary in traced.items():
                if section == "collections":
                    coll[label]["profile"] = summary
            collections_compare(coll, coll_outs, cpu_rows)
            statements_compare(stmts, cpu_rows["statements"], traced)
    finally:
        pool.shutdown(cancel_futures=True)
    print(f"phase3 tpcds, functions and collections launches {json.dumps(path_counts['tpcds'])} "
          f"{json.dumps(path_counts['functions'])} {json.dumps(path_counts['collections'])} "
          f"in {time.perf_counter() - t0:.3f} s", flush=True)
    for k in ("groupby_partials", "join_insert", "join_probe"):
        if path_counts["tpcds"][k] < 1:
            raise AssertionError(f"the tpcds path did not launch {k}")
    for k in ("join_insert", "join_probe"):
        if path_counts["collections"][k] < 1:
            raise AssertionError(f"the collections path did not launch {k}")
    print(f"phase3 statements launches {json.dumps(path_counts['statements'])}", flush=True)
    for k in ("groupby_partials", "join_insert", "join_probe"):
        if path_counts["statements"][k] < 1:
            raise AssertionError(f"the statements path did not launch {k}")

    # phase 2: each kernel against its plain version, at the main paths'
    # shapes and at wider cases
    t0 = time.perf_counter()
    checks = []
    cases = phase2(q1_kernel_call(sess, cat), checks)
    inserts, probes, groupby = join_phase2(sess, checks)
    cases += groupby
    q1_cases = q1_phase2(q1_page, checks)
    ds_groupby, ds_insert, ds_probe = tpcds_phase2(ds_sess)
    cases.append(ds_groupby)
    inserts.append(ds_insert)
    probes.append(ds_probe)
    del ds_sess, ds_cat
    launch_checks = launch_checks_in_child(checks)
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
              f"{sum(c['check'] == 'probe_one_launch' for c in launch_checks)} checks"),
        entry("q1_partials", "presto_tpu_torch/csrc/q1_partials.cu",
              "presto_tpu/ops/pallas_agg.py:45", q1_cases[0], q1_cases,
              "every field of q1_sums against the plain version (integers: exact) in "
              f"{len(q1_cases)} cases; a warm call one launch, no copy or sync"),
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


# stops the processes main() started, whatever path failed
_CLEANUP = []

if __name__ == "__main__":
    if sys.argv[1:2] == ["--http-worker"]:
        sys.exit(http_worker_main(sys.argv[2]))
    try:
        rc = main()
    finally:
        for stop in _CLEANUP:
            stop()
    sys.exit(rc)
