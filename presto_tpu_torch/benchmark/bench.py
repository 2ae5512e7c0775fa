"""Benchmark: TPC-H Q1 throughput on one device (torch counterpart of the
repository's root bench.py).

Protocol of the reference's in-process operator benchmark
(presto-benchmark/.../HandTpchQuery1.java via BenchmarkSuite.java:32,
rows/s over TPC-H data): lineitem is generated once on the device
(benchmark/benchgen.py, no upload), the hand-coded pipelines are timed
best of N with the device synchronized at the end of each run, then Q1, Q6
and Q3 run as SQL through `Session(DeviceTpchCatalog(sf))`. The headline
is the faster hand-coded Q1 path, in lineitem rows/s; `vs_baseline` is its
speedup over a single-threaded vectorized numpy Q1 over the host twin of
the same data (`numpy_q1_baseline`, float64 sums: a timing yardstick,
never a correctness check).

    python -m presto_tpu_torch.benchmark.bench [--sf 1] [--runs 5] [--device cuda]

prints one JSON line. Nothing is written to disk.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from .tpch_sql import QUERIES


def numpy_q1_baseline(cols):
    """Vectorized numpy Q1 doing the device pipeline's work: scaled-integer
    decimal products (disc_price scale 4, charge scale 6), all 8 aggregates
    with float64 sums, the three averages and the group sort. `cols` is the
    benchgen host twin."""
    ship = cols["l_shipdate"]
    cutoff = (np.datetime64("1998-09-02") - np.datetime64("1970-01-01")).astype(int)
    m = ship <= cutoff
    rf = cols["l_returnflag"][m]
    ls = cols["l_linestatus"][m]
    qty = cols["l_quantity"][m]
    price = cols["l_extendedprice"][m]
    disc = cols["l_discount"][m]
    tax = cols["l_tax"][m]
    gid = rf * 2 + ls
    nbins = 6
    disc_price = price * (100 - disc)
    charge = disc_price * (100 + tax)
    cnt = np.bincount(gid, minlength=nbins)
    sums = [
        np.bincount(gid, weights=w.astype(np.float64), minlength=nbins)
        for w in (qty, price, disc_price, charge, disc)
    ]
    safe = np.maximum(cnt, 1)
    avg_qty = (2 * np.abs(sums[0]) + safe) // (2 * safe)
    avg_price = (2 * np.abs(sums[1]) + safe) // (2 * safe)
    avg_disc = (2 * np.abs(sums[4]) + safe) // (2 * safe)
    order = np.argsort(np.arange(nbins)[cnt > 0])
    return (cnt, *sums, avg_qty, avg_price, avg_disc, order)


def _sync(dev: torch.device):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def best_seconds(fn, arg, dev: torch.device, runs: int) -> float:
    """Best wall seconds of fn(arg) over `runs` timed runs after one warm
    run, each ended by a device synchronize."""
    fn(arg)
    _sync(dev)
    best = float("inf")
    for _ in range(runs):
        t0 = time.perf_counter()
        fn(arg)
        _sync(dev)
        best = min(best, time.perf_counter() - t0)
    return best


def run(sf: float = 1.0, device="cuda", runs: int = 5) -> dict:
    """The benchmark at scale factor `sf` on `device`; returns the result
    dict with its details."""
    from ..connectors.tpch_device import DeviceTpchCatalog
    from ..session import Session, resolve_device
    from . import benchgen
    from .handcoded import (
        Q1_COLUMNS, lineitem_q1_page, lineitem_q6_page, q1_local, q1_local_kernel, q6_local,
    )
    from .northstar import device_kind

    dev = resolve_device(device)
    host_cols = benchgen.numpy_columns("lineitem", sf, Q1_COLUMNS)
    n_rows = len(host_cols["l_quantity"])
    numpy_q1_baseline(host_cols)  # warm
    t0 = time.perf_counter()
    numpy_q1_baseline(host_cols)
    cpu_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    page = lineitem_q1_page(sf, device=dev)
    p6 = lineitem_q6_page(sf, device=dev)
    _sync(dev)
    gen_s = time.perf_counter() - t0

    times = {
        "q1_hand": best_seconds(q1_local, page, dev, runs),
        "q1_kernel": best_seconds(q1_local_kernel, page, dev, runs),
        "q6_hand": best_seconds(q6_local, p6, dev, runs),
    }
    del page, p6
    details = {f"{k}_ms": v * 1e3 for k, v in times.items()}
    details["q6_rows_per_s"] = n_rows / times["q6_hand"]
    details["gen_lineitem_ms"] = gen_s * 1e3
    details["cpu_q1_rows_per_s"] = n_rows / cpu_s

    # without the result cache: every timed run executes
    sess = Session(DeviceTpchCatalog(sf, device=dev), device=dev, result_cache=False)
    for name, q in (("q1_sql_ms", 1), ("q6_sql_ms", 6), ("q3_sql_ms", 3)):
        details[name] = best_seconds(
            lambda sql: sess.query(sql).rows(), QUERIES[q], dev, runs) * 1e3
    details["sql_sf"] = sf

    path = "q1_kernel" if times["q1_kernel"] < times["q1_hand"] else "q1_hand"
    details["headline_path"] = path
    rows_per_s = n_rows / times[path]
    return {
        "metric": f"tpch_q1_sf{sf:g}_rows_per_sec",
        "value": rows_per_s,
        "unit": "rows/s",
        "vs_baseline": rows_per_s / details["cpu_q1_rows_per_s"],
        "backend": dev.type,
        "device_kind": device_kind(dev),
        "lineitem_rows": n_rows,
        "details": details,
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--sf", type=float, default=1.0)
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args()
    print(json.dumps(run(args.sf, args.device, args.runs)), flush=True)


if __name__ == "__main__":
    main()
