"""North-star queries (TPC-H Q3/Q5/Q17/Q18, BASELINE.json) over the
device-resident catalog (torch counterpart of
presto_tpu/benchmark/northstar.py).

Every table is generated on the device (connectors/tpch_device.py), so the
run uploads no table data. Protocol of presto-benchto-benchmarks' tpch.yaml:
prewarm runs, then timed runs per query; each timed run ends in the host
copy of the result rows, so the device has finished.

    python -m presto_tpu_torch.benchmark.northstar --sf 1 --runs 3

Prints one JSON line: per query the best and mean wall ms, lineitem rows/s,
output rows and the dynamic filters' pruning counts, with the device.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from .scale import Q3, Q5, Q17, Q18

QUERIES = {"q3": Q3, "q5": Q5, "q17": Q17, "q18": Q18}


def device_kind(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def run(sf: float, runs: int = 3, prewarm: int = 1, queries=None, device="cuda"):
    """Time each query over DeviceTpchCatalog(sf) on `device`; returns the
    result dict."""
    from ..connectors.tpch_device import DeviceTpchCatalog
    from ..session import Session

    # without the result cache: every timed run executes
    sess = Session(DeviceTpchCatalog(sf, device=device), device=device, result_cache=False)
    li_rows = sess.catalog.exact_row_count("lineitem")
    out = {
        "suite": "northstar_device_sql",
        "backend": sess.device.type,
        "device_kind": device_kind(sess.device),
        "sf": sf,
        "lineitem_rows": li_rows,
        "runs": runs,
        "results": [],
    }
    for name in queries or QUERIES:
        sql = QUERIES[name]
        for _ in range(prewarm):
            rows = sess.query(sql).rows()
        samples = []
        for _ in range(runs):
            t0 = time.perf_counter()
            rows = sess.query(sql).rows()  # rows() copies the result to the host
            samples.append((time.perf_counter() - t0) * 1e3)
        best = min(samples)
        snap = sess.executor.dyn_ctx.snapshot()
        out["results"].append({
            "name": name,
            "ms": best,
            "mean_ms": sum(samples) / len(samples),
            "lineitem_rows_per_s": li_rows / (best / 1e3),
            "out_rows": len(rows),
            "rows_pruned": sum(snap["scan_pruned"].values())
            + sum(snap["preprobe_pruned"].values()),
            "dyn_filters": snap["filters"],
        })
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--sf", type=float, default=1.0)
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--queries", type=str, default="")
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args()
    qs = [q for q in args.queries.split(",") if q] or None
    print(json.dumps(run(args.sf, runs=args.runs, queries=qs, device=args.device)), flush=True)


if __name__ == "__main__":
    main()
