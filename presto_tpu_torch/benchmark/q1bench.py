"""The fused-Q1 kernel (`agg_kernel.q1_sums`, csrc/q1_partials.cu) alone,
on one card, and the hand-coded Q1 pipeline that calls it.

    python3 -m presto_tpu_torch.benchmark.q1bench [--device cpu]

First it runs `handcoded.q1_local_kernel` over lineitem's Q1 columns at
SF 1 (warm wall, then one warm run under torch.profiler: device kernels,
copies, stream synchronises, device busy time and its idle share). Then,
for lineitem's Q1 columns generated on the device at SF 1 and SF 10, it
checks one `q1_sums` call against `q1_sums_plain` (every field equal),
times warm `q1_sums` calls with CUDA events around 20 back-to-back calls
(and the host time to issue them), works out the byte bound
(`bound_bytes`) and traces one more call with torch.profiler: device
kernels, copies, stream synchronises, the increase of the launch count
and the device time of the call. On the card it first prints the card's
name and power limit and ptxas's registers and spills of the kernel;
then one JSON line per entry. `q1_sums` and `q1_local_kernel` keep their
signatures across versions, so the script also measures earlier trees.
"""

from __future__ import annotations

import json
import subprocess
import sys

SHAPES = (("sf1", 1.0), ("sf10", 10.0))
Q1_CUTOFF = 10471  # 1998-09-02, days since 1970-01-01
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device-memory rate (NVIDIA data sheet)


def bound_bytes(cols, count, cutoff) -> dict:
    """The least device-memory bytes of one q1_sums call: ship, returnflag
    and linestatus read for each row below count (12 B), the four int64
    decimals by the 32 B sectors (4 rows) that hold a selected row
    (selected rows are scattered, so a sector is read whole), the (6, 8)
    totals written (384 B). Also the row, selected-row and sector counts."""
    import torch

    ship = cols[6]
    n = ship.shape[0]
    dev = ship.device
    count = count.reshape(())
    live = (torch.arange(n, device=dev) < count) & (ship <= cutoff.reshape(()))
    pad = torch.zeros((-n) % 4, dtype=torch.bool, device=dev)
    sectors = int(torch.cat([live, pad]).view(-1, 4).any(dim=1).sum())
    rows = max(0, min(n, int(count)))
    return {"n": n, "count": rows, "selected": int(live.sum()), "sectors": sectors,
            "bytes": 12 * rows + 4 * 32 * sectors + 6 * 8 * 8}


def _profile(fn, counter):
    """Counts of one call of fn under torch.profiler, and its device time:
    all device events, and the fused-Q1 kernel's alone."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    before = counter()
    with profile(activities=acts) as prof:
        fn()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    events = prof.key_averages()
    dev = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]

    def count(pred, among=events):
        return sum(e.count for e in among if pred(e))

    def device_ms(among):
        return sum(getattr(e, "self_device_time_total", 0) for e in among) / 1e3

    res = {"launches": counter() - before}
    if torch.cuda.is_available():  # device metrics only from a device run
        res.update({
            "device_kernels": count(lambda e: "Memcpy" not in e.key and "Memset" not in e.key,
                                    dev),
            "memcpy": count(lambda e: "Memcpy" in e.key, dev),
            "dtoh": count(lambda e: "DtoH" in e.key, dev),
            "stream_syncs": count(lambda e: e.key == "cudaStreamSynchronize"),
            "device_busy_ms": device_ms(dev),
            "kernel_device_ms": device_ms([e for e in dev if "q1_partials_kernel" in e.key]),
        })
    return res


def _time(fn, device, iters=20):
    """(device ms per call from CUDA events around `iters` calls, host ms
    per call to issue them); on the CPU (None, host ms)."""
    import time

    import torch

    for _ in range(3):
        fn()
    if device == "cpu":
        t = time.perf_counter()
        for _ in range(iters):
            fn()
        return None, (time.perf_counter() - t) * 1e3 / iters
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t = time.perf_counter()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    host = (time.perf_counter() - t) * 1e3 / iters
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters, host


def pipeline(page, device, runs=3) -> dict:
    """benchmark/handcoded.py's q1_local_kernel over `page`: its warm wall
    (best of `runs` after a cold run, host clock, ended by to_pylist())
    and one more warm run under torch.profiler."""
    import time

    from ..ops import agg_kernel as ak
    from . import handcoded

    walls = []
    for _ in range(runs + 1):
        t = time.perf_counter()
        handcoded.q1_local_kernel(page).to_pylist()
        walls.append((time.perf_counter() - t) * 1e3)
    res = {"warm_wall_ms": min(walls[1:]),
           **_profile(lambda: handcoded.q1_local_kernel(page).to_pylist(), lambda: ak.launches)}
    if "device_busy_ms" in res:
        res["idle_share_of_warm_wall"] = 1.0 - res["device_busy_ms"] / res["warm_wall_ms"]
    return res


def run(device="cuda", shapes=SHAPES) -> dict:
    """{shape: result} for each (name, scale factor) of `shapes`."""
    import torch

    from ..ops import agg_kernel as ak
    from . import handcoded

    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("q1bench: no CUDA device")
    out = {}
    # first, while the process is young: torch.profiler on the card lost
    # device records in processes that had run many launches
    page = handcoded.lineitem_q1_page(shapes[0][1], device=device)
    out["q1_local_kernel"] = pipeline(page, device)
    del page
    for name, sf in shapes:
        page = handcoded.lineitem_q1_page(sf, device=device)
        cols = [page.block(c).data for c in handcoded.Q1_COLUMNS]
        cutoff = torch.tensor(Q1_CUTOFF, dtype=torch.int32, device=device)
        call = (*cols, page.count, cutoff)
        got, want = ak.q1_sums(*call), ak.q1_sums_plain(*call)
        equal = all(torch.equal(got[k], want[k]) for k in want)
        del want
        ms, host_ms = _time(lambda: ak.q1_sums(*call), device)
        res = {"ms": ms, "host_ms": host_ms, "exact": equal,
               **bound_bytes(cols, page.count, cutoff),
               **_profile(lambda: ak.q1_sums(*call), lambda: ak.launches)}
        res["bound_ms"] = res["bytes"] / HBM_BYTES_PER_S * 1e3
        res["share_of_bound"] = res["bound_ms"] / ms if ms else None
        out[name] = res
        del page, cols, call
    return out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    device = argv[argv.index("--device") + 1] if "--device" in argv else "cuda"
    if device == "cuda":
        from .. import cuda_build

        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True).stdout.strip().splitlines()[0])
        for line in cuda_build.build_all()["q1_partials"].splitlines():
            if any(w in line for w in ("Compiling entry", "registers", "spill")):
                print("q1bench ptxas", line.strip())
    results = run(device)
    for name, res in results.items():
        print("q1bench", name, json.dumps(res), flush=True)
    return 0 if all(r.get("exact", True) for r in results.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
