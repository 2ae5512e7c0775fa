"""The hash join's table build and first-match probe, alone, on one card.

    python3 -m presto_tpu_torch.benchmark.joinbench [--device cpu]

For each shape it times a warm `join_kernel.build_table` over a build page
of distinct bigint keys and a warm `join_kernel.table_semi_mask` (probe key
evaluation and hashing, then the first-match probe) over a probe page of
which about half the rows match, with CUDA events around 20 calls, and
traces one more call of each with torch.profiler: device kernels,
device-to-host and host-to-device copies, stream synchronises and `nonzero`
calls. It prints one JSON line per shape, after the card's name and power
limit. The shapes are TPC-H Q5's largest build and probe at SF 1 and the
top of the table path's range (4,194,304 build rows). The two functions
keep one signature across versions of the module, so the script also
measures earlier trees.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

SHAPES = (("q5_sf1", 228_184, 1_204_202), ("max_build_4M", 4_194_304, 6_000_859))


def _profile(fn):
    """Counts of one call of fn under torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    with profile(activities=acts) as prof:
        fn()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    events = prof.key_averages()
    dev = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]

    def count(pred, among=events):
        return sum(e.count for e in among if pred(e))

    return {
        "device_launches": count(lambda e: "Memcpy" not in e.key and "Memset" not in e.key, dev),
        "dtoh": count(lambda e: "DtoH" in e.key, dev),
        "htod": count(lambda e: "HtoD" in e.key, dev),
        "stream_syncs": count(lambda e: e.key == "cudaStreamSynchronize"),
        "nonzero": count(lambda e: e.key == "aten::nonzero"),
    }


def _time(fn, device, iters=20):
    """(device ms per call from CUDA events, host ms per call)."""
    import torch

    for _ in range(3):
        fn()
    if device == "cpu":
        t = time.perf_counter()
        for _ in range(iters):
            fn()
        ms = (time.perf_counter() - t) * 1e3 / iters
        return None, ms
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


def run(device="cuda", shapes=SHAPES, seed=5):
    """{shape: {"build": ..., "probe": ...}} for each (name, build rows,
    probe rows) of `shapes`."""
    import numpy as np
    import torch

    from .. import types as T
    from ..expr.ir import col
    from ..ops import join_kernel as jk
    from ..page import Block, Page

    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("joinbench: no CUDA device")
    rng = np.random.default_rng(seed)
    key = (col("k", T.BIGINT),)
    out = {}
    for name, n, m in shapes:
        keys = rng.permutation(n).astype(np.int64) * 7 + 3
        pkeys = keys[rng.integers(0, n, m)] + np.where(rng.random(m) < 0.5, 1 << 40, 0)
        build = Page.from_blocks([Block.from_numpy(keys, T.BIGINT, device=device)], ["k"])
        probe = Page.from_blocks([Block.from_numpy(pkeys, T.BIGINT, device=device)], ["k"])
        jt = jk.build_table(build, key)
        res = {}
        for label, fn in (("build", lambda: jk.build_table(build, key)),
                          ("probe", lambda: jk.table_semi_mask(probe, jt, key))):
            ms, host_ms = _time(fn, device)
            res[label] = {"device_ms": ms, "host_ms": host_ms, **_profile(fn)}
        res["matched"] = int(jk.table_semi_mask(probe, jt, key).sum())
        out[name] = {"build_rows": n, "probe_rows": m, **res}
    return out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    device = argv[argv.index("--device") + 1] if "--device" in argv else "cuda"
    if device == "cuda":
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True).stdout.strip().splitlines()[0])
    for name, res in run(device).items():
        print("joinbench", name, json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
