"""How often torch.profiler returns a one-kernel window without the
kernel's device record, in a fresh process and after chip_smoke's run.

    python3 -m presto_tpu_torch.benchmark.profwindows [--windows N] [--after-smoke]

Each window is one `add_` on a 1M-element float32 tensor on the card
followed by `torch.cuda.synchronize()`, under torch.profiler with CPU and
CUDA activities. It counts the windows that hold no device record, and
over the others the gap from `cudaLaunchKernel` to the kernel's start
and from the end of `cudaDeviceSynchronize` to the kernel's end (μs;
a clock that drifted between the host and the card would move them).
First N windows in this fresh process, then N with the window padded by
20 ms on each side. With --after-smoke it then runs `chip_smoke.main()`
(from the current directory, the repo's root) and repeats: N windows,
N padded by 20 ms, N padded by 2 ms, and N after
`torch.cuda.empty_cache()`, with the card's free memory before and
after. It prints the card's name and power limit, then one JSON line.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

_LAUNCH_KEYS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC")


def windows(n: int, pad_s: float = 0.0) -> dict:
    """n one-kernel profiler windows, each padded by pad_s seconds before
    the kernel and after the synchronise: how many lack the device record,
    and the range of the launch-to-start and sync-end-to-kernel-end gaps."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.autograd.DeviceType.CUDA
    x = torch.zeros(1 << 20, device="cuda")
    x.add_(1)
    torch.cuda.synchronize()
    lost, lags, overs = 0, [], []
    for _ in range(n):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            time.sleep(pad_s)
            x.add_(1)
            torch.cuda.synchronize()
            time.sleep(pad_s)
        events = prof.events()
        kernels = [e for e in events if e.device_type == cuda]
        if not kernels:
            lost += 1
            continue
        k = kernels[-1].time_range
        launch = [e for e in events if e.name in _LAUNCH_KEYS]
        sync = [e for e in events if e.name == "cudaDeviceSynchronize"]
        if launch:
            lags.append(k.start - launch[-1].time_range.start)
        if sync:
            overs.append(k.end - sync[-1].time_range.end)

    def span(v):
        return [min(v), max(v)] if v else None

    return {"windows": n, "pad_s": pad_s, "lost": lost,
            "launch_to_start_us": span(lags), "sync_end_to_kernel_end_us": span(overs)}


def memory() -> dict:
    import torch

    free, total = torch.cuda.mem_get_info()
    return {"free_gib": free / 2**30, "total_gib": total / 2**30,
            "reserved_gib": torch.cuda.memory_reserved() / 2**30}


def main(argv=None) -> int:
    import torch

    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        print("profwindows: no CUDA device", file=sys.stderr)
        return 2
    n = int(argv[argv.index("--windows") + 1]) if "--windows" in argv else 20
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    out = {"torch": torch.__version__, "fresh": [windows(n), windows(n, 0.02)]}
    if "--after-smoke" in argv:
        sys.path.insert(0, ".")
        import chip_smoke

        t = time.perf_counter()
        try:
            out["smoke_rc"] = chip_smoke.main()
        except Exception as e:  # a failed phase is part of what this reports
            out["smoke_rc"] = repr(e)[:500]
        out["smoke_s"] = time.perf_counter() - t
        out["memory_after_smoke"] = memory()
        out["after_smoke"] = [windows(n), windows(n, 0.02), windows(n, 0.002)]
        torch.cuda.empty_cache()
        out["memory_after_empty_cache"] = memory()
        out["after_empty_cache"] = [windows(n)]
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
