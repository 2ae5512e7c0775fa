"""The kernel profile: compile against execute, per hand kernel (torch
counterpart of presto_tpu/obs/kernelprof.py).

The JAX package splits each jit-cache entry's first call ("compile":
trace, lower, compile and one run) from its later calls ("execute": the
dispatch wall). The port has no jit cache; its kernels are the four
hand-written CUDA libraries of csrc/. So here:

* "compile" is building or loading a kernel library
  (presto_tpu_torch/cuda_build.py), in seconds, per library;
* "execute" is one launch of a hand kernel, timed on the card by a pair
  of CUDA events recorded around the launch on the launch's stream.

Event pairs are parked and read only once their end event has completed
(`Event.query()`, which does not wait), so the profile adds no host
synchronisation: a query's pairs are read at its end, after its result
has reached the host, or at the next snapshot. At most `MAX_PENDING`
pairs wait; when that many are still running, the next launch is
counted as untimed instead of parking another pair, so no recorded pair
is ever dropped unread. On the CPU the wrappers take the plain version
and record nothing. Recording follows the trace switch
(PRESTO_TPU_TRACE), as in the JAX package.

`record`, `wrap`, `snapshot` and `reset` keep the JAX package's
meaning: a wrapped callable's first successful call books the compile
bucket, later ones the execute bucket, and an exception escapes
unrecorded.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Dict, Optional

MAX_PENDING = 4096  # event pairs parked unread at most


class KernelProfile:
    """Process-wide compile and execute accounting."""

    def __init__(self, max_pending: int = MAX_PENDING):
        self._lock = threading.Lock()
        self.max_pending = max_pending
        self._pending: deque = deque()  # (kernel, (start event, end event))
        self._free: list = []  # read events, reused
        self._streams: dict = {}  # raw stream handle -> its torch Stream
        self.reset()

    # -- the JAX package's interface --

    def record(self, first_call: bool, seconds: float) -> None:
        with self._lock:
            if first_call:
                self.compiles += 1
                self.compile_s += seconds
            else:
                self.executions += 1
                self.execute_s += seconds

    def snapshot(self) -> dict:
        """Totals, with every completed pair read first. `kernels` maps a
        kernel to its launches (timed or not), the launches read
        (`timed`) and their device seconds; `libraries` maps a kernel
        library to its builds and loads and their seconds."""
        self.drain()
        with self._lock:
            return {
                "compiles": self.compiles,
                "compile_s": self.compile_s,
                "executions": self.executions,
                "execute_s": self.execute_s,
                "pending": len(self._pending),
                "untimed": self.untimed,
                "kernels": {k: dict(v) for k, v in self._kernels.items()},
                "libraries": {k: dict(v) for k, v in self._libraries.items()},
            }

    def reset(self) -> None:
        with self._lock:
            self.compiles = 0
            self.compile_s = 0.0
            self.executions = 0
            self.execute_s = 0.0
            self.untimed = 0
            self._kernels: Dict[str, dict] = {}
            self._libraries: Dict[str, dict] = {}
            self._pending.clear()

    def wrap(self, fn: Callable) -> "_ProfiledKernel":
        return _ProfiledKernel(self, fn)

    # -- the port's kernels --

    def record_compile(self, library: str, seconds: float) -> None:
        """One build or load of a kernel library."""
        with self._lock:
            self.compiles += 1
            self.compile_s += seconds
            lib = self._libraries.setdefault(library, {"compiles": 0, "seconds": 0.0})
            lib["compiles"] += 1
            lib["seconds"] += seconds

    def start(self, kernel: str, device) -> Optional[tuple]:
        """Record a start event on `device`'s current stream before a
        launch of `kernel`; None when tracing is off (nothing recorded)
        or MAX_PENDING pairs are still running (the launch is counted
        untimed). Pass the result to `stop` after a successful launch."""
        if not enabled():
            return None
        if len(self._pending) >= self.max_pending:
            self.drain()
            if len(self._pending) >= self.max_pending:
                with self._lock:
                    self.untimed += 1
                    self._count(kernel)
                return None
        import torch

        # the launch's stream: the raw handle is cheap to read, its Stream
        # object is made once (current_stream costs a few microseconds)
        idx = device.index if getattr(device, "index", None) is not None else (
            torch.cuda.current_device())
        stream = self._streams.get(torch._C._cuda_getCurrentRawStream(idx))
        if stream is None:
            stream = torch.cuda.current_stream(idx)
            self._streams[stream.cuda_stream] = stream
        with self._lock:
            pair = self._free.pop() if self._free else None
        if pair is None:
            pair = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        pair[0].record(stream)
        return kernel, pair, stream

    def stop(self, token: Optional[tuple]) -> None:
        """Record the end event on the launch's stream and park the pair."""
        if token is None:
            return
        kernel, pair, stream = token
        pair[1].record(stream)
        with self._lock:
            self._pending.append((kernel, pair))
            self._count(kernel)

    def _count(self, kernel: str) -> dict:
        k = self._kernels.setdefault(kernel, {"launches": 0, "timed": 0, "device_s": 0.0})
        k["launches"] += 1
        return k

    def drain(self) -> int:
        """Read every parked pair whose end event has completed, oldest
        first, stopping at the first still running; no wait. Returns the
        pairs read."""
        n = 0
        with self._lock:
            while self._pending:
                kernel, pair = self._pending[0]
                if not pair[1].query():
                    break
                self._pending.popleft()
                s = pair[0].elapsed_time(pair[1]) / 1e3
                self.executions += 1
                self.execute_s += s
                k = self._kernels[kernel]
                k["timed"] += 1
                k["device_s"] += s
                self._free.append(pair)
                n += 1
        return n


class _ProfiledKernel:
    """A callable whose first successful call books the compile bucket
    and later calls the execute bucket (host wall)."""

    __slots__ = ("_profile", "fn", "_compiled", "_lock")

    def __init__(self, profile: KernelProfile, fn: Callable):
        self._profile = profile
        self.fn = fn
        self._compiled = False
        self._lock = threading.Lock()

    def __call__(self, *args, **kwargs):
        t0 = time.perf_counter()
        out = self.fn(*args, **kwargs)
        dt = time.perf_counter() - t0
        # the first-call decision is atomic: two threads racing the first
        # call would otherwise both book the compile bucket
        with self._lock:
            first = not self._compiled
            self._compiled = True
        self._profile.record(first, dt)
        return out


def enabled() -> bool:
    from ..server import knobs

    return knobs.trace_enabled()


def kernels_line(before: dict, after: dict) -> str:
    """The `-- kernels:` footer between two snapshots: compiles and
    launches with their seconds, then each launched kernel's launches and
    device ms from its event pairs."""
    d_comp = after["compiles"] - before["compiles"]
    d_comp_s = after["compile_s"] - before["compile_s"]
    d_exec = after["executions"] - before["executions"]
    d_exec_s = after["execute_s"] - before["execute_s"]
    parts = []
    for name, k in sorted(after["kernels"].items()):
        b = before["kernels"].get(name, {"launches": 0, "timed": 0, "device_s": 0.0})
        launches = k["launches"] - b["launches"]
        if launches:
            timed = k["timed"] - b["timed"]
            ms = (k["device_s"] - b["device_s"]) * 1e3
            parts.append(f"{name} {launches} ({timed} timed, {ms:,.3f}ms device)")
    if not (d_comp or d_exec or parts):
        return ""
    line = (f"compile +{d_comp} ({d_comp_s * 1e3:,.1f}ms), "
            f"execute +{d_exec} ({d_exec_s * 1e3:,.1f}ms)")
    if parts:
        line += "; " + ", ".join(parts)
    if after["pending"]:
        line += f"; {after['pending']} unread"
    return line


KERNEL_PROFILE = KernelProfile()
