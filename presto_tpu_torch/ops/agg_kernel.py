"""Fused TPC-H Q1 aggregation through a hand-written CUDA kernel
(torch counterpart of presto_tpu/ops/pallas_agg.py).

One pass over lineitem computes every Q1 aggregate of the 6
(returnflag, linestatus) groups; benchmark/handcoded.py's
`q1_local_kernel` builds the Q1 page from it.

`q1_sums` is the kernel's wrapper: for CUDA tensors it launches
csrc/q1_partials.cu (which replaces pallas_agg.py::_kernel) and folds the
per-block tiles; for CPU tensors it runs `q1_sums_plain`, the same function
in plain torch. There is no fault fallback: a kernel that fails to build or
launch raises.

Both return exactly what the JAX package's `combine(q1_partial_sums(...))`
returns: count, sum_qty, sum_price and sum_disc as int64 of shape (6,), and
sum_disc_price (scale 4) and sum_charge (scale 6) as (6, 2) two-lane
decimals (ops/decimal128.py). The lane sums are exact at any row count;
the four plain sums are exact for column values in int32's range (the
domain of the reference's int32 kernel) and below 2^31 rows.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch

from . import decimal128 as d128

GROUPS = 6  # returnflag {A, N, R} x linestatus {F, O}
CHANNELS = 8  # count, qty, price, disc, disc_price hi/lo, charge hi/lo
THREADS = 256

# launches of the CUDA kernel (one per q1_sums call on CUDA tensors)
launches = 0


def _check_inputs(qty, price, disc, tax, rf, ls, ship, count, cutoff):
    n = qty.shape[0]
    dev = qty.device
    for name, t, dtype in (
        ("qty", qty, torch.int64), ("price", price, torch.int64),
        ("disc", disc, torch.int64), ("tax", tax, torch.int64),
        ("rf", rf, torch.int32), ("ls", ls, torch.int32), ("ship", ship, torch.int32),
    ):
        if t.dtype != dtype or t.ndim != 1 or t.shape[0] != n or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {dtype} vector of {n} rows")
        if t.device != dev:
            raise ValueError("all inputs must be on one device")
    for name, t in (("count", count), ("cutoff", cutoff)):
        if t.dtype != torch.int32 or t.numel() != 1 or t.device != dev:
            raise ValueError(f"{name} must be one int32 on the columns' device")


def _totals(t: torch.Tensor) -> Dict[str, torch.Tensor]:
    """(6, 8) channel totals -> the reference combine()'s dict."""
    dp = torch.stack(d128.dnorm(t[:, 4], t[:, 5]), dim=-1)
    charge = torch.stack(d128.dnorm(t[:, 6], t[:, 7]), dim=-1)
    return {
        "count": t[:, 0], "sum_qty": t[:, 1], "sum_price": t[:, 2], "sum_disc": t[:, 3],
        "sum_disc_price": dp, "sum_charge": charge,
    }


def q1_sums_plain(qty, price, disc, tax, rf, ls, ship, count, cutoff):
    """Q1's per-group sums in plain torch over rows with row < count,
    ship <= cutoff and group rf * 2 + ls in [0, 6)."""
    _check_inputs(qty, price, disc, tax, rf, ls, ship, count, cutoff)
    n = qty.shape[0]
    dev = qty.device
    gid = rf.to(torch.int64) * 2 + ls
    live = (torch.arange(n, device=dev) < count.reshape(())) & (ship <= cutoff.reshape(()))
    live &= (gid >= 0) & (gid < GROUPS)
    g = torch.where(live, gid, GROUPS)  # dead rows -> overflow slot
    dp = price * (100 - disc)
    charge = dp * (100 + tax)
    chans = torch.stack([
        torch.ones_like(qty), qty, price, disc,
        dp >> 32, dp & d128.MASK32, charge >> 32, charge & d128.MASK32,
    ], dim=1)
    acc = torch.zeros((GROUPS + 1, CHANNELS), dtype=torch.int64, device=dev)
    return _totals(acc.index_add_(0, g, chans)[:GROUPS])


def _kernel_fn():
    """The C entry point, built and bound at first use."""
    from .. import cuda_build

    fn = cuda_build.load("q1_partials").q1_partials
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 9 + [
            ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
    return fn


def _launch(qty, price, disc, tax, rf, ls, ship, count, cutoff):
    """Launch csrc/q1_partials.cu on the current stream and fold its
    per-block tiles: (6, 8) channel totals."""
    global launches
    dev = qty.device
    n = qty.shape[0]
    fn = _kernel_fn()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    blocks = max(1, min(-(-n // THREADS), 4 * sms))
    out = torch.empty((blocks, GROUPS * CHANNELS), dtype=torch.int64, device=dev)
    count = count.reshape(1).contiguous()
    cutoff = cutoff.reshape(1).contiguous()
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = fn(
        qty.data_ptr(), price.data_ptr(), disc.data_ptr(), tax.data_ptr(), rf.data_ptr(),
        ls.data_ptr(), ship.data_ptr(), count.data_ptr(), cutoff.data_ptr(), n,
        out.data_ptr(), blocks, THREADS, stream,
    )
    if rc != 0:
        raise RuntimeError(f"q1_partials launch failed: cudaError {rc}")
    launches += 1
    return out.sum(0).reshape(GROUPS, CHANNELS)


def q1_sums(qty, price, disc, tax, rf, ls, ship, count, cutoff) -> Dict[str, torch.Tensor]:
    """Q1's per-group sums (see q1_sums_plain). The four decimal columns
    are int64, the codes and the date int32; count and cutoff are one
    int32 each on the columns' device (never read on the host). CUDA
    tensors go through the kernel, CPU tensors through the plain version."""
    _check_inputs(qty, price, disc, tax, rf, ls, ship, count, cutoff)
    if qty.device.type == "cuda":
        return _totals(_launch(qty, price, disc, tax, rf, ls, ship, count, cutoff))
    if qty.device.type != "cpu":
        raise ValueError(f"no q1_partials kernel for device {qty.device}")
    return q1_sums_plain(qty, price, disc, tax, rf, ls, ship, count, cutoff)
