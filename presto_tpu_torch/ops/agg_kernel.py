"""Fused TPC-H Q1 aggregation through a hand-written CUDA kernel
(torch counterpart of presto_tpu/ops/pallas_agg.py).

One pass over lineitem computes every Q1 aggregate of the 6
(returnflag, linestatus) groups; benchmark/handcoded.py's
`q1_local_kernel` builds the Q1 page from it.

`q1_sums` is the kernel's wrapper: for CUDA tensors it makes ONE launch of
csrc/q1_partials.cu (which replaces pallas_agg.py::_kernel and the fold of
its tiles, `combine`), which folds its blocks and normalizes the decimal
lanes itself; for CPU tensors it runs `q1_sums_plain`, the same function in
plain torch. A launch copies nothing between host and device: the
parameters travel by value in one Q1Params struct. There is no fault
fallback: a kernel that fails to build or launch raises.

Both return exactly what the JAX package's `combine(q1_partial_sums(...))`
returns: count, sum_qty, sum_price and sum_disc as int64 of shape (6,), and
sum_disc_price (scale 4) and sum_charge (scale 6) as (6, 2) two-lane
decimals (ops/decimal128.py), all views of one OUT_WORDS int64 buffer
(FIELDS). The lane sums are exact at any row count; the four plain sums are
exact for column values in int32's range (the domain of the reference's
int32 kernel) and below 2^31 rows.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, List

import torch

from . import decimal128 as d128

GROUPS = 6  # returnflag {A, N, R} x linestatus {F, O}
CHANNELS = 8  # count, qty, price, disc, disc_price hi/lo, charge hi/lo

# the result buffer: its fields (name, shape) one after another, as
# csrc/q1_partials.cu writes them
FIELDS = (
    ("count", (GROUPS,)),
    ("sum_qty", (GROUPS,)),
    ("sum_price", (GROUPS,)),
    ("sum_disc", (GROUPS,)),
    ("sum_disc_price", (GROUPS, 2)),
    ("sum_charge", (GROUPS, 2)),
)
_SPLIT = [math.prod(shape) for _, shape in FIELDS]
OUT_WORDS = sum(_SPLIT)

# launch shape (csrc/q1_partials.cu): 256 threads a block, BLOCK_ROWS rows a
# block a step, at most as many blocks as the SMs hold at once
# (__launch_bounds__(256, 2) and 96 KB of shared memory a block: 2 an SM)
BLOCK_ROWS = 1024
BLOCKS_PER_SM = 2

# launches of the CUDA kernel (one per q1_sums call on CUDA tensors)
launches = 0

_COLUMNS = (("qty", torch.int64), ("price", torch.int64), ("disc", torch.int64),
            ("tax", torch.int64), ("rf", torch.int32), ("ls", torch.int32),
            ("ship", torch.int32))


def _check_inputs(qty, price, disc, tax, rf, ls, ship, count, cutoff):
    n = qty.shape[0]
    dev = qty.device
    for (name, dtype), t in zip(_COLUMNS, (qty, price, disc, tax, rf, ls, ship)):
        if t.dtype != dtype or t.ndim != 1 or t.shape[0] != n or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {dtype} vector of {n} rows")
        if t.device != dev:
            raise ValueError("all inputs must be on one device")
    for name, t in (("count", count), ("cutoff", cutoff)):
        if t.dtype != torch.int32 or t.numel() != 1 or t.device != dev:
            raise ValueError(f"{name} must be one int32 on the columns' device")


def result_views(buf: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The result dict as views of one OUT_WORDS int64 buffer (FIELDS), in
    three tensor operations: the views are made on every call."""
    return {name: part if len(shape) == 1 else part.view(shape)
            for (name, shape), part in zip(FIELDS, buf.split(_SPLIT))}


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
    t = torch.zeros((GROUPS + 1, CHANNELS), dtype=torch.int64, device=dev)
    t = t.index_add_(0, g, chans)[:GROUPS]
    buf = torch.cat([
        t[:, :4].T.reshape(-1),
        torch.stack(d128.dnorm(t[:, 4], t[:, 5]), dim=-1).reshape(-1),
        torch.stack(d128.dnorm(t[:, 6], t[:, 7]), dim=-1).reshape(-1),
    ])
    return result_views(buf)


class Q1Params(ctypes.Structure):
    """csrc/q1_partials.cu's Q1Params, field for field (x86-64 and CUDA
    lay it out alike: twelve pointers, then n)."""

    _fields_ = [(name, ctypes.c_void_p) for name in (
        "qty", "price", "disc", "tax", "rf", "ls", "ship", "count", "cutoff", "out",
        "scratch", "ticket")] + [("n", ctypes.c_longlong)]


def launch_blocks(n: int, resident: int) -> int:
    """Blocks of one launch: one per BLOCK_ROWS rows, no more than the
    `resident` blocks the SMs hold at once."""
    return max(1, min(-(-n // BLOCK_ROWS), resident))


def paired_loads(cols) -> bool:
    """Whether the kernel may take its paired loads: every int64 column
    16-byte and every int32 column 8-byte aligned."""
    return all(c.data_ptr() % (2 * c.element_size()) == 0 for c in cols)


_LIB = None
_DEVICES: Dict[int, tuple] = {}  # device index -> (resident blocks, scratch, ticket)


def _lib():
    """The kernel library, built and bound at first use."""
    global _LIB
    if _LIB is None:
        from .. import cuda_build

        lib = cuda_build.load("q1_partials")
        lib.q1_sums_launch.restype = ctypes.c_int
        lib.q1_sums_launch.argtypes = [ctypes.POINTER(Q1Params), ctypes.c_int, ctypes.c_int,
                                       ctypes.c_void_p]
        lib.q1_params_layout.restype = ctypes.c_int
        lib.q1_params_layout.argtypes = [ctypes.POINTER(ctypes.c_longlong)]
        _LIB = lib
    return _LIB


def params_layout() -> List[int]:
    """sizeof(Q1Params) and its field offsets as the C side reads them
    (the card's build; compare with `ctypes_layout()`)."""
    buf = (ctypes.c_longlong * 16)()
    n = _lib().q1_params_layout(buf)
    return list(buf[:n])


def ctypes_layout() -> List[int]:
    return [ctypes.sizeof(Q1Params)] + [getattr(Q1Params, f).offset for f, _ in Q1Params._fields_]


def _device(idx: int) -> tuple:
    """(resident blocks, scratch, ticket) of CUDA device `idx`, made once:
    BLOCKS_PER_SM blocks an SM, a scratch array of that many block tiles
    and the ticket counter. Calls on one device share them, so they run in
    stream order."""
    state = _DEVICES.get(idx)
    if state is None:
        resident = torch.cuda.get_device_properties(idx).multi_processor_count * BLOCKS_PER_SM
        dev = torch.device("cuda", idx)
        state = _DEVICES[idx] = (
            resident, torch.empty((resident, GROUPS * CHANNELS), dtype=torch.int64, device=dev),
            torch.zeros(1, dtype=torch.int32, device=dev))
    return state


def _launch(qty, price, disc, tax, rf, ls, ship, count, cutoff) -> torch.Tensor:
    """One launch of csrc/q1_partials.cu on the current stream: the
    OUT_WORDS result buffer."""
    global launches
    dev = qty.device
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    resident, scratch, ticket = _device(idx)
    n = qty.shape[0]
    cols = (qty, price, disc, tax, rf, ls, ship)
    out = torch.empty(OUT_WORDS, dtype=torch.int64, device=dev)
    params = Q1Params(*(c.data_ptr() for c in cols), count.data_ptr(), cutoff.data_ptr(),
                      out.data_ptr(), scratch.data_ptr(), ticket.data_ptr(), n)
    rc = _lib().q1_sums_launch(ctypes.byref(params), int(paired_loads(cols)),
                               launch_blocks(n, resident),
                               torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"q1_partials launch failed: cudaError {rc}")
    launches += 1
    return out


def q1_sums(qty, price, disc, tax, rf, ls, ship, count, cutoff) -> Dict[str, torch.Tensor]:
    """Q1's per-group sums (see q1_sums_plain). The four decimal columns
    are int64, the codes and the date int32; count and cutoff are one
    int32 each on the columns' device (never read on the host). CUDA
    tensors go through the kernel, CPU tensors through the plain version."""
    _check_inputs(qty, price, disc, tax, rf, ls, ship, count, cutoff)
    if qty.device.type == "cuda":
        return result_views(_launch(qty, price, disc, tax, rf, ls, ship, count, cutoff))
    if qty.device.type != "cpu":
        raise ValueError(f"no q1_partials kernel for device {qty.device}")
    return q1_sums_plain(qty, price, disc, tax, rf, ls, ship, count, cutoff)
