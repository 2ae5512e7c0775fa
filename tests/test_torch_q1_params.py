"""The fused-Q1 kernel's launch on the CPU side (ops/agg_kernel.py): the
Q1Params struct as csrc/q1_partials.cu reads it, the grid, the choice of
the paired-load instance, the result buffer whose views make the result
dict, and the input checks. Torch only; the kernel itself runs in
tests/test_torch_cuda.py and chip_smoke.py on the card.
"""

import ctypes
import struct

import numpy as np
import pytest
import torch

from presto_tpu_torch.ops import agg_kernel as ak

# Q1Params under the C ABI of x86-64 and CUDA: twelve pointers, then n
C_LAYOUT = {
    "qty": 0, "price": 8, "disc": 16, "tax": 24, "rf": 32, "ls": 40, "ship": 48, "count": 56,
    "cutoff": 64, "out": 72, "scratch": 80, "ticket": 88, "n": 96,
}
C_SIZE = 104
CUTOFF = 10471


def test_params_struct_matches_the_c_layout():
    assert ctypes.sizeof(ak.Q1Params) == C_SIZE
    assert [f for f, _ in ak.Q1Params._fields_] == list(C_LAYOUT)
    for name, offset in C_LAYOUT.items():
        assert (getattr(ak.Q1Params, name).offset, getattr(ak.Q1Params, name).size) == (offset, 8)
    assert ak.ctypes_layout() == [C_SIZE, *C_LAYOUT.values()]


def test_params_put_each_field_where_c_reads_it():
    ptrs = [0x1000 * (i + 1) for i in range(12)]
    p = ak.Q1Params(*ptrs, 6_000_859)
    raw = ctypes.string_at(ctypes.addressof(p), C_SIZE)
    assert list(struct.unpack_from("<12Q", raw, 0)) == ptrs
    assert struct.unpack_from("<q", raw, C_LAYOUT["n"])[0] == 6_000_859


@pytest.mark.parametrize("n,resident,blocks", [
    (0, 264, 1), (1, 264, 1), (37, 264, 1), (ak.BLOCK_ROWS, 264, 1),
    (ak.BLOCK_ROWS + 1, 264, 2), (200_001, 264, 196), (6_000_000, 264, 264),
    (60_000_000, 264, 264), (6_000_000, 132, 132),
])
def test_launch_blocks(n, resident, blocks):
    assert ak.launch_blocks(n, resident) == blocks


def _columns(rng, n):
    """Q1's seven columns (int64 decimals, int32 codes and date), some
    group codes out of range."""
    return [
        torch.from_numpy(rng.integers(1, 51, n) * 100),
        torch.from_numpy(rng.integers(0, 1 << 31, n)),
        torch.from_numpy(rng.integers(0, 11, n)),
        torch.from_numpy(rng.integers(0, 9, n)),
        torch.from_numpy(rng.integers(-1, 4, n).astype(np.int32)),
        torch.from_numpy(rng.integers(0, 2, n).astype(np.int32)),
        torch.from_numpy(rng.integers(CUTOFF - 3000, CUTOFF + 200, n).astype(np.int32)),
    ]


def test_paired_loads_need_16_byte_decimals_and_8_byte_codes():
    cols = _columns(np.random.default_rng(3), 64)
    assert ak.paired_loads(cols)
    assert not ak.paired_loads([c[1:] for c in cols])  # 8 and 4 bytes off
    assert ak.paired_loads([c[2:] for c in cols])  # 16 and 8 bytes off
    assert not ak.paired_loads([cols[0][2:], *(c[1:-1] for c in cols[1:4]),
                                *(c[2:] for c in cols[4:])])
    assert not ak.paired_loads([*(c[:-1] for c in cols[:6]), cols[6][1:]])


def test_result_views_give_the_plain_dict():
    """The buffer filled from the plain totals as the kernel writes it
    (count, qty, price and disc field-major, then the normalized
    disc_price and charge lane pairs), read through result_views, gives
    q1_sums_plain's dict field by field; the plain version's fields are
    views of one such buffer."""
    rng = np.random.default_rng(11)
    n, count = 5000, 4321
    cols = _columns(rng, n)
    got = ak.q1_sums_plain(*cols, torch.tensor(count, dtype=torch.int32),
                           torch.tensor(CUTOFF, dtype=torch.int32))
    q, p, d, t, rf, ls, ship = (c.numpy().astype(object) for c in cols)
    g = rf * 2 + ls
    buf = torch.empty(ak.OUT_WORDS, dtype=torch.int64)
    words = buf.numpy()
    for grp in range(ak.GROUPS):
        m = (np.arange(n) < count) & (ship <= CUTOFF) & (g == grp)
        dp, ch = p[m] * (100 - d[m]), p[m] * (100 - d[m]) * (100 + t[m])
        for k, total in enumerate((int(m.sum()), sum(q[m]), sum(p[m]), sum(d[m]))):
            words[k * ak.GROUPS + grp] = total
        for c, total in enumerate((sum(dp), sum(ch))):
            base = 4 * ak.GROUPS + 2 * ak.GROUPS * c + 2 * grp
            words[base], words[base + 1] = int(total) >> 32, int(total) & 0xFFFFFFFF
    want = ak.result_views(buf)
    assert list(got) == list(want) == [name for name, _ in ak.FIELDS]
    assert ak.OUT_WORDS == 48
    for k in want:
        assert got[k].dtype == torch.int64 and torch.equal(got[k], want[k]), k
        assert got[k].untyped_storage().data_ptr() == got["count"].untyped_storage().data_ptr()
    assert got["count"].untyped_storage().nbytes() == 8 * ak.OUT_WORDS
    # the CPU wrapper is the plain version
    again = ak.q1_sums(*cols, torch.tensor(count, dtype=torch.int32),
                       torch.tensor(CUTOFF, dtype=torch.int32))
    assert all(torch.equal(again[k], want[k]) for k in want)


def _bad(case, cols, count, cutoff):
    if case == "strided_column":
        cols[1] = torch.stack([cols[1], cols[1]], dim=1)[:, 0]
    elif case == "int64_code":
        cols[4] = cols[4].to(torch.int64)
    elif case == "short_column":
        cols[3] = cols[3][:-1]
    elif case == "matrix_column":
        cols[0] = cols[0].reshape(-1, 1)
    elif case == "column_on_another_device":
        cols[6] = torch.empty_like(cols[6], device="meta")
    elif case == "two_counts":
        count = torch.tensor([5, 6], dtype=torch.int32)
    elif case == "int64_cutoff":
        cutoff = cutoff.to(torch.int64)
    return cols, count, cutoff


@pytest.mark.parametrize("case,match", [
    ("strided_column", "price"), ("int64_code", "rf"), ("short_column", "tax"),
    ("matrix_column", "qty"), ("column_on_another_device", "one device"),
    ("two_counts", "count"), ("int64_cutoff", "cutoff"),
])
def test_inputs_are_checked_before_any_launch(case, match):
    cols, count, cutoff = _bad(case, _columns(np.random.default_rng(5), 64),
                               torch.tensor(64, dtype=torch.int32),
                               torch.tensor(CUTOFF, dtype=torch.int32))
    for fn in (ak.q1_sums, ak.q1_sums_plain):
        with pytest.raises(ValueError, match=match):
            fn(*cols, count, cutoff)


def test_bound_bytes_counts_rows_below_count_and_selected_sectors():
    """12 B a row below count, 32 B of each int64 decimal per 4-row sector
    that holds a selected row, the 384 B of totals."""
    from presto_tpu_torch.benchmark import q1bench

    n = 10
    cols = _columns(np.random.default_rng(7), n)
    cols[6] = torch.tensor([0, 9, 9, 9, 9, 0, 9, 9, 0, 0], dtype=torch.int32)  # ship
    res = q1bench.bound_bytes(cols, torch.tensor(9, dtype=torch.int32),
                              torch.tensor(5, dtype=torch.int32))
    # selected rows 0, 5, 8 (row 9 is past count): sectors 0, 1 and 2
    assert (res["n"], res["count"], res["selected"], res["sectors"]) == (10, 9, 3, 3)
    assert res["bytes"] == 12 * 9 + 4 * 32 * 3 + 384


def test_q1bench_runs_on_cpu():
    from presto_tpu_torch.benchmark import q1bench

    out = q1bench.run("cpu", shapes=(("sf0.01", 0.01),))
    res, pipe = out["sf0.01"], out["q1_local_kernel"]
    assert res["exact"] and res["ms"] is None and res["launches"] == 0
    assert res["n"] == res["count"] == 60_000 and 0 < res["selected"] < res["count"]
    # no device metric from a CPU run
    assert pipe["warm_wall_ms"] > 0 and pipe["launches"] == 0
    assert "device_busy_ms" not in pipe and "device_busy_ms" not in res
