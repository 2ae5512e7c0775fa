"""Parity: presto_tpu_torch's Page/Block and long decimals against presto_tpu.

The same numpy inputs (fixed seed) go through both packages; every
comparison is exact. Cases follow tests/test_page.py and
tests/test_decimal128.py. The port runs on device="cpu".
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from presto_tpu import types as RT
from presto_tpu.ops import decimal128 as rd
from presto_tpu.page import Block as RBlock
from presto_tpu.page import Page as RPage
from presto_tpu.page import round_capacity as r_round_capacity
from presto_tpu_torch import types as T
from presto_tpu_torch.ops import decimal128 as d128
from presto_tpu_torch.page import (
    Block,
    Page,
    page_from_numpy,
    page_from_reference,
    round_capacity,
)

# one torch thread: the suite runs in parallel worker processes
# (pytest-xdist), and a thread per core in each oversubscribes the host
torch.set_num_threads(1)

CPU = "cpu"


@pytest.mark.parametrize(
    "typ,rtyp,arr",
    [
        (T.BIGINT, RT.BIGINT, np.array([1, 2, 3])),
        (T.INTEGER, RT.INTEGER, np.array([-5, 7], np.int32)),
        (T.DOUBLE, RT.DOUBLE, np.array([1.5, 2.5])),
        (T.DATE, RT.DATE, np.array([8035, 10591], np.int32)),
        (T.decimal(12, 2), RT.decimal(12, 2), np.array([100, -250])),
        (T.BOOLEAN, RT.BOOLEAN, np.array([True, False])),
    ],
)
def test_block_from_numpy_types(typ, rtyp, arr):
    b = Block.from_numpy(arr, typ, device=CPU)
    r = RBlock.from_numpy(arr, rtyp)
    assert str(b.data.dtype).split(".")[-1] == str(r.data.dtype)
    assert b.capacity == r.capacity and b.valid is None
    np.testing.assert_array_equal(b.to_numpy(), r.to_numpy())


@pytest.mark.parametrize(
    "values",
    [["cherry", "apple", "banana", "apple"], ["x", None, "y"], [None, None]],
)
def test_string_blocks(values):
    b = Block.from_strings(values, device=CPU)
    r = RBlock.from_strings(values)
    assert b.dictionary == r.dictionary
    np.testing.assert_array_equal(b.to_numpy(), r.to_numpy())
    if r.valid is None:
        assert b.valid is None
    else:
        np.testing.assert_array_equal(b.valid.numpy(), np.asarray(r.valid))


def test_page_from_dict_pylist_and_padding():
    a = np.array([1, 2, 3], np.int64)
    b = np.array([100, 200, 300])
    c = ["foo", None, "baz"]
    p = Page.from_dict({"a": a, "b": (b, T.decimal(10, 2)), "c": c}, pad_to=8, device=CPU)
    r = RPage.from_dict({"a": a, "b": (b, RT.decimal(10, 2)), "c": c}, pad_to=8)
    assert p.capacity == r.capacity == 8 and int(p.count) == int(r.count) == 3
    assert p.count.dtype == torch.int32 and p.count.ndim == 0
    np.testing.assert_array_equal(p.live_mask().numpy(), np.asarray(r.live_mask()))
    assert p.to_pylist() == r.to_pylist()
    got = p.to_dict_of_numpy()
    for k, v in r.to_dict_of_numpy().items():
        np.testing.assert_array_equal(got[k], v)


def test_round_capacity():
    for n in (0, 1, 15, 16, 17, 1000, 6_000_859):
        assert round_capacity(n) == r_round_capacity(n)


def test_page_from_reference_and_numpy_carry_state():
    rng = np.random.default_rng(11)
    n = 50
    ints = rng.integers(-1000, 1000, n)
    valid = rng.random(n) < 0.8
    longdec = np.stack([rng.integers(-(1 << 40), 1 << 40, n), rng.integers(0, 1 << 32, n)], -1)
    strs = [None if i % 7 == 0 else f"s{i % 5}" for i in range(n)]
    r = RPage.from_dict(
        {
            "i": RBlock.from_numpy(ints, RT.BIGINT, valid=valid),
            "d": RBlock.from_numpy(longdec, RT.decimal(38, 3)),
            "s": RBlock.from_strings(strs),
            "f": RBlock.from_numpy(rng.normal(size=n), RT.DOUBLE),
        },
        pad_to=64,
    )
    p = page_from_reference(r, device=CPU)
    assert p.to_pylist() == r.to_pylist()
    assert p.block("s").dictionary == r.block("s").dictionary
    q = page_from_numpy(
        {"i": ints, "s": r.block("s").to_numpy()[:n]},
        {"i": T.BIGINT, "s": T.VARCHAR},
        dictionaries={"s": r.block("s").dictionary},
        valids={"i": valid, "s": np.asarray(r.block("s").valid)[:n]},
        device=CPU,
    )
    assert q.to_pylist() == [(row[0], row[2]) for row in r.to_pylist()]


# -- long decimals (ops/decimal128.py) ---------------------------------------

VALS = [
    0, 1, -1, 10**18, -(10**18), 9_223_372_036_854_775_807,
    -9_223_372_036_854_775_808, 3 * 10**21, -(7 * 10**24),
    123_456_789_123_456_789_123_456,
]


def _np_lanes(values):
    return np.stack(
        [np.array([v >> 32 for v in values], np.int64),
         np.array([v & 0xFFFFFFFF for v in values], np.int64)], -1
    )


def _pair(values):
    a = _np_lanes(values)
    return torch.from_numpy(a), jnp.asarray(a)


def _same(t, j):
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_lane_add_sub_neg_cmp():
    ta, ja = _pair(VALS)
    tb, jb = _pair(list(reversed(VALS)))
    _same(d128.dadd(ta, tb), rd.dadd(ja, jb))
    _same(d128.dsub(ta, tb), rd.dsub(ja, jb))
    _same(d128.dneg(ta), rd.dneg(ja))
    _same(d128.dcmp_lt(ta, tb), rd.dcmp_lt(ja, jb))
    _same(d128.dcmp_eq(ta, tb), rd.dcmp_eq(ja, jb))
    _same(d128.dsign(ta), rd.dsign(ja))
    _same(d128.to_int64(d128.from_int64(torch.tensor(VALS[:7]))), np.array(VALS[:7]))


@pytest.mark.parametrize("c", [0, 1, -1, 3, 10**9, -(10**12), 999_999_937])
def test_lane_mul_int64(c):
    ta, ja = _pair(VALS)
    _same(d128.dmul_int64(ta, c), rd.dmul_int64(ja, jnp.int64(c)))


@pytest.mark.parametrize("p", [-12, -3, 0, 2, 9])
def test_lane_rescale(p):
    ta, ja = _pair(VALS[:4] + VALS[7:])
    _same(d128.rescale(ta, p), rd.rescale(ja, p))


def test_lane_division_half_up():
    ta, ja = _pair(VALS)
    for d in (1, 7, 10**6, 2**31 - 1):
        _same(d128.ddiv_lanes_half_up(ta, d), rd.ddiv_lanes_half_up(ja, d))
    # ddiv_wide's contract: |quotient| < 2^53
    for d in (3, -(10**12), 2**61 + 1):
        vals = [v for v in VALS + [10**15, -(10**15) - 1] if abs(v) < abs(d) * 2**52]
        ts, js = _pair(vals)
        dt = torch.full((len(vals),), d, dtype=torch.int64)
        _same(d128.ddiv_wide(ts, dt), rd.ddiv_wide(js, jnp.full(len(vals), d, jnp.int64)))


def test_lane_segment_sum_and_float():
    rng = np.random.default_rng(5)
    vals = [int(x) * 10**8 for x in rng.integers(-(10**12), 10**12, 40)]
    ta, ja = _pair(vals)
    seg = rng.integers(0, 4, 40)
    _same(
        d128.segment_sum_wide(ta, torch.from_numpy(seg), 4),
        rd.segment_sum_wide(ja, jnp.asarray(seg), 4),
    )
    np.testing.assert_array_equal(d128.to_float64(ta).numpy(), np.asarray(rd.to_float64(ja)))
