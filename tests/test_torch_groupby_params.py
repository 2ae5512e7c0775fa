"""The group-by kernel's launch on the CPU side (ops/groupby_kernel.py):
the GroupbyParams struct as csrc/groupby_partials.cu reads it, the choice
of regime and grid, and the channel-list and `count=None` forms of the
plain version. Torch only; the kernel itself runs in tests/test_torch_cuda.py
and chip_smoke.py on the card.
"""

import ctypes
import struct

import numpy as np
import pytest
import torch

from presto_tpu_torch.ops import groupby_kernel as gk

# GroupbyParams under the C ABI of x86-64 and CUDA (natural alignment):
# six pointers, n, G, K, aligned, int kind[128], then pointer chan[128]
# aligned to 8 bytes
C_LAYOUT = {
    "gid": (0, 8), "live": (8, 8), "count": (16, 8), "out": (24, 8), "scratch": (32, 8),
    "ticket": (40, 8), "n": (48, 8), "G": (56, 4), "K": (60, 4), "aligned": (64, 4),
    "kind": (68, 4 * 128), "chan": (584, 8 * 128),
}
C_SIZE = 1608


def test_params_struct_matches_the_c_layout():
    assert ctypes.sizeof(gk.GroupbyParams) == C_SIZE
    assert [f for f, _ in gk.GroupbyParams._fields_] == list(C_LAYOUT)
    for name, (offset, size) in C_LAYOUT.items():
        field = getattr(gk.GroupbyParams, name)
        assert (field.offset, field.size) == (offset, size), name
    assert C_SIZE <= 4096  # the kernel-parameter limit


@pytest.mark.parametrize("K", [1, 128])
def test_pack_params_puts_each_field_where_c_reads_it(K):
    rng = np.random.default_rng(K)
    kinds = [int(k) for k in rng.integers(0, 4, K)]
    chans = [0 if k == gk.COUNT else int(p) * 16
             for k, p in zip(kinds, rng.integers(1, 1 << 40, K))]
    p = gk.pack_params(0x1000, 0x2000, 0, 0x3000, 0x4000, 0x5000, 6_000_859, 75, kinds, chans,
                       True)
    raw = ctypes.string_at(ctypes.addressof(p), C_SIZE)

    def field(name, fmt, i=0):
        off, _ = C_LAYOUT[name]
        width = struct.calcsize(fmt)
        return struct.unpack_from(fmt, raw, off + i * width)[0]

    assert [field(f, "<Q") for f in ("gid", "live", "count", "out", "scratch", "ticket")] == [
        0x1000, 0x2000, 0, 0x3000, 0x4000, 0x5000]
    assert (field("n", "<q"), field("G", "<i"), field("K", "<i"), field("aligned", "<i")) == (
        6_000_859, 75, K, 1)
    assert [field("kind", "<i", k) for k in range(K)] == kinds
    assert [field("chan", "<Q", k) for k in range(K)] == chans
    assert all(field("chan", "<Q", k) == 0 for k in range(K, 128))


@pytest.mark.parametrize(
    "n,G,K,occ,regime,blocks",
    [
        (1024, 75, 2, 4, gk.ATOMIC, 1),  # Q18's hash-slot call: one block
        (6_000_859, 6, 6, 2, 2, 264),  # Q1's dense call: two 4 x 8 register slices
        (6_000_859, 6, 6, 1, 2, 132),
        (6_000_859, 6, 6, 3, 2, 264),  # at most MAX_BLOCKS_PER_SM per SM
        (1_204_202, 25, 2, 2, 4, 264),  # Q5's dense call: two 1 x 32 slices
        (50_000, 4, 4, 2, 1, 13),  # the 4 x 4 tile; one block per ROWS_PER_BLOCK rows
        (6_000_859, 64, 4, 4, gk.ATOMIC, 264),  # G 64, four channels
        (100_000, 8, 8, 1, 2, 25),  # G * K = 64: the register limit
        (100_000, 13, 5, 2, gk.ATOMIC, 25),  # G * K = 65: shared memory
        (1, 6, 6, 1, 2, 1),
        (gk.ROWS_PER_BLOCK, 6, 6, 1, 2, 1),
        (gk.ROWS_PER_BLOCK + 1, 6, 6, 1, 2, 2),
    ],
)
def test_launch_plan(n, G, K, occ, regime, blocks):
    assert gk.launch_plan(n, G, K, 132, occ) == (regime, blocks)


def test_register_tiles_hold_at_most_64_accumulators():
    """At most 32 accumulators a thread and 64 a block (G * K), and every
    (G, K) that some tile holds takes a register regime."""
    for kb, gb in gk.REGISTER_TILES:
        assert kb * gb <= 32 and kb * gk.MAX_SLICES * gb <= 64
    for G in range(1, 80):
        for K in range(1, 20):
            fits = [K <= kb * gk.MAX_SLICES and G <= gb for kb, gb in gk.REGISTER_TILES]
            r = gk.register_regime(G, K)
            assert r == (fits.index(True) + 1 if any(fits) else gk.ATOMIC)
            assert (r != gk.ATOMIC) <= (G * K <= 64)


def _call(seed, n=3000, G=9, dtype=np.int64):
    rng = np.random.default_rng(seed)
    gid = torch.from_numpy(rng.integers(-1, G + 1, n).astype(np.int32))  # some out of range
    live = torch.from_numpy(rng.random(n) < 0.85)
    if dtype == np.int64:
        chans = torch.from_numpy(rng.integers(-(1 << 62), 1 << 62, (3, n)))
        kinds, sources = [gk.COUNT, gk.MIN, gk.MAX, gk.ADD], [-1, 0, 1, 2]
    else:
        chans = torch.from_numpy(rng.normal(0.0, 1e3, (2, n)))
        kinds, sources = [gk.ADD, gk.ADD, gk.COUNT], [0, 1, -1]
    return gid, live, chans, kinds, sources, G


@pytest.mark.parametrize("dtype", [np.int64, np.float64])
def test_plain_takes_a_channel_list_or_a_stacked_tensor(dtype):
    gid, live, chans, kinds, sources, G = _call(1, dtype=dtype)
    count = torch.tensor(2000, dtype=torch.int32)
    whole = gk.groupby_totals_plain(gid, live, count, chans, kinds, sources, G)
    listed = gk.groupby_totals_plain(gid, live, count, [c.clone() for c in chans], kinds,
                                     sources, G)
    assert torch.equal(whole, listed)
    # the wrapper on CPU tensors is the plain version, in both forms
    assert torch.equal(gk.groupby_totals(gid, live, count, list(chans), kinds, sources, G), whole)


def test_count_none_is_every_row():
    gid, live, chans, kinds, sources, G = _call(2)
    n = torch.tensor(gid.shape[0], dtype=torch.int32)
    assert torch.equal(gk.groupby_totals_plain(gid, live, None, chans, kinds, sources, G),
                       gk.groupby_totals_plain(gid, live, n, chans, kinds, sources, G))
    assert torch.equal(gk.groupby_totals(gid, live, None, list(chans), kinds, sources, G),
                       gk.groupby_totals(gid, live, n, chans, kinds, sources, G))


def test_channel_plan_calls_pass_the_plan_vectors_unstacked():
    from presto_tpu_torch import types as T
    from presto_tpu_torch.expr.ir import col
    from presto_tpu_torch.ops.aggregate import AggSpec
    from presto_tpu_torch.page import Block, Page

    rng = np.random.default_rng(4)
    n = 500
    page = Page.from_blocks(
        [Block.from_numpy(rng.integers(0, 3, n).astype(np.int32), T.VARCHAR,
                          dictionary=("a", "b", "c"), device="cpu"),
         Block.from_numpy(rng.integers(0, 100, n), T.BIGINT, valid=rng.random(n) < 0.9,
                          device="cpu"),
         Block.from_numpy(rng.random(n), T.DOUBLE, device="cpu")],
        ["g", "v", "d"],
    )
    aggs = [AggSpec("sum", col("v", T.BIGINT), "s", T.BIGINT),
            AggSpec("max", col("v", T.BIGINT), "m", T.BIGINT),
            AggSpec("avg", col("d", T.DOUBLE), "a", T.DOUBLE),
            AggSpec("count_star", None, "c", T.BIGINT)]
    dp = gk.dense_plan(page, (col("g", T.VARCHAR),), aggs, None)
    calls = dp.kernel_calls()
    assert [c[3][0].dtype for c in calls] == [torch.int64, torch.float64]
    for call, chans in zip(calls, (dp.channels.ints, dp.channels.floats)):
        assert isinstance(call[3], list)
        assert [c.data_ptr() for c in call[3]] == [c.data_ptr() for c in chans.data]
        want = gk.groupby_totals_plain(call[0], call[1], call[2], torch.stack(call[3]),
                                       *call[4:])
        assert torch.equal(gk.groupby_totals(*call), want)


def test_inputs_are_checked_before_any_launch():
    gid, live, chans, kinds, sources, G = _call(3)
    with pytest.raises(ValueError, match="one dtype"):
        gk.groupby_totals(gid, live, None, [chans[0], chans[1].double()], kinds[:3],
                          sources[:3], G)
    with pytest.raises(ValueError, match="gid's length"):
        gk.groupby_totals(gid, live, None, [chans[0][:-1]], [gk.ADD], [0], G)
