"""Parity: presto_tpu_torch's hand-coded Q1/Q6 pipelines
(benchmark/handcoded.py), the fused Q1 aggregation (ops/agg_kernel.py) and
the benchmark runner (benchmark/bench.py) against presto_tpu's.

The port runs on device="cpu", where `q1_sums` takes `q1_sums_plain`, the
plain version of csrc/q1_partials.cu. The reference's `q1_partial_sums`
runs its Pallas kernel in interpret mode; it needs
`jax.experimental.disable_x64`, which this JAX release lacks, so the tests
supply it (monkeypatch; presto_tpu is unchanged). Every comparison is
exact: these are integer sums and scaled decimals.
"""

import jax
import jax.experimental
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from presto_tpu.benchmark import handcoded as rhandcoded
from presto_tpu.ops.pallas_agg import combine as r_combine
from presto_tpu.ops.pallas_agg import q1_partial_sums as r_q1_partial_sums
from presto_tpu_torch.benchmark import bench, handcoded
from presto_tpu_torch.ops import agg_kernel

# one torch thread: the suite runs in parallel worker processes
# (pytest-xdist), and a thread per core in each oversubscribes the host
torch.set_num_threads(1)

CUTOFF = 10471  # 1998-09-02


@pytest.fixture(scope="module")
def reference_kernel_x64():
    """The reference kernel's `disable_x64` for this JAX release."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jax.experimental, "disable_x64", lambda: jax.enable_x64(False), raising=False)
    yield
    mp.undo()


def _q1_columns(rng, n, price_hi):
    """Q1's seven columns (int64 decimals, int32 codes and date) with the
    group (N, F) left empty."""
    rf = rng.integers(0, 3, n).astype(np.int32)
    ls = rng.integers(0, 2, n).astype(np.int32)
    ls[rf == 1] = 1
    return {
        "qty": rng.integers(1, 51, n) * 100,
        "price": rng.integers(0, price_hi, n),
        "disc": rng.integers(0, 11, n),
        "tax": rng.integers(0, 9, n),
        "rf": rf,
        "ls": ls,
        "ship": rng.integers(CUTOFF - 3000, CUTOFF + 200, n).astype(np.int32),
    }


def _port_sums(cols, count, cutoff=CUTOFF):
    args = [torch.from_numpy(cols[k]) for k in ("qty", "price", "disc", "tax", "rf", "ls", "ship")]
    return agg_kernel.q1_sums(*args, torch.tensor(count, dtype=torch.int32),
                              torch.tensor(cutoff, dtype=torch.int32))


def test_q1_sums_plain_equals_reference_kernel(reference_kernel_x64):
    rng = np.random.default_rng(23)
    n = 2 * 16384  # the reference kernel's blocks of 16,384 rows
    count = n - 1234
    cols = _q1_columns(rng, n, 1 << 31)
    ref = r_combine(r_q1_partial_sums(
        *(jnp.asarray(cols[k].astype(np.int32))
          for k in ("qty", "price", "disc", "tax", "rf", "ls", "ship")),
        jnp.int32(count), jnp.int32(CUTOFF)))
    got = _port_sums(cols, count)
    assert set(got) == set(ref)
    for k, want in ref.items():
        want = np.asarray(want)
        assert got[k].dtype == torch.int64 and got[k].shape == want.shape, k
        assert np.array_equal(got[k].numpy(), want), k
    cnt = got["count"].numpy()
    assert cnt[2] == 0 and 0 < cnt.sum() < count  # the empty group; rows past cutoff


def test_q1_sums_plain_exact_past_int64():
    """Prices near 2^31 - 1 with most rows in one group: that group's
    sum_charge passes 2^63 and still equals the Python-int total."""
    rng = np.random.default_rng(29)
    n = 500_000
    cols = _q1_columns(rng, n, 1000)
    cols["price"] = (1 << 31) - 1 - cols["price"]
    cols["rf"][: int(0.95 * n)] = 0
    cols["ls"][: int(0.95 * n)] = 0
    cols["ship"][:] = CUTOFF
    got = _port_sums(cols, n)
    for g in (0, 5):
        m = (cols["rf"] * 2 + cols["ls"]) == g
        dp = cols["price"][m] * (100 - cols["disc"][m])
        charge = dp * (100 + cols["tax"][m])
        for key, rows in (("sum_disc_price", dp), ("sum_charge", charge)):
            hi, lo = (int(x) for x in got[key][g])
            assert 0 <= lo < 1 << 32
            assert hi * (1 << 32) + lo == sum(rows.tolist()), (g, key)
        assert int(got["sum_price"][g]) == sum(cols["price"][m].tolist())
        assert int(got["count"][g]) == int(m.sum())
    hi, lo = (int(x) for x in got["sum_charge"][0])
    assert hi * (1 << 32) + lo > 1 << 63


def test_q1_sums_checks_its_inputs():
    cols = _q1_columns(np.random.default_rng(1), 64, 1000)
    cols["ship"] = cols["ship"].astype(np.int64)
    with pytest.raises(ValueError, match="ship"):
        _port_sums(cols, 64)


@pytest.fixture(scope="module")
def pages():
    """Lineitem's Q1 columns in both packages, by scale factor."""
    return {sf: (handcoded.lineitem_q1_page(sf, device="cpu"), rhandcoded.lineitem_q1_page(sf))
            for sf in (0.003, 0.01)}


@pytest.mark.parametrize("sf", [0.003, 0.01])
@pytest.mark.parametrize("pipeline,reference", [
    ("q1_local", "q1_local"),
    ("q1_local_kernel", "q1_local_pallas"),
    ("q6_local", "q6_local"),
])
def test_pipeline_equals_reference(pages, reference_kernel_x64, sf, pipeline, reference):
    page, rpage = pages[sf]
    if sf == 0.003:  # capacity off the reference kernel's 16,384-row blocks
        assert page.capacity % 16384 != 0
    got = getattr(handcoded, pipeline)(page).to_pylist()
    want = getattr(rhandcoded, reference)(rpage).to_pylist()
    assert got == want and len(got) == (1 if pipeline == "q6_local" else 4)
    assert [type(x) for x in got[0]] == [type(x) for x in want[0]]


def test_bench_run_on_cpu():
    out = bench.run(0.01, "cpu", runs=1)
    assert out["metric"] == "tpch_q1_sf0.01_rows_per_sec" and out["backend"] == "cpu"
    assert out["lineitem_rows"] == 60_000 and out["value"] > 0 and out["vs_baseline"] > 0
    d = out["details"]
    for k in ("q1_hand_ms", "q1_kernel_ms", "q6_hand_ms", "q1_sql_ms", "q6_sql_ms",
              "q3_sql_ms", "gen_lineitem_ms", "cpu_q1_rows_per_s"):
        assert d[k] > 0, k
    assert d["headline_path"] in ("q1_hand", "q1_kernel")


def test_direct_aggregate_equals_reference():
    """grouped_aggregate_direct over two keys (3 x 4 codes, one combination
    never occupied), a fused mask, a nullable bigint and a nullable
    decimal: count, count(*), sum and avg equal the reference's."""
    from presto_tpu import page as rpage
    from presto_tpu import types as RT
    from presto_tpu.expr import ir as rir
    from presto_tpu.ops import aggregate as ragg
    from presto_tpu_torch import types as T
    from presto_tpu_torch.expr import ir
    from presto_tpu_torch.ops import aggregate as agg
    from presto_tpu_torch.page import page_from_reference

    rng = np.random.default_rng(5)
    n = 3000
    k1 = rng.integers(0, 3, n).astype(np.int32)
    k2 = rng.integers(0, 4, n).astype(np.int32)
    k2[k1 == 2] = np.minimum(k2[k1 == 2], 2)  # (2, 3) never occurs
    x = rng.integers(-(1 << 40), 1 << 40, n)
    d = rng.integers(-10**11, 10**11, n)
    ref = rpage.Page.from_dict({
        "k1": (k1, RT.INTEGER), "k2": (k2, RT.INTEGER),
        "x": rpage.Block(jnp.asarray(x), RT.BIGINT, jnp.asarray(rng.random(n) < 0.8)),
        "d": rpage.Block(jnp.asarray(d), RT.DecimalType(12, 2),
                         jnp.asarray(rng.random(n) < 0.7)),
    }, pad_to=4096)
    page = page_from_reference(ref, device="cpu")

    def run(mod, types, ir_mod):
        bigint, dec = types.BIGINT, types.DecimalType(12, 2)

        def spec(func, name, c=None, typ=None):
            inp = None if c is None else ir_mod.col(c, typ)
            return mod.AggSpec(func, inp, name,
                               mod.AggSpec.infer_output_type(func, None if c is None else typ))

        aggs = [spec("count_star", "n"), spec("count", "cx", "x", bigint),
                spec("sum", "sx", "x", bigint), spec("avg", "ax", "x", bigint),
                spec("sum", "sd", "d", dec), spec("avg", "ad", "d", dec)]
        keys = [ir_mod.col("k1", types.INTEGER), ir_mod.col("k2", types.INTEGER)]
        mask = ir_mod.comparison("gt", ir_mod.col("x", bigint),
                                 ir_mod.Literal(-(1 << 39), bigint))
        p = page if mod is agg else ref
        return mod.grouped_aggregate_direct(p, keys, ["k1", "k2"], aggs, [3, 4],
                                            pre_mask=mask).to_pylist()

    got = run(agg, T, ir)
    want = run(ragg, RT, rir)
    assert sorted(got) == sorted(want) and len(got) == 11
