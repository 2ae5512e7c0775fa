"""The port's exchange and distributed aggregation (presto_tpu_torch/
parallel/) against the JAX package's, on the same numpy-seeded pages: the
cases of tests/test_parallel.py through both packages. The JAX side runs on
its 8-device virtual CPU mesh (tests/conftest.py), the port on
default_mesh(8, device="cpu"): eight logical workers in one process.

Held exactly: the row hash (bit for bit), the row shards, every worker's
received rows and their order after a hash exchange, the replicated page
of all_gather_page. dist_grouped_aggregate equals the single-node result:
integers and decimals exact, doubles within presto_tpu/testing/oracle.py's
relative tolerance (1e-9)."""

from decimal import Decimal

import numpy as np
import pytest
import torch

import presto_tpu.types as RT
from presto_tpu.expr.ir import col as rcol
from presto_tpu.ops.aggregate import AggSpec as RAggSpec
from presto_tpu.ops.hashing import hash_rows as ref_hash_rows
from presto_tpu.page import Page as RPage
from presto_tpu.parallel import all_gather_page as ref_all_gather_page
from presto_tpu.parallel import dist_grouped_aggregate as ref_dist_grouped_aggregate
from presto_tpu.parallel import default_mesh as ref_default_mesh
from presto_tpu.parallel.mesh import shard_rows as ref_shard_rows
from presto_tpu_torch import types as T
from presto_tpu_torch.expr.ir import col
from presto_tpu_torch.ops.aggregate import AggSpec
from presto_tpu_torch.ops.hashing import hash_rows
from presto_tpu_torch.page import Block, Page
from presto_tpu_torch.parallel import (all_gather_page, default_mesh, dist_grouped_aggregate,
                                       exchange_by_hash, shard_rows)
from test_parallel import _exchange_harness

torch.set_num_threads(1)

N_WORKERS = 8


@pytest.fixture(scope="module")
def mesh():
    return default_mesh(N_WORKERS, device="cpu")


def _columns(seed, n_rows):
    """{name: (values, valid or None, type name)} with NULLs and a
    varchar column over a small sorted dictionary."""
    rng = np.random.default_rng(seed)
    words = ["ant", "bee", "cat", "dog", "eel", "fox", "gnu"]
    return {
        "k": (rng.integers(-50, 100, n_rows), None, "bigint"),
        "i": (rng.integers(0, 1000, n_rows).astype(np.int32), rng.random(n_rows) > 0.1,
              "integer"),
        "d": ((rng.random(n_rows) - 0.5) * 1e3, rng.random(n_rows) > 0.2, "double"),
        "s": ([words[x] if x < len(words) else None for x in rng.integers(0, 8, n_rows)],
              None, "varchar"),
    }


def _pages(cols, pad_to=None):
    """The same columns as a JAX package page and a port page."""
    rblocks, pblocks = {}, {}
    for name, (vals, valid, typ) in cols.items():
        if typ == "varchar":
            rblocks[name] = vals
            pblocks[name] = vals
            continue
        rt, pt = RT.parse_type(typ), T.parse_type(typ)
        from presto_tpu.page import Block as RBlock

        rblocks[name] = RBlock.from_numpy(vals, rt, valid)
        pblocks[name] = Block.from_numpy(vals, pt, valid, device="cpu")
    return (RPage.from_dict(rblocks, pad_to=pad_to),
            Page.from_dict(pblocks, pad_to=pad_to, device="cpu"))


def test_hash_rows_bit_identical():
    cols = _columns(3, 777)
    ref, port = _pages(cols)
    for keys in (["k"], ["i"], ["d"], ["s"], ["k", "i", "d", "s"]):
        want = np.asarray(ref_hash_rows([ref.block(k) for k in keys])).view(np.int64)
        got = hash_rows([port.block(k) for k in keys]).numpy()
        assert np.array_equal(got, want), keys


@pytest.mark.parametrize("n_rows,pad_to", [(512, None), (1000, 1021), (5, None)])
def test_shard_rows_split_as_reference(mesh, n_rows, pad_to):
    ref, port = _pages(_columns(4, n_rows), pad_to)
    rpadded, rcounts = ref_shard_rows(ref, N_WORKERS)
    shards = shard_rows(port, mesh)
    per = rpadded.capacity // N_WORKERS
    assert [int(s.count) for s in shards] == np.asarray(rcounts).tolist()
    for i, s in enumerate(shards):
        assert s.capacity == per
        for b, rb in zip(s.blocks, rpadded.blocks):
            n = int(s.count)
            assert np.array_equal(b.data[:n].numpy(),
                                  np.asarray(rb.data[i * per:i * per + n]))


@pytest.mark.parametrize("keys", [("k",), ("s",), ("i", "d")])
def test_exchange_by_hash_rows_and_order_as_reference(mesh, keys):
    """Every worker receives the rows the JAX package's worker receives,
    in the same order: senders in worker order, each in its row order."""
    ref, port = _pages(_columns(7, 1000), pad_to=1024)
    types = {b_name: b.type for b_name, b in zip(ref.names, ref.blocks)}
    ref_shards = _exchange_harness(ref, [rcol(k, types[k]) for k in keys], part_capacity=128)
    ptypes = {n: b.type for n, b in zip(port.names, port.blocks)}
    got, counts = exchange_by_hash(shard_rows(port, mesh), [col(k, ptypes[k]) for k in keys],
                                   mesh)
    assert sum(map(sum, counts)) == 1000
    for j, (g, r) in enumerate(zip(got, ref_shards)):
        assert g.to_pylist() == r.to_pylist(), j
    # rows with equal keys sit on one worker
    seen = {}
    for j, g in enumerate(got):
        idx = [g.names.index(k) for k in keys]
        for row in g.to_pylist():
            assert seen.setdefault(tuple(repr(row[i]) for i in idx), j) == j


def test_all_gather_page_replicates(mesh):
    import jax

    rng = np.random.default_rng(8)
    vals = rng.integers(0, 50, 64)
    ref = RPage.from_dict({"v": (vals, RT.BIGINT)})
    port = Page.from_dict({"v": (vals, T.BIGINT)}, device="cpu")
    rpadded, rcounts = ref_shard_rows(ref, N_WORKERS)
    rmesh = ref_default_mesh()
    from presto_tpu.exec.dist import _shard_map
    from presto_tpu.parallel.mesh import page_from_arrays, page_schema, page_to_arrays
    from jax.sharding import PartitionSpec as P

    schema = page_schema(rpadded)
    leaves = page_to_arrays(rpadded)

    def step(shard_leaves, counts):
        g = ref_all_gather_page(page_from_arrays(shard_leaves, schema, counts[0]), "workers",
                                N_WORKERS)
        return page_to_arrays(g), g.count.reshape(1)

    fn = jax.jit(_shard_map(step, mesh=rmesh,
                            in_specs=(tuple(P("workers") for _ in leaves), P("workers")),
                            out_specs=(tuple(P("workers") for _ in leaves), P("workers"))))
    out_leaves, out_counts = fn(leaves, rcounts)
    cap = out_leaves[0].shape[0] // N_WORKERS
    want = page_from_arrays([lf[:cap] for lf in out_leaves], schema, out_counts[0]).to_pylist()
    got = all_gather_page(shard_rows(port, mesh), mesh)
    assert len(got) == N_WORKERS
    for g in got:
        assert g.to_pylist() == want
    assert sorted(r[0] for r in want) == sorted(vals.tolist())


def test_dist_grouped_aggregate_matches_single_node(mesh):
    rng = np.random.default_rng(9)
    n_rows = 1000
    g = rng.integers(0, 37, n_rows)
    x = rng.integers(-50, 50, n_rows)
    d = (rng.random(n_rows) * 100).astype(np.float64)
    m = rng.integers(0, 10 ** 6, n_rows)
    dec = T.DecimalType(12, 2)

    def aggs(S, col_, types):
        return (
            S("count_star", None, "cnt", types.BIGINT),
            S("sum", col_("x", types.BIGINT), "sx", types.BIGINT),
            S("min", col_("x", types.BIGINT), "mn", types.BIGINT),
            S("max", col_("x", types.BIGINT), "mx", types.BIGINT),
            S("avg", col_("d", types.DOUBLE), "ad", types.DOUBLE),
            S("sum", col_("m", types.DecimalType(12, 2)), "sm", types.DecimalType(38, 2)),
        )

    ref = RPage.from_dict({"g": (g, RT.BIGINT), "x": (x, RT.BIGINT), "d": (d, RT.DOUBLE),
                           "m": (m, RT.DecimalType(12, 2))}, pad_to=1024)
    port = Page.from_dict({"g": (g, T.BIGINT), "x": (x, T.BIGINT), "d": (d, T.DOUBLE),
                           "m": (m, dec)}, pad_to=1024, device="cpu")
    out = dist_grouped_aggregate(mesh, port, [col("g", T.BIGINT)], ["g"], aggs(AggSpec, col, T))
    assert out.device == torch.device("cpu")
    rows = {r[0]: r[1:] for r in out.to_pylist()}
    assert len(rows) == len(set(g.tolist()))
    for gv in set(g.tolist()):
        sel = g == gv
        cnt, sx, mn, mx, ad, sm = rows[gv]
        assert (cnt, sx, mn, mx) == (int(sel.sum()), int(x[sel].sum()), int(x[sel].min()),
                                    int(x[sel].max()))
        assert ad == pytest.approx(float(d[sel].mean()), rel=1e-9)
        assert sm == Decimal(int(m[sel].sum())).scaleb(-2)
    # the JAX package's distributed result, the same groups and values
    want = ref_dist_grouped_aggregate(
        ref_default_mesh(), "workers", ref, [rcol("g", RT.BIGINT)], ["g"],
        aggs(RAggSpec, rcol, RT), max_groups=64, part_capacity=64).to_pylist()
    got = sorted(out.to_pylist())
    want = sorted(want)
    # (g, cnt, sx, mn, mx, ad, sm): all but the double avg exact
    assert [r[:5] + r[6:] for r in got] == [r[:5] + r[6:] for r in want]
    for a, b in zip(got, want):
        assert a[5] == pytest.approx(b[5], rel=1e-9)
