"""The chunked TPC-H catalog and the SF-N runner of presto_tpu_torch
(benchmark/scale.py) against the JAX package's, on the CPU at SF 0.01.
ChunkedTpchCatalog generates each batch on its device from benchgen's
splitmix64 streams; with CHUNK_ORDERS set small, so that scans cross
chunk boundaries, every table's columns over several [start, stop) ranges
(the whole table, inside one chunk, across chunks, past the end) must
equal the JAX package's numpy chunks bit for bit, dictionaries included.
`run_scale` must return the reference's rows (row counts, and the digest
of the first 100 rows). `run_sf100` is held in test_torch_scale_sf100.py.
Left out: tests/test_scale_sf10.py and tests/test_tpch_scale.py run SF 10
(marked slow in the JAX package); the card covers SF 10 (chip_smoke.py
`sf10`)."""

import numpy as np
import pytest
import torch

from presto_tpu.benchmark import scale as rscale
from presto_tpu_torch.benchmark import scale

torch.set_num_threads(1)

SF = 0.01
CHUNK_ORDERS = 1000  # 15 chunks at SF 0.01


@pytest.fixture(scope="module")
def catalogs():
    saved = (scale.ChunkedTpchCatalog.CHUNK_ORDERS, rscale.ChunkedTpchCatalog.CHUNK_ORDERS)
    scale.ChunkedTpchCatalog.CHUNK_ORDERS = rscale.ChunkedTpchCatalog.CHUNK_ORDERS = CHUNK_ORDERS
    try:
        yield scale.ChunkedTpchCatalog(SF, device="cpu"), rscale.ChunkedTpchCatalog(SF)
    finally:
        scale.ChunkedTpchCatalog.CHUNK_ORDERS, rscale.ChunkedTpchCatalog.CHUNK_ORDERS = saved


TABLES = ("lineitem", "orders", "customer", "part", "supplier", "nation", "region")


@pytest.mark.parametrize("table", TABLES)
def test_chunked_columns_equal_reference(catalogs, table):
    port, ref = catalogs
    n = ref.row_count(table)
    assert port.row_count(table) == n and port.exact_row_count(table) == n
    assert {k: repr(v) for k, v in port.schema(table).items()} == {
        k: repr(v) for k, v in ref.schema(table).items()}
    assert port.unique_columns(table) == ref.unique_columns(table)
    first_chunk = int(ref._offsets[1]) if table == "lineitem" else CHUNK_ORDERS
    ranges = [(0, n), (0, n // 3), (n // 3, n // 3 + 5000), (n - 7, n + 10),
              (first_chunk - 3, first_chunk + 3), (5, 9)]
    for start, stop in ranges:
        got = port.scan(table, start, stop, pad_to=8192)
        want = ref.scan(table, start, stop)
        m = int(want.count)
        assert int(got.count) == m and got.capacity == max(8192, m)
        assert got.names == want.names
        for name in want.names:
            g, w = got.block(name), want.block(name)
            a, b = g.data[:m].numpy(), np.asarray(w.data)[:m]
            assert a.dtype == b.dtype and np.array_equal(a, b), (table, name, start, stop)
            assert g.dictionary == w.dictionary, (table, name)
            assert repr(g.type) == repr(w.type)


def test_large_tables_refuse_to_materialize(monkeypatch):
    port = scale.ChunkedTpchCatalog(SF, device="cpu")
    monkeypatch.setattr(scale.ChunkedTpchCatalog, "row_count", lambda self, t: 5_000_000)
    with pytest.raises(MemoryError):
        port.page("lineitem")


def test_run_scale_equals_reference():
    got = scale.run_scale(SF, device="cpu")
    want = rscale.run_scale(SF)
    assert set(got["queries"]) == set(want["queries"])
    for q, w in want["queries"].items():
        g = got["queries"][q]
        assert (g["result_rows"], g["digest"]) == (w["result_rows"], w["digest"]), q
