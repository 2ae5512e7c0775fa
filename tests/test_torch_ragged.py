"""The ragged paged partition layout of presto_tpu_torch (ops/ragged.py)
against the JAX package's (presto_tpu/ops/ragged.py): from the same
partitions (uniform, skewed, with empty partitions, a single row, none at
all) every field of RaggedPages, part_rows, occupancy, the padded-waste
ratio, lane(), occupancy_stats and wire_padding must be equal. Also the
layout the hybrid hash join builds over its deferred partitions
(exec/stream.py `_hybrid_setup`) at a budget that forces it. Left out:
nothing (the JAX package has no separate ragged test file; its skew tests
live in the server's hierarchical exchange, ROADMAP queue 1 item 9)."""

import numpy as np
import pytest
import torch

from presto_tpu.ops import ragged as rragged
from presto_tpu_torch.ops import ragged

torch.set_num_threads(1)

FIELDS = ("page_start", "page_ids", "part_of_page", "rows_in_page", "row_index")


def _cases():
    rng = np.random.default_rng(11)
    perm = rng.permutation(100_000).astype(np.int64)
    sizes_skewed = [70_000, 1, 0, 29_000, 0, 999]
    skewed, off = [], 0
    for n in sizes_skewed:
        skewed.append(perm[off:off + n])
        off += n
    uniform = np.array_split(perm[:40_960], 8)
    return {
        "skewed_with_empty": (skewed, None),
        "uniform": (uniform, None),
        "small_pages": (skewed, 64),
        "one_row": ([np.array([5], np.int64)], None),
        "all_empty": ([np.empty(0, np.int64)] * 4, None),
        "no_partitions": ([], 16),
    }


CASES = _cases()


@pytest.mark.parametrize("name", sorted(CASES))
def test_layout_equals_reference(name):
    parts, page_rows = CASES[name]
    got = ragged.from_partitions(parts, page_rows)
    want = rragged.from_partitions(parts, page_rows)
    assert got.page_rows == want.page_rows
    for f in FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert (got.num_parts, got.num_pages, got.total_rows) == (
        want.num_parts, want.num_pages, want.total_rows)
    for p in range(got.num_parts):
        assert np.array_equal(got.part_rows(p), want.part_rows(p))
        assert np.array_equal(got.part_rows(p), np.asarray(parts[p], np.int64))
        assert got.part_num_rows(p) == want.part_num_rows(p)
    assert got.occupancy() == want.occupancy()
    assert got.padded_waste_ratio() == want.padded_waste_ratio()
    assert ragged.occupancy_stats(got) == rragged.occupancy_stats(want)
    counts = [len(p) for p in parts]
    assert ragged.wire_padding(counts, page_rows) == rragged.wire_padding(counts, page_rows)
    if got.num_pages:
        column = np.arange(100_000, dtype=np.float64) * 0.5
        assert np.array_equal(got.lane(column, fill=-1.0), want.lane(column, fill=-1.0))


def test_skew_allocates_unequal_pages():
    parts, _ = CASES["skewed_with_empty"]
    rp = ragged.from_partitions(parts, 1024)
    pages = np.diff(rp.page_start)
    assert list(pages) == [-(-len(p) // 1024) for p in parts]
    assert rp.padded_waste_ratio() > 2.0  # pad-to-max would waste more than twice


def test_page_rows_from_environment(monkeypatch):
    monkeypatch.setenv("PRESTO_TPU_RAGGED_PAGE_ROWS", "128")
    assert ragged.page_rows_default() == rragged.page_rows_default() == 128
    monkeypatch.setenv("PRESTO_TPU_RAGGED_PAGE_ROWS", "bad")
    assert ragged.page_rows_default() == rragged.page_rows_default() == ragged.DEFAULT_PAGE_ROWS


def test_hybrid_join_reports_its_layout(monkeypatch):
    from presto_tpu_torch.connectors.memory import MemoryCatalog
    from presto_tpu_torch.page import Page
    from presto_tpu_torch.session import Session

    monkeypatch.setenv("PRESTO_TPU_HOST_SPILL_BYTES", "0")
    rng = np.random.default_rng(5)
    cat = MemoryCatalog({
        "b": Page.from_dict({"bk": np.arange(8_000, dtype=np.int64),
                             "bv": rng.integers(0, 9, 8_000)}, device="cpu"),
        "p": Page.from_dict({"pk": rng.integers(0, 8_000, 16_000),
                             "pv": rng.integers(0, 9, 16_000)}, device="cpu"),
    }, device="cpu")
    s = Session(cat, device="cpu", streaming=True, batch_rows=2048, memory_budget=32 << 10,
                result_cache=False)
    s.query("select count(*), sum(bv + pv) from p join b on pk = bk").rows()
    st = s.executor.spill_stats
    assert st["ragged_pages"] >= 1 and 0 < st["ragged_occupancy_pct"] <= 100
