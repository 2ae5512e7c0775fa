"""Parity: presto_tpu_torch's TPC-H generator yields presto_tpu's tables.

Both packages generate every table at SF 0.01 from the same seeds; every
column must be equal value for value, with the same type and dictionary
(lazy dictionaries compared entry by entry). The port's catalog page on
device="cpu" must carry exactly the host table.
"""

import numpy as np
import pytest
import torch

from presto_tpu.connectors import tpch as rtpch
from presto_tpu_torch.connectors import tpch

# one torch thread: the suite runs in parallel worker processes
# (pytest-xdist), and a thread per core in each oversubscribes the host
torch.set_num_threads(1)

SF = 0.01


@pytest.mark.parametrize("name", tpch.TABLE_NAMES)
def test_table_equals_reference(name):
    got = tpch.table(name, SF)
    want = rtpch.table(name, SF)
    assert list(got.columns) == list(want.columns)
    assert got.num_rows == want.num_rows
    for cname, col in got.columns.items():
        ref = want.columns[cname]
        assert col.type.display() == ref.type.display(), cname
        assert col.data.dtype == ref.data.dtype, cname
        np.testing.assert_array_equal(col.data, ref.data, err_msg=cname)
        assert (col.valid is None) == (ref.valid is None)
        if ref.dictionary is None:
            assert col.dictionary is None
            continue
        assert len(col.dictionary) == len(ref.dictionary), cname
        assert getattr(col.dictionary, "is_sorted", True) == getattr(
            ref.dictionary, "is_sorted", True
        )
        idx = np.unique(np.concatenate([col.data[:50], col.data[-50:], [0]]))
        assert [col.dictionary[int(i)] for i in idx] == [
            ref.dictionary[int(i)] for i in idx
        ], cname
        if isinstance(ref.dictionary, tuple):
            assert tuple(col.dictionary) == ref.dictionary


def test_catalog_page_carries_the_table():
    cat = tpch.TpchCatalog(SF, device="cpu")
    page = cat.page("orders")
    assert str(page.device) == "cpu"
    host = cat.host_table("orders")
    got = page.to_dict_of_numpy()
    for cname, col in host.columns.items():
        np.testing.assert_array_equal(got[cname], col.data)
    ref = rtpch.TpchCatalog(SF)
    for t in tpch.TABLE_NAMES:
        assert cat.row_count(t) == ref.row_count(t)
        assert cat.exact_row_count(t) == ref.exact_row_count(t)
