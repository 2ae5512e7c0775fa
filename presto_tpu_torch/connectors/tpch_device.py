"""Device-resident TPC-H catalog: the tables are generated on the device
(torch counterpart of presto_tpu/connectors/tpch_device.py).

The host-fed `TpchCatalog` generates on the host and uploads. This catalog
follows the reference's worker-side generation instead
(presto-tpch/.../TpchRecordSet.java materializes rows inside the worker
from the split alone): `page` and `scan` generate their columns on the
catalog's device from the splitmix64 streams of benchmark/benchgen.py, so
no table data crosses the host link.

The numpy twin of the same generators (`table`) backs the host checks and
`column_stats`, so the optimizer sees statistics of exactly the data the
device generates. nation and region (25 and 5 rows) stay host-generated
and are uploaded.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..benchmark import benchgen
from ..page import Page
from . import tpch as tpch_host
from .tpch import Column, Table, TpchCatalog

TABLE_NAMES = sorted(list(benchgen.SCHEMAS) + ["nation", "region"])

_HOST_SMALL = {"nation": tpch_host.gen_nation, "region": tpch_host.gen_region}
_NUMPY_STORAGE = {torch.int32: np.int32, torch.int64: np.int64}
STATS_SAMPLE_ROWS = 2_000_000  # column_stats samples a prefix of larger tables


def table(name: str, sf: float = 1.0) -> Table:
    """Host-twin Table (numpy, bit-identical to the device data)."""
    if name in _HOST_SMALL:
        return _HOST_SMALL[name]()
    schema = benchgen.SCHEMAS[name]
    cols = benchgen.numpy_columns(name, sf, tuple(schema))
    out: Dict[str, Column] = {}
    for c, (typ, pool) in schema.items():
        data = cols[c].astype(_NUMPY_STORAGE[typ.storage_dtype])
        out[c] = Column(data, typ, None if pool is None else tuple(pool))
    return Table(name, out)


class DeviceTpchCatalog(TpchCatalog):
    """TpchCatalog whose pages and scans are generated on its device."""

    name = "tpch"

    def table_names(self):
        return list(TABLE_NAMES)

    def schema(self, tname: str):
        if tname in _HOST_SMALL:
            return {c: col.type for c, col in self.host_table(tname).columns.items()}
        return {c: t for c, (t, _pool) in benchgen.SCHEMAS[tname].items()}

    def row_count(self, tname: str) -> int:
        if tname in _HOST_SMALL:
            return self.host_table(tname).num_rows
        return benchgen._sizes(self.sf)[tname]

    def exact_row_count(self, tname: str) -> int:
        return self.row_count(tname)

    def host_table(self, tname: str) -> Table:
        tb = self._tables.get(tname)
        if tb is None:
            tb = table(tname, self.sf)
            self._tables[tname] = tb
        return tb

    def column_stats(self, tname: str, column: str):
        """Optimizer statistics from the numpy twin; tables above
        STATS_SAMPLE_ROWS are sampled by prefix (the generators are
        row-wise stationary, so a prefix is representative)."""
        from ..plan.stats import stats_from_column

        cache = getattr(self, "_stats_cache", None)
        if cache is None:
            cache = self._stats_cache = {}
        key = (tname, column)
        if key not in cache:
            n = self.row_count(tname)
            if tname in _HOST_SMALL or n <= STATS_SAMPLE_ROWS:
                col = self.host_table(tname).columns[column]
                data, dic, valid = col.data, col.dictionary, col.valid
            else:
                typ, dic = benchgen.SCHEMAS[tname][column]
                data = benchgen.numpy_columns_range(
                    tname, self.sf, (column,), 0, STATS_SAMPLE_ROWS
                )[column].astype(_NUMPY_STORAGE[typ.storage_dtype])
                valid = None
            cache[key] = stats_from_column(data, valid, self.schema(tname)[column], dic, n)
        return cache[key]

    def page(self, tname: str) -> Page:
        pg = self._pages.get(tname)
        if pg is None:
            if tname in _HOST_SMALL:
                pg = self.host_table(tname).to_page(device=self.device)
            else:
                pg = benchgen.device_page(
                    tname, self.sf, tuple(benchgen.SCHEMAS[tname]), device=self.device
                )
            self._pages[tname] = pg
        return pg

    def scan(self, tname: str, start: int, stop: int, pad_to=None,
             columns=None, predicate=None) -> Page:
        """Rows [start, stop) generated on the device; `stop` is clamped at
        the table's end."""
        if tname in _HOST_SMALL:
            return super().scan(tname, start, stop, pad_to=pad_to, columns=columns,
                                predicate=predicate)
        cols = tuple(columns) if columns is not None else tuple(benchgen.SCHEMAS[tname])
        stop = min(stop, self.row_count(tname))
        start = min(start, stop)
        arrays = benchgen.device_range(tname, self.sf, cols, start, stop - start, self.device)
        return benchgen.page_of(tname, cols, arrays, pad_to, self.device)
