"""Connector SPI — the contract between the engine and data sources
(torch package's copy of presto_tpu/connectors/spi.py).

Re-designed equivalent of the reference's connector SPI
(presto-spi/src/main/java/com/facebook/presto/spi/connector/ —
ConnectorMetadata, ConnectorSplitManager, ConnectorPageSource). TPU-first
reduction: a connector is ONE object serving both metadata and device
Pages; the "split" is a row range [start, stop) of a table (the morsel the
streaming driver schedules), and predicate/column pushdown arrives as
plain arguments instead of TupleDomain objects.

Metadata methods (planner-facing, reference ConnectorMetadata):
  table_names() -> [str]
  schema(table) -> {column: Type}
  row_count(table) -> int                  # statistics estimate
  unique_columns(table) -> [tuple]         # declared keys (n:1 joins)

Data methods (executor-facing, reference ConnectorPageSource):
  page(table) -> Page                      # whole table, device-resident
  exact_row_count(table) -> int            # TRUE row count (not the
      row_count estimate). Required for predicate pruning: the streaming
      driver otherwise detects end-of-table by a short batch, which a
      pruned batch would fake — without exact_row_count the engine drops
      the pruning hint entirely.
  page_columns(table, columns) -> Page     # optional: a page holding at
      least `columns`, decoding only those (file connectors). Callers go
      through read_columns(), which serves page() where a catalog has no
      page_columns; routing catalogs forward it to their members.
  scan(table, start, stop, pad_to=None, columns=None, predicate=None)
      -> Page                              # one batched split; MUST clamp
      stop to the true row count and may over-deliver rows that fail
      `predicate` (it is a pruning hint, not a filter — the engine always
      re-applies the real Filter)

`predicate` is a list of (column, op, value) conjuncts with op in
{'lt','le','gt','ge','eq','in'} and `value` a LOGICAL Python value
(datetime.date for DATE, float/Decimal for decimals, str for varchar,
int for integers — matching what file-format statistics expose, NOT the
engine's scaled storage units) — enough to prune row groups / partitions
by min-max statistics (reference TupleDomainOrcPredicate / Parquet
predicate pushdown). The 'in' op carries a tuple of logical values (from
IN-lists, OR-of-equals rewrites, and small-domain dynamic filters —
exec/dynfilter.py); a reader refutes it when NO value can fall inside the
unit's min/max range (and, where dictionary/value metadata is present,
when no value is actually in the unit).

The base class supplies scan() by slicing page() so minimal connectors
only implement metadata + page().
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from .. import types as T
from ..page import Block, Page, _pad_block, to_numpy
from ..sql.planner import Catalog

Predicate = List[Tuple[str, str, object]]


class Connector(Catalog):
    """Base connector: metadata protocol from planner.Catalog + default
    batched scan over the materialized page."""

    def page(self, table: str) -> Page:
        raise NotImplementedError

    def exact_row_count(self, table: str) -> int:
        return int(self.page(table).count)

    def table_version(self, table: str) -> Optional[int]:
        """Monotonic snapshot version for `table`, bumped by every
        INSERT/DELETE/DDL through this connector, or None when the
        connector cannot observe data changes. The plan/result caches
        (exec/qcache.py) treat None as UNCACHEABLE — a connector without
        versioning can never serve a stale result. Immutable connectors
        (tpch/tpcds generators) return a constant."""
        return None

    # -- statistics (reference ConnectorMetadata.getTableStatistics /
    # spi/statistics/TableStatistics) --

    STATS_SAMPLE_ROWS = 1 << 18

    def column_stats(self, table: str, column: str):
        """NDV / logical min / logical max / null fraction for one column,
        computed from a bounded sample of the table and cached. NDV scales
        up linearly when the sample looks key-like (>50% distinct), the
        standard low/high-cardinality split; file connectors override this
        with format metadata where available."""
        cache = getattr(self, "_column_stats_cache", None)
        if cache is None:
            cache = self._column_stats_cache = {}
        key = (table, column)
        if key not in cache:
            cache[key] = self._compute_column_stats(table, column)
        return cache[key]

    def forget_column_stats(self, table: str) -> None:
        """Drop `table`'s cached column stats (a write changed its rows)."""
        cache = getattr(self, "_column_stats_cache", None)
        if cache:
            for key in [k for k in cache if k[0] == table]:
                del cache[key]

    def _compute_column_stats(self, table: str, column: str):
        import numpy as np

        from ..plan.stats import ColumnStats, stats_from_column

        total = self.exact_row_count(table)
        n = min(total, self.STATS_SAMPLE_ROWS)
        if n == 0:
            return ColumnStats(ndv=0.0, null_fraction=0.0)
        # STRIDED ranges, not a prefix: tables are often stored sorted by
        # key/date, and a prefix sample would systematically miss the top
        # of the range (wrecking range-selectivity estimates)
        pieces, vpieces = [], []
        n_ranges = 8 if total > n else 1
        span = max(n // n_ranges, 1)
        any_valid = False
        for start in np.linspace(0, max(total - span, 0), n_ranges).astype(
            np.int64
        ):
            page = self.scan(table, int(start), int(start) + span,
                             columns=[column])
            b = page.block(column)
            m = int(page.count)
            pieces.append(to_numpy(b.data[:m]))
            if b.valid is not None:
                any_valid = True
                vpieces.append(to_numpy(b.valid[:m]))
            else:
                vpieces.append(np.ones((m,), np.bool_))
        data = np.concatenate(pieces)
        valid = np.concatenate(vpieces) if any_valid else None
        return stats_from_column(data, valid, b.type, b.dictionary, total)

    def scan(
        self,
        table: str,
        start: int,
        stop: int,
        pad_to: Optional[int] = None,
        columns: Optional[List[str]] = None,
        predicate: Optional[Predicate] = None,
    ) -> Page:
        src = self.page(table)
        n = int(src.count)
        stop = min(stop, n)
        count = max(stop - start, 0)
        names = list(src.names) if columns is None else list(columns)
        blocks = []
        for name in names:
            b = src.block(name)
            data = b.data[start:stop]
            valid = None if b.valid is None else b.valid[start:stop]
            blk = Block(data, b.type, valid, b.dict_id)
            if pad_to is not None and pad_to > count:
                blk = _pad_block(blk, pad_to)
            blocks.append(blk)
        return Page.from_blocks(blocks, names, count=count, device=src.device)


def read_columns(catalog, table: str, columns: List[str]) -> Page:
    """`table` with at least `columns`: the catalog's page_columns where it
    has one (the file connectors decode only those columns), else its
    whole page()."""
    fn = getattr(catalog, "page_columns", None)
    return catalog.page(table) if fn is None else fn(table, columns)


class WriteError(RuntimeError):
    pass


class DeltaUnavailable(RuntimeError):
    """A connector's scan_delta() cannot reconstruct the requested seq
    range exactly (e.g. compaction merged already-consumed rows with
    unconsumed ones into a single shard). Callers treat this as "delta
    maintenance not possible right now" and fall back to full
    recompute — it is never a data-loss signal."""


class WritableConnector(Connector):
    """Write protocol (reference ConnectorPageSink / ConnectorMetadata
    beginCreateTable/beginInsert, presto-spi/.../spi/ConnectorPageSink.java).
    The engine's DDL/DML tasks (session.py) call these; read-only
    connectors simply don't subclass this and get a clean error."""

    def create_table(self, table: str, schema: Dict[str, T.Type]) -> None:
        raise NotImplementedError

    def create_table_from_page(self, table: str, page: Page) -> None:
        raise NotImplementedError

    def drop_table(self, table: str) -> None:
        raise NotImplementedError

    def append(self, table: str, page: Page) -> None:
        raise NotImplementedError

    def replace(self, table: str, page: Page) -> None:
        raise NotImplementedError
