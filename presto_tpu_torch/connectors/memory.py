"""In-memory connector: query device Pages registered at runtime
(torch package's counterpart of presto_tpu/connectors/memory.py).

Re-designed equivalent of the reference's memory connector
(presto-memory/src/main/java/com/facebook/presto/plugin/memory/ —
MemoryPagesStore holding pages per table, MemoryMetadata). Here a table IS
a device-resident Page, so scans are free and tests/notebooks can query
arbitrary arrays with zero I/O.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch

from .. import types as T
from ..page import Page
from .spi import WritableConnector


class MemoryCatalog(WritableConnector):
    """tables: {name: Page}; unique: {table: [key column sets]} lets the
    planner use n:1 joins (the analog of declared primary keys). `device`
    is where CREATE TABLE builds its empty pages ("cuda" unless the caller
    passes "cpu"); registered and written pages stay where they are."""

    name = "memory"

    def __init__(
        self,
        tables: Dict[str, Page],
        unique: Optional[Dict[str, List[Tuple[str, ...]]]] = None,
        device="cuda",
    ):
        self.tables = dict(tables)
        self.unique = unique or {}
        self.device = torch.device(device)
        # per-table monotonic snapshot versions (plan/result cache
        # invalidation, exec/qcache.py): bumped BY NAME on every write so
        # a re-created table never resumes an old version sequence
        self._versions: Dict[str, int] = {}

    def _bump(self, table: str) -> None:
        self._versions[table] = self._versions.get(table, 0) + 1
        # a write changes the rows the cached stats were sampled from (the
        # JAX package keeps serving the old ones: ROADMAP queue 3)
        self.forget_column_stats(table)

    def table_version(self, table: str) -> int:
        if table not in self.tables:
            # unknown names must not look like a constant version 0 —
            # wrappers (SystemCatalog) probe through this
            raise KeyError(f"table {table!r} does not exist")
        return self._versions.get(table, 0)

    def add(self, name: str, page: Page) -> None:
        self.tables[name] = page
        self._bump(name)

    def table_names(self) -> List[str]:
        return list(self.tables)

    def schema(self, table: str) -> Dict[str, T.Type]:
        page = self.tables[table]
        return {n: b.type for n, b in zip(page.names, page.blocks)}

    def row_count(self, table: str) -> int:
        return int(self.tables[table].count)

    def unique_columns(self, table: str) -> List[Tuple[str, ...]]:
        return self.unique.get(table, [])

    def page(self, table: str) -> Page:
        # scan() and exact_row_count() come from the Connector base: the
        # default device-side slicing IS this connector's batched read path
        return self.tables[table]

    # -- writes (reference MemoryPagesStore.add / MemoryMetadata DDL) --

    def create_table(self, table: str, schema: Dict[str, T.Type]) -> None:
        from ..ops.union import empty_page

        self.tables[table] = empty_page(schema, self.device)
        self._bump(table)

    def create_table_from_page(self, table: str, page: Page) -> None:
        self.tables[table] = page
        self._bump(table)

    def drop_table(self, table: str) -> None:
        del self.tables[table]
        self.unique.pop(table, None)
        self._bump(table)

    def append(self, table: str, page: Page) -> None:
        """Rows appended after the table's live rows; varchar columns end
        on one merged dictionary (concat_pages)."""
        from ..ops.union import concat_pages

        base = self.tables[table]
        # one host read of both counts
        n_base, n_new = torch.stack([base.count, page.count.to(base.device)]).tolist()
        if n_base == 0:
            self.tables[table] = page.to(base.device)
        elif n_new > 0:
            self.tables[table] = concat_pages([base, page.to(base.device)])
        self._bump(table)

    def replace(self, table: str, page: Page) -> None:
        self.tables[table] = page
        self._bump(table)
