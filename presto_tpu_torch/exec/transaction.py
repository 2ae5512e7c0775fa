"""Multi-statement transactions: an overlay catalog buffering writes
(torch counterpart of presto_tpu/exec/transaction.py).

Re-designed equivalent of the reference's TransactionManager
(presto-main/.../transaction/TransactionManager.java: per-transaction
connector handles with commit/abort; most connectors commit buffered
state at transaction end — e.g. the memory/hive page sinks). Shape:
the transaction IS a catalog — an overlay over the session's writable
catalog where every DDL/DML lands in staged pages, kept on the base
catalog's device. Reads inside the transaction see the overlay first
(read-your-writes); COMMIT replays the staged state onto the base
catalog table-by-table (the reference's connector-commit granularity —
cross-table atomicity is per-connector best effort there too);
ROLLBACK simply drops the overlay.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from ..connectors.spi import WritableConnector, WriteError, read_columns
from ..page import Page


class TransactionCatalog(WritableConnector):
    """Overlay view of `base` plus staged writes."""

    def __init__(self, base):
        self.base = base
        self.name = getattr(base, "name", "txn")
        # staged pages live where the base catalog's tables do
        self.device = torch.device(getattr(base, "device", "cuda"))
        # staged state: table -> Page (full replacement) | None (dropped)
        self._staged: Dict[str, Optional[Page]] = {}
        self._created: List[str] = []
        # BASE tables dropped in this transaction (replayed as drops at
        # commit even when the name was re-created afterwards)
        self._dropped_base: set = set()

    # -- helpers --

    def _base_tables(self) -> List[str]:
        return list(self.base.table_names())

    def _staged_or_none(self, table: str) -> Optional[Page]:
        return self._staged.get(table)

    def _materialize(self, table: str) -> Page:
        """Current in-transaction content of a table (staged overlay or
        the base snapshot)."""
        if table in self._staged:
            pg = self._staged[table]
            if pg is None:
                raise WriteError(f"table {table!r} dropped in transaction")
            return pg
        return self.base.page(table)

    # -- metadata --

    def table_names(self) -> List[str]:
        names = [
            t for t in self._base_tables()
            if self._staged.get(t, "absent") is not None
        ]
        for t in self._staged:
            if self._staged[t] is not None and t not in names:
                names.append(t)
        return names

    def schema(self, table: str):
        if table in self._staged:
            pg = self._staged[table]
            if pg is None:
                raise KeyError(table)
            return {n: b.type for n, b in zip(pg.names, pg.blocks)}
        return self.base.schema(table)

    def row_count(self, table: str) -> int:
        if table in self._staged:
            return int(self._materialize(table).count)
        return self.base.row_count(table)

    def exact_row_count(self, table: str) -> int:
        if table in self._staged:
            return int(self._materialize(table).count)
        return self.base.exact_row_count(table)

    def column_stats(self, table: str, column: str):
        """A table the transaction has not written has the base's stats
        (and the base's cache); a staged one is sampled here."""
        if table in self._staged:
            return super().column_stats(table, column)
        return self.base.column_stats(table, column)

    def unique_columns(self, table: str):
        if table in self._staged:
            return []
        return self.base.unique_columns(table)

    # -- reads --

    def page(self, table: str) -> Page:
        return self._materialize(table)

    def page_columns(self, table: str, columns: List[str]) -> Page:
        if table in self._staged:
            return self._materialize(table)
        return read_columns(self.base, table, columns)

    def scan(self, table: str, start: int, stop: int, pad_to=None,
             columns=None, predicate=None):
        if table not in self._staged:
            return self.base.scan(
                table, start, stop, pad_to=pad_to, columns=columns,
                predicate=predicate,
            )
        from ..connectors.spi import Connector

        return Connector.scan(
            self, table, start, stop, pad_to=pad_to, columns=columns,
            predicate=predicate,
        )

    # -- writes (staged) --

    def create_table(self, table: str, schema) -> None:
        if table in self.table_names():
            raise WriteError(f"table {table} exists")
        from ..ops.union import empty_page

        self._staged[table] = empty_page(schema, self.device)
        self._created.append(table)
        self.forget_column_stats(table)


    def create_table_from_page(self, table: str, page: Page) -> None:
        if table in self.table_names():
            raise WriteError(f"table {table} exists")
        self._staged[table] = page.to(self.device)
        self._created.append(table)
        self.forget_column_stats(table)


    def append(self, table: str, page: Page) -> None:
        from ..ops.union import concat_pages

        cur = self._materialize(table)
        page = page.to(self.device)
        self._staged[table] = (
            page if int(cur.count) == 0 else concat_pages([cur, page])
        )
        self.forget_column_stats(table)


    def replace(self, table: str, page: Page) -> None:
        if table not in self.table_names():
            raise WriteError(f"unknown table {table}")
        self._staged[table] = page.to(self.device)
        self.forget_column_stats(table)

    def drop_table(self, table: str) -> None:
        if table not in self.table_names():
            raise WriteError(f"unknown table {table}")
        if table in self._created:
            self._created.remove(table)
            if table in self._dropped_base:
                # the name shadowed a dropped BASE table: keep the drop
                # visible in-transaction (base must not resurface)
                self._staged[table] = None
            else:
                self._staged.pop(table, None)
            return
        self._staged[table] = None
        self._dropped_base.add(table)

    # -- transaction end --

    def commit(self) -> None:
        """Replay staged state onto the base catalog: base-table drops
        first (a name may have been dropped then re-created in the same
        transaction), then creates, then replacements (table-granular,
        the reference's per-connector commit)."""
        for table in self._dropped_base:
            if table in self.base.table_names():
                self.base.drop_table(table)
        for table, pg in self._staged.items():
            if pg is None:
                continue  # drop already replayed
            if table in self._created:
                self.base.create_table_from_page(table, pg)
            else:
                self.base.replace(table, pg)
        self.rollback()  # clear staged state

    def rollback(self) -> None:
        self._staged.clear()
        self._created.clear()
        self._dropped_base.clear()
