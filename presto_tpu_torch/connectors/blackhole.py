"""Blackhole connector — the write-sink / benchmarking catalog (torch
counterpart of presto_tpu/connectors/blackhole.py).

Re-designed equivalent of presto-blackhole (BlackHoleMetadata +
BlackHolePageSinkProvider): INSERT/CTAS accept and DISCARD rows (the
standard sink for write-path benchmarking) and count them, reads return
empty pages, and tables are metadata only. A table can instead be set to
SYNTHESIZE rows on scan (the reference's split/page/row properties
collapsed to one `rows` knob), so read benchmarks need no storage either:
its columns are zeros and empty strings made on the catalog's device.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from .. import types as T
from ..page import Block, Page, intern_dictionary
from .spi import WritableConnector, WriteError


class BlackHoleCatalog(WritableConnector):
    name = "blackhole"

    def __init__(self, synthetic_rows: Optional[Dict[str, int]] = None, device="cuda"):
        self.device = torch.device(device)
        self._schemas: Dict[str, Dict[str, T.Type]] = {}
        self.rows_written: Dict[str, int] = {}
        # table -> row count to synthesize on scan (0 = plain sink)
        self.synthetic_rows = dict(synthetic_rows or {})

    # -- metadata --

    def table_names(self) -> List[str]:
        return sorted(self._schemas)

    def schema(self, table: str) -> Dict[str, T.Type]:
        try:
            return dict(self._schemas[table])
        except KeyError:
            raise KeyError(f"table {table!r} does not exist") from None

    def row_count(self, table: str) -> int:
        return self.synthetic_rows.get(table, 0)

    def exact_row_count(self, table: str) -> int:
        return self.row_count(table)

    def unique_columns(self, table: str):
        return []

    # -- reads: empty (or synthesized zeros) --

    def page(self, table: str) -> Page:
        schema = self.schema(table)
        n = self.synthetic_rows.get(table, 0)
        cap = max(n, 1)
        blocks = []
        for t in schema.values():
            lanes = getattr(t, "lanes", 1)
            shape = (cap,) if lanes == 1 else (cap, lanes)
            did = intern_dictionary(("",)) if isinstance(t, T.VarcharType) else None
            blocks.append(Block(torch.zeros(shape, dtype=t.storage_dtype, device=self.device),
                                t, None, did))
        return Page.from_blocks(blocks, list(schema), count=n, device=self.device)

    # -- writes: count, then discard --

    def create_table(self, table: str, schema: Dict[str, T.Type]) -> None:
        if table in self._schemas:
            raise WriteError(f"table {table!r} already exists")
        self._schemas[table] = dict(schema)
        self.rows_written[table] = 0

    def create_table_from_page(self, table: str, page: Page) -> None:
        self.create_table(table, {c: b.type for c, b in zip(page.names, page.blocks)})
        self.append(table, page)

    def append(self, table: str, page: Page) -> None:
        self.schema(table)
        self.rows_written[table] = self.rows_written.get(table, 0) + int(page.count)

    def replace(self, table: str, page: Page) -> None:
        self.schema(table)
        self.rows_written[table] = int(page.count)

    def drop_table(self, table: str) -> None:
        self._schemas.pop(table, None)
        self.rows_written.pop(table, None)
        self.synthetic_rows.pop(table, None)
