"""Per-operator execution statistics — the EXPLAIN ANALYZE substrate
(torch counterpart of presto_tpu/exec/stats.py).

Re-designed equivalent of the reference's operator stats tree
(presto-main/.../operator/OperatorStats.java, DriverStats, TaskStats rolled
into QueryStats) and ExplainAnalyzeContext
(presto-main/.../execution/ExplainAnalyzeContext.java). The unit of
accounting is one plan node's execution (a few eager tensor operations and
kernel launches), and the memory number is the device bytes of the node's
output page.

Row counts stay on the device: `record` parks each node's 0-d count
tensors, and `resolve()` reads them all in ONE host transfer at query end
(the JAX package's lazy mode; its per-node synchronous mode is not
ported). Per-node wall time is therefore host time: dispatch plus the
host reads the node itself makes (capacity shrinks, retry checks), not
device time.
`calls` separates repeated dispatches, and `retries` counts adaptive
capacity re-executions.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch


@dataclasses.dataclass
class NodeStats:
    calls: int = 0
    wall_s: float = 0.0
    rows_in: int = 0
    rows_out: int = 0
    retries: int = 0
    # device bytes of the node's output page. `out_bytes` is the LAST
    # call's page (the node's live footprint — the collector's
    # peak_bytes high-water sums these); multi-dispatch nodes report
    # through the cumulative total and per-dispatch peak.
    out_bytes: int = 0
    out_bytes_total: int = 0  # cumulative across all dispatches
    out_bytes_peak: int = 0  # largest single dispatch
    detail: str = ""  # strategy notes and dynamic-filter annotations

    def line(self) -> str:
        ms = self.wall_s * 1e3
        parts = [
            f"{ms:,.1f}ms",
            f"in {self.rows_in:,} rows",
            f"out {self.rows_out:,} rows",
            f"{_fmt_bytes(self.out_bytes)}",
        ]
        if self.calls != 1:
            parts.append(f"{self.calls} calls")
            if self.out_bytes_total != self.out_bytes:
                parts.append(
                    f"Σ{_fmt_bytes(self.out_bytes_total)}"
                    f" (peak {_fmt_bytes(self.out_bytes_peak)})"
                )
        if self.retries:
            parts.append(f"{self.retries} retries")
        if self.detail:
            parts.append(self.detail)
        return "[" + ", ".join(parts) + "]"


def _fmt_bytes(n: int) -> str:
    for unit in ("B", "kB", "MB", "GB"):
        if abs(n) < 1024 or unit == "GB":
            return f"{n:,.1f}{unit}" if unit != "B" else f"{n}B"
        n /= 1024
    return f"{n}B"


def _tensor_bytes(x) -> int:
    return 0 if x is None else x.numel() * x.element_size()


def block_device_bytes(b) -> int:
    """Device bytes of every tensor of a block: data and validity, and a
    collection block's lengths, element mask and map keys."""
    total = _tensor_bytes(b.data) + _tensor_bytes(b.valid)
    total += _tensor_bytes(b.lengths) + _tensor_bytes(b.elem_valid)
    if b.key_block is not None:
        total += block_device_bytes(b.key_block)
    return total


def page_device_bytes(page) -> int:
    """Device bytes of a Page's blocks (block_device_bytes of each)."""
    return sum(block_device_bytes(b) for b in page.blocks)


def read_counts(tensors) -> list:
    """Python ints of 0-d count tensors: ONE host transfer per device (a
    streaming run mixes card pages with host-tier pages)."""
    by_device: Dict = {}
    for i, x in enumerate(tensors):
        by_device.setdefault(x.device, []).append(i)
    out = [0] * len(tensors)
    for idx in by_device.values():
        values = torch.stack([tensors[i].reshape(()).to(torch.int64) for i in idx]).tolist()
        for i, v in zip(idx, values):
            out[i] = v
    return out


class StatsCollector:
    """Collects per-node stats keyed by plan-node identity (two structurally
    equal nodes at different tree positions stay distinct).

    Row counts are collected LAZILY: `record` accepts 0-d count tensors
    (or lists of them, or ints) for rows_in/rows_out and parks them unread
    — reading a device scalar is a blocking host sync, one per plan node.
    `resolve()` reads them in one batch at query end, when the EXPLAIN
    ANALYZE renderer needs integers."""

    def __init__(self):
        self.by_node: Dict[int, NodeStats] = {}
        self.peak_bytes: int = 0  # high-water of summed live output bytes
        self._pending: list = []  # (NodeStats, rows_in, rows_out)

    def stats_for(self, node) -> NodeStats:
        s = self.by_node.get(id(node))
        if s is None:
            s = NodeStats()
            self.by_node[id(node)] = s
        return s

    @staticmethod
    def _as_list(x) -> list:
        return list(x) if isinstance(x, (list, tuple)) else [x]

    def record(self, node, wall_s: float, rows_in, rows_out,
               out_bytes: int, retries: int = 0) -> None:
        s = self.stats_for(node)
        s.calls += 1
        s.wall_s += wall_s
        s.retries += retries
        s.out_bytes = out_bytes
        s.out_bytes_total += out_bytes
        s.out_bytes_peak = max(s.out_bytes_peak, out_bytes)
        self._pending.append((s, self._as_list(rows_in), self._as_list(rows_out)))
        live = sum(st.out_bytes for st in self.by_node.values())
        self.peak_bytes = max(self.peak_bytes, live)

    def resolve(self) -> None:
        """Fold every parked row count into the integer stats: one host
        read per device for all of them (read_counts)."""
        pending, self._pending = self._pending, []
        tensors = [x for _s, ins, outs in pending for x in ins + outs
                   if isinstance(x, torch.Tensor)]
        values = iter(read_counts(tensors))

        def total(xs):
            return sum(next(values) if isinstance(x, torch.Tensor) else int(x) for x in xs)

        for s, ins, outs in pending:
            s.rows_in += total(ins)
            s.rows_out += total(outs)
        from ..obs.export import export_node_stats

        export_node_stats(self.by_node)

    def lookup(self, node) -> Optional[NodeStats]:
        return self.by_node.get(id(node))

    def total_wall_s(self) -> float:
        return sum(s.wall_s for s in self.by_node.values())
