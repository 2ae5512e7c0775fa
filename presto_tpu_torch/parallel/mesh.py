"""The worker mesh and row sharding (torch counterpart of
presto_tpu/parallel/mesh.py).

The reference's analog is node discovery + partitioning handles
(metadata/DiscoveryNodeManager.java, sql/planner/SystemPartitioningHandle
.java:57-65): FIXED_HASH_DISTRIBUTION over N workers. The JAX package maps
the workers onto a jax.sharding.Mesh axis of N chips and runs each stage as
one shard_map program. Here a mesh is a tuple of torch devices, one per
logical worker, driven by one Python process (the JAX package's own test
harness, "N workers in one process", carried onto the card): on one card
every worker is bound to cuda:0, on more cards they go round-robin. A
sharded page is a tuple of per-worker Pages, each on its worker's device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ..page import Block, Page, _pad_block


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One torch device per logical worker (several workers may share one
    device)."""

    devices: Tuple[torch.device, ...]

    @property
    def size(self) -> int:
        return len(self.devices)


def default_mesh(n_workers: Optional[int] = None, device="cuda") -> Mesh:
    """A mesh of `n_workers` workers (None: one per visible card). On
    "cuda" the workers go round-robin over the visible cards and raise
    without one; on "cpu" every worker is a CPU worker."""
    kind = torch.device(device).type
    if kind == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' for a CPU mesh"
            )
        cards = torch.cuda.device_count()
        n = cards if n_workers is None else int(n_workers)
        devices = tuple(torch.device("cuda", i % cards) for i in range(n))
    elif kind == "cpu":
        n = 1 if n_workers is None else int(n_workers)
        devices = tuple(torch.device("cpu") for _ in range(n))
    else:
        raise ValueError(f"unsupported mesh device {device!r}")
    if n < 1:
        raise ValueError("a mesh needs at least one worker")
    return Mesh(devices)


def shard_rows(page: Page, mesh: Mesh) -> Tuple[Page, ...]:
    """Split a page into contiguous row shards, one per worker, each on
    its worker's device: per = ceil(capacity / n) rows of the page's
    capacity (dead padding included), so worker i owns rows
    [i*per, (i+1)*per) and holds clip(count - i*per, 0, per) live rows,
    as the JAX package splits (the analog of leaf-split assignment,
    SourcePartitionedScheduler). Only the last shard is padded."""
    n = mesh.size
    cap = page.capacity
    per = max(-(-cap // n), 1)
    shards = []
    for i, dev in enumerate(mesh.devices):
        lo, hi = min(i * per, cap), min((i + 1) * per, cap)
        blocks = [b.take_rows(slice(lo, hi)) for b in page.blocks]
        if hi - lo < per:
            blocks = [_pad_block(b, per) for b in blocks] if hi > lo else [
                _empty_like(b, per) for b in page.blocks]
        count = torch.clamp(page.count - i * per, 0, per).to(torch.int32)
        shards.append(Page(tuple(b.to(dev) for b in blocks), page.names, count.to(dev)))
    return tuple(shards)


def _empty_like(b: Block, rows: int) -> Block:
    """`rows` dead rows shaped like `b` (a shard past the page's end)."""
    return _pad_block(b.take_rows(slice(0, 0)), rows)
