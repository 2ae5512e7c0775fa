"""Multi-worker execution: the worker mesh, page exchange and distributed
operators (torch counterpart of presto_tpu/parallel/).

The JAX package runs each stage as one shard_map program over a mesh of
chips and exchanges with lax collectives. Here one process drives a mesh
of logical workers, each bound to a torch device (all on cuda:0 on one
card), runs the local operators on each worker's page in turn, and moves
rows between workers as device-to-device tensor copies, with no
torch.distributed and no NCCL. exec/dist.py executes fragmented plans
(plan/fragment.py) over it.
"""

from .distributed import dist_grouped_aggregate  # noqa: F401
from .exchange import (  # noqa: F401
    all_gather_page,
    all_to_all_page,
    exchange_by_hash,
    gather_page,
    shuffle_write,
    shuffle_write_parts,
)
from .mesh import Mesh, default_mesh, shard_rows  # noqa: F401
