"""presto_tpu_torch — the PyTorch/CUDA port of presto_tpu.

A second package beside presto_tpu (the JAX reference, which stays as it
is): the same SQL surface, results and layer map, with columnar Pages as
torch tensors on an explicit device ("cuda" unless the caller passes
device="cpu") and every Pallas TPU kernel on the ported path replaced by a
kernel written by hand for Hopper (csrc/, built by cuda_build.py).

Layer map (as in presto_tpu):
  sql/        parser, analyzer, logical planner            (copied, repointed)
  plan/       plan nodes, rules, optimizer, stats          (copied, repointed)
  expr/       row expressions evaluated eagerly on tensors
  page.py     columnar Page/Block device representation
  ops/        relational operators; groupby_kernel.py and join_kernel.py
              wrap the CUDA kernels
  exec/       single-device executor, runtime dynamic filters
  connectors/ tpch and tpcds generators (bit-identical), memory tables
  csrc/       CUDA C++ kernels (sm_90a), plain C interface

This package imports torch and never jax or presto_tpu.
"""

from . import types  # noqa: F401
from .page import Block, Page  # noqa: F401

__version__ = "0.1.0"
