"""Benchmark pipelines and data: TPC-H query texts (tpch_sql, scale), the
TPC-DS texts (tpcds_sql), on-device data generation (benchgen), the
hand-coded Q1/Q6 pipelines (handcoded), and the runners (bench, northstar). Reference:
presto-benchmark's BenchmarkSuite.java:32 (HandTpchQuery1/HandTpchQuery6)."""

from .handcoded import (  # noqa: F401
    lineitem_q1_page,
    lineitem_q6_page,
    q1_aggs,
    q1_local,
    q1_local_kernel,
    q6_local,
)
