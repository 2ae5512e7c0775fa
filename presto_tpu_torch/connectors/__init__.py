"""Connectors: the TPC-H and TPC-DS generators, in-memory tables, and the
storage connectors — Parquet, ORC and RCFile files, the Hive warehouse,
local CSV/TSV/JSONL/Avro/raw files, SQLite federation, the blackhole sink
and the shard store. pyarrow (Parquet, ORC, Hive, shard store) is
imported inside the functions that use it."""
