"""Connectors: the TPC-H and TPC-DS generators and in-memory tables."""
