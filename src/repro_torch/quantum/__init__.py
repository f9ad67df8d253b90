"""Tape-compiled QNN forward, heads and backends."""
