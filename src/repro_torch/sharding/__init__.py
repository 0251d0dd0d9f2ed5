"""Logical-axis partitioning: rules, per-rank shards, cache axes, padding."""
