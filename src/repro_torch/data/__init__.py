"""Deterministic-by-step synthetic and memory-mapped token batches."""
