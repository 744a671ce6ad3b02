"""Atomic, asynchronous, keep-k checkpoints of tensor trees."""
