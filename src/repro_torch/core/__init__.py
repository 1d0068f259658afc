"""Sparse format, pruning, conversion and pooled sparse-KV primitives."""
