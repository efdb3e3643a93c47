"""Fault-tolerant checkpointing on the JAX package's on-disk layout."""
