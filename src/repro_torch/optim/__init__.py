"""Optimizers for the port (``adam``: AdamW as the JAX package defines it)."""
