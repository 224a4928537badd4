"""Optimizers for the port, as the JAX package's ``optim``: ``adam`` (AdamW),
``schedule`` (learning-rate scales) and ``compression`` (int8 gradient
compression with error feedback)."""
