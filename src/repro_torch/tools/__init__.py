"""Measurement scripts that drive the port on the card (``python -m``)."""
