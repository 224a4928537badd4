"""Procedural scenes and camera trajectories."""
