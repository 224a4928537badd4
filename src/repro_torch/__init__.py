"""PyTorch/CUDA port of the Lumina reproduction.

Laid out module for module like the JAX package ``repro``: ``core`` holds
the scene math, tiling, rasterizer, radiance cache and the single-viewer
frame pipeline; ``kernels`` holds the hand-written Hopper kernels (CUDA C++
under ``kernels/csrc``, built with ``nvcc`` at first use) beside their plain
PyTorch versions.  The package imports ``torch`` and never ``jax``.

Entry points (``LuminSys``, ``render_frame_baseline``, ``structured_scene``,
``orbit_trajectory``) run on the card by default (``device='cuda'``) and
raise when no GPU is present; pass ``device='cpu'`` to run the plain
versions on the host.
"""
