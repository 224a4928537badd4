"""Scene math, tiling, rasterizer, radiance cache and the frame pipeline."""
