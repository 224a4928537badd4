"""lumina-3dgs — the paper's own workload.

Scene/render scale follows the paper's mobile setting (1M Gaussians,
1920x1080 target); reduced sizes are used for CPU tests.
"""
import dataclasses


@dataclasses.dataclass(frozen=True)
class LuminaArchConfig:
    name: str = 'lumina-3dgs'
    family: str = 'render'
    num_gaussians: int = 1_000_000
    width: int = 1920
    height: int = 1080
    capacity: int = 1024          # per-tile Gaussian budget
    window: int = 6               # S^2 sharing window
    margin: int = 4               # expanded-viewport margin (px)
    k_record: int = 5             # alpha-record length
    group_tiles: int = 4          # LuminCache shared across 4x4 tiles
    sort_method: str = 'sorted'   # scalable duplicate+global-sort path
    recipe: str = 'render'

    def reduced(self, **overrides):
        small = dict(num_gaussians=3000, width=128, height=128,
                     capacity=192, sort_method='dense')
        small.update(overrides)
        return dataclasses.replace(self, **small)


CONFIG = LuminaArchConfig()
