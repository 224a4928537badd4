"""Runtime services: ``straggler``, the per-host step-time detector that
the serving fleet's threaded driver feeds, and the device mesh:
``sharding`` (partition specs), ``spmd`` (the per-rank bodies'
collectives), ``pipeline`` (GPipe) and ``elastic`` (re-meshing)."""
from .straggler import HostStat, StragglerDetector

__all__ = ['HostStat', 'StragglerDetector']
