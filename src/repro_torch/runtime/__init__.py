"""Host-side runtime services: ``straggler``, the per-host step-time
detector that the serving fleet's threaded driver feeds."""
from .straggler import HostStat, StragglerDetector

__all__ = ['HostStat', 'StragglerDetector']
