"""Device placement for the port's launchers: ``mesh.serve_devices``, one
device per serving-fleet worker."""
from .mesh import serve_devices

__all__ = ['serve_devices']
