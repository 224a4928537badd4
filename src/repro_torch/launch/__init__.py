"""The port's launchers: ``serve`` (the LM token server), ``train`` (the LM
train driver) and ``mesh.serve_devices``, one device per serving-fleet
worker."""
from .mesh import serve_devices

__all__ = ['serve_devices']
