from .device import make_generator, resolve_device

__all__ = ["make_generator", "resolve_device"]
