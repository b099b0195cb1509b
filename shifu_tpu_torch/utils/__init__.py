from . import xmlconfig

__all__ = ["xmlconfig"]
