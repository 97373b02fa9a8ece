from .networks import define_G

__all__ = ["define_G"]
