from .networks import define_D, define_G

__all__ = ["define_D", "define_G"]
