from . import render

__all__ = ["render"]
