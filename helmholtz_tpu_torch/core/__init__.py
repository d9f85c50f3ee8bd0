from .sparse import Stencil5, Stencil9

__all__ = ["Stencil5", "Stencil9"]
