from .sparse import Stencil5

__all__ = ["Stencil5"]
