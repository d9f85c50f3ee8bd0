from . import assembly, pml, problems, stencil

__all__ = ["assembly", "pml", "problems", "stencil"]
