from .sparse import BSR, COO, CSR, Stencil5, Stencil9

__all__ = ["BSR", "COO", "CSR", "Stencil5", "Stencil9"]
