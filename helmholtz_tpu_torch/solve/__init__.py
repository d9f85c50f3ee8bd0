from .gmres import KrylovResult, gmres

__all__ = ["KrylovResult", "gmres"]
