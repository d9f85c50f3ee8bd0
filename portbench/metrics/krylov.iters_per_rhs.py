"""Mean GMRES iterations a right-hand side over the window's requests, from
`KrylovResult.iterations`: a count."""
import numpy as np


def read(run):
    its = [np.asarray(r.iterations).ravel() for r in run.requests]
    return float(np.concatenate(its).mean()) if its else None
