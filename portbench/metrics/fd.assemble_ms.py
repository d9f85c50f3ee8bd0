"""Mean span of a request's assembly (medium, A, subgrids, forcings), ms."""
import statistics


def read(run):
    xs = [s.ms for s in run.spans if s.name == "assemble"]
    return statistics.fmean(xs) if xs else None
