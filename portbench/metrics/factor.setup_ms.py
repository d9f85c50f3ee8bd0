"""Mean span of a request's `setup_preconditioner`, ms."""
import statistics


def read(run):
    xs = [s.ms for s in run.spans if s.name == "factor"]
    return statistics.fmean(xs) if xs else None
