"""Mean span of one preconditioner apply (the whole active batch), ms."""
import statistics


def read(run):
    xs = [s.ms for s in run.spans if s.name == "apply"]
    return statistics.fmean(xs) if xs else None
