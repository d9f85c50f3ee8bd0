"""GMRES's own time a request: the solve span minus the apply and operator
product spans inside it (its Arnoldi products, its host reads of norms and
the least-squares work), ms, mean over the requests."""
import statistics


def read(run):
    per = {}
    for s in run.spans:
        if s.name == "solve":
            per.setdefault(s.request, 0.0)
            per[s.request] += s.ms
        elif s.name in ("apply", "matvec") and "/solve/" in s.path:
            per.setdefault(s.request, 0.0)
            per[s.request] -= s.ms
    return statistics.fmean(per.values()) if per else None
