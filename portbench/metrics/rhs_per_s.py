"""Right-hand sides solved to the mix's rtol that pass the check, over the
window's wall time: all the work over all the time (host clock)."""


def read(run):
    return run.rhs_ok / run.window_s if run.window_s > 0 else None
