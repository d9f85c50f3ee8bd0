"""Visualization and reporting, ported from the JAX package's `viz.py`.

The reference's plotting conventions: solution heatmaps show Re(u), flipped
vertically, extent [0,1]^2; the runtime plot shows solve / init / total time
against N = n^2.  Headless (the Agg backend).  matplotlib is imported only
when a plot is made, so the package imports where matplotlib is absent.
"""
from __future__ import annotations

import numpy as np


def _plt():
    import matplotlib
    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt
    return plt


def plot_solution(report, path: str | None = None):
    """Heatmap of Re(u) in the reference's orientation."""
    plt = _plt()
    cfg = report.config
    u = np.flipud(np.real(report.u))
    fig = plt.figure()
    plt.imshow(u, extent=[0, 1, 0, 1])
    plt.xlabel("x")
    plt.ylabel("y")
    plt.title(f"N = {cfg['n']}$^2$\n$\\omega/(2\\pi)$ = {cfg['wave_num']}\n"
              f"const = {cfg['const']}\nReal(u)")
    plt.colorbar()
    plt.tight_layout()
    if path:
        fig.savefig(path, dpi=130)
        plt.close(fig)
        return path
    return fig


def plot_runtime(init_times, solve_times, ns, path: str | None = None,
                 title: str = "Runtime"):
    """Solve / init / total time against N = n^2."""
    plt = _plt()
    init_times = np.asarray(init_times)
    solve_times = np.asarray(solve_times)
    N = np.asarray(ns, dtype=float) ** 2
    fig = plt.figure()
    plt.plot(N, solve_times, "b-o", label="Solve Time")
    plt.plot(N, init_times, "g-o", label="Init Time")
    plt.plot(N, init_times + solve_times, "r-o", label="Total Time")
    plt.xlabel("N")
    plt.ylabel("Time (s)")
    plt.legend()
    plt.title(title)
    if path:
        fig.savefig(path, dpi=130)
        plt.close(fig)
        return path
    return fig


def plot_residual_history(report, path: str | None = None):
    """Per-iteration preconditioned residuals (the `gmres_counter`
    analog)."""
    plt = _plt()
    fig = plt.figure()
    h = np.asarray(report.history)
    plt.semilogy(np.arange(1, len(h) + 1), h, "b-o")
    plt.xlabel("iteration")
    plt.ylabel("preconditioned residual")
    plt.title("Residual history")
    plt.grid(True, which="both", alpha=0.3)
    if path:
        fig.savefig(path, dpi=130)
        plt.close(fig)
        return path
    return fig
