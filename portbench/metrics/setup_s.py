"""Seconds from the start of the process to the window's first request:
import, the kernel library's load (and build, on a checkout's first run),
the inputs and one warm-up request at the cell's shapes.  The result line
gives the build's share apart, as `setup_build_s` (0 where the library was
only loaded)."""


def read(run):
    return run.setup_s
