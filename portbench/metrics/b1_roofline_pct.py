"""b1_roofline_pct: kernel B1's share of its roofline over the traced
window: the least time the card could take for the work of every B1
launch (portbench/peaks.py, from each launch's shape, start eps and
supersteps) over the time B1's launches took on the card by the
profiler's capture. None where B1 did not run."""

from portbench.peaks import b1_bound_s


def read(ctx):
    tr, launches = ctx["trace"], ctx["b1"]
    if not tr or not launches or not tr["b1_s"]:
        return None
    bound = sum(b1_bound_s(C, Mp, steps, eps, alpha, warm)
                for C, Mp, eps, alpha, warm, steps in launches)
    return 100.0 * bound / tr["b1_s"]
