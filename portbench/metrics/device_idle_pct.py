"""device_idle_pct: the share of the traced window in which no kernel
and no copy ran on the card, from the profiler's capture."""


def read(ctx):
    tr = ctx["trace"]
    if not tr or not tr["busy_s"]:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
