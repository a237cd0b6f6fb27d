"""launches_per_round: the kernels that ran on the card in the traced
window, by the profiler's capture, over the window's rounds."""


def read(ctx):
    tr = ctx["trace"]
    if not tr or not tr["launches"] or not ctx["rounds"]:
        return None
    return tr["launches"] / ctx["rounds"]
