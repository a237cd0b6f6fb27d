"""supersteps_per_round: the bounded solve's supersteps (each round's
`supersteps` stat, fetched after the window) over all of the window's
rounds."""


def read(ctx):
    steps = ctx["counts"]["supersteps"]
    return float(steps.mean()) if len(steps) else None
