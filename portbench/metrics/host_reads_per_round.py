"""host_reads_per_round: the program's host reads in the window (a
solve's converged flag, `read_flag.count`, and a branch point's
predicates, `read_branch.count`, in solver/layered.py) over its
rounds."""


def read(ctx):
    return ctx["host_reads"] / ctx["rounds"] if ctx["rounds"] else None
