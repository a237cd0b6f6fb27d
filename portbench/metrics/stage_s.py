"""stage_s: the seconds the program's trace stager took in set-up
(`drivers/trace_replay.py` DeviceTraceReplayDriver.stage: the trace's
windows to fixed-width arrays), by the harness's host-clock span around
it. None where the cell stages no trace."""


def read(ctx):
    return ctx["counts"].get("stage_s")
