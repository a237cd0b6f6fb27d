"""The traced window: a torch.profiler capture, reduced to numbers.

`Capture` wraps the measured window of a `--trace 1` run: the profiler
records the host's operations and the card's kernels and copies, and
the B1 entry of the program (`ksched_tpu_torch.ops.transport_solve`)
is wrapped so that each launch's shape, start eps and superstep count
are kept for its bound. `reduce` then reads, inside the window's own
range: the seconds in which a kernel or a copy ran on the card (the
union of their intervals), the kernel launches, the kernels' time by
name, B1's time, and the idle gaps, each named by the innermost host
operation under way as it opened.
"""

from __future__ import annotations

import bisect
from contextlib import contextmanager

WINDOW_RANGE = "portbench.window"
#: the host range around each B1 launch; a kernel the trace leaves
#: unnamed takes the name of the host range that launched it
B1_RANGE = "B1 transport_kernel"
#: device activities that occupy the card
BUSY = ("kernel", "gpu_memcpy", "gpu_memset")
#: how many of the longest idle gaps are named and summed by name
NAMED_GAPS = 5000


def _short(name: str) -> str:
    """A kernel's name without its return type, namespace and
    arguments, at most 64 characters."""
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    return name.split("(")[0][:64]


class Capture:
    def __init__(self, device):
        self.device = device
        self.b1 = []  # (C, Mp, eps, alpha, warm, steps), tensors read later
        self.prof = None

    @contextmanager
    def window(self):
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function

        import ksched_tpu_torch.ops as kops

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        orig = kops.transport_solve

        def recorded(wS, supply, col_cap, eps_init, pm0=None, *, alpha=8, **kw):
            with record_function(B1_RANGE):
                out = orig(wS, supply, col_cap, eps_init, pm0, alpha=alpha, **kw)
            C, Mp = wS.shape
            self.b1.append((C, Mp, eps_init, alpha, pm0 is not None, out[2]))
            return out

        kops.transport_solve = recorded
        try:
            with profile(activities=acts) as prof:
                with record_function(WINDOW_RANGE):
                    yield
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
        finally:
            kops.transport_solve = orig
        self.prof = prof

    def b1_launches(self):
        """[(C, Mp, eps, alpha, warm, steps)] with every value an int."""
        return [(C, Mp, int(eps), alpha, warm, int(steps))
                for C, Mp, eps, alpha, warm, steps in self.b1]

    def reduce(self) -> dict:
        """The window's device numbers (see the module's docstring);
        times in seconds."""
        cpu, dev, by_corr = [], [], {}
        w0 = w1 = None
        for e in self.prof.profiler.kineto_results.events():
            s, d, kind = e.start_ns(), e.duration_ns(), _kind(e)
            if kind in BUSY:
                link = getattr(e, "linked_correlation_id", None)
                dev.append((s, s + d, e.name(), kind, link() if link else None))
            elif kind == "host":
                if e.name() == WINDOW_RANGE:
                    w0, w1 = s, s + d
                cpu.append((s, s + d, e.name()))
                by_corr[e.correlation_id()] = (s, s + d, e.name())
        if w0 is None:
            raise RuntimeError("the traced window's range is not in the capture")
        b1_ranges = sorted((s, t) for s, t, n in cpu if n == B1_RANGE)
        named = []
        for s, t, n, kind, link in dev:
            if t <= w0 or s >= w1:
                continue
            if kind == "kernel":
                n = _kernel_name(n, by_corr.get(link), b1_ranges)
            named.append((max(s, w0), min(t, w1), _short(n), kind))
        named.sort()
        by_name = {}
        for s, t, n, _k in named:
            by_name[n] = by_name.get(n, 0.0) + (t - s) / 1e9
        busy, gaps, end = 0, [], w0
        for s, t, _n, _k in named:
            if s > end:
                gaps.append((s - end, end))
            if t > end:
                busy += t - max(s, end)
                end = t
        if w1 > end:
            gaps.append((w1 - end, end))
        kernels = [x for x in named if x[3] == "kernel"]
        return {
            "window_s": (w1 - w0) / 1e9,
            "busy_s": busy / 1e9,
            "launches": len(kernels),
            "b1_s": sum(t - s for s, t, n, _k in kernels if n == B1_RANGE) / 1e9,
            "device_ops": sorted(by_name.items(), key=lambda kv: -kv[1])[:10],
            "idle_gaps": _name_gaps(gaps, cpu),
        }


def _kind(e) -> str:
    """An event's activity: "host" for the host's, else the card's
    "kernel", "gpu_memcpy", "gpu_memset" or another (an annotation)."""
    if not str(e.device_type()).endswith("CUDA"):
        return "host"
    get = getattr(e, "activity_type", None)
    if get is not None:
        return get()
    name = e.name()
    if name.startswith("Memcpy"):
        return "gpu_memcpy"
    if name.startswith("Memset"):
        return "gpu_memset"
    if name in (WINDOW_RANGE, B1_RANGE):
        return "gpu_user_annotation"
    return "kernel"


def _kernel_name(name: str, launch, b1_ranges) -> str:
    """A kernel's name: B1_RANGE where the host call that launched it
    (`launch`, the host event linked to it) lies inside a B1 launch's
    range or its own name is B1's, else its name ("unnamed kernel"
    where the trace gives none)."""
    if _short(name).startswith("transport_kernel"):
        return B1_RANGE
    if launch is not None:
        i = bisect.bisect_right(b1_ranges, (launch[0], float("inf"))) - 1
        if i >= 0 and b1_ranges[i][0] <= launch[0] and launch[1] <= b1_ranges[i][1]:
            return B1_RANGE
    return name or "unnamed kernel"


def _name_gaps(gaps, cpu):
    """The longest gaps, each named by the innermost host operation open
    at its start, summed by name: the ten largest sums."""
    cpu.sort()
    starts = [s for s, _t, _n in cpu]
    sums = {}
    for dur, at in sorted(gaps, reverse=True)[:NAMED_GAPS]:
        i = bisect.bisect_right(starts, at) - 1
        name = "host, outside any operation"
        for j in range(i, max(i - 64, -1), -1):
            if cpu[j][1] >= at and cpu[j][2] not in (WINDOW_RANGE, B1_RANGE):
                name = cpu[j][2][:64]
                break
        sums[name] = sums.get(name, 0.0) + dur / 1e9
    return sorted(sums.items(), key=lambda kv: -kv[1])[:10]
