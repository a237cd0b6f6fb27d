"""The soltel ring's cost on bench.py's churn round, on one CUDA card.

    python3 soltel_cost.py [rounds]

Builds two device-resident churn arms (drivers/churn.py, 10k tasks on
1k machines, 1% churn) whose CsrSolvers differ only in the ring: the
default capacity (on) and 0 (off). It drives them round-robin in turns
(on, off, off, on, ...) for `rounds` rounds (default 46, the first 6
warm-up), holds their placements equal every round, and prints per
arm the round wall's p25 / p50 / p75 (host clock around
schedule_all_jobs), RoundTiming.solve_s's p50, and the p50 of the host
time spent in the solver's own calls (solve_async, which runs the warm
attempt and writes its ring, and complete, which decodes it); then in
how many rounds the ring-on arm was the faster one, and the card's name
and power limit.
"""

from __future__ import annotations

import subprocess
import sys
import time

import numpy as np
import torch


def timed_solver(solver, spent):
    """Wrap the solver's solve_async and complete to append their host
    seconds, [solve_async, complete], to `spent` per solve."""
    solve_async, complete = solver.solve_async, solver.complete

    def timed_async(problem):
        t0 = time.perf_counter()
        out = solve_async(problem)
        spent.append([time.perf_counter() - t0, 0.0])
        return out

    def timed_complete(token):
        t0 = time.perf_counter()
        out = complete(token)
        spent[-1][1] = time.perf_counter() - t0
        return out

    solver.solve_async, solver.complete = timed_async, timed_complete


def main(rounds: int = 46, warmup: int = 6) -> int:
    if not torch.cuda.is_available():
        print("soltel_cost: no CUDA device", file=sys.stderr)
        return 1
    from ksched_tpu_torch.drivers.churn import CHURN, ChurnArm
    from ksched_tpu_torch.solver.csr_solver import CsrSolver

    dev = torch.device("cuda", 0)
    arms = [ChurnArm("device_resident", device=dev,
                     backend=CsrSolver(restart_budget=CHURN["restart_budget"],
                                       telemetry=cap, device=dev))
            for cap in (None, 0)]
    spent = ([], [])
    for arm, s in zip(arms, spent):
        timed_solver(arm.solver, s)
    walls, solve_ms = ([], []), ([], [])
    for r in range(rounds):
        recs = {i: arms[i].drive_round(r) for i in ((0, 1) if r % 2 == 0 else (1, 0))}
        if recs[0]["sha256"] != recs[1]["sha256"]:
            print(f"soltel_cost: round {r}: the arms' placements differ", file=sys.stderr)
            return 1
        if r >= warmup:
            for i in (0, 1):
                walls[i].append(recs[i]["wall_ms"])
                solve_ms[i].append(arms[i].sched.last_timing.solve_s * 1e3)
    for i, name in ((0, "ring on "), (1, "ring off")):
        sp = np.array(spent[i][-len(walls[i]):]) * 1e3
        q25, q50, q75 = np.percentile(walls[i], [25, 50, 75])
        print(f"{name}: wall p25 {q25:.3f} p50 {q50:.3f} p75 {q75:.3f} ms; solve_s p50 "
              f"{np.percentile(solve_ms[i], 50):.3f}; solve_async p50 "
              f"{np.percentile(sp[:, 0], 50):.3f} complete p50 {np.percentile(sp[:, 1], 50):.3f}")
    wins = sum(a < b for a, b in zip(*walls))
    print(f"rounds with the ring-on arm faster: {wins} of {len(walls[0])}")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main(*(int(a) for a in sys.argv[1:2])))
