"""Named multi-round scenarios over the synthetic cluster driver.

Scenario W ("whare-mixed"): a Whare-Map cluster of `num_machines`
machines (1 core x 4 PUs, 4 tasks per PU: 16 slots each) that receives
four waves of ten jobs — num_tasks/10, then three times num_tasks/40
tasks per job — with every new task given a task class drawn from
numpy's default_rng(wave). The mixed classes make the collapsed
transport problem neither single-class nor class-degenerate, so the
rounds past the first reach the iterative transport solve (the last
wave oversubscribes the cluster). W(1000, 10000) is the event path's
full-size run: 10k tasks on 1k machines, 16k slots.

Scenario P ("trivial-preempt"): the same cluster and waves under the
trivial cost model with preemption on and no task classes. A running
task keeps its arc to its PU, so from the second round on the graph
does not collapse to a dense transport and AutoSolver sends it to the
general-graph rungs (the mcmf kernel, else the CSR solve).
"""

from __future__ import annotations

import numpy as np

from ..costmodels import WhareMapCostModel
from ..data import TaskType
from ..utils import seed_rng
from .synthetic import add_job, build_cluster


def _waves(num_tasks: int):
    """Tasks per job of the four waves of ten jobs."""
    return (num_tasks // 10, num_tasks // 40, num_tasks // 40, num_tasks // 40)


def whare_mixed_rounds(num_machines: int, num_tasks: int, backend, seed: int = 7,
                       device_resident: bool = False):
    """Run Scenario W round by round: yields (round index, scheduler,
    placed count) after each of the four `schedule_all_jobs` rounds.
    Seeds the id RNG with `seed` first, so ids are reproducible.
    ``device_resident`` keeps the problem on the backend's device
    between rounds (PlacementSolver)."""
    seed_rng(seed)
    sched, _rmap, jmap, tmap, _root = build_cluster(
        num_machines=num_machines, num_cores=1, pus_per_core=4,
        max_tasks_per_pu=4, backend=backend,
        cost_model_factory=WhareMapCostModel, device_resident=device_resident,
    )
    seen = set()
    for r, per_job in enumerate(_waves(num_tasks)):
        for _ in range(10):
            add_job(sched, jmap, tmap, num_tasks=per_job)
        rng = np.random.default_rng(r)
        for uid, td in tmap.unsafe_get().items():
            if uid in seen:
                continue
            seen.add(uid)
            td.task_type = TaskType(int(rng.integers(0, 4)))
        placed, _ = sched.schedule_all_jobs()
        yield r, sched, placed


def trivial_preempt_rounds(num_machines: int, num_tasks: int, backend,
                           seed: int = 7):
    """Run Scenario P round by round, as whare_mixed_rounds runs W:
    yields (round index, scheduler, placed count) after each round."""
    seed_rng(seed)
    sched, _rmap, jmap, tmap, _root = build_cluster(
        num_machines=num_machines, num_cores=1, pus_per_core=4,
        max_tasks_per_pu=4, backend=backend, preemption=True,
    )
    for r, per_job in enumerate(_waves(num_tasks)):
        for _ in range(10):
            add_job(sched, jmap, tmap, num_tasks=per_job)
        placed, _ = sched.schedule_all_jobs()
        yield r, sched, placed
