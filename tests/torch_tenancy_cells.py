"""Toy per-tenant flow problems for the port's tenancy tests, the cells
of tests/test_tenancy.py: tasks -> machines -> sink, feasible by
construction, churned a round at a time by cost (the journal leaves the
endpoints alone) or by re-wiring endpoints. `problem(FlowProblem)` takes
the package's FlowProblem class, so one cell feeds either package."""

import numpy as np

#: three pow2 shape buckets: (n_cap, m_cap, tasks, machines)
BUCKETS = [(32, 64, 6, 8), (64, 128, 14, 12), (128, 256, 30, 20)]


class ToyCell:
    def __init__(self, seed: int, n_cap: int, m_cap: int, tasks: int, machines: int):
        self.rng = np.random.default_rng(seed)
        self.n_cap, self.m_cap = n_cap, m_cap
        self.tasks, self.machines = tasks, machines
        assert 2 + tasks + machines <= n_cap
        self.excess = np.zeros(n_cap, np.int64)
        self.excess[1 : 1 + tasks] = 1
        self.sink = 1 + tasks + machines
        self.excess[self.sink] = -tasks
        src, dst, cap, cost = [], [], [], []
        self.m0 = 1 + tasks  # first machine node
        for t in range(1, 1 + tasks):
            for mm in self.rng.choice(machines, 3, replace=False):
                src.append(t)
                dst.append(self.m0 + int(mm))
                cap.append(1)
                cost.append(int(self.rng.integers(1, 50)))
        for mm in range(machines):
            src.append(self.m0 + mm)
            dst.append(self.sink)
            cap.append(tasks)
            cost.append(1)
        k = len(src)
        assert k <= m_cap
        self.src = np.zeros(m_cap, np.int32)
        self.dst = np.zeros(m_cap, np.int32)
        self.cap = np.zeros(m_cap, np.int32)
        self.cost = np.zeros(m_cap, np.int32)
        self.src[:k], self.dst[:k] = src, dst
        self.cap[:k], self.cost[:k] = cap, cost
        self.k = k
        self.task_arcs = tasks * 3  # arcs eligible for churn

    def churn(self, kind: str) -> None:
        idx = self.rng.choice(self.task_arcs, 2, replace=False)
        if kind == "cost":
            for i in idx:
                self.cost[i] = int(self.rng.integers(1, 50))
        elif kind == "endpoint":
            for i in idx:
                self.dst[i] = self.m0 + int(self.rng.integers(0, self.machines))
        else:  # pragma: no cover
            raise ValueError(kind)

    def problem(self, flow_problem):
        return flow_problem(
            num_nodes=self.n_cap,
            excess=self.excess.copy(),
            node_type=np.zeros(self.n_cap, np.int8),
            src=self.src.copy(),
            dst=self.dst.copy(),
            cap=self.cap.copy(),
            cost=self.cost.copy(),
            flow_offset=np.zeros(self.m_cap, np.int32),
            num_arcs=self.k,
        )


def lane_inputs(cell: ToyCell, build_csr_plan, rng=None):
    """One lane's numpy arguments for a stacked solve: (cap, scaled cost,
    supply, flow0, plan columns); with `rng`, flow0 is a random feasible
    start below the capacities instead of zero."""
    plan = build_csr_plan(cell.src, cell.dst, cell.n_cap)
    cost = cell.cost.astype(np.int32) * np.int32(cell.n_cap)
    flow0 = np.zeros(cell.m_cap, np.int32)
    if rng is not None:
        flow0 = (rng.integers(0, 2, cell.m_cap) * cell.cap).astype(np.int32)
    cols = tuple(getattr(plan, k) for k in (
        "s_arc", "s_sign", "s_src", "s_dst", "s_segstart", "s_isstart",
        "inv_order", "node_first", "node_last", "node_nonempty"))
    return cell.cap.copy(), cost, cell.excess.astype(np.int32), flow0, cols
