"""One flow graph and one churn script driven through both packages'
DeviceGraphState side by side, for the slot-plan and device-resident
tests (tests/test_torch_slot_plan.py, tests/test_torch_resident.py).

`build_graph` is tests/test_slot_plan.py's `_build_graph` written over
either package's FlowGraph (the same draws, so the same node ids and arc
order); `Pair` holds the JAX package's state, resident mirror and
JaxSolver beside this package's (on the CPU) and applies every mutation
to both; `churn_round` is tests/test_slot_plan.py's `_churn_round` on a
Pair (or on a `Solo`, the port's side alone). `Pair.solve_round` refreshes, solves and compares both sides.
"""

import numpy as np

import ksched_tpu_torch.graph.changes as tch
import ksched_tpu_torch.graph.flowgraph as tfg
from ksched_tpu_torch.graph.device_export import DeviceGraphState as TState
from ksched_tpu_torch.graph.device_export import DeviceResidentState as TRes
from ksched_tpu_torch.solver.csr_solver import CsrSolver

SCRIPT = ("cost", "rewire", "recycle", "rewire", "supply", "cost",
          "rewire", "recycle", "rewire")
PLAN_COUNTERS = ("enabled", "needs_rebuild", "layout_gen", "value_version",
                 "static_version", "layout_rebuilds", "region_overflows",
                 "region_relocations", "entry_cap")
RESIDENT_COUNTERS = ("last_upload_kind", "last_upload_bytes", "last_arc_records",
                     "last_node_records", "last_plan_kind", "last_plan_bytes",
                     "last_plan_records", "version")


def build_graph(fg, num_tasks, num_machines, machine_cap=(2, 6)):
    """tasks -> machines -> sink plus a cost-50 escape, in package
    module `fg` (either flowgraph module)."""
    g = fg.FlowGraph()
    sink = g.add_node()
    sink.type = fg.NodeType.SINK
    machines = [g.add_node() for _ in range(num_machines)]
    escape = g.add_node()
    tasks = [g.add_node() for _ in range(num_tasks)]
    rng = np.random.default_rng(num_tasks * 1000 + num_machines)
    for m in machines:
        a = g.add_arc(m, sink)
        g.change_arc(a, 0, int(rng.integers(*machine_cap)), int(rng.integers(0, 4)))
    a = g.add_arc(escape, sink)
    g.change_arc(a, 0, num_tasks, 50)
    for t in tasks:
        t.excess = 1
        for m in rng.choice(num_machines, size=min(3, num_machines), replace=False):
            a = g.add_arc(t, machines[int(m)])
            g.change_arc(a, 0, 1, int(rng.integers(0, 10)))
        a = g.add_arc(t, escape)
        g.change_arc(a, 0, 1, 40)
    sink.excess = -num_tasks
    return g, sink.id, [m.id for m in machines], [t.id for t in tasks]


def assert_plans_equal(jp, tp, where=""):
    """Host plan tensors (values and dtypes) and counters equal."""
    for name in PLAN_COUNTERS:
        assert getattr(tp, name) == getattr(jp, name), f"{where} {name}"
    if jp.needs_rebuild or not jp.enabled:
        return
    for i, (a, b) in enumerate(zip(jp.host_args(), tp.host_args())):
        assert b.dtype == a.dtype, f"{where} plan tensor {i} dtype"
        np.testing.assert_array_equal(b, a, err_msg=f"{where} plan tensor {i}")
    for name in ("region_start", "region_cap", "pos_fwd", "pos_bwd"):
        np.testing.assert_array_equal(getattr(tp, name), getattr(jp, name),
                                      err_msg=f"{where} {name}")
    np.testing.assert_array_equal(tp._tail_next, jp._tail_next, err_msg=where)
    assert tp.block_extent == jp.block_extent, where
    assert tp._dead_spans == [[(int(s), int(c)) for s, c in spans]
                              for spans in jp._dead_spans], where


def peek_plan_records(plan):
    """drain_records() without consuming the journal."""
    saved = [set(s) for s in (plan._dirty_pos, plan._dirty_inv,
                              plan._dirty_seg, plan._dirty_node)]
    recs = plan.drain_records()
    (plan._dirty_pos, plan._dirty_inv, plan._dirty_seg, plan._dirty_node) = saved
    return recs


class Pair:
    """Both packages' DeviceGraphState on one graph, optionally with
    their resident mirrors, each with its general-graph solver."""

    def __init__(self, num_tasks, num_machines, resident=True, machine_cap=(2, 6)):
        # the JAX package is imported here, not at module level, so that
        # `build_graph`, `Solo` and `churn_round` serve processes that
        # run the port alone (the ranks of tests/torch_parallel_cases.py)
        import ksched_tpu.graph.changes as jch
        import ksched_tpu.graph.flowgraph as jfg
        from ksched_tpu.graph.device_export import DeviceGraphState as JState
        from ksched_tpu.graph.device_export import DeviceResidentState as JRes
        from ksched_tpu.solver.jax_solver import JaxSolver

        self._jch = jch
        jg, _s, self.machines, self.tasks = build_graph(jfg, num_tasks, num_machines,
                                                        machine_cap)
        tg, _s, machines, tasks = build_graph(tfg, num_tasks, num_machines, machine_cap)
        assert (machines, tasks) == (self.machines, self.tasks)
        self.j, self.t = JState(), TState()
        self.j.full_build(jg)
        self.t.full_build(tg)
        self.jres = JRes(self.j) if resident else None
        self.tres = TRes(self.t, "cpu") if resident else None
        self.js = JaxSolver(telemetry=0)
        self.ts = CsrSolver(device="cpu")

    # -- mutations, applied to both states --------------------------------

    def arc(self, s, d, cap, cost):
        jch = self._jch
        self.j.apply_changes([jch.NewArcChange(s, d, 0, cap, cost, jch.ArcType.OTHER)])
        self.t.apply_changes([tch.NewArcChange(s, d, 0, cap, cost, tch.ArcType.OTHER)])

    def kill(self, s, d):
        jch = self._jch
        self.j.apply_changes([jch.ChangeArcChange(s, d, 0, 0, 0, jch.ArcType.OTHER, 0)])
        self.t.apply_changes([tch.ChangeArcChange(s, d, 0, 0, 0, tch.ArcType.OTHER, 0)])

    def set_excess(self, node, excess):
        self.j.set_excess(node, excess)
        self.t.set_excess(node, excess)

    def live(self):
        keys = sorted(self.j._arc_slot.keys())
        assert keys == sorted(self.t._arc_slot.keys())
        return keys

    # -- a round ------------------------------------------------------------

    def problems(self, check_records=True):
        """Both round problems (refreshing the mirrors); with
        check_records, the packed delta and plan records are compared
        before the refresh and the mirrors' counters after it."""
        if self.jres is None:
            return self.j.problem(), self.t.problem()
        if check_records:
            slots = np.sort(np.fromiter(self.j._dirty_slots, np.int32))
            nodes = np.sort(np.fromiter(self.j._dirty_nodes, np.int32))
            assert self.t._dirty_slots == self.j._dirty_slots
            assert self.t._dirty_nodes == self.j._dirty_nodes
            np.testing.assert_array_equal(self.tres._pack_arcs(slots),
                                          self.jres._pack_arcs(slots))
            np.testing.assert_array_equal(self.tres._pack_nodes(nodes),
                                          self.jres._pack_nodes(nodes))
            if self.j.plan.enabled and not self.j.plan.needs_rebuild:
                for a, b in zip(peek_plan_records(self.j.plan),
                                peek_plan_records(self.t.plan)):
                    np.testing.assert_array_equal(b, a)
        jp, tp = self.jres.refresh(), self.tres.refresh()
        for name in RESIDENT_COUNTERS:
            assert getattr(self.tres, name) == getattr(self.jres, name), name
        return jp, tp

    def solve_round(self, where="", check_records=True):
        """Refresh, solve in both packages and compare: flows,
        supersteps, objective, warm scope, plan tensors and counters; on
        the port, the mirror's parity checks and the plan's invariants."""
        jp, tp = self.problems(check_records)
        jr, tr = self.js.solve(jp), self.ts.solve(tp)
        np.testing.assert_array_equal(tr.flow, jr.flow, err_msg=where)
        assert (tr.objective, self.ts.last_supersteps) == (
            jr.objective, self.js.last_supersteps), where
        assert self.ts.last_warm_scope == self.js.last_warm_scope, where
        assert_plans_equal(self.j.plan, self.t.plan, where)
        if self.tres is not None:
            self.tres.parity_check()
            self.tres.plan_parity_check()
        if self.t.plan.enabled and not self.t.plan.needs_rebuild:
            self.t.plan.check_invariants()
        return tr


class Solo:
    """The port's side of a Pair alone (no JAX): one DeviceGraphState
    with the mutation methods `churn_round` drives, for processes that
    must not import the JAX package. `j` and `t` are the same state."""

    def __init__(self, num_tasks, num_machines, machine_cap=(2, 6)):
        tg, _s, self.machines, self.tasks = build_graph(tfg, num_tasks, num_machines,
                                                        machine_cap)
        self.t = TState()
        self.t.full_build(tg)
        self.j = self.t

    def arc(self, s, d, cap, cost):
        self.t.apply_changes([tch.NewArcChange(s, d, 0, cap, cost, tch.ArcType.OTHER)])

    def kill(self, s, d):
        self.t.apply_changes([tch.ChangeArcChange(s, d, 0, 0, 0, tch.ArcType.OTHER, 0)])

    def set_excess(self, node, excess):
        self.t.set_excess(node, excess)

    def live(self):
        return sorted(self.t._arc_slot.keys())


class JSolo:
    """The JAX package's side alone: `Solo` over its DeviceGraphState
    (the same graph, ids and mutations), for tests that hold a run of
    the port in other processes against it."""

    def __init__(self, num_tasks, num_machines, machine_cap=(2, 6)):
        import ksched_tpu.graph.changes as jch
        import ksched_tpu.graph.flowgraph as jfg
        from ksched_tpu.graph.device_export import DeviceGraphState as JState

        self._jch = jch
        jg, _s, self.machines, self.tasks = build_graph(jfg, num_tasks, num_machines,
                                                        machine_cap)
        self.j = JState()
        self.j.full_build(jg)
        self.t = self.j

    def arc(self, s, d, cap, cost):
        jch = self._jch
        self.j.apply_changes([jch.NewArcChange(s, d, 0, cap, cost, jch.ArcType.OTHER)])

    def kill(self, s, d):
        jch = self._jch
        self.j.apply_changes([jch.ChangeArcChange(s, d, 0, 0, 0, jch.ArcType.OTHER, 0)])

    def set_excess(self, node, excess):
        self.j.set_excess(node, excess)

    def live(self):
        return sorted(self.j._arc_slot.keys())


def churn_round(pair, kind, rng):
    """tests/test_slot_plan.py's `_churn_round` on both states of a Pair."""
    tasks, machines = pair.tasks, pair.machines
    if kind == "cost":
        for s, d in [pair.live()[i % len(pair.live())] for i in range(4)]:
            pair.arc(s, d, int(rng.integers(1, 4)), int(rng.integers(0, 10)))
    elif kind == "rewire":
        for t in rng.choice(tasks, size=3, replace=False):
            t = int(t)
            outs = [(s, d) for (s, d) in pair.live() if s == t and d in machines]
            if not outs:
                continue
            s, d = outs[int(rng.integers(len(outs)))]
            pair.kill(s, d)
            choices = [m for m in machines if (t, m) not in pair.j._arc_slot]
            if choices:
                pair.arc(t, choices[int(rng.integers(len(choices)))], 1,
                         int(rng.integers(0, 10)))
    elif kind == "recycle":
        for t in rng.choice(tasks, size=2, replace=False):
            t = int(t)
            outs = [(s, d) for (s, d) in pair.live() if s == t and d in machines]
            if len(outs) > 1:
                pair.kill(*outs[0])
    elif kind == "supply":
        a, b = (int(x) for x in rng.choice(tasks, size=2, replace=False))
        ea, eb = int(pair.j.excess[a]), int(pair.j.excess[b])
        if ea > 0:
            pair.set_excess(a, ea - 1)
            pair.set_excess(b, eb + 1)
    else:  # pragma: no cover - script typo guard
        raise AssertionError(kind)
