"""The port's DIMACS codec (graph/dimacs.py) against the JAX package's:
the goldens of tests/test_preemption_and_dimacs.py and every case of
tests/test_dimacs_malformed.py, with the port's text equal to the JAX
package's byte for byte and its errors word for word."""

import io

import numpy as np
import pytest

from ksched_tpu_torch.drivers import add_job, build_cluster
from ksched_tpu_torch.graph.changes import ChangeManager, ChangeType
from ksched_tpu_torch.graph.dimacs import (
    export,
    export_flow,
    export_incremental,
    flow_on_arcs,
    parse_flow,
    parse_graph,
)
from ksched_tpu_torch.graph.flowgraph import ArcType, FlowGraph, NodeType
from ksched_tpu_torch.solver.select import make_backend

jd = pytest.importorskip("ksched_tpu.graph.dimacs")

GOOD = """\
c a well-formed instance
p min 4 3
n 1 2
n 4 -2
a 1 2 0 2 5
a 2 4 0 2 0
a 1 4 0 1 9
c EOI
"""


def _tiny_graph(pkg):
    cm = pkg.ChangeManager()
    sink = cm.add_node(pkg.NodeType.SINK, 0, pkg.ChangeType.ADD_SINK_NODE, "SINK")
    task = cm.add_node(pkg.NodeType.UNSCHEDULED_TASK, 1, pkg.ChangeType.ADD_TASK_NODE, "t")
    sink.excess = -1
    pu = cm.add_node(pkg.NodeType.PU, 0, pkg.ChangeType.ADD_RESOURCE_NODE, "pu")
    cm.add_arc(task, pu, 0, 1, 42, pkg.ArcType.OTHER, pkg.ChangeType.ADD_ARC_TASK_TO_RES,
               "t->pu")
    cm.add_arc(pu, sink, 0, 1, 0, pkg.ArcType.OTHER, pkg.ChangeType.ADD_ARC_RES_TO_SINK,
               "pu->sink")
    return cm, sink, task, pu


def _pkgs():
    from types import SimpleNamespace

    from ksched_tpu.graph import changes as jc
    from ksched_tpu.graph import flowgraph as jf

    mine = SimpleNamespace(ChangeManager=ChangeManager, ChangeType=ChangeType,
                           NodeType=NodeType, ArcType=ArcType, dimacs=__import__(
                               "ksched_tpu_torch.graph.dimacs", fromlist=["x"]))
    ref = SimpleNamespace(ChangeManager=jc.ChangeManager, ChangeType=jc.ChangeType,
                          NodeType=jf.NodeType, ArcType=jf.ArcType, dimacs=jd)
    return mine, ref


def _error(fn, *a):
    try:
        fn(*a)
    except ValueError as e:
        return str(e)
    raise AssertionError("no ValueError")


@pytest.mark.parametrize("with_types", [True, False])
def test_dimacs_full_export_golden(with_types):
    texts = []
    for pkg in _pkgs():
        cm, sink, task, pu = _tiny_graph(pkg)
        buf = io.StringIO()
        pkg.dimacs.export(cm.graph, buf, with_node_types=with_types)
        texts.append(buf.getvalue())
    assert texts[0] == texts[1]
    lines = texts[0].strip().splitlines()
    assert lines[-1] == "c EOI"
    header, nodes, arcs = parse_graph(lines)
    assert header == (3, 2)
    if with_types:
        by_id = {n[0]: n for n in nodes}
        assert by_id[task.id][1:] == (1, 1)
        assert by_id[pu.id][1:] == (0, 2)
        assert by_id[sink.id][1:] == (-1, 3)
    assert (task.id, pu.id, 0, 1, 42) in arcs
    assert (pu.id, sink.id, 0, 1, 0) in arcs


def test_dimacs_incremental_export_golden():
    texts = []
    for pkg in _pkgs():
        cm, sink, task, pu = _tiny_graph(pkg)
        cm.reset_changes()
        arc = cm.graph.get_arc(task, pu)
        cm.change_arc_cost(arc, 7, pkg.ChangeType.CHG_ARC_TASK_TO_RES, "reprice")
        cm.delete_arc(cm.graph.get_arc(pu, sink), pkg.ChangeType.DEL_ARC_BETWEEN_RES, "drop")
        extra = cm.add_node(pkg.NodeType.MACHINE, 0, pkg.ChangeType.ADD_RESOURCE_NODE, "m")
        cm.add_arc(extra, sink, 0, 3, 2, pkg.ArcType.OTHER,
                   pkg.ChangeType.ADD_ARC_RES_TO_SINK, "m->sink")
        buf = io.StringIO()
        pkg.dimacs.export_incremental(cm.get_graph_changes(), buf)
        texts.append(buf.getvalue())
    assert texts[0] == texts[1]
    lines = texts[0].strip().splitlines()
    assert lines[-1] == "c EOI"
    body = [ln for ln in lines if not ln.startswith("c")]
    assert body[0].startswith(f"x {task.id} {pu.id} 0 1 7") and body[0].endswith("42")
    assert any(ln.startswith(f"x {pu.id} {sink.id} 0 0 0") for ln in body[1:])
    assert any(ln.startswith("n ") and ln.endswith(" 4") for ln in body)


def test_scheduled_cluster_exports_as_the_jax_package():
    """A scheduled cluster's full export and a flow response round trip
    through parse_flow/flow_on_arcs, equal text in both packages."""
    from ksched_tpu.drivers import add_job as jadd
    from ksched_tpu.drivers import build_cluster as jbuild
    from ksched_tpu.solver.decode import flow_to_mapping as jmapping
    from ksched_tpu.utils import seed_rng as jseed

    from ksched_tpu_torch.solver.decode import flow_to_mapping
    from ksched_tpu_torch.utils import seed_rng

    outs = []
    for seed, build, add, mapping, dimacs, kw in (
        (seed_rng, build_cluster, add_job, flow_to_mapping, __import__(
            "ksched_tpu_torch.graph.dimacs", fromlist=["x"]),
         dict(backend=make_backend("ref", device="cpu"))),
        (jseed, jbuild, jadd, jmapping, jd, {}),
    ):
        seed(3)
        sched, rmap, jmap, tmap, root = build(num_machines=2, pus_per_core=2, **kw)
        add(sched, jmap, tmap, num_tasks=3)
        n, _ = sched.schedule_all_jobs()
        assert n == 3
        full = io.StringIO()
        dimacs.export(sched.gm.cm.graph, full)
        problem = sched.solver.state.problem()
        tf = sched.solver.backend.solve(problem).total_flow(problem)
        resp = io.StringIO()
        dimacs.export_flow(problem.src, problem.dst, tf, resp)
        wire = "c ALGORITHM successive_shortest_path 12ms\n" + resp.getvalue() + "f 9 9 9\n"
        flows = dimacs.parse_flow(io.StringIO(wire))
        assert (9, 9) not in flows
        tf2 = dimacs.flow_on_arcs(flows, problem.src, problem.dst)
        assert tf2.dtype == np.int64 and (tf2 == tf).all()
        task_ids = [node.id for node in sched.gm.task_to_node.values()]
        leaf, sink = sched.gm.leaf_node_ids, sched.gm.sink_node.id
        assert mapping(problem, tf2, leaf, sink, task_ids) == mapping(
            problem, tf, leaf, sink, task_ids)
        outs.append((full.getvalue(), resp.getvalue()))
    assert outs[0] == outs[1]


def test_parse_flow_last_pair_wins_and_rejects_junk():
    assert parse_flow(io.StringIO("f 1 2 3\nf 1 2 5\nc EOI\n")) == {(1, 2): 5}
    for bad in ("q nonsense\n", "f 1 2 3\n"):
        assert _error(parse_flow, io.StringIO(bad)) == _error(jd.parse_flow, io.StringIO(bad))


def test_well_formed_parses():
    got = parse_graph(io.StringIO(GOOD))
    assert got == jd.parse_graph(io.StringIO(GOOD))
    header, nodes, arcs = got
    assert header == (4, 3) and len(nodes) == 2 and len(arcs) == 3
    assert arcs[0] == (1, 2, 0, 2, 5)


def test_roundtrip_with_real_graph():
    g = FlowGraph()
    a, b = g.add_node(), g.add_node()
    arc = g.add_arc(a, b)
    arc.cap_upper = 3
    arc.cost = 7
    a.excess, b.excess = 1, -1
    buf = io.StringIO()
    export(g, buf)
    header, nodes, arcs = parse_graph(io.StringIO(buf.getvalue()))
    assert header == (2, 1)
    assert (a.id, b.id, 0, 3, 7) in arcs


@pytest.mark.parametrize("bad_line,match", [
    ("a 1 2 0 2", "truncated arc line"),
    ("a 1 2", "truncated arc line"),
    ("a 1 2 0 -2 5", "negative capacity"),
    ("a 1 2 -1 2 5", "negative capacity"),
    ("a 1 2 3 2 5", "below lower bound"),
    ("a 1 9 0 2 5", "out of range"),
    ("a 9 2 0 2 5", "out of range"),
    ("a -3 2 0 2 5", "out of range"),
    ("a 1 2 0 x 5", "non-integer"),
    ("n 1", "truncated node line"),
    ("n 9 2", "out of range"),
    ("n -1 2", "out of range"),
    ("q 1 2", "unknown record type"),
])
def test_malformed_lines_raise(bad_line, match):
    text = GOOD.replace("a 1 4 0 1 9", bad_line)
    with pytest.raises(ValueError, match=match):
        parse_graph(io.StringIO(text))
    assert _error(parse_graph, io.StringIO(text)) == _error(jd.parse_graph, io.StringIO(text))


@pytest.mark.parametrize("text,match", [
    ("n 1 2\np min 4 3\n", "before `p min` header"),
    ("a 1 2 0 2 5\np min 4 3\n", "before `p min` header"),
    ("p max 4 3\n", "malformed header"),
    ("p min 4\n", "malformed header"),
    ("p min -4 3\n", "negative extent"),
    (GOOD.replace("c EOI\n", ""), "no 'c EOI' terminator"),
    (GOOD.replace("a 1 4 0 1 9\n", ""), "declares 3 arcs, got 2"),
    ("p min 4 3\nn 1 2\na 1 2 0 2\n", "line 3"),
])
def test_malformed_streams_raise(text, match):
    with pytest.raises(ValueError, match=match):
        parse_graph(io.StringIO(text))
    assert _error(parse_graph, io.StringIO(text)) == _error(jd.parse_graph, io.StringIO(text))


@pytest.mark.parametrize("text,match", [
    ("f 1 2\nc EOI\n", "truncated flow line"),
    ("f 1 2 x\nc EOI\n", "non-integer"),
    ("f 1 2 3 5\nc EOI\n", "trailing fields"),
    ("f 1 2 -1\nc EOI\n", "negative flow"),
    ("f 1 2 1\n", "truncated"),
])
def test_malformed_flow_responses_raise(text, match):
    with pytest.raises(ValueError, match=match):
        parse_flow(io.StringIO(text))
    assert _error(parse_flow, io.StringIO(text)) == _error(jd.parse_flow, io.StringIO(text))
