"""DIMACS text codec.

Reference: scheduling/flow/dimacs/{doc.go,export.go,add_node_change.go,
create_arc_change.go,update_arc_change.go,remove_node_change.go}. In the
reference this text stream over pipes IS the solver wire protocol; in the
TPU build the solver consumes flat arrays (graph/device_export.py), so
this codec exists for debugging, golden-file tests, and interop with
external DIMACS tooling.

Format (reference: dimacs/doc.go:3-22):
    c <comment>
    p min <num nodes> <num arcs>
    n <id> <excess> [<solver node type>]
    a <src> <dst> <cap lower> <cap upper> <cost> [<arc type>]
Incremental lines additionally use
    r <id>                                      (remove node)
    x <src> <dst> <low> <cap> <cost> <type> <old cost>   (update arc)
and each batch ends with "c EOI" (end of iteration).

The solver's RESPONSE direction (flow assignments back to the
scheduler) is
    f <src> <dst> <flow>
lines terminated by "c EOI" (reference: placement/solver.go:134-179
readFlowGraph). export_flow/parse_flow below close that loop so an
external DIMACS solver can serve as a parity oracle against the
in-process backends.
"""

from __future__ import annotations

from typing import IO, Dict, Iterable, List, Tuple

from .changes import AddNodeChange, Change, ChangeArcChange, NewArcChange, RemoveNodeChange
from .flowgraph import FlowGraph, NodeType

# Solver-side node taxonomy (reference: dimacs/export.go:53-70 and
# add_node_change.go:27-36; the ordering is ABI with the solver there).
SOLVER_NODE_OTHER = 0
SOLVER_NODE_TASK = 1
SOLVER_NODE_PU = 2
SOLVER_NODE_SINK = 3
SOLVER_NODE_MACHINE = 4
SOLVER_NODE_INTERMEDIATE_RES = 5

_SOLVER_TYPE = {
    NodeType.UNSCHEDULED_TASK: SOLVER_NODE_TASK,
    NodeType.SCHEDULED_TASK: SOLVER_NODE_TASK,
    NodeType.ROOT_TASK: SOLVER_NODE_TASK,
    NodeType.PU: SOLVER_NODE_PU,
    NodeType.SINK: SOLVER_NODE_SINK,
    NodeType.MACHINE: SOLVER_NODE_MACHINE,
    NodeType.NUMA: SOLVER_NODE_INTERMEDIATE_RES,
    NodeType.SOCKET: SOLVER_NODE_INTERMEDIATE_RES,
    NodeType.CACHE: SOLVER_NODE_INTERMEDIATE_RES,
    NodeType.CORE: SOLVER_NODE_INTERMEDIATE_RES,
}


def solver_node_type(node_type: NodeType) -> int:
    return _SOLVER_TYPE.get(node_type, SOLVER_NODE_OTHER)


def export(graph: FlowGraph, out: IO[str], with_node_types: bool = True) -> None:
    """Full-graph export (reference: dimacs/export.go:11-29)."""
    out.write(f"p min {graph.num_nodes} {graph.num_arcs}\n")
    for node in graph.nodes():
        if with_node_types:
            out.write(f"n {node.id} {node.excess} {solver_node_type(node.type)}\n")
        else:
            out.write(f"n {node.id} {node.excess}\n")
    for arc in graph.arcs():
        out.write(f"a {arc.src} {arc.dst} {arc.cap_lower} {arc.cap_upper} {arc.cost}\n")
    out.write("c EOI\n")
    out.flush()


def export_incremental(changes: Iterable[Change], out: IO[str]) -> None:
    """Incremental delta export (reference: dimacs/export.go:31-49)."""
    for ch in changes:
        if isinstance(ch, AddNodeChange):
            out.write(f"n {ch.node_id} {ch.excess} {solver_node_type(ch.node_type)}\n")
        elif isinstance(ch, RemoveNodeChange):
            out.write(f"r {ch.node_id}\n")
        elif isinstance(ch, NewArcChange):
            out.write(
                f"a {ch.src} {ch.dst} {ch.cap_lower} {ch.cap_upper} {ch.cost} {int(ch.arc_type)}\n"
            )
        elif isinstance(ch, ChangeArcChange):
            out.write(
                f"x {ch.src} {ch.dst} {ch.cap_lower} {ch.cap_upper} {ch.cost} "
                f"{int(ch.arc_type)} {ch.old_cost}\n"
            )
        else:  # pragma: no cover - exhaustive over Change union
            raise TypeError(f"unknown change record: {ch!r}")
    out.write("c EOI\n")
    out.flush()


def export_flow(src, dst, flow, out: IO[str]) -> None:
    """Write a solver flow response: one `f src dst flow` line per
    positive-flow arc, then the `c EOI` terminator — the stdout side of
    the reference solver protocol (placement/solver.go:134-179 parses
    exactly this). src/dst/flow are parallel arrays/sequences."""
    for s, d, f in zip(src, dst, flow):
        if f > 0:
            out.write(f"f {int(s)} {int(d)} {int(f)}\n")
    out.write("c EOI\n")
    out.flush()


def parse_flow(lines: Iterable[str]) -> Dict[Tuple[int, int], int]:
    """Parse `f src dst flow` response lines until `c EOI` into
    {(src, dst): flow} (reference: readFlowGraph's dstToSrcAndFlow,
    placement/solver.go:134-179 — keyed there as map[dst]map[src]; the
    flat pair key is equivalent since DIMACS cannot express parallel
    arcs). Comment lines other than the terminator are skipped, as the
    reference skips the solver's `c ALGORITHM TIME` chatter
    (solver.go:169-170). A repeated pair overwrites (last wins)."""
    flows: Dict[Tuple[int, int], int] = {}
    terminated = False
    for line in lines:
        line = line.strip()
        if not line:
            continue
        if line.startswith("c"):
            if line == "c EOI":
                terminated = True
                break
            continue  # solver timing/debug chatter
        parts = line.split()
        if parts[0] != "f":
            raise ValueError(f"unexpected line in flow response: {line!r}")
        if len(parts) < 4:
            raise ValueError(f"truncated flow line (want `f src dst flow`): {line!r}")
        if len(parts) > 4:
            # a flow value split by pipe corruption must not silently
            # decode as its first fragment
            raise ValueError(f"trailing fields on flow line: {line!r}")
        try:
            s, d, f = (int(x) for x in parts[1:4])
        except ValueError:
            raise ValueError(f"non-integer field in flow line: {line!r}") from None
        if f < 0:
            raise ValueError(f"negative flow in response line: {line!r}")
        flows[(s, d)] = f
    if not terminated:
        # A dead solver / cut pipe must fail loudly, not decode as a
        # partial assignment (the reference panics there, solver.go:178).
        raise ValueError("flow response truncated: no 'c EOI' terminator")
    return flows


def flow_on_arcs(flows: Dict[Tuple[int, int], int], src, dst):
    """Align a parsed {(src, dst): flow} response with a problem's arc
    order: returns int64[num_arcs] with each arc's flow (0 when the
    response omitted the arc). Feed the result to
    solver.decode.flow_to_mapping for the task→PU assignment — the same
    decode the in-process backends use, so an external solver's answer
    is directly comparable."""
    import numpy as np

    out = np.zeros(len(src), np.int64)
    for i, (s, d) in enumerate(zip(src, dst)):
        out[i] = flows.get((int(s), int(d)), 0)
    return out


def _ints(parts: List[str], line: str, lineno: int) -> Tuple[int, ...]:
    try:
        return tuple(int(x) for x in parts)
    except ValueError:
        raise ValueError(
            f"DIMACS line {lineno}: non-integer field in {line!r}"
        ) from None


def parse_graph(lines: Iterable[str]):
    """Parse a full-graph DIMACS export into (num_nodes, node_lines, arc_lines)
    tuples of ints, for golden-file tests and external-solver interop.

    Malformed input fails loudly with the offending line — a truncated
    arc line, a negative capacity, or a node id outside the header's
    range must never decode into a flow problem that silently
    mis-places flow (downstream indexes device arrays by these ids)."""
    nodes: List[tuple] = []
    arcs: List[tuple] = []
    header = None
    terminated = False
    for lineno, line in enumerate(lines, 1):
        line = line.strip()
        if not line or line.startswith("c"):
            if line == "c EOI":
                terminated = True
            continue
        parts = line.split()
        if parts[0] == "p":
            if len(parts) < 4 or parts[1] != "min":
                raise ValueError(
                    f"DIMACS line {lineno}: malformed header (want `p min N M`): {line!r}"
                )
            header = _ints(parts[2:4], line, lineno)
            if header[0] < 0 or header[1] < 0:
                raise ValueError(
                    f"DIMACS line {lineno}: negative extent in header: {line!r}"
                )
        elif parts[0] == "n":
            if header is None:
                raise ValueError(
                    f"DIMACS line {lineno}: node line before `p min` header"
                )
            if len(parts) < 3:
                raise ValueError(
                    f"DIMACS line {lineno}: truncated node line "
                    f"(want `n id excess [type]`): {line!r}"
                )
            fields = _ints(parts[1:], line, lineno)
            # ids are 1-based (graph/flowgraph.py IDGenerator(start=1));
            # 0 is tolerated as the device-array padding row
            if not 0 <= fields[0] <= header[0]:
                raise ValueError(
                    f"DIMACS line {lineno}: node id {fields[0]} out of range "
                    f"[0, {header[0]}]: {line!r}"
                )
            nodes.append(fields)
        elif parts[0] == "a":
            if header is None:
                raise ValueError(
                    f"DIMACS line {lineno}: arc line before `p min` header"
                )
            if len(parts) < 6:
                raise ValueError(
                    f"DIMACS line {lineno}: truncated arc line "
                    f"(want `a src dst low cap cost [type]`): {line!r}"
                )
            fields = _ints(parts[1:], line, lineno)
            src, dst, low, cap = fields[0], fields[1], fields[2], fields[3]
            for nid in (src, dst):
                if not 0 <= nid <= header[0]:
                    raise ValueError(
                        f"DIMACS line {lineno}: arc endpoint {nid} out of range "
                        f"[0, {header[0]}]: {line!r}"
                    )
            if low < 0 or cap < 0:
                raise ValueError(
                    f"DIMACS line {lineno}: negative capacity: {line!r}"
                )
            if cap < low:
                raise ValueError(
                    f"DIMACS line {lineno}: upper capacity {cap} below lower "
                    f"bound {low}: {line!r}"
                )
            arcs.append(fields)
        else:
            raise ValueError(
                f"DIMACS line {lineno}: unknown record type {parts[0]!r}: {line!r}"
            )
    if header is not None:
        # a dead writer / cut pipe must fail loudly, not decode as a
        # partial graph (mirrors parse_flow's terminator contract);
        # node lines are not counted — standard DIMACS lists only
        # nonzero-excess nodes
        if not terminated:
            raise ValueError("DIMACS stream truncated: no 'c EOI' terminator")
        if len(arcs) != header[1]:
            raise ValueError(
                f"DIMACS stream truncated: header declares {header[1]} arcs, "
                f"got {len(arcs)}"
            )
    return header, nodes, arcs
