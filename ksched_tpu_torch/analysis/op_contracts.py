"""Level-2 contracts: invariants checked on the RECORDED program.

The JAX package traces each registered program abstractly
(`jax.make_jaxpr` over shapes) and walks the jaxpr. A torch program has
data-dependent loops (a flag read a superstep), so fake or meta tensors
cannot run it. Each tracer here builds a small seeded problem with
numpy instead (the JAX tracers' generator graph, a feasible flow by
construction) and runs the program on real tensors, CPU tensors in
tier-1 and CUDA tensors in the card phase, under `Recorder`:

- a `TorchFunctionMode` records every torch call the port's own source
  makes (name, argument and result shapes and dtypes; Python numbers by
  type). It does not move with aten decompositions between torch
  versions, so the hash pins, the int64/float64 counts, the scatter,
  gather and host-read counts are read from it;
- a `TorchDispatchMode` records the aten ops underneath: no float64
  value anywhere, and one `aten._local_scalar_dense` for each scalar
  read the function level counted;
- `marks.loop_mark` cuts the record into segments: outside the loops,
  and one segment an iteration of a "superstep", "sweep" or "wave"
  loop; a ShardMesh collective is counted in the segment that issues
  it.

The folded trace, each loop's distinct iteration bodies once (sorted)
between the outside segments in order, is the torch counterpart of a
jaxpr, whose loop body appears once: its sha256 does not depend on how
many supersteps a problem takes. See analysis/__init__.py for the
catalog.
"""

from __future__ import annotations

import hashlib
import re
import types
from collections import Counter
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode

from . import marks

_I32 = torch.int32

#: calls that read a device value back to the host
SCALAR_READS = frozenset({"__bool__", "__int__", "__float__", "__index__", "item"})
HOST_READS = SCALAR_READS | {"cpu", "tolist"}
#: tensor-indexed reads
GATHER_FUNCS = frozenset({"gather", "index_select", "take", "take_along_dim"})
#: scatter-family calls, by kind (in-place and out-of-place spellings)
SCATTER_FUNCS = frozenset({
    "scatter", "scatter_", "scatter_add", "scatter_add_", "scatter_reduce",
    "scatter_reduce_", "index_put", "index_put_", "index_copy", "index_copy_",
    "index_add", "index_add_", "index_fill", "index_fill_", "masked_scatter",
    "masked_scatter_", "put", "put_",
})
#: the kinds that combine colliding writes (deterministic on CUDA for
#: integers; a float sum is not)
_ACCUMULATING = frozenset({"scatter_add", "scatter_add_", "index_add", "index_add_",
                           "scatter_reduce", "scatter_reduce_"})
_FLOAT_REDUCTIONS = ("sum", "prod", "mean")
_SCALAR_DENSE = torch.ops.aten._local_scalar_dense
#: the 64-bit dtypes a recording looks for
_WIDE = torch.int64  # kschedlint: disable=dtype64 -- the dtype the recorder counts
_DOUBLE = torch.float64  # kschedlint: disable=dtype64 -- the dtype the recorder forbids


# ---------------------------------------------------------------------------
# recording
# ---------------------------------------------------------------------------


def _fn_name(func) -> Optional[str]:
    """The recorded name of a torch call, None for a property read."""
    name = getattr(func, "__name__", None) or type(func).__name__
    if name == "__get__":
        return None
    return name


def _is_tensor(x) -> bool:
    return isinstance(x, torch.Tensor)


_DTYPES: Dict[torch.dtype, str] = {}


def _norm(x):
    """A device-free, value-free description of an argument or result:
    tensors by shape and dtype, Python numbers by type."""
    t = type(x)
    if t is torch.Tensor or isinstance(x, torch.Tensor):
        d = _DTYPES.get(x.dtype)
        if d is None:
            d = _DTYPES[x.dtype] = str(x.dtype).replace("torch.", "")
        return ("T", tuple(x.shape), d)
    if t is int or t is float or t is bool:
        return t.__name__
    if t is tuple or t is list:
        return tuple([_norm(v) for v in x])
    if x is None or t is str:
        return x
    if isinstance(x, (int, float, complex)):
        return type(x).__name__
    if isinstance(x, (list, tuple)):
        return tuple(_norm(v) for v in x)
    if isinstance(x, dict):
        return tuple(sorted((k, _norm(v)) for k, v in x.items()))
    if isinstance(x, slice):
        return ("slice", _norm(x.start), _norm(x.stop), _norm(x.step))
    if isinstance(x, torch.dtype):
        return str(x).replace("torch.", "")
    if isinstance(x, np.ndarray):
        return ("nd", x.shape, str(x.dtype))
    if isinstance(x, np.generic):
        return type(x).__name__
    if x is Ellipsis:
        return "..."
    return type(x).__name__  # devices, streams, generators


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)


@dataclass
class Segment:
    """The calls between two loop marks: one loop iteration of `kind`,
    or (kind None) a stretch outside the loops."""

    kind: Optional[str]
    calls: List[Tuple] = field(default_factory=list)
    reads: int = 0
    scalar_reads: int = 0
    aten_scalar_reads: int = 0
    gathers: int = 0
    scatters: Counter = field(default_factory=Counter)
    nonaccumulating: Counter = field(default_factory=Counter)
    float_accumulations: List[str] = field(default_factory=list)
    wide: Counter = field(default_factory=Counter)  # calls yielding int64, by name
    double_values: List[str] = field(default_factory=list)  # float64 results
    collectives: Counter = field(default_factory=Counter)

    def signature(self) -> str:
        return hashlib.sha256(repr(self.calls).encode()).hexdigest()


def _has_tensor_index(index) -> bool:
    if isinstance(index, torch.Tensor):
        return True
    if isinstance(index, (list, tuple)):
        return any(isinstance(i, torch.Tensor) for i in index)
    return False


class _FunctionLevel(TorchFunctionMode):
    def __init__(self, rec):
        super().__init__()
        self.rec = rec

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.rec.on_call(func, args, kwargs, out)
        return out


class _AtenLevel(TorchDispatchMode):
    def __init__(self, rec):
        super().__init__()
        self.rec = rec

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.rec.on_aten(func, out)
        return out


class Recorder:
    """Records what runs inside its `with` block (see the module
    docstring). `segments` holds the record; attached to `marks` so the
    loops' marks cut it."""

    def __init__(self):
        self.segments: List[Segment] = [Segment(None)]

    def mark(self, kind: Optional[str]) -> None:
        self.segments.append(Segment(kind))

    def on_call(self, func, args, kwargs, out) -> None:
        name = _fn_name(func)
        if name is None:
            return
        seg = self.segments[-1]
        if "device" in kwargs:  # a device named by a string is still a device
            kwargs = dict(kwargs, device="device")
        seg.calls.append((name, _norm(args), _norm(kwargs) if kwargs else None,
                          _norm(out)))
        if name in HOST_READS:
            seg.reads += 1
            seg.scalar_reads += name in SCALAR_READS
        if name in GATHER_FUNCS or (name == "__getitem__" and len(args) > 1
                                    and _has_tensor_index(args[1])):
            seg.gathers += 1
        self._scatter(seg, name, args, kwargs)
        for t in _tensors(out):
            if t.dtype == _WIDE:
                seg.wide[name] += 1
            elif t.dtype == _DOUBLE:
                seg.double_values.append(name)

    def _scatter(self, seg, name, args, kwargs) -> None:
        if name == "__setitem__":
            kind = "setitem[tensor]" if len(args) > 1 and _has_tensor_index(args[1]) \
                else "setitem"
            seg.scatters[kind] += 1
            if kind == "setitem[tensor]":
                seg.nonaccumulating[kind] += 1
            return
        if name not in SCATTER_FUNCS:
            return
        seg.scatters[name] += 1
        self_t = args[0] if args and _is_tensor(args[0]) else None
        floating = self_t is not None and self_t.dtype.is_floating_point
        reduce = kwargs.get("reduce")
        if name.startswith("scatter_reduce") and len(args) > 3:
            reduce = args[3]
        accumulate = (name in _ACCUMULATING or bool(kwargs.get("accumulate"))
                      or (name.startswith("index_put") and len(args) > 3 and bool(args[3]))
                      or (name.startswith("scatter") and reduce is not None))
        if accumulate:
            if floating and (name.startswith(("scatter_add", "index_add", "index_put"))
                             or reduce in _FLOAT_REDUCTIONS or reduce in ("add", "multiply")):
                seg.float_accumulations.append(name)
        else:
            seg.nonaccumulating[name] += 1

    def on_aten(self, func, out) -> None:
        seg = self.segments[-1]
        if getattr(func, "overloadpacket", None) is _SCALAR_DENSE:
            seg.aten_scalar_reads += 1
        for t in _tensors(out):
            if t.dtype == _DOUBLE:
                seg.double_values.append(str(func))

    def on_collective(self, kind: str) -> None:
        self.segments[-1].collectives[kind] += 1

    def __enter__(self):
        from ..parallel import mesh as mesh_mod

        marks.RECORDERS.append(self)
        orig = mesh_mod.ShardMesh._all_reduce
        rec = self

        def all_reduce(mesh_self, x, op, kind, site):
            rec.on_collective(kind)
            return orig(mesh_self, x, op, kind, site)

        self._restore = (mesh_mod.ShardMesh, orig)
        mesh_mod.ShardMesh._all_reduce = all_reduce
        self._modes = (_FunctionLevel(self), _AtenLevel(self))
        for m in self._modes:
            m.__enter__()
        return self

    def __exit__(self, *exc):
        for m in reversed(self._modes):
            m.__exit__(*exc)
        cls, orig = self._restore
        cls._all_reduce = orig
        marks.RECORDERS.remove(self)
        return False


@dataclass
class Recording:
    """A recorded run: its segments, the program's outputs and the
    kernel launches counted during it."""

    segments: List[Segment]
    outputs: object = None
    launches: Dict[str, int] = field(default_factory=dict)

    def folded(self):
        """(outside segments in order, {loop kind: {signature: first
        segment of that body}})."""
        outside = [s for s in self.segments if s.kind is None]
        loops: Dict[str, Dict[str, Segment]] = {}
        for s in self.segments:
            if s.kind is not None:
                loops.setdefault(s.kind, {}).setdefault(s.signature(), s)
        return outside, loops

    def folded_segments(self) -> List[Segment]:
        outside, loops = self.folded()
        return outside + [s for kind in sorted(loops) for _, s in sorted(loops[kind].items())]

    def trace_hash(self) -> str:
        outside, loops = self.folded()
        key = (tuple(tuple(s.calls) for s in outside),
               tuple((kind, tuple(sorted(loops[kind]))) for kind in sorted(loops)))
        return hashlib.sha256(repr(key).encode()).hexdigest()[:16]

    def report(self) -> "ContractReport":
        folded = self.folded_segments()
        loop_segs = [s for s in self.segments if s.kind is not None]
        rep = ContractReport(trace_hash=self.trace_hash())
        for s in folded:
            rep.wide.update(s.wide)
            rep.scatters.update(s.scatters)
            rep.nonaccumulating.update(s.nonaccumulating)
            rep.collectives_total.update(s.collectives)
        for s in self.segments:
            rep.double_values += s.double_values
            rep.float_accumulations += s.float_accumulations
            rep.scalar_reads += s.scalar_reads
            rep.aten_scalar_reads += s.aten_scalar_reads
            rep.ops += len(s.calls)
            if s.kind is None:
                rep.reads_once += s.reads
                rep.gathers_oneshot += s.gathers
        for s in loop_segs:
            rep.loop_iterations[s.kind] += 1
            rep.reads_by_kind.setdefault(s.kind, set()).add(s.reads)
            rep.gathers_loop = max(rep.gathers_loop, s.gathers)
            for kind, n in s.collectives.items():
                rep.collectives_loop[kind] = max(rep.collectives_loop[kind], n)
        return rep


@dataclass
class ContractReport:
    trace_hash: str
    wide: Counter = field(default_factory=Counter)  # int64 results, folded, by call
    double_values: List[str] = field(default_factory=list)  # float64 results
    scatters: Counter = field(default_factory=Counter)  # folded, by kind
    nonaccumulating: Counter = field(default_factory=Counter)
    float_accumulations: List[str] = field(default_factory=list)
    scalar_reads: int = 0  # function level, every iteration
    aten_scalar_reads: int = 0  # aten._local_scalar_dense, every iteration
    reads_once: int = 0  # outside the loops
    reads_by_kind: Dict[str, set] = field(default_factory=dict)
    gathers_loop: int = 0  # in the busiest loop iteration
    gathers_oneshot: int = 0
    collectives_loop: Counter = field(default_factory=Counter)  # max an iteration
    collectives_total: Counter = field(default_factory=Counter)  # folded
    loop_iterations: Counter = field(default_factory=Counter)
    ops: int = 0  # every recorded call, unfolded


#: the kernel wrappers whose launch counts a recording reads
def _launch_counters():
    from ..ops import mcmf, transport

    return {"mcmf": mcmf.mcmf_loop, "transport": transport.transport_loop,
            "transport_tiered": transport.transport_loop_tiered}


def record(fn) -> Recording:
    """Run `fn()` under a Recorder; the launches are the kernel wrappers'
    count deltas."""
    counters = _launch_counters()
    before = {k: c.launches for k, c in counters.items()}
    with Recorder() as rec:
        out = fn()
    launches = {k: c.launches - before[k] for k, c in counters.items()}
    return Recording(rec.segments, out, launches)


# ---------------------------------------------------------------------------
# seeded problems
# ---------------------------------------------------------------------------


def bucketed_sizes(n_raw: int, m_raw: int) -> Tuple[int, int]:
    """(Np, Mp): the padded extents the solvers see, the pow2 bucket."""
    from ..utils import next_pow2

    return max(next_pow2(n_raw), 16), max(next_pow2(m_raw), 16)


def generator_graph(n: int, m: int, seed: int = 0):
    """The JAX tracers' deterministic multigraph with skewed degrees."""
    rng = np.random.default_rng(seed)
    src = np.where(np.arange(m) % 3 == 0, 0, rng.integers(0, n, m)).astype(np.int32)
    dst = ((src + 1 + rng.integers(0, n - 1, m)) % n).astype(np.int32)
    return src, dst


def flow_problem(n: int, m: int, seed: int = 0):
    """(src, dst, cap, cost, supply) int32 on the generator graph: a
    feasible problem by construction (supply is the net outflow of a
    random flow within the capacities), unscaled costs in [0, 6)."""
    src, dst = generator_graph(n, m, seed)
    rng = np.random.default_rng(seed + 1)
    cap = rng.integers(1, 3, m).astype(np.int32)
    cost = rng.integers(0, 6, m).astype(np.int32)
    f = rng.integers(0, cap + 1).astype(np.int32)
    supply = (np.bincount(src, weights=f, minlength=n)
              - np.bincount(dst, weights=f, minlength=n)).astype(np.int32)
    return src, dst, cap, cost, supply


def _t(x, device, dtype=None):
    return torch.tensor(np.ascontiguousarray(x), dtype=dtype, device=device)


def _csr_args(n, m, seed, device):
    """(cap, scaled cost, supply, flow0, cold eps, plan tensors)."""
    from ..solver.csr_solver import build_csr_plan

    src, dst, cap, cost, supply = flow_problem(n, m, seed)
    plan = build_csr_plan(src, dst, n).tensors(device)
    eps = max(1, int(cost.max()) * n)
    return (_t(cap, device), _t(cost * np.int32(n), device), _t(supply, device),
            torch.zeros(m, dtype=_I32, device=device), eps, plan)


# ---------------------------------------------------------------------------
# tracers (one per registered program; `device` added by the engine)
# ---------------------------------------------------------------------------


def trace_csr(n_raw: int, m_raw: int, seed: int = 0, telemetry_cap: int = 0,
              device="cpu", slot_stable: bool = False):
    """The scan-CSR solve (solver/csr_solver.py `_solve_mcmf`), cold."""
    from ..solver import csr_solver

    n, m = bucketed_sizes(n_raw, m_raw)
    cap, cost, supply, flow0, eps, plan = _csr_args(n, m, seed, device)
    return record(lambda: csr_solver._solve_mcmf(
        cap, cost, supply, flow0, eps, *plan, alpha=8, max_supersteps=4096,
        tighten_sweeps=32, telemetry_cap=telemetry_cap, slot_stable=slot_stable))


def trace_csr_slot(n_raw: int, m_raw: int, seed: int = 0, telemetry_cap: int = 0,
                   device="cpu"):
    """The slot-stable variant: liveness rides the sign column."""
    return trace_csr(n_raw, m_raw, seed, telemetry_cap, device, slot_stable=True)


def trace_csr_warmp(n_raw: int, m_raw: int, seed: int = 0, telemetry_cap: int = 0,
                    slot_stable: bool = False, device="cpu"):
    """The dirty-frontier warm-price refit: the sweeps seeded from
    carried potentials (zero here), from the cold eps."""
    from ..solver import csr_solver

    n, m = bucketed_sizes(n_raw, m_raw)
    cap, cost, supply, flow0, eps, plan = _csr_args(n, m, seed, device)
    warm_p = torch.zeros(n, dtype=_I32, device=device)
    return record(lambda: csr_solver._solve_mcmf(
        cap, cost, supply, flow0, eps, *plan, warm_p=warm_p, use_warm_p=True,
        alpha=8, max_supersteps=4096, tighten_sweeps=32,
        telemetry_cap=telemetry_cap, slot_stable=slot_stable))


def trace_stacked(lanes_raw: int, n_raw: int, m_raw: int, telemetry_cap: int = 0,
                  use_warm_p: bool = False, device="cpu"):
    """The multi-tenant stacked lane solve (`stacked_solve_fn`): the
    seeded problem in every lane, the lane count padded as tenancy pads
    it."""
    from ..solver import csr_solver

    n, m = bucketed_sizes(n_raw, m_raw)
    L = csr_solver.pad_lane_count(lanes_raw)
    lanes = [_csr_args(n, m, 0, "cpu") for _ in range(L)]

    def stack(i):
        return torch.stack([lane[i] for lane in lanes]).to(device)

    cap, cost, supply, flow0 = (stack(i) for i in range(4))
    eps = torch.tensor([lane[4] for lane in lanes], dtype=_I32, device=device)
    plan = [torch.stack([lane[5][k] for lane in lanes]).to(device) for k in range(10)]
    fn = csr_solver.stacked_solve_fn(alpha=8, max_supersteps=4096, tighten_sweeps=32,
                                     telemetry_cap=telemetry_cap, use_warm_p=use_warm_p)
    warm = (torch.zeros((L, n), dtype=_I32, device=device),) if use_warm_p else ()
    return record(lambda: fn(cap, cost, supply, flow0, eps, *warm, *plan))


def trace_ell(n_raw: int, m_raw: int, seed: int = 0, telemetry_cap: int = 0,
              device="cpu"):
    """The bucketed-ELL solve (solver/ell_solver.py `_solve_mcmf_ell`)."""
    from ..solver import ell_solver

    n, m = bucketed_sizes(n_raw, m_raw)
    src, dst, cap, cost, supply = flow_problem(n, m, seed)
    plan = ell_solver.plan_tensors(ell_solver.build_ell_plan(src, dst, n), device)
    eps = max(1, int(cost.max()) * n)
    args = (_t(cap, device), _t(cost * np.int32(n), device), _t(supply, device),
            torch.zeros(m, dtype=_I32, device=device), eps, *plan)
    return record(lambda: ell_solver._solve_mcmf_ell(
        *args, alpha=8, max_supersteps=4096, tighten_sweeps=32,
        telemetry_cap=telemetry_cap))


def _mega_args(n, m, seed, device, supply_zero=False):
    from ..solver.csr_solver import build_csr_plan
    from ..solver.mega_solver import _pad_pow2, build_mega_plan

    src, dst, cap, cost, supply = flow_problem(n, m, seed)
    if supply_zero:
        supply = np.zeros_like(supply)
    mp = build_mega_plan(build_csr_plan(src, dst, n))
    eps = max(1, int(cost.max()) * n)
    args = (_t(_pad_pow2(cap), device), _t(_pad_pow2(cost * np.int32(n)), device),
            _t(_pad_pow2(supply), device),
            torch.zeros(len(_pad_pow2(cap)), dtype=_I32, device=device), eps,
            *(_t(x, device) for x in (mp.e_arc, mp.e_sign, mp.e_src, mp.e_hs, mp.e_he,
                                      mp.e_prow, mp.e_pcol, _pad_pow2(mp.fwd_pos))))
    return args, mp.R, mp.L


def trace_mega(n_raw: int, m_raw: int, seed: int = 0, telemetry_cap: int = 0,
               device="cpu"):
    """B3's plain version (ops/mcmf.py `mcmf_loop_plain`) over a
    MegaPlan's padded entry tables, on any device."""
    from ..ops import mcmf

    n, m = bucketed_sizes(n_raw, m_raw)
    args, R, L = _mega_args(n, m, seed, device)
    return record(lambda: mcmf.mcmf_loop_plain(
        *args, R, L, alpha=8, max_supersteps=4096, tighten_sweeps=32,
        telemetry_cap=telemetry_cap))


def trace_mega_kernel(n_raw: int, m_raw: int, seed: int = 0, telemetry_cap: int = 0,
                      device="cuda"):
    """B3's launching route (`mcmf_loop` on CUDA tensors: one launch)."""
    from ..ops import mcmf

    n, m = bucketed_sizes(n_raw, m_raw)
    args, R, L = _mega_args(n, m, seed, device)
    return record(lambda: mcmf.mcmf_loop(
        *args, R, L, alpha=8, max_supersteps=4096, tighten_sweeps=32,
        telemetry_cap=telemetry_cap))


def transport_problem(C: int, Mp: int, n_scale: int, seed: int = 0):
    """(wS, supply, col_cap, own) of a feasible [C, Mp] transport that
    converges in a few hundred supersteps: row c prefers the columns
    m = c (mod C) (cost -3 or -4 against 0 or -1 elsewhere, scaled by
    n_scale) and its supply fills them; the escape column last (cost 0,
    room for every unit). `own` marks the preferred cells."""
    rng = np.random.default_rng(seed)
    own = (np.arange(Mp)[None, :] % C) == np.arange(C)[:, None]
    w = np.where(own, -3 - rng.integers(0, 2, (C, Mp)),
                 -rng.integers(0, 2, (C, Mp))).astype(np.int32)
    w[:, -1] = 0
    col_cap = rng.integers(1, 3, Mp).astype(np.int32)
    supply = np.array([np.sum(col_cap[:-1][own[c, :-1]]) for c in range(C)], np.int32)
    col_cap[-1] = np.sum(supply)
    return (w * np.int32(n_scale)).astype(np.int32), supply, col_cap, own


def _layered_args(n_raw, m_raw, seed, tiered, device):
    from ..solver import layered

    C = max(2, n_raw)
    Mp, n_scale = layered.pad_geometry(m_raw, C)
    wS, supply, col_cap, own = transport_problem(C, Mp, n_scale, seed)
    if not tiered:
        return [_t(wS, device), _t(supply, device), _t(col_cap, device)], int(np.abs(wS).max())
    # residents on half the preferred cells, one unit each, a tier cheaper
    res = own & (np.random.default_rng(seed + 7).integers(0, 2, wS.shape) == 1)
    wLo = (wS - n_scale * res).astype(np.int32)
    return ([_t(x, device) for x in (wLo, wS, res.astype(np.int32), supply, col_cap)],
            int(np.abs(wLo).max()))


def trace_layered(n_raw: int, m_raw: int, seed: int = 0, telemetry_cap: int = 0,
                  tiered: bool = False, device="cpu"):
    """B1's plain version (solver/layered.py `_solve_transport`), or with
    `tiered` B2's (`_solve_transport_tiered`); (n_raw, m_raw) double as
    (classes, machines), padded by the port's `pad_geometry`."""
    from ..solver import layered

    args, eps = _layered_args(n_raw, m_raw, seed, tiered, device)
    if tiered:
        return record(lambda: layered._solve_transport_tiered(
            *args, eps, alpha=8, max_supersteps=4096))
    pm0 = torch.zeros_like(args[2])
    return record(lambda: layered._solve_transport(
        *args, eps, pm0, alpha=8, max_supersteps=4096, refine_waves=0,
        telemetry_cap=telemetry_cap))


def trace_layered_kernel(n_raw: int, m_raw: int, seed: int = 0, tiered: bool = False,
                         device="cuda"):
    """The launching route: `transport_fori` (B1) or
    `transport_fori_tiered` (B2) from the full eps range, one launch."""
    from ..solver import layered

    args, _eps = _layered_args(n_raw, m_raw, seed, tiered, device)
    fn = layered.transport_fori_tiered if tiered else layered.transport_fori
    return record(lambda: fn(*args, 4096))


#: the mesh the sharded tracers run on (set by the rank that runs them)
MESH = None


def _mesh():
    if MESH is None:
        raise RuntimeError("a sharded tracer needs op_contracts.MESH: a ShardMesh "
                           "over an initialised torch.distributed group")
    return MESH


def trace_sharded(n_raw: int, m_raw: int, seed: int = 0, telemetry_cap: int = 0,
                  device="cpu"):
    """The legacy sharded solve (`make_sharded_solver`) on this rank."""
    from ..parallel import sharded_solver

    mesh = _mesh()
    n, m = bucketed_sizes(n_raw, m_raw)
    src, dst, cap, cost, supply = flow_problem(n, m, seed)
    plan = sharded_solver.build_sharded_plan(src, dst, n, mesh.size)
    fn = sharded_solver.make_sharded_solver(mesh, alpha=8, telemetry_cap=telemetry_cap)
    eps = max(1, int(cost.max()) * n)
    args = (_t(cap, device), _t(cost * np.int32(n), device), _t(supply, device),
            torch.zeros(m, dtype=_I32, device=device), eps, 4096,
            *plan.shard_tensors(mesh.rank, device))
    return record(lambda: fn(*args))


def _slot_state(n: int, m: int, seed: int = 0):
    """A DeviceGraphState holding the seeded problem (duplicate arcs of
    the multigraph merged, as the state keys arcs by endpoints)."""
    from ..graph.changes import AddNodeChange, ArcType, NewArcChange
    from ..graph.device_export import DeviceGraphState
    from ..graph.flowgraph import NodeType

    src, dst, cap, cost, _supply = flow_problem(n, m, seed)
    _, keep = np.unique(np.stack([src, dst], 1), axis=0, return_index=True)
    keep = np.sort(keep)
    src, dst, cap, cost = src[keep], dst[keep], cap[keep], cost[keep]
    rng = np.random.default_rng(seed + 2)
    f = rng.integers(0, cap + 1)
    net = np.bincount(src, weights=f, minlength=n) - np.bincount(dst, weights=f, minlength=n)
    supply = [int(v) for v in net]
    st = DeviceGraphState()
    st._alloc(n, len(src))
    st.apply_changes([AddNodeChange(i, supply[i], NodeType.EQUIV_CLASS)
                      for i in range(n)])
    st.apply_changes([NewArcChange(int(s), int(d), 0, int(c), int(w), ArcType.OTHER)
                      for s, d, c, w in zip(src, dst, cap, cost)])
    return st


def trace_sharded_slot(n_raw: int, m_raw: int, num_devices: int = 2,
                       telemetry_cap: int = 0, use_warm_p: bool = False, device="cpu"):
    """The slot-stable sharded solve (`make_sharded_slot_solver`) on this
    rank, over the maintained plan's per-shard blocks."""
    from ..parallel import sharded_solver

    mesh = _mesh()
    if mesh.size != num_devices:
        raise RuntimeError(f"a {num_devices}-shard trace on a {mesh.size}-rank mesh")
    n, m = bucketed_sizes(n_raw, m_raw)
    st = _slot_state(n, m, seed=2)  # its merged arcs converge in ~400 supersteps
    prob = st.problem()
    st.plan.enable_sharding(num_devices)
    st.plan.ensure_built()
    plan = sharded_solver.place_sharded_plan(mesh, st.plan.host_args(), num_devices,
                                             st.plan.block_extent)
    N = prob.num_nodes
    eps = max(1, int(np.abs(prob.cost).max()) * N)
    args = [_t(prob.cap, device, _I32), _t(prob.cost.astype(np.int32) * np.int32(N), device),
            _t(prob.excess, device, _I32),
            torch.zeros(len(prob.cap), dtype=_I32, device=device), eps, 4096, *plan]
    if use_warm_p:
        args.append(torch.zeros(N, dtype=_I32, device=device))
    fn = sharded_solver.make_sharded_slot_solver(
        mesh, alpha=8, telemetry_cap=telemetry_cap, use_warm_p=use_warm_p)
    return record(lambda: fn(*args))


def _stub_mesh(num_devices: int, device):
    """A ShardMesh with no process group, for the zero-collective
    programs that read only the rank: a collective through it fails."""
    from ..parallel.mesh import ShardMesh
    from ..utils.device import resolve_device

    mesh = object.__new__(ShardMesh)
    mesh.group, mesh.size, mesh.rank = None, num_devices, 0
    mesh.device = resolve_device(device)
    mesh.counts = Counter()
    return mesh


def _records(k: int, cols: int, bound: int, rng):
    """k int32 records: a position below `bound`, then random values."""
    rec = rng.integers(0, 7, (k, cols)).astype(np.int32)
    rec[:, 0] = rng.integers(0, bound, k)
    return rec


def apply_delta(ka_raw: int = 5, kn_raw: int = 3, n_raw: int = 20, m_raw: int = 100,
                device="cpu"):
    """(fn, args, new_outputs): `delta_apply` on seeded persistent
    tensors and pow2-padded records; fn returns (excess, src, dst, cap,
    cost), src and dst new tensors."""
    from ..graph import device_export

    n, m = bucketed_sizes(n_raw, m_raw)
    ka = device_export.pad_record_count(ka_raw)
    kn = device_export.pad_record_count(kn_raw)
    rng = np.random.default_rng(3)
    bufs = [_t(rng.integers(0, 9, size).astype(np.int32), device) for size in (n, m, m, m, m)]
    recs = [_t(_records(ka, device_export.ARC_RECORD_COLS, m, rng), device),
            _t(_records(kn, device_export.NODE_RECORD_COLS, n, rng), device)]
    return device_export.delta_apply, tuple(bufs + recs), (1, 2)


def _plan_tensors(n, m, device, rng):
    e = 2 * m
    ints = [_t(rng.integers(0, 9, size).astype(np.int32), device)
            for size in (e, e, e, e, 2 * m, e)]
    isstart = _t(rng.integers(0, 2, e).astype(bool), device)
    first, last = (_t(rng.integers(0, e, n).astype(np.int32), device) for _ in range(2))
    nonempty = _t(rng.integers(0, 2, n).astype(bool), device)
    return (*ints[:4], ints[4], ints[5], isstart, first, last, nonempty)


def apply_plan(kp_raw: int = 5, ki_raw: int = 3, n_raw: int = 20, m_raw: int = 100,
               ks_raw: int = 0, kn_raw: int = 0, device="cpu"):
    """(fn, args, new_outputs): `plan_apply` on ten seeded plan tensors
    (SlotPlanState.host_args order) and padded records; fn returns the
    ten tensors."""
    from ..graph import slot_plan
    from ..graph.device_export import pad_record_count

    n, m = bucketed_sizes(n_raw, m_raw)
    rng = np.random.default_rng(4)
    p = _plan_tensors(n, m, device, rng)
    # SlotPlanState.host_args order: p_arc, p_sign, p_src, p_dst,
    # seg_start, is_start, inv_order, node_first, node_last, node_nonempty
    plan = (p[0], p[1], p[2], p[3], p[5], p[6], p[4], p[7], p[8], p[9])
    e = 2 * m
    recs = (
        _t(_records(pad_record_count(kp_raw), slot_plan.PLAN_RECORD_COLS, e, rng), device),
        _t(_records(pad_record_count(ki_raw), slot_plan.INV_RECORD_COLS, 2 * m, rng), device),
        _t(_records(pad_record_count(ks_raw), slot_plan.SEG_RECORD_COLS, e, rng), device),
        _t(_records(pad_record_count(kn_raw), slot_plan.NODE_RECORD_COLS, n, rng), device),
    )

    def fn(*a):
        slot_plan.plan_apply(a[:10], *a[10:])
        return a[:10]

    return fn, plan + recs, ()


def apply_sharded_plan(kp_raw: int = 5, ks_raw: int = 3, num_devices: int = 2,
                       n_raw: int = 20, m_raw: int = 100, device="cpu"):
    """(fn, args, new_outputs): `sharded_plan_apply_fn` on this rank's six
    seeded [Es] blocks and host records routed [D, K, cols]."""
    from ..graph.device_export import pad_record_count
    from ..graph.slot_plan import PLAN_RECORD_COLS, SEG_RECORD_COLS
    from ..parallel import sharded_solver

    _n, m = bucketed_sizes(n_raw, m_raw)
    D = num_devices
    es = sharded_solver.sharded_entry_extent(m, D)
    rng = np.random.default_rng(5)
    blocks = [_t(rng.integers(0, 9, es).astype(np.int32), device) for _ in range(5)]
    blocks.append(_t(rng.integers(0, 2, es).astype(bool), device))
    kp, ks = pad_record_count(kp_raw), pad_record_count(ks_raw)
    row = np.stack([_records(kp, PLAN_RECORD_COLS, es, rng) for _ in range(D)])
    seg = np.stack([_records(ks, SEG_RECORD_COLS, es, rng) for _ in range(D)])
    apply = sharded_solver.sharded_plan_apply_fn(_stub_mesh(D, device))

    def fn(*a):
        apply(*a)
        return a[:6]

    return fn, tuple(blocks) + (row, seg), ()


def apply_replicated_plan(ki_raw: int = 5, kn_raw: int = 3, n_raw: int = 20,
                          m_raw: int = 100, device="cpu"):
    """(fn, args, new_outputs): `replicated_plan_apply_fn` on the seeded
    replicated plan tensors and host records."""
    from ..graph.device_export import pad_record_count
    from ..graph.slot_plan import INV_RECORD_COLS, NODE_RECORD_COLS
    from ..parallel import sharded_solver

    n, m = bucketed_sizes(n_raw, m_raw)
    rng = np.random.default_rng(6)
    inv = _t(rng.integers(0, 2 * m, 2 * m).astype(np.int32), device)
    first, last = (_t(rng.integers(0, 2 * m, n).astype(np.int32), device) for _ in range(2))
    nonempty = _t(rng.integers(0, 2, n).astype(bool), device)
    inv_rec = _records(pad_record_count(ki_raw), INV_RECORD_COLS, 2 * m, rng)
    node_rec = _records(pad_record_count(kn_raw), NODE_RECORD_COLS, n, rng)
    apply = sharded_solver.replicated_plan_apply_fn()

    def fn(*a):
        apply(*a)
        return a[:4]

    return fn, (inv, first, last, nonempty, inv_rec, node_rec), ()


def _trace_apply(builder, *args, device="cpu", **kw):
    fn, a, _new = builder(*args, device=device, **kw)
    return record(lambda: fn(*a))


def trace_delta_apply(ka_raw: int, kn_raw: int, n_raw: int = 20, m_raw: int = 100,
                      device="cpu"):
    """The device-resident delta apply (graph/device_export.py `delta_apply`)."""
    return _trace_apply(apply_delta, ka_raw, kn_raw, n_raw, m_raw, device=device)


def trace_plan_apply(kp_raw: int, ki_raw: int, n_raw: int = 20, m_raw: int = 100,
                     ks_raw: int = 0, kn_raw: int = 0, device="cpu"):
    """The slot-stable plan apply (graph/slot_plan.py `plan_apply`)."""
    return _trace_apply(apply_plan, kp_raw, ki_raw, n_raw, m_raw, ks_raw, kn_raw,
                        device=device)


def trace_sharded_plan_apply(kp_raw: int, ks_raw: int, num_devices: int = 2,
                             n_raw: int = 20, m_raw: int = 100, device="cpu"):
    """The per-shard routed plan apply (`sharded_plan_apply_fn`)."""
    return _trace_apply(apply_sharded_plan, kp_raw, ks_raw, num_devices, n_raw, m_raw,
                        device=device)


def trace_replicated_plan_apply(ki_raw: int, kn_raw: int, n_raw: int = 20,
                                m_raw: int = 100, device="cpu"):
    """The replicated remainder of a sharded plan sync."""
    return _trace_apply(apply_replicated_plan, ki_raw, kn_raw, n_raw, m_raw,
                        device=device)


def _ints(sizes, device, seed):
    rng = np.random.default_rng(seed)
    return [_t(rng.integers(0, 9, s).astype(np.int32), device) for s in sizes]


def trace_warm_flow(n_raw: int = 20, m_raw: int = 100, device="cpu"):
    """The device warm-flow carry (graph/device_export.py `device_warm_flow`)."""
    from ..graph import device_export

    _n, m = bucketed_sizes(n_raw, m_raw)
    args = _ints([m] * 6, device, 7)
    return record(lambda: device_export.device_warm_flow(*args))


def trace_scale_cost(n_raw: int = 20, m_raw: int = 100, device="cpu"):
    """The cost pre-scaling (DeviceResidentState.scaled_cost): d_cost * n."""
    from ..graph.device_export import DeviceResidentState

    n, m = bucketed_sizes(n_raw, m_raw)
    owner = types.SimpleNamespace(_scaled=None)
    problem = types.SimpleNamespace(version=1, d_cost=_ints([m], device, 8)[0],
                                    num_nodes=n)
    return record(lambda: DeviceResidentState.scaled_cost(owner, problem))


def _fresh_weights():
    from ..runtime import integrity

    integrity._DEV_WEIGHTS.clear()  # record the weights' own ops every time


def trace_state_fingerprint(n_raw: int = 20, m_raw: int = 100, device="cpu"):
    """The five persistent problem tensors' checksums (runtime/integrity.py
    `device_fingerprints`)."""
    from ..runtime import integrity

    n, m = bucketed_sizes(n_raw, m_raw)
    bufs = _ints([n, m, m, m, m], device, 9)
    _fresh_weights()
    return record(lambda: integrity.device_fingerprints(bufs))


def trace_plan_fingerprint(n_raw: int = 20, m_raw: int = 100, device="cpu"):
    """The mirror's ten plan tensors' checksums
    (DeviceResidentState.plan_fingerprints, single-device mode)."""
    from ..graph.device_export import DeviceResidentState

    n, m = bucketed_sizes(n_raw, m_raw)
    p = _plan_tensors(n, m, device, np.random.default_rng(10))
    owner = types.SimpleNamespace(
        d_p_arc=p[0], d_p_sign=p[1], d_p_src=p[2], d_p_dst=p[3], d_inv=p[4],
        d_seg=p[5], d_isstart=p[6], d_first=p[7], d_last=p[8], d_nonempty=p[9],
        _shard=None)
    _fresh_weights()
    return record(lambda: DeviceResidentState.plan_fingerprints(owner))


def trace_buffer_fingerprint(n_raw: int = 20, m_raw: int = 100, device="cpu"):
    """One buffer's checksum (runtime/integrity.py `_device_fp1`)."""
    from ..runtime import integrity

    _n, m = bucketed_sizes(n_raw, m_raw)
    buf = _ints([m], device, 11)[0]
    _fresh_weights()
    return record(lambda: integrity._device_fp1(buf))


def trace_sharded_plan_fingerprint(num_devices: int = 2, n_raw: int = 20,
                                   m_raw: int = 100, device="cpu"):
    """The sharded plan checksum (`sharded_plan_fingerprint_fn`) on this rank."""
    from ..parallel import sharded_solver

    mesh = _mesh()
    n, m = bucketed_sizes(n_raw, m_raw)
    es = sharded_solver.sharded_entry_extent(m, num_devices)
    rng = np.random.default_rng(12)
    ints = [_t(rng.integers(0, 9, s).astype(np.int32), device)
            for s in (es, es, es, es, 2 * m, es)]
    isstart = _t(rng.integers(0, 2, es).astype(bool), device)
    first, last = (_t(rng.integers(0, 2 * m, n).astype(np.int32), device) for _ in range(2))
    nonempty = _t(rng.integers(0, 2, n).astype(bool), device)
    fp = sharded_solver.sharded_plan_fingerprint_fn(mesh)
    _fresh_weights()
    return record(lambda: fp(*ints[:4], ints[4], ints[5], isstart, first, last, nonempty))


def trace_corrupt_flip(n_raw: int = 20, m_raw: int = 100, device="cpu"):
    """The chaos poison flip (runtime/integrity.py `corrupt_flip`)."""
    from ..runtime import integrity

    _n, m = bucketed_sizes(n_raw, m_raw)
    buf = _ints([m], device, 13)[0]
    return record(lambda: integrity.corrupt_flip(buf, 3, 4))


# ---------------------------------------------------------------------------
# the mega live set: constants of the CUDA sources
# ---------------------------------------------------------------------------

_CSRC = Path(__file__).resolve().parents[1] / "ops" / "csrc"


def _constant(text: str, name: str) -> int:
    m = re.search(rf"\b{name}\s*=\s*(\d+)", text)
    if m is None:
        raise ValueError(f"{name} not found in the CUDA sources")
    return int(m.group(1))


def cuda_live_set_constants() -> Dict[str, int]:
    """What csrc/mcmf.cu and transport_common.cuh say of B3's live set:
    scratch tables, header words, words a block, warps a block, and the
    int32 tables the launch reads (the `const int*` parameters of
    `ksched_mcmf_solve`)."""
    mcmf_src = (_CSRC / "mcmf.cu").read_text()
    common = (_CSRC / "transport_common.cuh").read_text()
    head = re.search(r"kHeadWords\s*=\s*kTelWord\s*\+\s*(\d+)\s*\*\s*kTelCounters",
                     mcmf_src)
    block = re.search(r"kHeadWords\s*\+\s*(\d+)LL\s*\*\s*blocks", mcmf_src)
    solve = re.search(r"ksched_mcmf_solve\((.*?)\)\s*\{", mcmf_src, re.S)
    if head is None or block is None or solve is None:
        raise ValueError("B3's scratch layout not found in csrc/mcmf.cu")
    inputs = len(re.findall(r"const int\*", solve.group(1)))
    return {
        "scratch_tables": _constant(mcmf_src, "kScratchTables"),
        "head_words": (_constant(mcmf_src, "kTelWord")
                       + int(head.group(1)) * _constant(mcmf_src, "kTelCounters")),
        "block_words": int(block.group(1)),
        "warps": _constant(common, "kThreads") // 32,
        "input_tables": inputs,
    }


def reckoned_words(num_entries: int, telemetry: bool, const: Dict[str, int]) -> int:
    """B3's live set in int32 words from the CUDA constants alone: the
    inputs, the flow, the ring (one table at most) and the scratch at
    the most blocks a grid of `num_entries` can take."""
    from ..ops.mcmf import MEGA_LANES, mega_entry_rows

    padded = mega_entry_rows(num_entries, MEGA_LANES) * MEGA_LANES
    most_blocks = -(-padded // (const["warps"] * 32))
    tables = const["input_tables"] + 1 + int(telemetry) + const["scratch_tables"]
    return tables * padded + const["head_words"] + const["block_words"] * most_blocks


def mega_trivial_args(num_entries: int, device):
    """A B3 problem of `num_entries` residual entries (a MegaPlan's own
    padding) with zero supply: it converges without a superstep, for the
    grid gate's launch at the largest admitted size."""
    n = 1024
    return _mega_args(n, max(1, num_entries // 2), 0, device, supply_zero=True)
