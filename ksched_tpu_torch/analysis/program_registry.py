"""Level-3 registry: every device program and kernel of the port, declared once.

The JAX package registers each compiled program (a `jax.jit`,
`pl.pallas_call` or `shard_map` site) with a contract spec and lets one
engine check every spec; this is the port's registry of the same 23
programs under the same names and kinds, with each contract given its
torch meaning (the catalog is analysis/__init__.py's docstring). A
torch program is not compiled, so a "site" here is one of:

- a kernel launch through `ops/build.py::load`'s libraries
  (`lib.ksched_*_solve(`), B1, B2 and B3;
- a `torch.distributed` collective call (`parallel/mesh.py`);
- the `def` of a registered plain program (a solve, an apply, an audit).

Each site carries ``# kschedlint: program=<name>`` or a waiver with a
rationale (`ast_rules.rule_unregistered_program`), and every registered
site name must be annotated somewhere (`program_coverage`).

Stdlib only, as in the JAX package: the lint CLI reads this module
without importing torch. Tracers are named by string and resolved by the
engine in analysis/op_contracts.py.

Program-owning modules confirm ownership with one line at their end::

    from ..analysis.program_registry import declare_programs
    declare_programs(__name__, "delta_apply", "warm_flow", "scale_cost")

`declare_programs` checks the names at import, and the engine checks
that each spec's owning module declares it.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Set, Tuple

# ---------------------------------------------------------------------------
# spec vocabulary
# ---------------------------------------------------------------------------

#: scatter policies (the JAX package's, with their torch meaning):
#: - "deterministic": the JAX package's "forbidden". The port's solves
#:   do scatter (`scatter_reduce_` amin/amax, a permutation `scatter_`),
#:   so the policy is the torch meaning of the rule, determinism on
#:   CUDA: the program's scatter-family calls are pinned by kind and
#:   count (`scatters`), a float accumulation fails, and a
#:   non-accumulating write through a tensor index is allowed only as a
#:   declared permutation (`permutation`).
#: - "scoped-exempt": the program MUST scatter (non-vacuity); the
#:   once-a-round maintenance appliers.
#: - "chaos-only": allowed to scatter, never run in production (the
#:   poison flip that proves the fingerprint audit).
SCATTER_POLICIES = ("deterministic", "scoped-exempt", "chaos-only")

#: hash-stability classes, as in the JAX package: two raw sizes that
#: pad to one bucket record identical traces, shapes included
HASH_STABILITY_KINDS = ("pow2-bucket", "record-bucket", "shard-bucket", "exempt")


@dataclass(frozen=True)
class TraceCall:
    """One concrete invocation of a spec's tracer: (args, kwargs)."""

    args: Tuple = ()
    kwargs: Tuple = ()  # sorted (key, value) pairs — hashable

    def as_kwargs(self) -> Dict:
        return dict(self.kwargs)


def call(*args, **kwargs) -> TraceCall:
    return TraceCall(args=tuple(args), kwargs=tuple(sorted(kwargs.items())))


@dataclass(frozen=True)
class HashStability:
    """Which tracer calls must (and must not) record the same trace."""

    kind: str
    #: pairs of TraceCalls that MUST record identical traces
    same: Tuple[Tuple[TraceCall, TraceCall], ...] = ()
    #: pairs that MUST differ (keeps the stability check non-vacuous)
    cross: Tuple[Tuple[TraceCall, TraceCall], ...] = ()
    reason: str = ""  # mandatory when kind == "exempt"

    def __post_init__(self):
        if self.kind not in HASH_STABILITY_KINDS:
            raise ValueError(f"unknown hash-stability kind {self.kind!r}")
        if self.kind == "exempt" and not self.reason:
            raise ValueError("exempt hash stability requires a reason")


@dataclass(frozen=True)
class DonationSpec:
    """Declared in-place buffers: the torch meaning of a donation.

    The engine calls `builder`'s program (an op_contracts function
    returning ``(fn, args, new_outputs)``) and holds every argument in
    `donate_argnums` to an in-place update: the returned tensor at that
    position is the argument itself (same `data_ptr()`) and its
    `_version` moved. On the card the peak memory growth of the call,
    less the bytes of the outputs declared new (`new_outputs`), stays
    below the smallest declared buffer: an out-of-place copy doubles
    memory with no error anywhere, which this catches."""

    donate_argnums: Tuple[int, ...]
    builder: str


@dataclass(frozen=True)
class CollectiveBudget:
    """The collectives of a (sharded) program, counted by kind from the
    ShardMesh calls it makes.

    `loop` pins, per kind, the most issued in any one iteration of a
    marked loop (a superstep, a sweep, a refinement wave): the JAX
    package's "loop body counts once". `total` pins the folded program
    (every loop body once). `forbidden` kinds must not appear at all:
    a single-device program makes no ShardMesh call."""

    loop: Tuple[Tuple[str, int], ...] = ()
    total: Tuple[Tuple[str, int], ...] = ()
    forbidden: Tuple[str, ...] = ()
    #: telemetry-ON variant must add loop psums (the soltel counters)
    knob_adds_loop_psum: bool = False


@dataclass(frozen=True)
class GatherBudget:
    """Gathers (a tensor-indexed read, `gather`, `index_select`,
    `take`) of the recorded program (None = unchecked)."""

    hbm_loop: Optional[int] = None  # exact, in the busiest superstep of the plain loop
    #: torch calls a superstep on the launching route (card only), read
    #: from two solves of different superstep counts: 0 when the whole
    #: loop runs inside one launch
    kernel: Optional[int] = None
    oneshot: Optional[int] = None  # exact, outside every loop
    hbm_loop_min: Optional[int] = None  # lower bound (the classifier canary)


@dataclass(frozen=True)
class HostReadBudget:
    """Host reads (`bool`, `int`, `float`, `.item()`, `.tolist()` or
    `.cpu()` of a tensor) pinned exactly: in every superstep, in every
    tightening sweep, and outside the loops."""

    superstep: Optional[int] = None
    sweep: Optional[int] = None
    once: Optional[int] = None


@dataclass(frozen=True)
class ProgramSpec:
    """One registered device program and its full contract."""

    name: str
    module: str  # dotted module owning the annotated site
    kind: str  # "solve" | "maintenance" | "audit" | "chaos"
    tracer: str  # factory name in analysis/op_contracts
    trace: TraceCall = field(default_factory=TraceCall)
    #: extra calls the contract sweep also records
    extra: Tuple[TraceCall, ...] = ()
    scatter_policy: str = "deterministic"
    #: exact scatter-family calls by kind in the folded telemetry-off
    #: trace at the default call (None = unchecked)
    scatters: Optional[Tuple[Tuple[str, int], ...]] = None
    #: non-accumulating scatter kinds the program declares permutations
    permutation: Tuple[str, ...] = ()
    dtype_policy: str = "int32"  # the only policy: no 64-bit values
    #: calls yielding an int64 tensor, by function and count, in the
    #: folded telemetry-off trace at the default call: index operands
    #: (and the fingerprints' declared wide arithmetic). Exact.
    int64_ops: Tuple[Tuple[str, int], ...] = ()
    host_reads: Optional[HostReadBudget] = None
    collectives: Optional[CollectiveBudget] = None
    donation: Optional[DonationSpec] = None
    #: pinned sha256 (16 hex) of the normalised function-level trace of
    #: the DEFAULT (telemetry-off) call, loop bodies folded
    telemetry_off_hash: Optional[str] = None
    #: tracer kwarg enabling the soltel ring: knob=0 records the default
    #: trace, knob=512 a different one
    telemetry_knob: Optional[str] = None
    hash_stability: Optional[HashStability] = None
    gathers: Optional[GatherBudget] = None
    #: other programs whose default trace must hash differently
    distinct_from: Tuple[str, ...] = ()
    #: run the mega live-set gate cross-checks (`mega_fits`)
    vmem_gate: bool = False
    #: card only: the op_contracts tracer of the launching route
    kernel_tracer: Optional[str] = None
    #: names in KERNELS this program launches on the card
    kernels: Tuple[str, ...] = ()
    #: ranks the tracer needs in a torch.distributed group (0: none)
    ranks: int = 0
    #: annotation name at the site (variants share one); defaults to name
    site: Optional[str] = None
    notes: str = ""

    def __post_init__(self):
        if self.scatter_policy not in SCATTER_POLICIES:
            raise ValueError(f"{self.name}: bad scatter policy {self.scatter_policy!r}")
        if self.dtype_policy != "int32":
            raise ValueError(f"{self.name}: bad dtype policy {self.dtype_policy!r}")

    @property
    def site_name(self) -> str:
        return self.site or self.name


@dataclass(frozen=True)
class KernelSpec:
    """One hand-written kernel: its source, what it replaces, and the
    resources of each `__global__` instantiation pinned as the card's
    `cudaFuncGetAttributes` reports them (registers a thread, local
    bytes a thread (spill), static shared bytes, max threads a block),
    in the order the source's ``ksched_<name>_kernel_attrs`` query
    takes. A redesign re-pins them on purpose."""

    name: str
    source: str
    replaces: str
    program: str
    #: (variant, registers, local bytes, static shared bytes, max threads)
    resources: Tuple[Tuple[str, int, int, int, int], ...]


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------

_CSR_SAME = (
    (call(12, 40), call(15, 60)),
    (call(20, 100), call(30, 70)),
    (call(40, 220), call(60, 200)),
)
_CSR_CROSS = ((call(12, 40), call(12, 200)),)
_MEGA_CROSS = ((call(12, 40), call(12, 2000)),)
_LAYERED_SAME = (
    (call(4, 40), call(4, 100)),
    (call(4, 130), call(4, 250)),
    (call(8, 300), call(8, 370)),
)
_LAYERED_CROSS = ((call(4, 40), call(4, 300)),)
_RECORD_SAME = ((call(3, 2), call(7, 5)),)
_RECORD_CROSS = ((call(3, 2), call(100, 2)),)
_RECORD_GRAPH_SAME = ((call(3, 2, n_raw=20, m_raw=100), call(3, 2, n_raw=24, m_raw=110)),)
_RECORD_GRAPH_CROSS = ((call(3, 2, n_raw=20, m_raw=100), call(3, 2, n_raw=20, m_raw=300)),)
_GRAPH_SAME = ((call(20, 100), call(24, 110)),)
_GRAPH_CROSS = ((call(20, 100), call(20, 300)),)

#: the scan-CSR solves' scatters (the segment min and max) and int64
#: calls (gather indices, the segment ids `scatter_reduce_` takes)
_CSR_SCATTERS = (("scatter_reduce_", 2),)
_CSR_INT64 = (("__getitem__", 5), ("cumsum", 2), ("long", 7), ("sub", 2))
_STACKED_INT64 = (("__getitem__", 1), ("arange", 1), ("cumsum", 1), ("gather", 3),
                  ("long", 7), ("sub", 1))

#: the slot-stable sharded solve's: its block-local index arithmetic too
_SLOT_SHARDED_INT64 = (("__floordiv__", 2), ("__getitem__", 4), ("clamp", 3),
                       ("cumsum", 2), ("long", 12), ("sub", 7), ("where", 2))

#: every collective kind a ShardMesh issues — "forbid all"
_ALL_COLLECTIVES = ("psum", "pmin", "pmax", "all_gather")

_SPECS = (
    # -- solver programs (solver/select.py rungs + variants) ------------
    ProgramSpec(
        name="csr_solve", module="ksched_tpu_torch.solver.csr_solver", kind="solve",
        tracer="trace_csr", trace=call(20, 100),
        extra=(call(12, 40), call(40, 220)),
        scatters=_CSR_SCATTERS, int64_ops=_CSR_INT64,
        host_reads=HostReadBudget(superstep=1, sweep=1, once=2),
        telemetry_off_hash="95fe0cf026e4e385", telemetry_knob="telemetry_cap",
        hash_stability=HashStability("pow2-bucket", same=_CSR_SAME, cross=_CSR_CROSS),
        gathers=GatherBudget(hbm_loop_min=1),
        collectives=CollectiveBudget(forbidden=_ALL_COLLECTIVES),
        notes="scan-CSR push-relabel in plain PyTorch; hbm_loop_min=1 is "
        "the gather-classifier canary (CSR pays per-superstep gathers)",
    ),
    ProgramSpec(
        name="csr_solve_warmp", module="ksched_tpu_torch.solver.csr_solver",
        kind="solve", tracer="trace_csr_warmp", trace=call(20, 100), site="csr_solve",
        scatters=_CSR_SCATTERS, int64_ops=_CSR_INT64,
        host_reads=HostReadBudget(superstep=1, sweep=1, once=2),
        hash_stability=HashStability("pow2-bucket", same=_GRAPH_SAME, cross=_GRAPH_CROSS),
        distinct_from=("csr_solve",),
        notes="dirty-frontier warm-price refit (the sweeps seeded from "
        "the carried prices)",
    ),
    ProgramSpec(
        name="csr_solve_slot", module="ksched_tpu_torch.solver.csr_solver",
        kind="solve", tracer="trace_csr_slot", trace=call(20, 100), site="csr_solve",
        scatters=_CSR_SCATTERS, int64_ops=_CSR_INT64,
        host_reads=HostReadBudget(superstep=1, sweep=1, once=2),
        hash_stability=HashStability("pow2-bucket", same=_GRAPH_SAME, cross=_GRAPH_CROSS),
        distinct_from=("csr_solve",),
        notes="slot-stable layout: dead rows masked through the sign column",
    ),
    ProgramSpec(
        name="csr_refit_slot", module="ksched_tpu_torch.solver.csr_solver",
        kind="solve", tracer="trace_csr_warmp", trace=call(20, 100, slot_stable=True),
        site="csr_solve", distinct_from=("csr_solve_warmp",),
        scatters=_CSR_SCATTERS, int64_ops=_CSR_INT64,
        host_reads=HostReadBudget(superstep=1, sweep=1, once=2),
        notes="the event path's program: the refit on the slot-stable plan",
    ),
    ProgramSpec(
        name="stacked_solve", module="ksched_tpu_torch.solver.csr_solver",
        kind="solve", tracer="trace_stacked", trace=call(4, 20, 100),
        telemetry_knob="telemetry_cap",
        scatters=_CSR_SCATTERS, int64_ops=_STACKED_INT64,
        permutation=("setitem[tensor]",),
        host_reads=HostReadBudget(superstep=1, sweep=1, once=0),
        hash_stability=HashStability(
            "pow2-bucket",
            same=((call(3, 20, 100), call(4, 24, 110)),),
            cross=(
                (call(3, 20, 100), call(8, 20, 100)),  # lane bucket
                (call(3, 20, 100), call(4, 20, 300)),  # shape bucket
            ),
        ),
        collectives=CollectiveBudget(forbidden=_ALL_COLLECTIVES),
        notes="the multi-tenant stacked lane solve; one host read a "
        "superstep and a sweep for the whole stack, not one a lane; the "
        "ring's write at (lane, slot) is one row a lane, a permutation",
    ),
    ProgramSpec(
        name="stacked_solve_warmp", module="ksched_tpu_torch.solver.csr_solver",
        kind="solve", tracer="trace_stacked", trace=call(4, 20, 100, use_warm_p=True),
        site="stacked_solve", distinct_from=("stacked_solve",),
        scatters=_CSR_SCATTERS, int64_ops=_STACKED_INT64,
        host_reads=HostReadBudget(superstep=1, sweep=1, once=0),
        notes="lane-batched dirty-frontier refit",
    ),
    ProgramSpec(
        name="ell_solve", module="ksched_tpu_torch.solver.ell_solver", kind="solve",
        tracer="trace_ell", trace=call(20, 100),
        extra=(call(12, 40), call(40, 220)),
        scatters=(),
        int64_ops=(("add", 1), ("clamp", 53), ("long", 59), ("mul", 1)),
        host_reads=HostReadBudget(superstep=1, sweep=1, once=2),
        telemetry_off_hash="3e9430788ce54f42", telemetry_knob="telemetry_cap",
        hash_stability=HashStability(
            "exempt",
            reason="entry-table shapes depend on degree buckets; the "
            "recompile unit of the JAX package is the ELL plan rebuild "
            "(tests/test_torch_ell_solver.py)",
        ),
        collectives=CollectiveBudget(forbidden=_ALL_COLLECTIVES),
    ),
    ProgramSpec(
        name="mega_solve", module="ksched_tpu_torch.ops.mcmf", kind="solve",
        tracer="trace_mega", trace=call(20, 100),
        extra=(call(12, 40), call(40, 220)),
        scatters=(("scatter_reduce_", 2), ("setitem", 1)),
        int64_ops=(("__getitem__", 2), ("add", 1), ("cat", 1), ("clamp", 2),
                   ("flatten", 1), ("long", 6), ("mul", 1), ("new_full", 1),
                   ("nonzero", 1), ("sub", 1)),
        host_reads=HostReadBudget(superstep=1, sweep=1, once=2),
        telemetry_off_hash="ccf350afeced751a", telemetry_knob="telemetry_cap",
        hash_stability=HashStability("pow2-bucket", same=_CSR_SAME, cross=_MEGA_CROSS),
        gathers=GatherBudget(hbm_loop=16, kernel=0),
        collectives=CollectiveBudget(forbidden=_ALL_COLLECTIVES),
        vmem_gate=True, kernel_tracer="trace_mega_kernel", kernels=("mcmf",),
        notes="B3: one cooperative launch for the whole solve on the card "
        "(kernel=0: no torch op a superstep); its plain version is pinned "
        "on both devices",
    ),
    ProgramSpec(
        name="layered_solve", module="ksched_tpu_torch.solver.layered", kind="solve",
        tracer="trace_layered", trace=call(20, 100),
        extra=(call(12, 40), call(40, 220), call(4, 100, tiered=True)),
        scatters=(), int64_ops=(),
        host_reads=HostReadBudget(superstep=1, once=0),
        telemetry_off_hash="44e93db4d7db501b", telemetry_knob="telemetry_cap",
        hash_stability=HashStability("pow2-bucket", same=_LAYERED_SAME, cross=_LAYERED_CROSS),
        gathers=GatherBudget(hbm_loop=0, oneshot=0, kernel=0),
        collectives=CollectiveBudget(forbidden=_ALL_COLLECTIVES),
        kernel_tracer="trace_layered_kernel", kernels=("transport", "transport_tiered"),
        notes="B1 (transport_fori) and B2 (transport_fori_tiered): the dense "
        "transport solve, one launch a solve attempt on the card",
    ),
    ProgramSpec(
        name="sharded_solve", module="ksched_tpu_torch.parallel.sharded_solver",
        kind="solve", tracer="trace_sharded", trace=call(20, 100),
        scatters=_CSR_SCATTERS,
        int64_ops=(("__getitem__", 2), ("cumsum", 2), ("long", 8), ("sub", 2)),
        host_reads=HostReadBudget(superstep=1, sweep=1, once=2),
        telemetry_off_hash="759f2c4478036c26", telemetry_knob="telemetry_cap", ranks=2,
        collectives=CollectiveBudget(
            loop=(("psum", 3), ("pmin", 1), ("pmax", 2)), forbidden=("all_gather",),
            knob_adds_loop_psum=True,
        ),
        hash_stability=HashStability(
            "exempt",
            reason="legacy ShardedPlan shapes depend on per-shard maxima; "
            "the recompile unit is build_sharded_plan (superseded by "
            "sharded_slot_solve on the event path)",
        ),
        notes="legacy sharded solve, recorded at D = 2 (the hash pin holds "
        "the 2-shard block shapes)",
    ),
    ProgramSpec(
        name="sharded_slot_solve", module="ksched_tpu_torch.parallel.sharded_solver",
        kind="solve", tracer="trace_sharded_slot", trace=call(20, 100, num_devices=2),
        scatters=_CSR_SCATTERS, int64_ops=_SLOT_SHARDED_INT64,
        host_reads=HostReadBudget(superstep=1, sweep=1, once=2),
        telemetry_knob="telemetry_cap", ranks=2,
        hash_stability=HashStability(
            "shard-bucket",
            same=((call(20, 100, num_devices=2), call(24, 110, num_devices=2)),),
            cross=((call(20, 100, num_devices=2), call(20, 300, num_devices=2)),),
        ),
        collectives=CollectiveBudget(
            loop=(("psum", 3), ("pmin", 1), ("pmax", 2)),
            forbidden=("all_gather",),
            knob_adds_loop_psum=True,
        ),
        notes="exactly 3 vector psums a superstep (the [N] excess, [M] "
        "arc-delta, [N] potential combines); pmin = a tightening sweep, "
        "pmax = sat_full's two phase-boundary combines; recorded at one "
        "shard count, D = 2 (the JAX registry's D = 4 and 8 pairs need "
        "more ranks than the test's group)",
    ),
    ProgramSpec(
        name="sharded_slot_solve_warmp",
        module="ksched_tpu_torch.parallel.sharded_solver", kind="solve",
        tracer="trace_sharded_slot",
        trace=call(20, 100, num_devices=2, use_warm_p=True), ranks=2,
        scatters=_CSR_SCATTERS, int64_ops=_SLOT_SHARDED_INT64,
        host_reads=HostReadBudget(superstep=1, sweep=1, once=2),
        site="sharded_slot_solve", distinct_from=("sharded_slot_solve",),
    ),
    # -- maintenance programs (the scoped scatter exemptions) -----------
    ProgramSpec(
        name="delta_apply", module="ksched_tpu_torch.graph.device_export",
        kind="maintenance", tracer="trace_delta_apply", trace=call(5, 3),
        scatter_policy="scoped-exempt", scatters=(("index_copy_", 5),),
        int64_ops=(("long", 2),), host_reads=HostReadBudget(once=0),
        donation=DonationSpec(donate_argnums=(0, 3, 4), builder="apply_delta"),
        hash_stability=HashStability(
            "record-bucket",
            same=_RECORD_SAME + _RECORD_GRAPH_SAME,
            cross=_RECORD_CROSS + _RECORD_GRAPH_CROSS,
        ),
        collectives=CollectiveBudget(forbidden=_ALL_COLLECTIVES),
        notes="O(churn) once-a-round delta scatter; excess/cap/cost in place, "
        "src/dst new tensors (the solvers' warm masks keep the old ones)",
    ),
    ProgramSpec(
        name="plan_apply", module="ksched_tpu_torch.graph.slot_plan",
        kind="maintenance", tracer="trace_plan_apply", trace=call(5, 3),
        scatter_policy="scoped-exempt", scatters=(("index_copy_", 10),),
        int64_ops=(("long", 4),), host_reads=HostReadBudget(once=0),
        donation=DonationSpec(donate_argnums=tuple(range(10)), builder="apply_plan"),
        hash_stability=HashStability(
            "record-bucket",
            same=_RECORD_SAME + _RECORD_GRAPH_SAME,
            cross=_RECORD_CROSS + _RECORD_GRAPH_CROSS,
        ),
        collectives=CollectiveBudget(forbidden=_ALL_COLLECTIVES),
        notes="slot-stable plan-row + boundary-static apply; all ten plan "
        "tensors in place",
    ),
    ProgramSpec(
        name="sharded_plan_apply", module="ksched_tpu_torch.parallel.sharded_solver",
        kind="maintenance", tracer="trace_sharded_plan_apply", trace=call(5, 3),
        scatter_policy="scoped-exempt", scatters=(("index_copy_", 6),),
        int64_ops=(("long", 2),),
        donation=DonationSpec(donate_argnums=(0, 1, 2, 3, 4, 5),
                              builder="apply_sharded_plan"),
        hash_stability=HashStability("record-bucket", same=_RECORD_SAME, cross=_RECORD_CROSS),
        collectives=CollectiveBudget(forbidden=_ALL_COLLECTIVES),
        notes="per-shard routed plan scatter; zero collectives (routing "
        "happened on the host), six entry tensors in place",
    ),
    ProgramSpec(
        name="replicated_plan_apply", module="ksched_tpu_torch.parallel.sharded_solver",
        kind="maintenance", tracer="trace_replicated_plan_apply", trace=call(5, 3),
        scatter_policy="scoped-exempt", scatters=(("index_copy_", 4),),
        int64_ops=(("long", 2),),
        donation=DonationSpec(donate_argnums=(0, 1, 2, 3),
                              builder="apply_replicated_plan"),
        hash_stability=HashStability("record-bucket", same=_RECORD_SAME, cross=_RECORD_CROSS),
        collectives=CollectiveBudget(forbidden=_ALL_COLLECTIVES),
        notes="the replicated remainder of a sharded plan sync (inv-order "
        "and node boundaries)",
    ),
    ProgramSpec(
        name="warm_flow", module="ksched_tpu_torch.graph.device_export",
        kind="maintenance", tracer="trace_warm_flow", scatters=(),
        host_reads=HostReadBudget(once=0),
        gathers=GatherBudget(hbm_loop=0, oneshot=0),
        hash_stability=HashStability("pow2-bucket", same=_GRAPH_SAME, cross=_GRAPH_CROSS),
        collectives=CollectiveBudget(forbidden=_ALL_COLLECTIVES),
        notes="pure elementwise warm-flow carry: scatter- AND gather-free",
    ),
    ProgramSpec(
        name="scale_cost", module="ksched_tpu_torch.graph.device_export",
        kind="maintenance", tracer="trace_scale_cost", scatters=(),
        host_reads=HostReadBudget(once=0),
        hash_stability=HashStability("pow2-bucket", same=_GRAPH_SAME, cross=_GRAPH_CROSS),
        collectives=CollectiveBudget(forbidden=_ALL_COLLECTIVES),
        notes="cost pre-scaling (cost * n) before a device solve "
        "(DeviceResidentState.scaled_cost)",
    ),
    # -- audit programs (integrity fingerprints: the normal round cadence,
    #    so no scatter exemption) -----------------------------------------
    ProgramSpec(
        name="state_fingerprint", module="ksched_tpu_torch.runtime.integrity",
        kind="audit", tracer="trace_state_fingerprint", scatters=(),
        int64_ops=(("__and__", 12), ("__or__", 2), ("add", 2), ("arange", 2),
                   ("cpu", 1), ("mul", 7), ("stack", 1), ("sum", 5), ("to", 5)),
        host_reads=HostReadBudget(once=1),
        hash_stability=HashStability("pow2-bucket", same=_GRAPH_SAME, cross=_GRAPH_CROSS),
        collectives=CollectiveBudget(forbidden=_ALL_COLLECTIVES),
        notes="per-buffer weighted checksums of the five persistent "
        "problem tensors, one device-to-host copy; int64 holds the "
        "uint32 checksum's masked products (declared in int64_ops)",
    ),
    ProgramSpec(
        name="plan_fingerprint", module="ksched_tpu_torch.graph.device_export",
        kind="audit", tracer="trace_plan_fingerprint", scatters=(),
        int64_ops=(("__and__", 22), ("__or__", 2), ("add", 2), ("arange", 2),
                   ("cpu", 1), ("mul", 12), ("stack", 1), ("sum", 10), ("to", 10)),
        host_reads=HostReadBudget(once=1),
        hash_stability=HashStability("pow2-bucket", same=_GRAPH_SAME, cross=_GRAPH_CROSS),
        collectives=CollectiveBudget(forbidden=_ALL_COLLECTIVES),
        notes="the mirror's ten plan tensors (DeviceResidentState."
        "plan_fingerprints, single-device mode)",
    ),
    ProgramSpec(
        name="buffer_fingerprint", module="ksched_tpu_torch.runtime.integrity",
        kind="audit", tracer="trace_buffer_fingerprint", scatters=(),
        int64_ops=(("__and__", 3), ("__or__", 1), ("add", 1), ("arange", 1),
                   ("mul", 2), ("sum", 1), ("to", 1)),
        host_reads=HostReadBudget(once=0),
        hash_stability=HashStability("pow2-bucket", same=_GRAPH_SAME, cross=_GRAPH_CROSS),
        collectives=CollectiveBudget(forbidden=_ALL_COLLECTIVES),
        notes="single-buffer checksum (the warm-flow audit's _device_fp1)",
    ),
    ProgramSpec(
        name="sharded_plan_fingerprint",
        module="ksched_tpu_torch.parallel.sharded_solver", kind="audit",
        tracer="trace_sharded_plan_fingerprint", trace=call(), ranks=2,
        scatters=(), host_reads=HostReadBudget(once=1),
        int64_ops=(("__and__", 23), ("__getitem__", 6), ("__or__", 8), ("add", 14),
                   ("arange", 8), ("clone", 1), ("cpu", 1), ("mul", 18),
                   ("reshape", 2), ("stack", 2), ("sum", 10), ("to", 10)),
        collectives=CollectiveBudget(
            total=(("psum", 1),), forbidden=("pmin", "pmax", "all_gather"),
        ),
        notes="per-shard partials psum'd to one comparable checksum: ONE "
        "psum of the six entry tensors' stacked partials (the JAX program "
        "psums them one by one, 6)",
    ),
    # -- chaos programs --------------------------------------------------
    ProgramSpec(
        name="corrupt_flip", module="ksched_tpu_torch.runtime.integrity",
        kind="chaos", tracer="trace_corrupt_flip", scatter_policy="chaos-only",
        scatters=(("setitem", 1),), host_reads=HostReadBudget(once=0),
        notes="the seeded poison write: flips one bit of one element to "
        "prove the fingerprint audit detects it; never run in production",
    ),
)

PROGRAMS: Dict[str, ProgramSpec] = {s.name: s for s in _SPECS}
if len(PROGRAMS) != len(_SPECS):  # duplicate name = table bug
    raise RuntimeError("duplicate program name in registry")

#: annotation names valid at sites (variant specs share a site)
SITE_NAMES: frozenset = frozenset(s.site_name for s in _SPECS)

#: the hand-written kernels (ops/csrc/) and their resources on the H100
#: (NVIDIA H100 80GB HBM3, torch 2.11.0+cu128, CUDA 12.8, nvcc -O3 for
#: sm_90a): B1 and B2 sit at the 64-register cap of 1,024 threads and
#: spill (local bytes); B3 does not
KERNELS: Dict[str, KernelSpec] = {
    k.name: k for k in (
        KernelSpec(
            name="transport", source="ksched_tpu_torch/ops/csrc/transport.cu",
            replaces="ksched_tpu/ops/transport_pallas.py:59", program="layered_solve",
            resources=(
                ("shared+probe", 64, 24, 704, 1024),
                ("shared", 64, 8, 672, 1024),
                ("global+probe", 64, 40, 704, 1024),
                ("global", 64, 56, 672, 1024),
            ),
        ),
        KernelSpec(
            name="transport_tiered",
            source="ksched_tpu_torch/ops/csrc/transport_tiered.cu",
            replaces="ksched_tpu/ops/transport_pallas.py:233", program="layered_solve",
            resources=(
                ("shared+probe", 64, 8, 704, 1024),
                ("shared", 64, 16, 672, 1024),
                ("global+probe", 64, 56, 704, 1024),
                ("global", 64, 56, 672, 1024),
            ),
        ),
        KernelSpec(
            name="mcmf", source="ksched_tpu_torch/ops/csrc/mcmf.cu",
            replaces="ksched_tpu/ops/mcmf_pallas.py:108", program="mega_solve",
            resources=(
                ("solve", 62, 0, 260, 1024),
                ("solve+ring", 56, 0, 284, 1024),
                ("barrier_probe", 10, 0, 4, 1024),
            ),
        ),
    )
}

#: int32 [R * L] tables of slack the measured mega live set may exceed
#: `mega_fits`' reckoning by: the wrapper's int64 partner index (two
#: words an entry), its int32 copy and the bool heads, alive around the
#: launch (23.75 tables measured at R = 128 against 21 reckoned)
MEGA_LIVE_SLACK_TABLES = 4


def registered_names() -> frozenset:
    return frozenset(PROGRAMS)


def donating_programs() -> Tuple[ProgramSpec, ...]:
    return tuple(s for s in _SPECS if s.donation is not None)


def specs_for_site(site_name: str) -> Tuple[ProgramSpec, ...]:
    return tuple(s for s in _SPECS if s.site_name == site_name)


# ---------------------------------------------------------------------------
# ownership declarations
# ---------------------------------------------------------------------------

#: module -> names it declared (owners and consumers both appear here)
DECLARED: Dict[str, Set[str]] = {}


def declare_programs(module: str, *names: str) -> None:
    """Registration hook for program-owning (and consuming) modules.

    Validates eagerly: an unregistered name raises at the owning
    module's import, so a typo can never silently declare nothing."""
    unknown = [n for n in names if n not in PROGRAMS]
    if unknown:
        raise ValueError(
            f"{module} declares unregistered program(s) {unknown}; "
            "register them in ksched_tpu_torch/analysis/program_registry.py"
        )
    DECLARED.setdefault(module, set()).update(names)
