"""Level-3 enforcement engine: one code path checks every registered
program's contract spec (analysis/program_registry.py).

The JAX package's engine interprets `ProgramSpec` fields over abstract
traces and compiled executables; this one interprets the port's specs
over recordings (analysis/op_contracts.py):

- **contracts**: record the program at the default call and every extra
  call; no float64 anywhere, the int64 calls as declared, one aten
  scalar read for each scalar read, the scatter policy (deterministic:
  pinned kinds and counts, no float accumulation, non-accumulating
  tensor-index writes only as declared permutations; scoped-exempt and
  chaos-only non-vacuous), the gather and host-read budgets, the
  collective budget.
- **hash_pin**: the telemetry-off folded trace hash equals the pin.
- **stability**: every `same` pair records the same trace, every
  `cross` pair a different one.
- **telemetry_knob**: knob 0 is the default, knob 512 a different
  program that still holds the structural contracts.
- **distinct**, **declared**: as in the JAX package.
- **inplace**: the torch meaning of a donation (see DonationSpec).
- **vmem_gate**: `mega_fits`' reckoning against the CUDA sources.

Card checks (CUDA only): **kernel_resources** (registers, spill, shared
bytes, max threads against `KERNELS`' pins), **kernel_route** (one
launch, the same torch calls for two solves of different superstep
counts, no loop iteration), **grid_gate**, **live_set** and
**inplace_memory**.

Every check raises `ContractError` (an AssertionError) naming the
program.
"""

from __future__ import annotations

import importlib
import inspect
from typing import Dict, Optional, Tuple

from .program_registry import (
    DECLARED,
    KERNELS,
    MEGA_LIVE_SLACK_TABLES,
    PROGRAMS,
    ProgramSpec,
    TraceCall,
)


class ContractError(AssertionError):
    """A registered program violates its declared contract."""


# ---------------------------------------------------------------------------
# recording (memoized: the parametrized suite revisits default calls)
# ---------------------------------------------------------------------------

_TRACE_CACHE: Dict[Tuple, object] = {}


def clear_cache() -> None:
    _TRACE_CACHE.clear()


def _contracts():
    from . import op_contracts

    return op_contracts


def resolve_tracer(name: str):
    fn = getattr(_contracts(), name, None)
    if fn is None or not callable(fn):
        raise ContractError(f"tracer {name!r} does not exist in analysis/op_contracts.py")
    return fn


def trace_call(spec: ProgramSpec, tc: Optional[TraceCall] = None, device="cpu",
               **overrides):
    """The Recording of `spec`'s tracer at `tc` (default: its registered
    call) on `device`, with kwarg overrides (the telemetry knob)."""
    tc = tc or spec.trace
    key = (spec.tracer, tc, tuple(sorted(overrides.items())), str(device))
    rec = _TRACE_CACHE.get(key)
    if rec is None:
        kwargs = tc.as_kwargs()
        kwargs.update(overrides)
        rec = resolve_tracer(spec.tracer)(*tc.args, device=device, **kwargs)
        _TRACE_CACHE[key] = rec
    return rec


def report(spec: ProgramSpec, tc: Optional[TraceCall] = None, device="cpu", **overrides):
    return trace_call(spec, tc, device, **overrides).report()


def program_hash(spec: ProgramSpec, tc: Optional[TraceCall] = None, device="cpu",
                 **overrides) -> str:
    return trace_call(spec, tc, device, **overrides).trace_hash()


# ---------------------------------------------------------------------------
# contract checks
# ---------------------------------------------------------------------------


def _fail(spec: ProgramSpec, msg: str):
    raise ContractError(f"program {spec.name!r}: {msg}")


def _where(tc: TraceCall, device) -> str:
    return f"at {tc.args}{dict(tc.kwargs) or ''} on {device}"


def _check_one(spec: ProgramSpec, tc: TraceCall, device="cpu", exact: bool = True,
               **overrides):
    rep = report(spec, tc, device, **overrides)
    where = _where(tc, device)
    if rep.double_values:
        _fail(spec, f"float64 values {where}: {sorted(set(rep.double_values))}")
    if exact and dict(rep.wide) != dict(spec.int64_ops):
        _fail(spec, f"int64 calls {where}: recorded {dict(sorted(rep.wide.items()))}, "
                    f"declared {dict(spec.int64_ops)} — a 64-bit value, or an "
                    "undeclared index operand")
    if rep.scalar_reads != rep.aten_scalar_reads:
        _fail(spec, f"{rep.scalar_reads} scalar reads at the function level but "
                    f"{rep.aten_scalar_reads} aten._local_scalar_dense {where}")
    _check_scatters(spec, rep, where, exact)
    _check_gathers(spec, rep, where, exact)
    _check_reads(spec, rep, where, exact)
    if spec.collectives is not None:
        _check_collectives(spec, rep, where, exact)


def _check_scatters(spec, rep, where, exact):
    if rep.float_accumulations:
        _fail(spec, f"float scatter accumulation {where}: {rep.float_accumulations} "
                    "(not deterministic on CUDA)")
    if spec.scatter_policy == "deterministic":
        undeclared = sorted(k for k in rep.nonaccumulating if k not in spec.permutation)
        if undeclared:
            _fail(spec, f"non-accumulating tensor-index writes {undeclared} {where} "
                        "are not declared permutations (colliding writes are not "
                        "deterministic on CUDA)")
    elif not sum(rep.scatters.values()):
        _fail(spec, f"scatter policy {spec.scatter_policy!r} is VACUOUS {where}: "
                    "the program never scatters — drop the exemption")
    if exact and spec.scatters is not None and dict(rep.scatters) != dict(spec.scatters):
        _fail(spec, f"scatter calls {where}: recorded {dict(sorted(rep.scatters.items()))}, "
                    f"pinned {dict(spec.scatters)}")


def _check_gathers(spec, rep, where, exact):
    g = spec.gathers
    if g is None:
        return
    if exact and g.hbm_loop is not None and rep.gathers_loop != g.hbm_loop:
        _fail(spec, f"gathers in a loop iteration {where}: expected {g.hbm_loop}, "
                    f"recorded {rep.gathers_loop}")
    if exact and g.oneshot is not None and rep.gathers_oneshot != g.oneshot:
        _fail(spec, f"gathers outside the loops {where}: expected {g.oneshot}, "
                    f"recorded {rep.gathers_oneshot}")
    if g.hbm_loop_min is not None and rep.gathers_loop < g.hbm_loop_min:
        _fail(spec, f"gathers in a superstep {where}: expected >= {g.hbm_loop_min}, "
                    f"recorded {rep.gathers_loop} — the gather classifier has rotted "
                    "(this program gathers every superstep by design)")


def _check_reads(spec, rep, where, exact):
    hr = spec.host_reads
    if hr is None:
        return
    for kind in ("superstep", "sweep"):
        want = getattr(hr, kind)
        if want is None:
            continue
        got = rep.reads_by_kind.get(kind)
        if got is None:
            if exact:
                _fail(spec, f"no {kind} recorded {where}: the host-read pin is vacuous")
            continue
        if got != {want}:
            _fail(spec, f"host reads a {kind} {where}: expected {want}, recorded "
                        f"{sorted(got)} — a device-to-host sync in the loop")
    if exact and hr.once is not None and rep.reads_once != hr.once:
        _fail(spec, f"host reads outside the loops {where}: expected {hr.once}, "
                    f"recorded {rep.reads_once}")


def _check_collectives(spec, rep, where, exact=True):
    budget = spec.collectives
    if exact:  # exact counts pin the TELEMETRY-OFF program only
        for kind, want in budget.loop:
            if rep.collectives_loop.get(kind, 0) != want:
                _fail(spec, f"{kind} a loop iteration {where}: expected {want}, "
                            f"recorded {rep.collectives_loop.get(kind, 0)}")
        for kind, want in budget.total:
            if rep.collectives_total.get(kind, 0) != want:
                _fail(spec, f"total {kind} {where}: expected {want}, recorded "
                            f"{rep.collectives_total.get(kind, 0)}")
    for kind in budget.forbidden:
        if rep.collectives_total.get(kind, 0):
            _fail(spec, f"forbidden collective {kind} appears "
                        f"{rep.collectives_total[kind]}x {where}")


def check_contracts(spec: ProgramSpec, device="cpu"):
    """Dtype / scatter / gather / host-read / collective contracts at
    the default call (exact pins) and every extra call (the rules)."""
    _check_one(spec, spec.trace, device)
    for tc in spec.extra:
        _check_one(spec, tc, device, exact=False)


def check_default_call(spec: ProgramSpec, device="cpu"):
    """The contracts at the default call alone (the card phase's
    budgeted form of `check_contracts`)."""
    _check_one(spec, spec.trace, device)


def check_hash_pin(spec: ProgramSpec, device="cpu"):
    if spec.telemetry_off_hash is None:
        return
    got = program_hash(spec, device=device)
    if got != spec.telemetry_off_hash:
        _fail(spec, f"telemetry-off trace hash {got} on {device} != pinned "
                    f"{spec.telemetry_off_hash} — the recorded program CHANGED. "
                    "If intentional, re-derive and re-pin in program_registry.py")


def check_hash_stability(spec: ProgramSpec, device="cpu"):
    hs = spec.hash_stability
    if hs is None or hs.kind == "exempt":
        return
    for a, b in hs.same:
        ha, hb = program_hash(spec, a, device), program_hash(spec, b, device)
        if ha != hb:
            _fail(spec, f"{hs.kind} hash split inside one bucket: "
                        f"{a.args}{dict(a.kwargs) or ''}={ha} vs "
                        f"{b.args}{dict(b.kwargs) or ''}={hb} — a raw size "
                        "leaked into a tensor shape")
    for a, b in hs.cross:
        ha, hb = program_hash(spec, a, device), program_hash(spec, b, device)
        if ha == hb:
            _fail(spec, f"cross-bucket calls {a.args} and {b.args} collide "
                        f"({ha}) — the stability check is vacuous")


def check_telemetry_knob(spec: ProgramSpec, device="cpu"):
    if spec.telemetry_knob is None:
        return
    knob = spec.telemetry_knob
    params = inspect.signature(resolve_tracer(spec.tracer)).parameters
    if knob not in params or params[knob].default != 0:
        _fail(spec, f"tracer {spec.tracer!r} does not default {knob}=0 — "
                    "the pinned hash would not be the telemetry-OFF program")
    off = program_hash(spec, device=device)
    if program_hash(spec, device=device, **{knob: 0}) != off:
        _fail(spec, f"{knob}=0 records a different program than the default")
    if program_hash(spec, device=device, **{knob: 512}) == off:
        _fail(spec, f"{knob}=512 records the SAME program as {knob}=0 — "
                    "the telemetry knob is dead")
    _check_one(spec, spec.trace, device, exact=False, **{knob: 512})
    if spec.collectives is not None and spec.collectives.knob_adds_loop_psum:
        loop_off = report(spec, device=device).collectives_loop
        loop_on = report(spec, device=device, **{knob: 512}).collectives_loop
        if loop_on.get("psum", 0) <= loop_off.get("psum", 0):
            _fail(spec, "telemetry-ON record adds no loop psums (the soltel "
                        "counters ride the superstep reductions)")
    hs = spec.hash_stability
    if hs is not None and hs.kind != "exempt" and hs.same:
        a, b = hs.same[0]
        ha = program_hash(spec, a, device, **{knob: 512})
        hb = program_hash(spec, b, device, **{knob: 512})
        if ha != hb:
            _fail(spec, f"telemetry-ON record splits the {hs.kind} hash "
                        f"({a.args} vs {b.args}) — the knob leaks a raw size")


def check_distinct(spec: ProgramSpec, device="cpu"):
    mine = program_hash(spec, device=device)
    for other_name in spec.distinct_from:
        if mine == program_hash(PROGRAMS[other_name], device=device):
            _fail(spec, f"default trace collides with {other_name!r} — the "
                        "variant is vacuous (its distinguishing input is dead)")


def check_declared(spec: ProgramSpec, device="cpu"):
    """The owning module's `declare_programs` hook names this spec."""
    importlib.import_module(spec.module)
    declared = DECLARED.get(spec.module, set())
    if spec.name not in declared:
        _fail(spec, f"owning module {spec.module} does not declare_programs() "
                    f"it (declared: {sorted(declared) or 'nothing'})")


def _donated(spec: ProgramSpec, device):
    builder = getattr(_contracts(), spec.donation.builder, None)
    if builder is None:
        _fail(spec, f"in-place builder {spec.donation.builder!r} missing from "
                    "analysis/op_contracts.py")
    return builder


def check_inplace(spec: ProgramSpec, device="cpu"):
    """Every declared buffer is updated in place: the call returns the
    argument itself (same storage) and its version counter moved."""
    if spec.donation is None:
        return
    fn, args, _new = _donated(spec, device)(device=device)
    before = {i: (args[i].data_ptr(), args[i]._version) for i in spec.donation.donate_argnums}
    out = fn(*args)
    for i, (ptr, version) in before.items():
        got = out[i]
        if got.data_ptr() != ptr:
            _fail(spec, f"declared in-place buffer {i} came back as a NEW tensor on "
                        f"{device} — an out-of-place copy (twice the memory)")
        if args[i]._version == version:
            _fail(spec, f"declared in-place buffer {i} was not written on {device}")


def check_vmem_gate(spec: ProgramSpec, device="cpu"):
    """Mega only: `mega_fits`' constants equal the CUDA sources', and its
    reckoning equals the one those constants give, to the word, with
    the ring off and on (on: exactly one table more)."""
    if not spec.vmem_gate:
        return
    from ..obs.soltel import SOLTEL_WIDTH
    from ..ops import mcmf

    oc = _contracts()
    const = oc.cuda_live_set_constants()
    python = {"scratch_tables": mcmf.MCMF_SCRATCH_TABLES,
              "head_words": mcmf.MCMF_HEAD_WORDS,
              "block_words": mcmf.MCMF_BLOCK_WORDS, "warps": mcmf.MCMF_WARPS,
              "input_tables": mcmf.MEGA_LIVE_TABLES - mcmf.MCMF_SCRATCH_TABLES - 1}
    if python != const:
        _fail(spec, f"ops/mcmf.py's live-set constants {python} drifted from the "
                    f"CUDA sources' {const}")
    for E in (1, 511, 512, 4097, 100_000):
        words = {tel: oc.reckoned_words(E, tel, const) for tel in (False, True)}
        padded = mcmf.mega_entry_rows(E) * mcmf.MEGA_LANES
        if words[True] - words[False] != padded:
            _fail(spec, f"the ring adds {words[True] - words[False]} words at E={E}, "
                        f"not one table ({padded})")
        for tel, w in words.items():
            if not mcmf.mega_fits(E, budget_bytes=4 * w, telemetry=tel) or \
                    mcmf.mega_fits(E, budget_bytes=4 * w - 1, telemetry=tel):
                _fail(spec, f"mega_fits at E={E} (telemetry {tel}) does not reckon "
                            f"{w} words, the live set of the CUDA sources")
        rows = mcmf.mega_entry_rows(E)
        ring = mcmf.mega_telemetry_cap(rows, mcmf.MEGA_LANES, 1 << 30) * SOLTEL_WIDTH
        if ring > padded:
            _fail(spec, f"the ring at E={E} holds {ring} words, over one table")


CHECKS = {
    "contracts": check_contracts,
    "hash_pin": check_hash_pin,
    "stability": check_hash_stability,
    "telemetry_knob": check_telemetry_knob,
    "distinct": check_distinct,
    "inplace": check_inplace,
    "vmem_gate": check_vmem_gate,
    "declared": check_declared,
}


def applicable_checks(spec: ProgramSpec) -> Tuple[str, ...]:
    """Which CHECKS are non-trivial for this spec (the suite
    parametrizes over exactly these)."""
    names = ["contracts", "declared"]
    if spec.telemetry_off_hash is not None:
        names.append("hash_pin")
    hs = spec.hash_stability
    if hs is not None and hs.kind != "exempt" and (hs.same or hs.cross):
        names.append("stability")
    if spec.telemetry_knob is not None:
        names.append("telemetry_knob")
    if spec.distinct_from:
        names.append("distinct")
    if spec.donation is not None:
        names.append("inplace")
    if spec.vmem_gate:
        names.append("vmem_gate")
    return tuple(names)


def needs_ranks(spec: ProgramSpec, check: str) -> bool:
    """Whether `check` of `spec` runs on the ranks of a process group."""
    return spec.ranks > 0 and check != "declared"


def run_all(spec: ProgramSpec, device="cpu"):
    for name in applicable_checks(spec):
        CHECKS[name](spec, device)


# ---------------------------------------------------------------------------
# card checks
# ---------------------------------------------------------------------------


def _kernel_attrs(name: str) -> dict:
    from ..ops import mcmf, transport

    return mcmf.kernel_attrs() if name == "mcmf" else transport.kernel_attrs(name)


def check_kernel_resources(spec: ProgramSpec, device="cuda") -> dict:
    """Each kernel's instantiations against their pinned resources;
    returns {kernel: {variant: attrs}} for printing."""
    got = {}
    for name in spec.kernels:
        attrs = _kernel_attrs(name)
        got[name] = attrs
        pins = {p[0]: p[1:] for p in KERNELS[name].resources}
        if set(pins) != set(attrs):
            _fail(spec, f"kernel {name}'s pinned variants {sorted(pins)} != its "
                        f"library's {sorted(attrs)}: {attrs}")
        for variant, a in attrs.items():
            have = (a["registers"], a["local_bytes"], a["shared_bytes"], a["max_threads"])
            if have != tuple(pins[variant]):
                _fail(spec, f"kernel {name} {variant}: registers, local, shared, max "
                            f"threads {have} != pinned {tuple(pins[variant])} — "
                            "re-pin in program_registry.KERNELS on purpose")
    return got


def _steps_of(out) -> int:
    # mcmf_loop: (flow, steps, ...); transport_fori: (y, pm, steps, ...)
    return int(out[1]) if out[0].dim() == 1 else int(out[2])


def check_kernel_route(spec: ProgramSpec, device="cuda") -> dict:
    """The launching route: one launch of the spec's kernel a solve,
    no loop iteration on the host, and the same torch calls for solves
    of different superstep counts (zero torch ops a superstep)."""
    if spec.kernel_tracer is None:
        return {}
    out = {}
    variants = [dict()] + ([dict(tiered=True)] if "transport_tiered" in spec.kernels else [])
    for kw in variants:
        tracer = resolve_tracer(spec.kernel_tracer)
        tracer(*spec.trace.args, seed=0, device=device, **kw)  # loads and sizes
        recs = [tracer(*spec.trace.args, seed=s, device=device, **kw) for s in (0, 1)]
        kernel = "transport_tiered" if kw.get("tiered") else spec.kernels[0]
        steps = [_steps_of(r.outputs) for r in recs]
        ops = [r.report().ops for r in recs]
        for r in recs:
            if r.launches.get(kernel) != 1:
                _fail(spec, f"{kernel} launched {r.launches} times for one solve")
            if r.report().loop_iterations:
                _fail(spec, f"the {kernel} route iterates on the host: "
                            f"{dict(r.report().loop_iterations)}")
        if steps[0] == steps[1]:
            _fail(spec, f"the two {kernel} route solves take the same {steps[0]} "
                        "supersteps: the op-count check is vacuous")
        per_step = (ops[1] - ops[0]) / (steps[1] - steps[0])
        if per_step != spec.gathers.kernel:
            _fail(spec, f"the {kernel} route records {ops} torch calls for "
                        f"{steps} supersteps: {per_step} a superstep on the host, "
                        f"not {spec.gathers.kernel}")
        out[kernel] = {"supersteps": steps, "ops": ops[0]}
    return out


def check_grid_gate(spec: ProgramSpec, device="cuda") -> dict:
    """At every size `mega_fits` admits, `mcmf_grid` asks for no more
    blocks than can be co-resident; the largest admitted size's
    cooperative launch is accepted by the card."""
    from ..ops import mcmf

    sms, per_sm = mcmf.grid_capacity(device)
    lo, hi = 1, 1 << 26
    while lo < hi:  # the largest admitted entry count
        mid = (lo + hi + 1) // 2
        lo, hi = (mid, hi) if mcmf.mega_fits(mid) else (lo, mid - 1)
    largest = lo
    worst = 0
    for E in sorted({1, 512, 4096, 65_536, largest // 2, largest}):
        padded = mcmf.mega_entry_rows(E) * mcmf.MEGA_LANES
        blocks, _chunk = mcmf.mcmf_grid(padded, sms, per_sm)
        worst = max(worst, blocks)
        if blocks > sms * per_sm:
            _fail(spec, f"mcmf_grid asks {blocks} blocks at E={E}, {sms} SMs x "
                        f"{per_sm} co-resident")
    args, R, L = _contracts().mega_trivial_args(largest, device)
    before = mcmf.mcmf_loop.launches
    res = mcmf.mcmf_loop(*args, R, L, max_supersteps=1)
    if mcmf.mcmf_loop.launches != before + 1 or not bool(res[2]):
        _fail(spec, f"the launch at the largest admitted E={largest} did not converge "
                    "its zero-supply problem")
    return {"largest_entries": largest, "largest_blocks": mcmf.mcmf_loop.last_blocks,
            "sms": sms, "blocks_per_sm": per_sm, "most_blocks": worst}


def check_live_set(spec: ProgramSpec, device="cuda", n: int = 4096, m: int = 32_768) -> dict:
    """The card's memory growth over one mega solve (its inputs on the
    card first) lies within `mega_fits`' reckoning plus
    MEGA_LIVE_SLACK_TABLES tables, and above the kernel's own flow and
    scratch; the kernel's scratch count equals the wrapper's at three
    sizes."""
    import torch

    from ..ops import mcmf

    lib = mcmf.load("mcmf", mcmf._SIGNATURES)
    for E, blocks in ((512, 1), (131_072, 128), (499_712, 132)):
        if int(lib.ksched_mcmf_scratch_words(E, blocks)) != mcmf.mcmf_scratch_words(E, blocks):
            _fail(spec, f"the kernel's scratch words at E={E}, {blocks} blocks != "
                        "mcmf_scratch_words'")
    oc = _contracts()
    args, R, L = oc._mega_args(n, m, 0, device)
    E = R * L
    torch.cuda.synchronize(device)
    base = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    out = mcmf.mcmf_loop(*args, R, L, max_supersteps=4096)
    torch.cuda.synchronize(device)
    growth = torch.cuda.max_memory_allocated(device) - base
    del out
    reckoned = 4 * oc.reckoned_words(E, False, oc.cuda_live_set_constants())
    slack = 4 * MEGA_LIVE_SLACK_TABLES * E
    blocks = mcmf.mcmf_loop.last_blocks
    own = 4 * (E + mcmf.mcmf_scratch_words(E, blocks))
    if not own <= growth <= reckoned + slack:
        _fail(spec, f"measured live set {growth} B at E={E} outside [{own}, "
                    f"{reckoned} + {slack}] B (the kernel's flow and scratch; the "
                    "reckoning plus the wrapper's slack)")
    return {"entries": E, "measured_bytes": growth, "reckoned_bytes": reckoned,
            "slack_bytes": slack, "tables": growth / (4 * E)}


def check_inplace_memory(spec: ProgramSpec, device="cuda") -> dict:
    """The apply's peak memory growth, less its declared new outputs,
    stays below the smallest declared in-place buffer."""
    import torch

    if spec.donation is None:
        return {}
    builder = _donated(spec, device)
    kw = dict(n_raw=1 << 16, m_raw=1 << 20)
    fn, args, new = builder(device=device, **kw)
    torch.cuda.synchronize(device)
    base = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    out = fn(*args)
    torch.cuda.synchronize(device)
    growth = torch.cuda.max_memory_allocated(device) - base
    fresh = sum(out[i].nbytes for i in new)
    smallest = min(args[i].nbytes for i in spec.donation.donate_argnums)
    if growth - fresh >= smallest:
        _fail(spec, f"peak growth {growth} B less the new outputs' {fresh} B is not "
                    f"below the smallest in-place buffer ({smallest} B): an "
                    "out-of-place copy")
    return {"growth_bytes": growth, "new_output_bytes": fresh, "smallest_buffer": smallest}


CARD_CHECKS = {
    "kernel_resources": check_kernel_resources,
    "kernel_route": check_kernel_route,
    "grid_gate": check_grid_gate,
    "live_set": check_live_set,
    "inplace_memory": check_inplace_memory,
}


def applicable_card_checks(spec: ProgramSpec) -> Tuple[str, ...]:
    names = []
    if spec.kernels:
        names.append("kernel_resources")
    if spec.kernel_tracer is not None:
        names.append("kernel_route")
    if spec.vmem_gate:
        names += ["grid_gate", "live_set"]
    if spec.donation is not None and spec.ranks == 0:
        names.append("inplace_memory")
    return tuple(names)


# ---------------------------------------------------------------------------
# the sharded programs' checks on the ranks of a group
# ---------------------------------------------------------------------------


def rank_checks(rank: int, world: int, payload) -> dict:
    """Run on every rank of a process group (parallel/launch.run_ranks):
    each (program, check) in `payload` (None: every one that needs
    ranks) on a ShardMesh over the group, in one order on every rank so
    that their collectives pair up. Returns {"program/check": None or
    the ContractError's text}."""
    from ..parallel.mesh import ShardMesh

    oc = _contracts()
    device = "cpu"
    pairs = payload or [(s.name, c) for s in PROGRAMS.values()
                        for c in applicable_checks(s) if needs_ranks(s, c)]
    oc.MESH = ShardMesh(device=device)
    out = {}
    try:
        for name, check in pairs:
            try:
                CHECKS[check](PROGRAMS[name], device)
                out[f"{name}/{check}"] = None
            except ContractError as e:
                out[f"{name}/{check}"] = str(e)
    finally:
        oc.MESH = None
    return out
