"""The general-graph MCMF solve as one CUDA kernel on Hopper.

`mcmf_loop` (csrc/mcmf.cu) replaces ksched_tpu/ops/mcmf_pallas.py
`_mcmf_kernel` (the `pl.pallas_call` in `mcmf_loop_pallas`): the whole
cost-scaling push-relabel solve of solver/csr_solver.py — Bellman-Ford
price tightening, a saturate, the eps phases and every synchronous
push/relabel superstep — in one launch, over the padded [R * L] entry
tables of a MegaPlan (solver/mega_solver.py). It returns what the
Pallas kernel returns, bit for bit: the flow at each arc's forward
entry, the superstep count, converged and p_overflow. `mcmf_loop_plain`
is the same solve in plain PyTorch over the same tables; a CPU tensor
runs it, a CUDA tensor launches the kernel or raises. With
`telemetry_cap` > 0 both also return the Pallas kernel's fifth output,
the int32 [cap, 8] soltel ring (obs/soltel.py), the cap clamped as the
JAX package clamps it (`mega_telemetry_cap`).

The gathers of cap, cost, supply and flow0 into entry order and the
final flow[fwd_pos] are torch ops around the launch, as the JAX wrapper
leaves them to XLA around the pallas_call. `e_he` is accepted for the
JAX signature's sake and not read: a segment ends where the next one
starts (`e_hs`), as build_mega_plan builds it.

The kernel is one cooperative grid: `mcmf_grid` sizes it (one block of
1024 threads per SM at most, as many as the entries need at 32 per
warp), and every superstep is three passes over the entries, each
closed by a grid barrier. What bounds it on this card: those barriers
and each pass's chain of dependent L2 reads and atomics, not bytes or
arithmetic (PERF.md). Its live set, the 21 int32 [R * L] tables of
`MEGA_LIVE_TABLES` and a few words per block, stays in global memory,
L2-resident below `MEGA_BUDGET_BYTES`; that is the card's fits gate in
place of the TPU's VMEM gate (`mega_fits_vmem`).
"""

from __future__ import annotations

import ctypes

import torch

from .build import KernelError, check_tensor, load, raise_on

_I32 = torch.int32
_BIG = 1 << 30
_BIG_D = 1 << 28
_P_GUARD = 1 << 30

#: lane width of the entry tiling ([R, L] row-major), as in the JAX package
MEGA_LANES = 512
#: the kernel's scratch tables of R * L words (csrc/mcmf.cu kScratchTables)
MCMF_SCRATCH_TABLES = 11
#: its scratch header words (kHeadWords: the barrier counter, the
#: decision flag, the end flags and two buffers of the ring's six
#: counters) and per-block slots (a tail and a head flag per block)
MCMF_HEAD_WORDS = 15
MCMF_BLOCK_WORDS = 2
#: int32 [R * L] tables the kernel keeps in global memory during a
#: solve: its 9 inputs, the flow it writes and its scratch tables
MEGA_LIVE_TABLES = 10 + MCMF_SCRATCH_TABLES
#: warps per block (csrc/mcmf.cu kWarps: 1024 threads)
MCMF_WARPS = 32
#: the kernel's tables stay resident in the H100's 50 MB L2 when they
#: fit in 40 MiB, leaving a fifth of it to the rest of the round's data
MEGA_BUDGET_BYTES = 40 << 20

_VP, _CI = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "ksched_mcmf_solve": ([_VP] * 13 + [_CI] * 8 + [_VP], _CI),
    "ksched_mcmf_scratch_words": ([_CI, _CI], ctypes.c_longlong),
    "ksched_mcmf_blocks_per_sm": ([], _CI),
    "ksched_mcmf_barrier_probe": ([_VP, _CI, _CI, _VP], _CI),
}


def mega_entry_rows(num_entries: int, lanes: int = MEGA_LANES) -> int:
    """Block rows R for a 2M-entry table tiled [R, lanes]."""
    return max(1, -(-num_entries // lanes))


def mega_telemetry_cap(R: int, L: int, cap: int) -> int:
    """The ring length for a requested capacity `cap` on an [R, L] entry
    tiling: at most one [R, L] tile of int32, as the JAX package clamps
    it to one VMEM tile (mcmf_pallas.py mega_telemetry_cap), so the two
    packages' rings have the same length."""
    from ..obs.soltel import SOLTEL_WIDTH

    return max(1, min(int(cap), (R * L) // SOLTEL_WIDTH))


def mcmf_grid(num_entries: int, sm_count: int, blocks_per_sm: int) -> tuple:
    """(blocks, chunk) of the kernel's cooperative grid over
    `num_entries` entries: each warp owns `chunk` consecutive entries (a
    multiple of 32), each block `MCMF_WARPS` chunks. One 32-entry step
    per warp while `sm_count * blocks_per_sm` co-resident blocks hold
    the entries that way; past that, as few steps per warp as that
    capacity allows, and only the blocks those steps need."""
    per_step = MCMF_WARPS * 32  # a block's entries per 32-entry step
    capacity = sm_count * blocks_per_sm
    if capacity < 1:
        raise ValueError(f"no co-resident blocks ({sm_count} SMs x {blocks_per_sm})")
    steps = max(1, -(-num_entries // (capacity * per_step)))
    blocks = max(1, -(-num_entries // (steps * per_step)))
    return blocks, 32 * steps


def mcmf_scratch_words(num_entries: int, blocks: int) -> int:
    """int32 words of the kernel's scratch (csrc/mcmf.cu
    ksched_mcmf_scratch_words)."""
    return (MCMF_SCRATCH_TABLES * num_entries + MCMF_HEAD_WORDS
            + MCMF_BLOCK_WORDS * blocks)


def mega_fits(num_entries: int, lanes: int = MEGA_LANES,
              budget_bytes: int = MEGA_BUDGET_BYTES,
              telemetry: bool = False) -> bool:
    """Whether the kernel's live set for `num_entries` residual entries
    (its inputs, flow and scratch at the most blocks its grid can take,
    and with `telemetry` the soltel ring, at most one more table: see
    `mega_telemetry_cap`) stays within `budget_bytes`."""
    padded = mega_entry_rows(num_entries, lanes) * lanes
    most_blocks = -(-padded // (MCMF_WARPS * 32))
    words = ((MEGA_LIVE_TABLES - MCMF_SCRATCH_TABLES + telemetry) * padded
             + mcmf_scratch_words(padded, most_blocks))
    return 4 * words <= budget_bytes


def _entry_tables(cap, cost, supply, flow0, e_arc, e_sign, e_src, e_hs,
                  e_prow, e_pcol, L):
    """The per-entry tables of a solve: (sign, cap, signed scaled cost,
    source supply, start flow, segment id, partner, head flags), the
    gathers mcmf_loop_pallas runs before its pallas_call. Entry 0
    always opens a segment."""
    live = e_sign != 0
    arc = e_arc.long().clamp(0, cap.shape[0] - 1)
    src = e_src.long().clamp(0, supply.shape[0] - 1)
    sign = e_sign.to(_I32)
    cap_e = torch.where(live, cap[arc], 0)
    sc = torch.where(live, sign * cost[arc], 0)
    sup = torch.where(live, supply[src], 0)
    f0 = torch.where(live, flow0[arc], 0)
    partner = e_prow.long() * L + e_pcol.long()
    head = e_hs != 0
    head[0] = True
    seg = torch.cumsum(head, 0, dtype=_I32) - 1
    return sign, cap_e, sc, sup, f0, seg, partner, head


def mcmf_loop_plain(cap, cost, supply, flow0, eps_init,
                    e_arc, e_sign, e_src, e_hs, e_he, e_prow, e_pcol, fwd_pos,
                    R: int, L: int, *, alpha: int = 8,
                    max_supersteps: int = 50_000, tighten_sweeps: int = 32,
                    telemetry_cap: int = 0):
    """The kernel's solve in plain PyTorch on the tensors' device: flow
    per entry, price and excess per segment (each segment is one source
    node's entries, and the pad), one host read of "any excess
    positive" per superstep. Same arguments and results as
    `mcmf_loop`."""
    from ..obs import soltel

    sign, cap_e, sc, sup, f, seg, partner, head = _entry_tables(
        cap, cost, supply, flow0, e_arc, e_sign, e_src, e_hs, e_prow, e_pcol, L)
    E = R * L
    seg = seg.long()
    pseg = seg[partner]
    first = torch.nonzero(head).flatten()
    last = torch.cat([first[1:] - 1, first.new_full((1,), E - 1)])
    sup_s = sup[first]
    fwd, bwd = sign > 0, sign < 0

    def seg_sum(v):
        c = torch.cumsum(v, 0, dtype=_I32)
        return c[last] - c[first] + v[first]

    def seg_reduce(v, how):
        return torch.empty_like(sup_s).scatter_reduce_(
            0, seg, v, how, include_self=False)

    def resid(f):
        return torch.where(fwd, cap_e - f, torch.where(bwd, f, 0))

    def excess(f):
        return sup_s - seg_sum(sign * f)

    def saturate(f, p):
        rcf = sign * (sc + p[seg] - p[pseg])
        return torch.where(rcf < 0, cap_e, torch.where(rcf > 0, 0, f))

    # price tightening: synchronous Bellman-Ford over residual reduced costs
    r = resid(f)
    d = torch.where(excess(f) < 0, 0, _BIG_D).to(_I32)
    changed, it = True, 0
    while changed and it < tighten_sweeps:
        best = seg_reduce(torch.where(r > 0, sc + d[pseg], _BIG_D), "amin")
        d2 = torch.clamp(torch.minimum(d, best), min=-_BIG_D)
        changed = bool((d2 != d).any())
        d, it = d2, it + 1
    mcmf_loop_plain.sweeps = it
    p = -torch.clamp(d, max=_BIG_D)
    f = saturate(f, p)

    dev = f.device
    if telemetry_cap:
        telemetry_cap = mega_telemetry_cap(R, L, telemetry_cap)
        tel = soltel.device_ring(telemetry_cap, dev)
    eps, steps, done = int(eps_init), 0, False
    while not done and steps < max_supersteps:
        exc = excess(f)
        if bool((exc > 0).any()):
            r = resid(f)
            pp = p[pseg]
            exc_e = exc[seg]
            r_adm = torch.where((r > 0) & (sc + p[seg] - pp < 0) & (exc_e > 0), r, 0)
            # maximal push: each node's excess over its admissible entries,
            # front to back (the in-segment exclusive prefix sum)
            c = torch.cumsum(r_adm, 0, dtype=_I32)
            excl = c - r_adm - (c[first] - r_adm[first])[seg]
            delta = torch.minimum(torch.clamp(exc_e - excl, min=0), r_adm)
            f = f + sign * (delta - delta[partner])
            # relabel the nodes that were active but pushed nothing
            best = seg_reduce(torch.where(r > 0, pp - sc, -_BIG), "amax")
            relabel = (exc > 0) & (seg_sum(delta) == 0) & (seg_sum(r) > 0)
            p = torch.where(relabel, best - eps, p)
            if telemetry_cap:
                # segments with excess and their excess at the step's
                # start, units pushed, relabels, forward entries at zero
                # residual before the push, admissible entries
                soltel.device_ring_write(tel, steps, soltel.device_row(
                    eps, torch.sum(exc > 0, dtype=_I32),
                    torch.sum(exc.clamp(min=0), dtype=_I32),
                    torch.sum(delta, dtype=_I32), torch.sum(relabel, dtype=_I32),
                    torch.sum(fwd & (r == 0), dtype=_I32),
                    torch.sum(r_adm > 0, dtype=_I32), device=dev))
            steps += 1
        elif eps <= 1:
            done = True
        else:
            f = saturate(f, p)
            eps = max(1, eps // alpha)
    converged = done and int(excess(f).abs().max()) == 0
    p_overflow = int(p.abs().max()) >= _P_GUARD
    out = (f[fwd_pos.long()], torch.tensor(steps, dtype=_I32, device=dev),
           torch.tensor(converged, device=dev),
           torch.tensor(p_overflow, device=dev))
    return out + (tel,) if telemetry_cap else out


#: tightening sweeps of the last call (the kernel runs the same number)
mcmf_loop_plain.sweeps = 0


def mcmf_loop(cap, cost, supply, flow0, eps_init,
              e_arc, e_sign, e_src, e_hs, e_he, e_prow, e_pcol, fwd_pos,
              R: int, L: int, *, alpha: int = 8, max_supersteps: int = 50_000,
              tighten_sweeps: int = 32, telemetry_cap: int = 0):
    """One general-graph MCMF solve: (flow int32[len(fwd_pos)], steps
    int32 scalar, converged bool scalar, p_overflow bool scalar) on
    cap's device, and with telemetry_cap > 0 the int32
    [mega_telemetry_cap(R, L, telemetry_cap), 8] soltel ring.

    cap/cost/flow0 are int32[M] per arc (cost pre-scaled by the node
    count), supply int32[N], eps_init an int; e_* are a MegaPlan's
    int32[R * L] entry tables and fwd_pos each arc's forward entry. A
    CUDA tensor launches the kernel (one cooperative launch, counted in
    `mcmf_loop.launches`; the data_ptr() of its cap, cost and supply in
    `mcmf_loop.last_inputs`, its grid in `mcmf_loop.last_blocks`, the grid
    barriers it ran in the int32 device scalar `mcmf_loop.last_barriers`)
    or raises, also when the card refuses the cooperative launch; a CPU
    tensor runs `mcmf_loop_plain`."""
    kw = dict(alpha=alpha, max_supersteps=max_supersteps,
              tighten_sweeps=tighten_sweeps, telemetry_cap=telemetry_cap)
    args = (cap, cost, supply, flow0, eps_init, e_arc, e_sign, e_src, e_hs,
            e_he, e_prow, e_pcol, fwd_pos, R, L)
    if cap.device.type == "cpu":
        return mcmf_loop_plain(*args, **kw)
    if cap.device.type != "cuda":
        raise ValueError(f"mcmf_loop runs on cuda or cpu, not {cap.device}")
    dev = cap.device
    E = R * L
    M = cap.shape[0]
    for name, t, n in (("cap", cap, M), ("cost", cost, M), ("flow0", flow0, M),
                       ("supply", supply, None), ("fwd_pos", fwd_pos, None),
                       ("e_arc", e_arc, E), ("e_sign", e_sign, E),
                       ("e_src", e_src, E), ("e_hs", e_hs, E),
                       ("e_prow", e_prow, E), ("e_pcol", e_pcol, E)):
        check_tensor(name, t, (n,), dev)
    if M < 1 or supply.shape[0] < 1 or E < 1:
        raise ValueError("mcmf_loop needs at least one arc, node and entry")
    if alpha < 2:
        raise ValueError(f"alpha must be >= 2, got {alpha}")
    if not all(0 <= v < 1 << 31 for v in (max_supersteps, tighten_sweeps,
                                         telemetry_cap)):
        raise ValueError("max_supersteps, tighten_sweeps and telemetry_cap "
                         "must fit int32")
    eps = int(eps_init)
    if not -(1 << 31) <= eps < 1 << 31:
        raise ValueError(f"eps_init {eps} does not fit int32")

    sign, cap_e, sc, sup, f0, seg, partner, head = _entry_tables(
        cap, cost, supply, flow0, e_arc, e_sign, e_src, e_hs, e_prow, e_pcol, L)
    pseg = seg[partner]
    tables = [t.to(_I32).contiguous() for t in
              (sign, cap_e, sc, sup, seg, pseg, partner, head, f0)]
    lib = load("mcmf", _SIGNATURES)
    blocks, chunk = mcmf_grid(E, *grid_capacity(dev))
    f = torch.empty(E, dtype=_I32, device=dev)
    # steps, converged, p_overflow, grid barriers
    result = torch.empty(4, dtype=_I32, device=dev)
    scratch = torch.empty(int(lib.ksched_mcmf_scratch_words(E, blocks)),
                          dtype=_I32, device=dev)
    if telemetry_cap:
        telemetry_cap = mega_telemetry_cap(R, L, telemetry_cap)
        tel = torch.zeros((telemetry_cap, 8), dtype=_I32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.ksched_mcmf_solve(
            *(t.data_ptr() for t in tables), f.data_ptr(), result.data_ptr(),
            scratch.data_ptr(), tel.data_ptr() if telemetry_cap else None, E, eps,
            alpha, max_supersteps, tighten_sweeps, blocks, chunk, telemetry_cap,
            stream,
        )
    raise_on(lib, rc, "mcmf")
    mcmf_loop.launches += 1
    mcmf_loop.last_inputs = (cap.data_ptr(), cost.data_ptr(), supply.data_ptr())
    mcmf_loop.last_blocks = blocks
    mcmf_loop.last_barriers = result[3]
    out = (f[fwd_pos.long()], result[0], result[1] != 0, result[2] != 0)
    return out + (tel,) if telemetry_cap else out


#: kernel launches since the count was last set to 0
mcmf_loop.launches = 0
#: data_ptr() of the last launch's cap, cost and supply arguments
mcmf_loop.last_inputs = None
#: blocks of the last launch's grid
mcmf_loop.last_blocks = 0
#: grid barriers the last launch ran (an int32 scalar on its card)
mcmf_loop.last_barriers = None

_capacity = {}


def grid_capacity(dev) -> tuple:
    """(SM count, blocks of the kernel per SM) of CUDA device `dev`,
    queried once per device."""
    dev = torch.device(dev)
    index = torch.cuda.current_device() if dev.index is None else dev.index
    if index not in _capacity:
        lib = load("mcmf", _SIGNATURES)
        with torch.cuda.device(index):
            per_sm = lib.ksched_mcmf_blocks_per_sm()
        if per_sm <= 0:
            raise KernelError(
                "the mcmf kernel does not fit an SM: "
                + (lib.ksched_cuda_error_string(-per_sm).decode() if per_sm else
                   "no block is resident"))
        sms = torch.cuda.get_device_properties(index).multi_processor_count
        _capacity[index] = (sms, per_sm)
    return _capacity[index]


def barrier_probe_ms(dev, blocks: int, n: int) -> float:
    """Milliseconds (CUDA events) of one cooperative launch of `blocks`
    blocks that meets `n` of the kernel's grid barriers and does nothing
    else: the barrier's own cost, for timing."""
    lib = load("mcmf", _SIGNATURES)
    hdr = torch.empty(MCMF_HEAD_WORDS, dtype=_I32, device=dev)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        start.record()
        rc = lib.ksched_mcmf_barrier_probe(hdr.data_ptr(), blocks, n, stream)
        end.record()
    raise_on(lib, rc, "mcmf barrier probe")
    end.synchronize()
    return start.elapsed_time(end)
