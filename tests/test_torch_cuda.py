"""The port on the card: the CUDA transport kernels (plain and tiered,
also at the row-split plan's edges and with all their state in global
memory, and their phase probe) and the mcmf kernel (on its cooperative
grid, across blocks) against their plain PyTorch versions, bit for bit,
Scenario W(20, 200) through the default cuda backend and through
"mega", Scenario P(20, 200) on the card against the CPU, and the
device-resident round on the card against the same round on the CPU,
three-tier preemption, group mode and trace replay included, the
transport kernel at the trace replay's [4, 12,544], and the
device-resident event rounds (bench.py's churn config at 400 x 40, and
"mega" with the mcmf kernel reading the mirror's tensors) against the
CPU; the mcmf kernel's soltel ring against its plain version's across
blocks, and the rings of the mega, CSR and ELL solves on the card
against the CPU's.
Marked `cuda`; every test skips where no CUDA device is present.
Imports nothing of JAX, so it runs on a machine without it:

    python -m pytest tests/test_torch_cuda.py --noconftest -q
"""

import numpy as np
import pytest
import torch

from ksched_tpu_torch.ops.transport import transport_loop, transport_loop_tiered
from ksched_tpu_torch.solver.layered import (
    _solve_transport,
    _solve_transport_tiered,
    pad_geometry,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is false)")
    return torch.device("cuda", 0)


def _instance(seed, C, M, dev):
    rng = np.random.default_rng(seed)
    Mp, n_scale = pad_geometry(M, C)
    wS = np.zeros((C, Mp), np.int32)
    wS[:, :M] = rng.integers(-30, 30, (C, M)) * n_scale
    supply = rng.integers(0, 60, C).astype(np.int32)
    col_cap = np.zeros(Mp, np.int32)
    col_cap[:M] = rng.integers(0, 25, M)
    col_cap[-1] = supply.sum()
    t = [torch.as_tensor(a, device=dev) for a in (wS, supply, col_cap)]
    return t, int(max(1, np.abs(wS).max())), n_scale


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("C,M", [(2, 5), (5, 130), (8, 250), (300, 3000)])
@pytest.mark.parametrize("refine", [0, 2])
def test_kernel_matches_plain(card, seed, C, M, refine):
    args, eps, n_scale = _instance(seed, C, M, card)
    before = transport_loop.launches
    got = transport_loop(*args, eps, refine_waves=refine, max_supersteps=50_000)
    assert transport_loop.launches == before + 1
    want = _solve_transport(*args, eps, refine_waves=refine, max_supersteps=50_000)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)
    warm = transport_loop(*args, n_scale, got[1], max_supersteps=50_000)
    warm_p = _solve_transport(*args, n_scale, got[1], max_supersteps=50_000)
    for a, b in zip(warm, warm_p):
        assert torch.equal(a, b)


def _edge_instance(seed, C, Mp, dev):
    """An instance of exactly Mp columns (Mp - 1 machines and the escape
    column), for the row-split plan's edges: (tensors, cold eps,
    n_scale)."""
    rng = np.random.default_rng(seed)
    M = Mp - 1
    n_scale = 1 << (C + Mp + 2).bit_length()
    wS = np.zeros((C, Mp), np.int32)
    wS[:, :M] = rng.integers(-30, 30, (C, M)) * n_scale
    supply = rng.integers(0, 60, C).astype(np.int32)
    col_cap = np.zeros(Mp, np.int32)
    col_cap[:M] = rng.integers(0, 25, M)
    col_cap[-1] = supply.sum()
    t = [torch.as_tensor(a, device=dev) for a in (wS, supply, col_cap)]
    return t, int(max(1, np.abs(wS).max())), n_scale


# the row-split plan's edges (ops/transport.py row_plan): the main
# [4, 1024]; Mp not a multiple of 4 with uneven slices; one warp per row
# (32 rows); more rows than warps; most warps without a column
_PLAN_EDGES = [(4, 1024), (6, 1021), (31, 777), (33, 64), (3, 4)]


def _all_in_global_memory(monkeypatch, card):
    """The kernels' layout with no shared memory: every array global."""
    from ksched_tpu_torch.ops import transport

    for kind in ("transport", "transport_tiered"):
        monkeypatch.setitem(transport._budgets, (kind, card.index), 0)


@pytest.mark.parametrize("C,Mp", _PLAN_EDGES)
@pytest.mark.parametrize("refine", [0, 2])
@pytest.mark.parametrize("where", ["layout", "global"])
def test_kernel_matches_plain_at_plan_edges(card, monkeypatch, C, Mp, refine, where):
    """Bit-identical to the plain version where the row-split plan has
    its edges, cold and from carried prices, with the state where the
    layout puts it and with all of it in global memory."""
    if where == "global":
        _all_in_global_memory(monkeypatch, card)
    args, eps, n_scale = _edge_instance(C * 1000 + Mp, C, Mp, card)
    got = transport_loop(*args, eps, refine_waves=refine, max_supersteps=50_000)
    want = _solve_transport(*args, eps, refine_waves=refine, max_supersteps=50_000)
    assert bool(want[3])
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)
    warm = transport_loop(*args, n_scale, got[1], refine_waves=refine,
                          max_supersteps=50_000)
    warm_p = _solve_transport(*args, n_scale, got[1], refine_waves=refine,
                              max_supersteps=50_000)
    for a, b in zip(warm, warm_p):
        assert torch.equal(a, b)


def test_kernel_phase_probe(card):
    """The probe leaves the solve's outputs as they are and counts
    cycles in every phase a solve runs."""
    from ksched_tpu_torch.ops.transport import PROBE_SLOTS

    args, eps, _n = _edge_instance(4, 4, 1024, card)
    cycles = torch.zeros(len(PROBE_SLOTS), dtype=torch.int64, device=card)
    got = transport_loop(*args, eps, cycles=cycles)
    want = transport_loop(*args, eps)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    c = dict(zip(PROBE_SLOTS, cycles.tolist()))
    assert all(v > 0 for v in c.values())
    assert sum(c[k] for k in PROBE_SLOTS[:-1]) < c["total"]
    with pytest.raises(ValueError):
        transport_loop(*args, eps, cycles=cycles.to(torch.int32))


def test_kernel_matches_plain_at_group_mode_scale(card):
    """Hundreds of rows on a 12.5k-machine axis: the state lives in
    global memory. Bounded at 2000 supersteps — converged or not, the
    bits must match."""
    args, eps, _n = _instance(7, 400, 12_500, card)
    got = transport_loop(*args, eps, max_supersteps=2000)
    want = _solve_transport(*args, eps, max_supersteps=2000)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_kernel_rejects_bad_inputs(card):
    (wS, supply, col_cap), eps, _n = _instance(0, 3, 40, card)
    with pytest.raises(TypeError):
        transport_loop(wS.to(torch.int64), supply, col_cap, eps)
    with pytest.raises(ValueError):
        transport_loop(wS, supply[:2], col_cap, eps)
    with pytest.raises(ValueError):
        transport_loop(wS.t().contiguous().t(), supply, col_cap, eps)
    with pytest.raises(ValueError):
        transport_loop(wS, supply.cpu(), col_cap, eps)


def test_event_path_on_card(card):
    from ksched_tpu_torch.drivers import whare_mixed_rounds
    from ksched_tpu_torch.solver.select import make_backend

    backend = make_backend("auto")
    before = transport_loop.launches
    rows = [(placed, backend.last_path, backend.last_supersteps,
             sched.solver.last_result.objective)
            for _r, sched, placed in whare_mixed_rounds(20, 200, backend)]
    assert rows == [(200, "dense", 0, 0), (50, "dense", 84, 0),
                    (50, "dense", 3207, 166), (20, "dense", 170, 76756)]
    assert transport_loop.launches - before >= 3


def _tiered_instance(seed, C, M, dev):
    """A tiered instance: _instance's costs as the dear tier, a random
    continuation discount off every real column for the cheap tier, a
    random resident tile (none on the escape column)."""
    rng = np.random.default_rng(seed)
    Mp, n_scale = pad_geometry(M, C)
    wHi = np.zeros((C, Mp), np.int32)
    wHi[:, :M] = rng.integers(-30, 30, (C, M)) * n_scale
    wLo = wHi.copy()
    wLo[:, :M] -= int(rng.integers(1, 12)) * n_scale
    R = rng.integers(0, 6, (C, Mp)).astype(np.int32)
    R[:, -1] = 0
    supply = rng.integers(0, 60, C).astype(np.int32)
    col_cap = np.zeros(Mp, np.int32)
    col_cap[:M] = rng.integers(0, 25, M)
    col_cap[-1] = supply.sum()
    t = [torch.as_tensor(a, device=dev) for a in (wLo, wHi, R, supply, col_cap)]
    return t, int(max(1, np.abs(wHi).max()))


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("C,M", [(2, 5), (5, 130), (8, 250), (300, 3000)])
@pytest.mark.parametrize("refine", [0, 8])
def test_tiered_kernel_matches_plain(card, seed, C, M, refine):
    """Bounded at 2000 supersteps from 300 rows up, where the plain
    version takes minutes to converge on some seeds: converged or not,
    the bits must match."""
    args, eps = _tiered_instance(seed, C, M, card)
    budget = 2000 if C >= 300 else 50_000
    before = transport_loop_tiered.launches
    got = transport_loop_tiered(*args, eps, refine_waves=refine,
                                max_supersteps=budget)
    assert transport_loop_tiered.launches == before + 1
    want = _solve_transport_tiered(*args, eps, refine_waves=refine,
                                   max_supersteps=budget)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)
    # the start eps as an int32 scalar on the card, as the device round
    # passes it
    eps_t = torch.full((), eps, dtype=torch.int32, device=card)
    again = transport_loop_tiered(*args, eps_t, refine_waves=refine,
                                  max_supersteps=budget)
    for a, b in zip(again, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("refine", [0, 8])
def test_tiered_kernel_matches_plain_in_global_memory(card, refine):
    """Hundreds of rows on a 12.5k-machine axis ([400, 12544]): the
    tiles live in global memory. Bounded at 2000 supersteps —
    converged or not, the bits must match."""
    args, eps = _tiered_instance(7, 400, 12_500, card)
    got = transport_loop_tiered(*args, eps, refine_waves=refine, max_supersteps=2000)
    want = _solve_transport_tiered(*args, eps, refine_waves=refine,
                                   max_supersteps=2000)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("C,Mp", _PLAN_EDGES)
@pytest.mark.parametrize("refine", [0, 8])
@pytest.mark.parametrize("where", ["layout", "global"])
def test_tiered_kernel_matches_plain_at_plan_edges(card, monkeypatch, C, Mp, refine,
                                                   where):
    """The tiered kernel where the row-split plan has its edges, with the
    state where the layout puts it and all of it in global memory."""
    if where == "global":
        _all_in_global_memory(monkeypatch, card)
    (wHi, supply, col_cap), eps, n_scale = _edge_instance(C * 1000 + Mp, C, Mp, card)
    rng = np.random.default_rng(Mp)
    wLo = wHi.clone()
    wLo[:, :-1] -= int(rng.integers(1, 12)) * n_scale
    R = torch.as_tensor(rng.integers(0, 6, (C, Mp)).astype(np.int32), device=card)
    R[:, -1] = 0
    args = (wLo, wHi, R, supply, col_cap)
    got = transport_loop_tiered(*args, eps, refine_waves=refine, max_supersteps=50_000)
    want = _solve_transport_tiered(*args, eps, refine_waves=refine,
                                   max_supersteps=50_000)
    assert bool(want[3])
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)
    from ksched_tpu_torch.ops.transport import PROBE_SLOTS

    cycles = torch.zeros(len(PROBE_SLOTS), dtype=torch.int64, device=card)
    probed = transport_loop_tiered(*args, eps, refine_waves=refine,
                                   max_supersteps=50_000, cycles=cycles)
    assert all(torch.equal(a, b) for a, b in zip(probed, want))
    assert int(cycles[-1]) > 0


def test_tiered_kernel_rejects_bad_inputs(card):
    (wLo, wHi, R, supply, col_cap), eps = _tiered_instance(0, 3, 40, card)
    with pytest.raises(TypeError):
        transport_loop_tiered(wLo, wHi, R.to(torch.int64), supply, col_cap, eps)
    with pytest.raises(ValueError):
        transport_loop_tiered(wLo, wHi[:2], R, supply, col_cap, eps)
    with pytest.raises(ValueError):
        transport_loop_tiered(wLo, wHi, R, supply, col_cap.cpu(), eps)
    with pytest.raises(ValueError):
        transport_loop_tiered(wLo, wHi, R, supply, col_cap,
                              torch.ones(1, dtype=torch.int32, device=card))


def test_device_bulk_on_card_matches_cpu(card):
    """The device round on the card — fill, host-driven rounds, steady
    rounds with draws made on the CPU — equals the same round on the
    CPU, stats and state, preemption on (the tiered kernel) and off
    (the transport kernel)."""
    from ksched_tpu_torch.costmodels import coco
    from ksched_tpu_torch.costmodels.device_costs import coco_device_cost_fn
    from ksched_tpu_torch.drivers.device_bulk import run_rounds
    from ksched_tpu_torch.scheduler.device_bulk import (
        DeviceBulkCluster,
        draw_steady,
    )

    pen = np.random.default_rng(7).integers(0, 40, (40, 4))
    for preemption in (True, False):
        def make(dev):
            return DeviceBulkCluster(
                num_machines=40, pus_per_machine=4, slots_per_pu=4, num_jobs=4,
                num_task_classes=4, task_capacity=1024,
                class_cost_fn=coco_device_cost_fn(pen),
                unsched_cost=coco.UNSCHEDULED_COST, ec_cost=0,
                supersteps=1 << 16, preemption=preemption,
                continuation_discount=8, decode_width=256, device=dev,
            )

        gpu, cpu = make(card), make("cpu")
        launches = (transport_loop.launches, transport_loop_tiered.launches)
        for (_r, a), (_r2, b) in zip(run_rounds(gpu, 400, 3), run_rounds(cpu, 400, 3)):
            ga, gb = gpu.fetch_stats(a), cpu.fetch_stats(b)
            assert {k: int(v) for k, v in ga.items()} == {k: int(v) for k, v in gb.items()}
        gen = torch.Generator().manual_seed(3)
        for _ in range(4):
            draws = draw_steady(gen, 1024, 4, 4)
            a = gpu.fetch_stats(gpu.steady_round(*(d.to(card) for d in draws), 0.05, 20))
            b = cpu.fetch_stats(cpu.steady_round(*draws, 0.05, 20))
            assert {k: int(v) for k, v in a.items()} == {k: int(v) for k, v in b.items()}
        sa, sb = gpu.fetch_state(), cpu.fetch_state()
        for k in sa:
            np.testing.assert_array_equal(sa[k], sb[k])
        ran = (transport_loop.launches - launches[0],
               transport_loop_tiered.launches - launches[1])
        assert (ran[1] > 0 and ran[0] == 0) if preemption else (ran[0] > 0 and ran[1] == 0)


@pytest.mark.parametrize("policy", ["closed-form", "coco"])
def test_trace_replay_on_card_matches_cpu(card, policy):
    """A staged trace (12 machines, 160 tasks, machine churn) replayed
    on the card in two chunks with their own seeds equals the same
    replay on the CPU, stats and state; the CoCo policy launches the
    transport kernel on every window, the closed form never."""
    from ksched_tpu_torch.costmodels import coco
    from ksched_tpu_torch.costmodels.device_costs import coco_device_cost_fn
    from ksched_tpu_torch.drivers.gtrace import window_slice
    from ksched_tpu_torch.drivers.trace_replay import (
        DeviceTraceReplayDriver,
        synthesize_trace,
    )

    machines, events = synthesize_trace(num_machines=12, num_tasks=160, duration_s=120.0,
                                        mean_runtime_s=60.0, seed=5, machine_churn=0.5)
    kw = dict(slots_per_machine=2, num_jobs_hint=8, task_capacity=256, decode_width=16)
    if policy == "coco":
        pen = np.random.default_rng(7).integers(0, 40, (12, 4))
        kw.update(class_cost_fn=coco_device_cost_fn(pen), unsched_cost=coco.UNSCHEDULED_COST,
                  supersteps=1 << 14)
    gpu = DeviceTraceReplayDriver(machines, device=card, **kw)
    cpu = DeviceTraceReplayDriver(machines, device="cpu", **kw)
    sch = gpu.stage(events, window_s=10.0)
    launches = transport_loop.launches
    k = sch["rounds"] // 2
    for i0, n, seed in ((0, k, 1), (k, sch["rounds"] - k, 2)):
        a = gpu.cluster.fetch_stats(gpu.replay(window_slice(sch, i0, n), seed=seed))
        b = cpu.cluster.fetch_stats(cpu.replay(window_slice(sch, i0, n), seed=seed))
        assert set(a) == set(b)
        for key in a:
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    sa, sb = gpu.cluster.fetch_state(), cpu.cluster.fetch_state()
    for key in sa:
        np.testing.assert_array_equal(sa[key], sb[key])
    ran = transport_loop.launches - launches
    assert ran >= sch["rounds"] if policy == "coco" else ran == 0


def test_kernel_matches_plain_at_gtrace_width(card):
    """The transport kernel at gtrace12k-coco's [4, 12,544] (12,500
    machines: every state array in the global scratch, a row's slices
    spread over six warps), on a contended instance: bit for bit the
    plain version, cold and from carried prices."""
    rng = np.random.default_rng(12)
    C, M = 4, 12_500
    Mp, n_scale = pad_geometry(M, C)
    assert Mp == 12_544
    wS = np.zeros((C, Mp), np.int32)
    wS[:, :M] = (rng.integers(0, 40, (C, M)) - 540) * n_scale
    supply = rng.integers(4_000, 7_000, C).astype(np.int32)
    col_cap = np.zeros(Mp, np.int32)
    col_cap[:M] = rng.integers(0, 3, M)
    col_cap[-1] = supply.sum()
    args = [torch.as_tensor(a, device=card) for a in (wS, supply, col_cap)]
    eps = int(np.abs(wS).max())
    got = transport_loop(*args, eps, max_supersteps=50_000, refine_waves=8)
    want = _solve_transport(*args, eps, max_supersteps=50_000, refine_waves=8)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)
    assert bool(got[3]) and int(got[2]) > 0
    warm = transport_loop(*args, n_scale, got[1], max_supersteps=50_000)
    warm_p = _solve_transport(*args, n_scale, got[1], max_supersteps=50_000)
    for a, b in zip(warm, warm_p):
        assert torch.equal(a, b)


@pytest.mark.parametrize("grouped", [False, True])
def test_steady_draws_on_card_match_cpu(card, grouped):
    """utils/threefry.py's steady draws (int64 words masked to 32 bits),
    a chunk of rounds in one pass, give the same bits on the card as on
    the CPU at Tcap = 65,536, where tests/test_torch_threefry.py holds
    the CPU's against jax.random."""
    from ksched_tpu_torch.utils import threefry

    keys, _offsets = threefry.steady_keys(6, 4, grouped)
    a = threefry.steady_draws(torch.as_tensor(keys, device=card), 65_536,
                              480 if grouped else 4, 20)
    b = threefry.steady_draws(torch.as_tensor(keys), 65_536, 480 if grouped else 4, 20)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape == (4, 65_536)
        assert torch.equal(x.cpu(), y)


@pytest.mark.parametrize("mode", ["three-tier", "grouped"])
def test_tiers_and_groups_on_card_match_cpu(card, mode):
    """Three-tier preemption (incremental rounds on the transport kernel
    under a budget, scoped and global re-solves on the tiered one) and
    group mode (compacted two-stage solves on the transport kernel):
    steady rounds on the JAX package's draws (utils/threefry.py) equal
    on the card and on the CPU, stats, state and hybrid carry."""
    from ksched_tpu_torch.costmodels import coco
    from ksched_tpu_torch.costmodels.device_costs import coco_device_cost_fn
    from ksched_tpu_torch.costmodels.quincy_device import QuincyGroupTable
    from ksched_tpu_torch.drivers.device_bulk import run_rounds
    from ksched_tpu_torch.scheduler.device_bulk import DeviceBulkCluster

    pen = np.random.default_rng(7).integers(0, 40, (40, 4))
    if mode == "three-tier":
        kw = dict(num_task_classes=4, class_cost_fn=coco_device_cost_fn(pen),
                  unsched_cost=coco.UNSCHEDULED_COST, ec_cost=0, preemption=True,
                  continuation_discount=8, preempt_every=4, preempt_drift=60,
                  preempt_global_every=12, preempt_scope_tau=2,
                  preempt_incr_budget=4096, preempt_scoped_width=512,
                  track_realized_cost=True)
        setup = None
    else:
        kw = dict(num_groups=64, active_groups_cap=(8, 32))

        def setup(cluster, rng):
            table = QuincyGroupTable(num_groups=64, num_machines=40, cost_unit_mb=64)
            for b in range(1, 49):
                table.blocks.register(b, 512 << 20, rng.choice(40, 3, replace=False).tolist())
            groups = table.groups_for(np.zeros(400, np.int32),
                                      [[int(b)] for b in rng.integers(1, 49, 400)])
            table.sync(cluster)
            return groups

    def make(dev):
        return DeviceBulkCluster(num_machines=40, pus_per_machine=4, slots_per_pu=4,
                                 num_jobs=4, task_capacity=1024, supersteps=1 << 16,
                                 decode_width=256, device=dev, **kw)

    gpu, cpu = make(card), make("cpu")
    launches = (transport_loop.launches, transport_loop_tiered.launches)
    for (_r, a), (_r2, b) in zip(run_rounds(gpu, 400, 2, setup=setup),
                                 run_rounds(cpu, 400, 2, setup=setup)):
        ga, gb = gpu.fetch_stats(a), cpu.fetch_stats(b)
        assert {k: int(v) for k, v in ga.items()} == {k: int(v) for k, v in gb.items()}
    a = gpu.fetch_stats(gpu.run_steady_rounds(24, 0.05, 20, seed=2))
    b = cpu.fetch_stats(cpu.run_steady_rounds(24, 0.05, 20, seed=2))
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    sa, sb = gpu.fetch_state(), cpu.fetch_state()
    for k in sa:
        np.testing.assert_array_equal(sa[k], sb[k], err_msg=k)
    ran = (transport_loop.launches - launches[0],
           transport_loop_tiered.launches - launches[1])
    if mode == "three-tier":
        np.testing.assert_array_equal(gpu._hyb_census.cpu().numpy(), cpu._hyb_census.numpy())
        assert (gpu._hyb_k, gpu._hyb_kg) == (cpu._hyb_k, cpu._hyb_kg)
        assert a["full_round"].any() and a["global_round"].any() and not a["full_round"].all()
        assert ran[0] > 0 and ran[1] > 0
    else:
        assert ran[0] > 0 and ran[1] == 0


def _mcmf_case(seed, dev, lanes=None, arc_slots=None, tasks=40, machines=4,
               slots=3):
    """A seeded scheduling graph as mcmf_loop's arguments on `dev`:
    (arc and node tensors, entry tables, R, L, cold eps)."""
    from ksched_tpu_torch.drivers import random_flow_problem
    from ksched_tpu_torch.solver.csr_solver import build_csr_plan
    from ksched_tpu_torch.solver.mega_solver import _pad_pow2, build_mega_plan

    p = random_flow_problem(np.random.default_rng(seed), tasks, machines, slots,
                            arc_slots=arc_slots)
    n = p.num_nodes
    plan = build_mega_plan(build_csr_plan(p.src, p.dst, n), lanes)
    arrays = [_pad_pow2(x) for x in (p.cap, p.cost * np.int32(n),
                                     p.excess.astype(np.int32),
                                     np.zeros(len(p.src), np.int32))]
    tables = [plan.e_arc, plan.e_sign, plan.e_src, plan.e_hs, plan.e_he,
              plan.e_prow, plan.e_pcol, _pad_pow2(plan.fwd_pos)]
    on = [torch.as_tensor(x, device=dev) for x in arrays]
    tab = [torch.as_tensor(x, device=dev) for x in tables]
    return on, tab, plan.R, plan.L, max(1, int(np.abs(p.cost).max()) * n)


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("lanes", [None, 8])
@pytest.mark.parametrize("cold", [False, True], ids=["eps1", "cold"])
def test_mcmf_kernel_matches_plain(card, seed, lanes, cold):
    from ksched_tpu_torch.ops.mcmf import mcmf_loop, mcmf_loop_plain

    a, t, R, L, eps_cold = _mcmf_case(seed, card, lanes, tasks=40 + 30 * seed)
    eps = eps_cold if cold else 1
    before = mcmf_loop.launches
    got = mcmf_loop(*a[:4], eps, *t, R, L)
    assert mcmf_loop.launches == before + 1
    want = mcmf_loop_plain(*a[:4], eps, *t, R, L)
    assert bool(want[2])
    for x, y in zip(got, want):
        assert x.dtype == y.dtype and x.shape == y.shape and torch.equal(x, y)
    # stopped mid-solve, both hold the same state
    got = mcmf_loop(*a[:4], eps, *t, R, L, max_supersteps=7)
    want = mcmf_loop_plain(*a[:4], eps, *t, R, L, max_supersteps=7)
    for x, y in zip(got, want):
        assert torch.equal(x, y)


def test_mcmf_kernel_matches_plain_at_r256(card):
    """The 10k x 1k shape: 65,536 arc slots (export-style padding), so
    131,072 entries in R = 256 rows of 512 lanes. Bounded at 300
    supersteps: converged or not, the bits must match."""
    from ksched_tpu_torch.ops.mcmf import grid_capacity, mcmf_grid, mcmf_loop, mcmf_loop_plain

    a, t, R, L, eps = _mcmf_case(5, card, arc_slots=65_536, tasks=15_000,
                                 machines=1000, slots=8)
    assert R == 256
    for e in (1, eps):
        got = mcmf_loop(*a[:4], e, *t, R, L, max_supersteps=300)
        assert mcmf_loop.last_blocks == mcmf_grid(R * L, *grid_capacity(card))[0] > 1
        want = mcmf_loop_plain(*a[:4], e, *t, R, L, max_supersteps=300)
        for x, y in zip(got, want):
            assert x.dtype == y.dtype and torch.equal(x, y)


# seeded graphs whose entries spread over the cooperative grid (their
# layouts are checked on the CPU in tests/test_torch_mcmf_grid.py):
# (seed, tasks, machines, slots, arc_slots, the longer budget)
_GRID_CASES = {
    # one block (R = 1)
    "r1": (0, 40, 4, 3, None, 50_000),
    # 16 blocks, a segment over 4 blocks with headless middle blocks, a
    # head on the first entry of blocks 1 and 10, R = 31 (ragged)
    "span3": (0, 3000, 100, 4, None, 2000),
    # 12 blocks, every one full (R = 24)
    "full-blocks": (8, 2500, 60, 3, None, 2000),
    # 5 blocks; the cold solve converges (2,572 supersteps)
    "converges": (2, 800, 30, 4, None, 3000),
    # R = 300: past one step per warp on 132 SMs, 75 blocks of 64-entry chunks
    "two-steps": (5, 15_000, 1000, 8, 76_800, 300),
}


@pytest.mark.parametrize("case", list(_GRID_CASES))
@pytest.mark.parametrize("cold", [False, True], ids=["eps1", "cold"])
def test_mcmf_kernel_matches_plain_across_blocks(card, case, cold):
    """Bit-identical to the plain version on the grid the wrapper sizes
    (more than one block from R = 8 up), run to the longer budget and
    cut at 7 supersteps."""
    from ksched_tpu_torch.ops.mcmf import grid_capacity, mcmf_grid, mcmf_loop, mcmf_loop_plain

    seed, tasks, machines, slots, arc_slots, budget = _GRID_CASES[case]
    a, t, R, L, eps_cold = _mcmf_case(seed, card, arc_slots=arc_slots, tasks=tasks,
                                      machines=machines, slots=slots)
    eps = eps_cold if cold else 1
    for steps in (budget, 7):
        got = mcmf_loop(*a[:4], eps, *t, R, L, max_supersteps=steps)
        blocks = mcmf_loop.last_blocks
        want = mcmf_loop_plain(*a[:4], eps, *t, R, L, max_supersteps=steps)
        for x, y in zip(got, want):
            assert x.dtype == y.dtype and x.shape == y.shape and torch.equal(x, y)
        assert blocks == mcmf_grid(R * L, *grid_capacity(card))[0]
        assert (blocks > 1) == (R >= 8)
        assert int(mcmf_loop.last_barriers) >= 3 * int(got[1])
    if case == "converges" and cold:
        assert bool(mcmf_loop(*a[:4], eps, *t, R, L, max_supersteps=budget)[2])


def test_mcmf_scratch_words_match_the_kernel(card):
    from ksched_tpu_torch.ops.build import load
    from ksched_tpu_torch.ops.mcmf import _SIGNATURES, grid_capacity, mcmf_scratch_words

    lib = load("mcmf", _SIGNATURES)
    for E, blocks in ((512, 1), (15_872, 16), (131_072, 128), (153_600, 75)):
        assert lib.ksched_mcmf_scratch_words(E, blocks) == mcmf_scratch_words(E, blocks)
    sms, per_sm = grid_capacity(card)
    assert sms == torch.cuda.get_device_properties(card).multi_processor_count
    assert per_sm >= 1


def test_mcmf_refused_cooperative_launch_raises(card, monkeypatch):
    """A grid larger than the card holds at once is refused and raises:
    no fallback to a smaller grid or to the plain version."""
    from ksched_tpu_torch.ops import mcmf

    seed, tasks, machines, slots, arc_slots, _budget = _GRID_CASES["two-steps"]
    a, t, R, L, _eps = _mcmf_case(seed, card, arc_slots=arc_slots, tasks=tasks,
                                  machines=machines, slots=slots)
    sms, per_sm = mcmf.grid_capacity(card)
    monkeypatch.setitem(mcmf._capacity, card.index, (2 * sms, per_sm))
    before = mcmf.mcmf_loop.launches
    with pytest.raises(RuntimeError, match="mcmf kernel launch failed"):
        mcmf.mcmf_loop(*a[:4], 1, *t, R, L, max_supersteps=7)
    assert mcmf.mcmf_loop.launches == before
    # the refusal leaves nothing behind: the next launch runs
    monkeypatch.setitem(mcmf._capacity, card.index, (sms, per_sm))
    got = mcmf.mcmf_loop(*a[:4], 1, *t, R, L, max_supersteps=7)
    want = mcmf.mcmf_loop_plain(*a[:4], 1, *t, R, L, max_supersteps=7)
    assert all(torch.equal(x, y) for x, y in zip(got, want))


def test_mcmf_kernel_rejects_bad_inputs(card):
    from ksched_tpu_torch.ops.mcmf import mcmf_loop

    a, t, R, L, _eps = _mcmf_case(0, card)
    with pytest.raises(TypeError):
        mcmf_loop(a[0].to(torch.int64), *a[1:4], 1, *t, R, L)
    with pytest.raises(ValueError):
        mcmf_loop(*a[:4], 1, *t[:3], t[3][:-1], *t[4:], R, L)
    with pytest.raises(ValueError):
        mcmf_loop(*a[:3], a[3].cpu(), 1, *t, R, L)
    with pytest.raises(ValueError):
        mcmf_loop(*a[:4], 1, *t, R, L, alpha=1)


@pytest.mark.parametrize("name", ["W", "P"])
def test_general_graph_scenarios_on_card_match_cpu(card, name):
    """W(20, 200) through "mega" and P(20, 200) through "auto": the card
    gives the CPU's values every round, with the kernel launched."""
    from ksched_tpu_torch.drivers import trivial_preempt_rounds, whare_mixed_rounds
    from ksched_tpu_torch.ops.mcmf import mcmf_loop
    from ksched_tpu_torch.solver.select import make_backend

    rounds = whare_mixed_rounds if name == "W" else trivial_preempt_rounds
    kind = "mega" if name == "W" else "auto"

    def run(dev):
        b = make_backend(kind, device=dev)
        return [(placed, getattr(b, "last_path", "mega"), b.last_supersteps,
                 sched.solver.last_result.objective,
                 sorted(sched.get_task_bindings().items()))
                for _r, sched, placed in rounds(20, 200, b)]

    before = mcmf_loop.launches
    on_card = run(card)
    assert mcmf_loop.launches - before >= 3
    assert on_card == run("cpu")


def _churn_records(dev):
    from ksched_tpu_torch.drivers.churn import run_churn

    out = run_churn(rounds=6, tasks=400, machines=40, churn=0.05, device=dev)
    keys = ("supersteps", "warm_scope", "sha256", "plan_kind", "upload_bytes",
            "solver_upload_bytes")
    return out, {arm: [{k: r[k] for k in keys} for r in out[arm]]
                 for arm in ("full_rebuild", "delta_scatter", "device_resident")}


def test_churn_arms_on_the_card_match_cpu(card):
    """bench.py's churn config at 400 x 40: the three export arms on the
    card equal the same run on the CPU round by round, the resident
    mirror and plan on the card."""
    out, got = _churn_records(card)
    res = out["objects"]["device_resident"].sched.solver.resident
    assert res.d_cap.is_cuda and res.d_p_arc.is_cuda and res.d_p_sign.is_cuda
    _, want = _churn_records("cpu")
    assert got == want


def test_resident_mega_on_the_card_matches_cpu(card):
    """W(20, 200) through "mega" on the device-resident export: the
    kernel reads the mirror's tensors, and the rounds equal the CPU's."""
    from ksched_tpu_torch.drivers import whare_mixed_rounds
    from ksched_tpu_torch.ops.mcmf import mcmf_loop
    from ksched_tpu_torch.solver.select import make_backend

    def rounds(dev):
        backend = make_backend("mega", device=dev)
        out = []
        for r, sched, placed in whare_mixed_rounds(20, 200, backend, device_resident=True):
            res = sched.solver.resident
            if res.device.type == "cuda":
                assert mcmf_loop.last_inputs == (
                    res.d_cap.data_ptr(), res._scaled[1].data_ptr(),
                    res.d_excess.data_ptr())
            out.append((placed, backend.last_supersteps,
                        sched.solver.last_result.objective,
                        sorted(sched.get_task_bindings().items())))
            if r == 2:
                return out

    assert rounds(card) == rounds("cpu")


@pytest.mark.parametrize("case", list(_GRID_CASES))
@pytest.mark.parametrize("cold", [False, True], ids=["eps1", "cold"])
@pytest.mark.parametrize("cap", [16, 512])
def test_mcmf_ring_matches_plain_across_blocks(card, case, cold, cap):
    """Kernel B3's soltel ring equals its plain version's on 1 to 128
    blocks, a 16-row ring that wraps among them, run to the longer
    budget and cut at 7 supersteps (the last row written after the
    loop); with the ring off the flow and the grid barriers are the
    same."""
    from ksched_tpu_torch.ops.mcmf import mcmf_loop, mcmf_loop_plain, mega_telemetry_cap

    seed, tasks, machines, slots, arc_slots, budget = _GRID_CASES[case]
    a, t, R, L, eps_cold = _mcmf_case(seed, card, arc_slots=arc_slots, tasks=tasks,
                                      machines=machines, slots=slots)
    eps = eps_cold if cold else 1
    wraps = []
    for steps in (budget, 7):
        off = mcmf_loop(*a[:4], eps, *t, R, L, max_supersteps=steps)
        barriers_off = int(mcmf_loop.last_barriers)
        got = mcmf_loop(*a[:4], eps, *t, R, L, max_supersteps=steps, telemetry_cap=cap)
        assert int(mcmf_loop.last_barriers) == barriers_off
        want = mcmf_loop_plain(*a[:4], eps, *t, R, L, max_supersteps=steps,
                               telemetry_cap=cap)
        assert len(got) == len(want) == 5
        assert got[4].shape == (mega_telemetry_cap(R, L, cap), 8)
        for x, y in zip(got, want):
            assert x.dtype == y.dtype and x.shape == y.shape and torch.equal(x, y)
        for x, y in zip(got[:4], off):
            assert torch.equal(x, y)
        wraps.append(int(got[1]) > got[4].shape[0])
    if cap == 16 and cold and R >= 8:
        assert wraps[0]  # the long cold solves wrap a 16-row ring


def test_soltel_rings_on_card_match_cpu(card):
    """W(20, 200) through "mega" (kernel B3), the CSR and the ELL solves
    with a 64-row ring: each round's decoded ring on the card equals the
    CPU's; the layered transport on the card keeps its kernel and makes
    no ring, with the same supersteps as the CPU's loop."""
    from ksched_tpu_torch.drivers import whare_mixed_rounds
    from ksched_tpu_torch.solver.csr_solver import CsrSolver
    from ksched_tpu_torch.solver.ell_solver import EllSolver
    from ksched_tpu_torch.solver.layered import LayeredProblem, LayeredTransportSolver
    from ksched_tpu_torch.solver.mega_solver import MegaSolver

    def rings(make, dev):
        b = make(dev)
        out = []
        for r, _sched, _placed in whare_mixed_rounds(20, 200, b):
            out.append(b.last_telemetry.to_dict())
            if r == 2:
                return out

    for make in (lambda d: MegaSolver(telemetry=64, device=d,
                                      fallback=CsrSolver(telemetry=64, device=d)),
                 lambda d: CsrSolver(telemetry=64, device=d),
                 lambda d: EllSolver(telemetry=64, device=d)):
        assert rings(make, card) == rings(make, "cpu")
    rng = np.random.default_rng(11)
    lp = dict(supply=rng.integers(1, 30, 6).astype(np.int32),
              col_cap=rng.integers(0, 3, 300).astype(np.int32),
              cost_cm=rng.integers(0, 50, (6, 300)).astype(np.int32),
              unsched_cost=40, ec_cost=2)
    on_card = LayeredTransportSolver(telemetry=64, device=card)
    on_cpu = LayeredTransportSolver(telemetry=64, device="cpu")
    assert (on_card.solve_layered(LayeredProblem(**lp)).supersteps
            == on_cpu.solve_layered(LayeredProblem(**lp)).supersteps > 0)
    assert on_card.last_telemetry is None and on_cpu.last_telemetry is not None
