"""Batched what-if (shadow) solves: the data-parallel axis.

Port of ksched_tpu/parallel/whatif.py. An operator scores K scheduling
scenarios against the live cluster without perturbing it: "what if we
drained machine m?" (`drain_scenarios`), "what if these arrivals came
on top of today's backlog?" (`surge_scenarios`). Every scenario is the
production round's dense transport (solver/layered.py) over a shared
padded geometry; results carry the objective, per-class placements and
unscheduled counts.

`C == 1` batches take the exact closed form per scenario. `C >= 2`
loops over the scenarios through `transport_fori`, one bounded solve
after another: K launches of kernel B1 on the card (its plain version
on the CPU), the sequential semantics of the JAX package's `lax.map`,
so the batch costs the sum of its scenarios' supersteps. Batches in
which every class carries the same cost row take the class-degenerate
closed form, as in the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..solver.layered import (
    COST_SCALE_LIMIT,
    choose_eps0,
    pad_geometry,
    solve_single_class,
    transport_fori,
    validate_alpha,
)

_I32 = torch.int32


@dataclass
class ScenarioBatchResult:
    y: np.ndarray  # int64[K, C, M] placements per scenario
    objective: np.ndarray  # int64[K] in full-graph units
    num_unsched: np.ndarray  # int64[K]
    converged: np.ndarray  # bool[K]


def _batch_solve(wS, supply, col_cap, n_scale: int, alpha: int,
                 max_supersteps: int, class_degenerate: bool):
    """The transport over the leading scenario axis: wS int32[K, C, Mp],
    supply int32[K, C], col_cap int32[K, Mp] on one device. Returns
    (y int32[K, C, Mp], converged bool[K], steps [K]) tensors, `steps`
    the supersteps each scenario's solve took (0 on the closed forms).

    C == 1 is the exact closed form per scenario. C >= 2 runs the
    convergence-exiting solve scenario by scenario, each from its own
    adaptive eps start (an oversubscribed scenario, such as a drain
    that removes more capacity than the backlog fits, takes the full
    range; choose_eps0)."""
    K, C, _Mp = wS.shape
    dev = wS.device
    ys, convs, steps = [], [], []
    for k in range(K):
        w, s, cap = wS[k], supply[k], col_cap[k]
        if C == 1:
            ys.append(solve_single_class(w[0], s[0], cap)[None, :])
            convs.append(torch.ones((), dtype=torch.bool, device=dev))
            steps.append(torch.zeros((), dtype=_I32, device=dev))
            continue
        eps_full = w.abs().amax().clamp(min=1)
        y, _pm, st, conv, _known = transport_fori(
            w, s, cap, max_supersteps, alpha=alpha,
            eps0=choose_eps0(n_scale, eps_full, s.sum(dtype=_I32),
                             cap[:-1].sum(dtype=_I32)),
            class_degenerate=class_degenerate,
        )
        ys.append(y)
        convs.append(conv)
        steps.append(st)
    return torch.stack(ys), torch.stack(convs), torch.stack(steps)


class WhatIfSolver:
    """Batch scenario evaluation over a shared cluster geometry: every
    scenario has the same (num_machines, num_classes). The solves run
    on `device` (the card by default; "cpu" runs the kernel's plain
    version). `last_supersteps` holds each scenario's supersteps of the
    last batch."""

    def __init__(
        self,
        num_machines: int,
        num_classes: int,
        unsched_cost: int,
        ec_cost: int,
        alpha: int = 8,
        max_supersteps: int = 1 << 17,
        device="cuda",
    ) -> None:
        from ..utils.device import resolve_device

        self.M = num_machines
        self.C = num_classes
        self.unsched_cost = int(unsched_cost)
        self.ec_cost = int(ec_cost)
        self.alpha = validate_alpha(alpha)
        self.max_supersteps = max_supersteps
        self.device = resolve_device(device)
        self.Mp, self.n_scale = pad_geometry(num_machines, num_classes)
        self.last_supersteps = np.zeros(0, np.int64)  # kschedlint: host-only (host numpy)

    def solve_batch(
        self,
        cost_cm: np.ndarray,  # int[K, C, M] or [C, M] broadcast to all
        supply: np.ndarray,  # int[K, C]
        col_cap: np.ndarray,  # int[K, M]
    ) -> ScenarioBatchResult:
        supply = np.asarray(supply, np.int64)  # kschedlint: host-only (host numpy)
        col_cap = np.asarray(col_cap, np.int64)  # kschedlint: host-only (host numpy)
        K = supply.shape[0]
        if cost_cm.ndim == 2:
            cost_cm = np.broadcast_to(cost_cm, (K,) + cost_cm.shape)
        cost_cm = np.asarray(cost_cm, np.int64)  # kschedlint: host-only (host numpy)
        assert cost_cm.shape == (K, self.C, self.M), cost_cm.shape
        assert supply.shape == (K, self.C) and col_cap.shape == (K, self.M)

        w = cost_cm + self.ec_cost - self.unsched_cost
        max_w = int(np.abs(w).max()) if w.size else 0
        if max_w * self.n_scale >= COST_SCALE_LIMIT:
            raise OverflowError(
                f"scaled what-if costs overflow int32: max|w|={max_w} * {self.n_scale}"
            )
        totals = supply.sum(axis=1)  # kschedlint: disable=int32-reduce -- a host numpy sum
        wP = np.zeros((K, self.C, self.Mp), np.int32)
        wP[:, :, : self.M] = w * self.n_scale
        capP = np.zeros((K, self.Mp), np.int32)
        capP[:, : self.M] = col_cap
        capP[:, -1] = totals

        # class-degenerate batches (every class the same cost row in
        # every scenario: the stock no-cost-model configuration) take
        # the closed-form collapse; the iterative solve herds on
        # identical costs
        degenerate = bool((cost_cm == cost_cm[:, :1, :]).all())
        dev = self.device
        y, conv, steps = _batch_solve(
            torch.as_tensor(wP, device=dev),
            torch.as_tensor(supply.astype(np.int32), device=dev),
            torch.as_tensor(capP, device=dev),
            self.n_scale, self.alpha, self.max_supersteps, degenerate)
        self.last_supersteps = steps.cpu().numpy().astype(np.int64)  # kschedlint: host-only (host numpy)
        y_np = y.cpu().numpy().astype(np.int64)[:, :, : self.M]  # kschedlint: host-only (host numpy)
        placed = y_np.sum(axis=(1, 2))  # kschedlint: disable=int32-reduce -- a host numpy sum
        objective = self.unsched_cost * (totals - placed) + (  # kschedlint: disable=int32-reduce -- a host numpy sum
            (cost_cm + self.ec_cost) * y_np
        ).sum(axis=(1, 2))
        return ScenarioBatchResult(
            y=y_np,
            objective=objective,
            num_unsched=totals - placed,
            converged=conv.cpu().numpy(),
        )


def _cluster_snapshot(cluster):
    """(machine_free[M], base_supply[C], cost_cm[C,M]) of a BulkCluster's
    current round inputs: the derivation the production round uses
    (scheduler/bulk.py `_round_layered`), factored so the what-if
    scenario functions cannot drift from it."""
    C, M = cluster.C, cluster.M
    cluster._refresh_capacities()
    pu_free = cluster.S - cluster.pu_running
    pu_free[~np.repeat(cluster.machine_enabled, cluster.P)] = 0
    machine_free = pu_free.reshape(M, cluster.P).sum(axis=1)  # kschedlint: disable=int32-reduce -- a host numpy sum
    unplaced = cluster.task_live & (cluster.task_pu < 0)
    base_supply = np.bincount(cluster.task_class[unplaced], minlength=C)
    cost_cm = cluster.cost[
        cluster.a_ecm0 : cluster.a_ecm0 + C * M
    ].reshape(C, M).astype(np.int64)  # kschedlint: host-only (host numpy)
    return machine_free, base_supply, cost_cm


def drain_scenarios(cluster, machine_indices, device="cuda") -> ScenarioBatchResult:
    """Score draining each candidate machine: scenario k reschedules the
    cluster's current unplaced backlog PLUS machine k's displaced tasks
    with machine k's capacity removed. Returns one result per candidate
    (lower objective = cheaper drain)."""
    machine_indices = np.asarray(machine_indices, np.int64)  # kschedlint: host-only (host numpy)
    K = len(machine_indices)
    C, M = cluster.C, cluster.M
    if K and (machine_indices.min() < 0 or machine_indices.max() >= M):
        # a negative index would alias the "unplaced" sentinel in the
        # placed-machine map and drain the wrong machine
        raise IndexError(f"machine indices must be in [0, {M}), got {machine_indices}")

    machine_free, base_supply, cost_cm = _cluster_snapshot(cluster)
    placed_machine = np.where(
        cluster.task_live & (cluster.task_pu >= 0),
        cluster.task_pu // cluster.P,
        -1,
    )

    supply = np.tile(base_supply, (K, 1))
    col_cap = np.tile(machine_free, (K, 1))
    for k, m in enumerate(machine_indices):
        displaced = placed_machine == m
        supply[k] += np.bincount(cluster.task_class[displaced], minlength=C)
        col_cap[k, m] = 0

    solver = WhatIfSolver(
        M, C, unsched_cost=cluster.unsched_cost, ec_cost=cluster.ec_cost,
        device=device,
    )
    return solver.solve_batch(cost_cm, supply, col_cap)


def surge_scenarios(cluster, extra_supply: np.ndarray,
                    device="cuda") -> ScenarioBatchResult:
    """Score admission headroom: scenario k adds extra_supply[k] (per
    class) to the current backlog against today's free capacity."""
    extra_supply = np.asarray(extra_supply, np.int64)  # kschedlint: host-only (host numpy)
    K = extra_supply.shape[0]
    C, M = cluster.C, cluster.M
    assert extra_supply.shape == (K, C)

    machine_free, base_supply, cost_cm = _cluster_snapshot(cluster)
    solver = WhatIfSolver(
        M, C, unsched_cost=cluster.unsched_cost, ec_cost=cluster.ec_cost,
        device=device,
    )
    return solver.solve_batch(
        cost_cm,
        base_supply[None, :] + extra_supply,
        np.tile(machine_free, (K, 1)),
    )
