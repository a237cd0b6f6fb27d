"""Capture and replay superstep-tail rounds of the steady-state configs.

A small minority of steady rounds burn many times the typical superstep
budget. This tool makes those rounds reproducible:

  capture  run the steady-state loop one round at a time, snapshotting
           each round's exact transport instance (cost matrix, window
           supply, free columns) BEFORE the round runs; rounds whose
           supersteps reach a threshold are written to an npz.
  replay   re-solve captured instances under solver-knob sweeps (alpha,
           refine waves) through solver/layered.py `transport_fori`,
           one attempt from the adaptive eps start: the transport
           kernel on the card, so it times what the round runs.
  replay-grouped / replay-tiered
           the group-mode two-stage and full solves (the transport
           kernel) and the preemption-on tiered solve (the tiered
           kernel) of such captures, under their own sweeps.

The npz keys are those of ksched_tpu's tools/tail_repro.py, so an
instance captured by either tool replays in the other.

Usage:
  python -m ksched_tpu_torch.tools.tail_repro capture --config whare \\
      --rounds 200 --out tails.npz [--device cpu]
  python -m ksched_tpu_torch.tools.tail_repro replay --inst tails.npz \\
      --alpha 2,8 --refine 8,32
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..utils.device import resolve_device

#: host-side integer arithmetic of the instances (never a device value)
_I64 = np.int64  # kschedlint: host-only (host numpy arithmetic of captured instances)


def build_config(name: str, device="cuda"):
    """The bench suite's steady-state configs at tools/tail_repro.py's
    sizes, on `device`. Returns (cluster, tasks, initial groups or None)."""
    from ..costmodels import coco, whare
    from ..costmodels.device_costs import coco_device_cost_fn, whare_device_cost_fn
    from ..scheduler.device_bulk import DeviceBulkCluster
    from ..utils.ids import next_pow2

    rng = np.random.default_rng(7)
    groups = None
    if name == "whare":
        tasks, machines = 20_000, 1_000
        platform_factor = rng.integers(80, 140, machines).astype(_I64)
        dev = DeviceBulkCluster(
            num_machines=machines, pus_per_machine=4, slots_per_pu=8,
            num_jobs=20, num_task_classes=4,
            task_capacity=next_pow2(tasks + 4096),
            class_cost_fn=whare_device_cost_fn(
                slots_per_machine=32, platform_factor=platform_factor
            ),
            unsched_cost=whare.UNSCHEDULED_COST, ec_cost=0,
            supersteps=1 << 17, decode_width=2048, device=device,
        )
    elif name == "coco":
        tasks, machines = 50_000, 1_000
        penalties = rng.integers(0, 40, (machines, 4)).astype(_I64)
        dev = DeviceBulkCluster(
            num_machines=machines, pus_per_machine=4, slots_per_pu=16,
            num_jobs=20, num_task_classes=4,
            task_capacity=next_pow2(tasks + 4096),
            class_cost_fn=coco_device_cost_fn(penalties),
            unsched_cost=coco.UNSCHEDULED_COST, ec_cost=0,
            supersteps=1 << 17, decode_width=4096, device=device,
        )
    elif name == "coco-preempt":
        # coco50k-preempt's structure at 20k tasks
        tasks, machines = 20_000, 1_000
        penalties = rng.integers(0, 40, (machines, 4)).astype(_I64)
        dev = DeviceBulkCluster(
            num_machines=machines, pus_per_machine=4, slots_per_pu=8,
            num_jobs=20, num_task_classes=4,
            task_capacity=next_pow2(tasks + 4096),
            class_cost_fn=coco_device_cost_fn(penalties),
            unsched_cost=coco.UNSCHEDULED_COST, ec_cost=0,
            supersteps=1 << 17,
            preemption=True, continuation_discount=8, device=device,
        )
    elif name == "quincy":
        from ..costmodels.quincy_device import QuincyGroupTable

        MBv = 1 << 20
        tasks, machines, n_blocks, G = 10_000, 1_000, 480, 512
        dev = DeviceBulkCluster(
            num_machines=machines, pus_per_machine=4, slots_per_pu=4,
            num_jobs=10, task_capacity=next_pow2(tasks + 4096),
            num_groups=G, supersteps=1 << 17, decode_width=2048, device=device,
        )
        table = QuincyGroupTable(num_groups=G, num_machines=machines, cost_unit_mb=64)
        for b in range(1, n_blocks + 1):
            table.blocks.register(
                b, 512 * MBv, rng.choice(machines, size=3, replace=False).tolist())
        blocks = rng.integers(1, n_blocks + 1, tasks)
        groups = table.groups_for(np.zeros(tasks, np.int32), [[int(b)] for b in blocks])
        table.sync(dev)
    elif name == "multiblock":
        # bench.py's quincy10k-multiblock setup: split quanta,
        # heavy-tailed block sizes, a skewed template pool
        from ..costmodels.quincy_device import QuincyGroupTable

        MBv = 1 << 20
        tasks, machines, n_blocks, G = 10_000, 1_000, 480, 1024
        n_templates = 640
        dev = DeviceBulkCluster(
            num_machines=machines, pus_per_machine=4, slots_per_pu=4,
            num_jobs=10, task_capacity=next_pow2(tasks + 4096),
            num_groups=G, supersteps=1 << 17, decode_width=2048,
            active_groups_cap=(128, 256, 512), two_stage_eps0="quarter",
            device=device,
        )
        table = QuincyGroupTable(num_groups=G, num_machines=machines,
                                 cost_unit_mb=64, sig_unit_mb=128)
        rng7 = np.random.default_rng(7)
        sizes = (128 * MBv * np.exp(rng7.exponential(1.2, n_blocks))).astype(_I64)
        sizes = np.minimum(sizes, 4096 * MBv)
        for b in range(1, n_blocks + 1):
            table.blocks.register(
                b, int(sizes[b - 1]),
                rng7.choice(machines, size=3, replace=False).tolist())
        templates = [
            sorted(rng7.choice(n_blocks, size=int(rng7.integers(2, 4)), replace=False) + 1)
            for _ in range(n_templates)
        ]
        popularity = 1.0 / np.arange(1, n_templates + 1) ** 0.8
        popularity /= np.sum(popularity)
        t_idx = rng7.choice(n_templates, size=tasks, p=popularity)
        groups = table.groups_for(np.zeros(tasks, np.int32), [templates[t] for t in t_idx])
        table.sync(dev)
    else:
        raise SystemExit(f"unknown config {name!r}")
    return dev, tasks, groups


def capture_rounds(dev, tasks: int, rounds: int, threshold: int, warmup: int = 0,
                   groups=None, verbose: bool = False, log=print):
    """The capture loop on a built cluster: `tasks` tasks added
    (`default_rng(0)`; `groups` their groups in group mode) and a fill
    round, `warmup` steady rounds in chunks of 256, then `rounds` rounds
    driven from the host (complete and admit 1% of the tasks), each
    round's pre-solve state kept when its supersteps reach `threshold`.
    Returns ([(supersteps, state)], supersteps of every round)."""
    rng = np.random.default_rng(0)
    grouped = groups is not None
    if grouped:
        dev.add_tasks(tasks, rng.integers(0, dev.J, tasks).astype(np.int32), groups=groups)
    else:
        dev.add_tasks(tasks, rng.integers(0, dev.J, tasks).astype(np.int32),
                      rng.integers(0, dev.C, tasks).astype(np.int32))
    dev.fetch_stats(dev.round())
    churn_n = max(1, int(tasks * 0.01))
    # tail rounds appear after the backlog drifts into the contended
    # regime: the warm-up runs as chained chunks before the one-by-one
    # capture rounds
    warm_chunk = 256
    for w0 in range(0, warmup, warm_chunk):
        stats = dev.fetch_stats(dev.run_steady_rounds(
            min(warm_chunk, warmup - w0), 0.01, churn_n, seed=w0))
        if verbose:
            ss = stats["supersteps"]
            log(f"# warmup {w0}+{len(ss)}: ss p50={np.percentile(ss, 50):.0f} "
                f"max={ss.max()}", file=sys.stderr)
    insts = []
    ss_all = []
    for i in range(rounds):
        # churn from the host (complete + admit), snapshot the exact
        # pre-solve state, then run the round
        st0 = dev.fetch_state()
        placed_rows = np.nonzero(st0["live"] & (st0["pu"] >= 0))[0]
        done = rng.choice(placed_rows, size=min(churn_n, len(placed_rows)), replace=False)
        dev.complete_tasks(done.astype(np.int32))
        if grouped:
            dev.add_tasks(churn_n, rng.integers(0, dev.J, churn_n).astype(np.int32),
                          groups=rng.integers(0, dev.G, churn_n).astype(np.int32))
        else:
            dev.add_tasks(churn_n, rng.integers(0, dev.J, churn_n).astype(np.int32),
                          rng.integers(0, dev.C, churn_n).astype(np.int32))
        st = dev.fetch_state()
        ss = int(dev.fetch_stats(dev.round())["supersteps"])
        ss_all.append(ss)
        if ss >= threshold:
            insts.append((ss, st))
        if verbose and (ss >= threshold or i % 20 == 0):
            log(f"# round {i}: supersteps={ss}", file=sys.stderr)
    return insts, np.array(ss_all)


def capture_summary(ss_all, threshold: int, kept: int) -> str:
    """tools/tail_repro.py's capture line."""
    return (
        f"rounds={len(ss_all)} supersteps p50={np.percentile(ss_all, 50):.0f} "
        f"p90={np.percentile(ss_all, 90):.0f} p99={np.percentile(ss_all, 99):.0f} "
        f"max={ss_all.max()} tails>={threshold}: {kept}"
    )


def instances_npz(dev, insts, grouped: bool) -> dict:
    """The captured instances as tools/tail_repro.py's npz arrays."""
    out = {}
    if grouped:
        # per-group supply over the decode window + machine_free; the
        # GroupSpec arrays are capture-static, saved once
        for k, (ss, st) in enumerate(insts):
            supply, machine_free = grouped_instance_from_state(dev, st)
            out[f"supply_{k}"] = supply
            out[f"free_{k}"] = machine_free
            out[f"ss_{k}"] = _I64(ss)
        g = dev.groups
        out.update(
            n=_I64(len(insts)), n_scale=_I64(dev.n_scale), Mp=_I64(dev.Mp),
            grouped=_I64(1), g_e=g.e.cpu().numpy(), g_u=g.u.cpu().numpy(),
            g_pref=g.pref_w.cpu().numpy(), active_cap=_I64(dev.active_groups_cap),
        )
        return out
    # each tail round's transport instance from its pre-round snapshot
    for k, (ss, st) in enumerate(insts):
        inst = instance_from_state(dev, st)
        out[f"w_{k}"] = inst[0]
        out[f"supply_{k}"] = inst[1]
        out[f"colcap_{k}"] = inst[2]
        if dev.preemption:
            out[f"residents_{k}"] = inst[3]
        out[f"ss_{k}"] = _I64(ss)
    out["n"] = _I64(len(insts))
    out["n_scale"] = _I64(dev.n_scale)
    out["Mp"] = _I64(dev.Mp)
    out["preempt"] = _I64(int(dev.preemption))
    out["discount"] = _I64(dev.continuation_discount)
    return out


def capture(args, log=print):
    """capture: build `args.config` on `args.device`, run the capture
    loop and write the kept instances to `args.out`. Returns the npz
    arrays (None when no round reached the threshold)."""
    dev, tasks, groups = build_config(args.config, device=args.device)
    insts, ss_all = capture_rounds(dev, tasks, args.rounds, args.threshold, args.warmup,
                                   groups=groups, verbose=args.verbose, log=log)
    log(capture_summary(ss_all, args.threshold, len(insts)))
    if not insts:
        log("no tail rounds captured; lower --threshold")
        return None
    out = instances_npz(dev, insts, groups is not None)
    np.savez_compressed(args.out, **out)
    kind = "grouped instances" if groups is not None else "instances"
    log(f"wrote {len(insts)} {kind} to {args.out}")
    return out


def grouped_instance_from_state(dev, st):
    """(supply[G] over the decode window, machine_free[M]) for a
    group-mode round, as the round's window census computes them."""
    live, pu, grp = st["live"], st["pu"], st["grp"]
    M, P, S = dev.M, dev.P, dev.S
    placed = live & (pu >= 0)
    pu_running = np.zeros(dev.num_pus, _I64)
    np.add.at(pu_running, pu[placed], 1)
    pu_free = np.where(np.repeat(st["machine_enabled"], P), S - pu_running, 0)
    machine_free = np.sum(pu_free.reshape(M, P), axis=1)
    W = dev.decode_width or dev.Tcap
    rows = np.nonzero(live & (pu < 0))[0][:W]
    supply = np.bincount(grp[rows], minlength=dev.G)
    return supply.astype(np.int32), machine_free.astype(np.int32)


def instance_from_state(dev, st):
    """(w[C, M], supply[C], col_cap[Mp]) the round core solves for a
    fetched state, with a zero window offset. In preemption mode supply
    counts ALL live tasks, col_cap the total slots, and a 4th value is
    the resident census R[C, M]. The cost callback runs on the cluster's
    device."""
    live, pu, cls = st["live"], st["pu"], st["cls"]
    M, P, S, C = dev.M, dev.P, dev.S, dev.C
    num_pus = dev.num_pus
    placed = live & (pu >= 0)
    machine = np.clip(pu, 0, num_pus - 1) // P
    census = np.zeros((M, C), _I64)
    np.add.at(census, (machine[placed], cls[placed]), 1)
    pu_running = np.zeros(num_pus, _I64)
    np.add.at(pu_running, pu[placed], 1)
    enabled = st["machine_enabled"]
    pu_free = np.where(np.repeat(enabled, P), S - pu_running, 0)
    machine_free = np.sum(pu_free.reshape(M, P), axis=1)
    on_dev = torch.as_tensor(census.astype(np.int32), device=dev.device)
    cost_cm = dev.class_cost_fn(on_dev).cpu().numpy().astype(_I64)
    w = cost_cm + dev.ec_cost - dev.unsched_cost
    col_cap = np.zeros(dev.Mp, _I64)
    if dev.preemption:
        supply = np.bincount(cls[live], minlength=C)
        col_cap[:M] = np.where(enabled, P * S, 0)
        col_cap[-1] = np.sum(supply)
        R = np.zeros((C, M), _I64)
        np.add.at(R, (cls[placed], machine[placed]), 1)
        return (w.astype(np.int32), supply.astype(np.int32),
                col_cap.astype(np.int32), R.astype(np.int32))
    W = dev.decode_width or dev.Tcap
    rows = np.nonzero(live & (pu < 0))[0][:W]
    supply = np.bincount(cls[rows], minlength=C)
    col_cap[:M] = machine_free
    col_cap[-1] = np.sum(supply)
    return w.astype(np.int32), supply.astype(np.int32), col_cap.astype(np.int32)


def _i32(x, device):
    return torch.as_tensor(np.asarray(x).astype(np.int32), device=device)


def replay(args, log=print) -> list:
    """Re-solve every captured instance at each alpha x refine point:
    one `transport_fori` attempt from the adaptive eps start
    (`choose_eps0`), no retry. Logs tools/tail_repro.py's lines; returns
    per instance its points (alpha, refine, ss, conv, obj)."""
    from ..solver.layered import choose_eps0, transport_fori

    device = resolve_device(args.device)
    data = np.load(args.inst)
    n, n_scale, Mp = int(data["n"]), int(data["n_scale"]), int(data["Mp"])
    alphas = [int(a) for a in args.alpha.split(",")]
    refines = [int(r) for r in args.refine.split(",")]
    res = []
    for k in range(n):
        w = data[f"w_{k}"].astype(_I64)
        supply = data[f"supply_{k}"]
        col_cap = data[f"colcap_{k}"]
        orig = int(data[f"ss_{k}"])
        C, M = w.shape
        wP = np.zeros((C, Mp), _I64)
        wP[:, :M] = w
        wS = _i32(wP * n_scale, device)
        sup, cap = _i32(supply, device), _i32(col_cap, device)
        eps_full = int(max(1, np.abs(wP).max() * n_scale))
        eps0 = int(choose_eps0(n_scale, eps_full, int(np.sum(supply, dtype=_I64)),
                               int(np.sum(col_cap[:M], dtype=_I64))))
        log(f"instance {k}: C={C} M={M} supply={supply.tolist()} "
            f"cap_total={int(np.sum(col_cap[:M], dtype=_I64))} orig_ss={orig}")
        points = []
        for alpha in alphas:
            for refine in refines:
                y, _pm, steps, conv, _known = transport_fori(
                    wS, sup, cap, 1 << 17, alpha=alpha, eps0=eps0,
                    refine_waves=refine, eps0_retry=False)
                obj = int(np.sum(y.cpu().numpy().astype(_I64)[:, :M] * wP[:, :M]))
                points.append({"alpha": alpha, "refine": refine, "ss": int(steps),
                               "conv": bool(conv), "obj": obj})
                log(f"  alpha={alpha} refine={refine}: "
                    f"ss={int(steps)} conv={bool(conv)} obj={obj}")
        res.append({"orig_ss": orig, "points": points})
    return res


def replay_grouped(args, log=print) -> list:
    """Re-solve captured GROUPED instances under strategy sweeps, as
    the device round's grouped dispatch does (two-stage decomposition
    with its bounded eps0 attempt, active-row compaction, the refined
    full fallback), outside the round so strategies compare on real
    contention rounds. Strategies: `two:<eps0>:<budget>[:<fallback
    eps0>]` or `full:<eps0>:<alpha>` (eps0 `1`, `n4` = n_scale/4, `n`,
    `n2`, `full`). Logs tools/tail_repro.py's lines; returns per
    instance each strategy's (ss, obj)."""
    from ..solver.layered import choose_eps0, split_grants_by_class, transport_fori

    device = resolve_device(args.device)
    data = np.load(args.inst)
    n, n_scale, Mp = int(data["n"]), int(data["n_scale"]), int(data["Mp"])
    e = data["g_e"].astype(_I64)
    u = data["g_u"].astype(_I64)
    pref = data["g_pref"].astype(_I64)
    G, M = pref.shape
    route = np.broadcast_to(e[:, None], (G, M))
    w = np.minimum(route, pref) - u[:, None]
    ground = e - u  # [G]
    strategies = args.strategies.split(",")
    active_cap = int(data["active_cap"])
    res = []
    for k in range(n):
        supply = data[f"supply_{k}"].astype(np.int32)
        machine_free = data[f"free_{k}"].astype(np.int32)
        orig = int(data[f"ss_{k}"])
        total = int(np.sum(supply, dtype=_I64))
        free_total = int(np.sum(machine_free, dtype=_I64))
        # active-row compaction (as the device path does)
        act = np.nonzero(supply > 0)[0]
        if len(act) > active_cap:
            act = np.arange(G)
        wA, supA, groundA = w[act], supply[act], ground[act]
        Ga = len(act)
        col_cap = np.zeros(Mp, _I64)
        col_cap[:M] = machine_free
        col_cap[-1] = total
        wP = np.zeros((Ga, Mp), _I64)
        wP[:, :M] = wA
        wS = _i32(wP * n_scale, device)
        supJ, capJ = _i32(supA, device), _i32(col_cap, device)
        eps_full = int(max(1, np.abs(wP).max() * n_scale))
        D = np.maximum(groundA[:, None] - wA, 0)
        w1P = np.zeros((Ga, Mp), _I64)
        w1P[:, :M] = np.where(D > 0, -D, 1)
        wS1 = _i32(w1P * n_scale, device)
        two_stage_ok = (total <= free_total) and bool(((groundA < 0) | (supA == 0)).all())
        log(f"inst {k}: rows={Ga} total={total} free={free_total} "
            f"two_stage_ok={two_stage_ok} orig_ss={orig}")
        obj_ref = None
        rows = []
        for strat in strategies:
            ss_total = 0
            if strat.startswith("two"):
                parts = strat.split(":")
                _, e0name, budget = parts[:3]
                fb_name = parts[3] if len(parts) > 3 else None
                e0 = {"1": 1, "n4": n_scale // 4, "n": n_scale}[e0name]
                y1, _pm, s1, conv1, _known = transport_fori(
                    wS1, supJ, capJ, 1 << 17, alpha=2, refine_waves=8,
                    eps0=int(e0), eps0_budget=int(budget), eps0_retry=False)
                ss_total += int(s1)
                if bool(conv1):
                    y1r = y1.cpu().numpy().astype(_I64)[:, :M]
                    left = supA - np.sum(y1r, axis=1)
                    rem = machine_free - np.sum(y1r, axis=0)
                    excl = np.cumsum(rem) - rem
                    grants_m = np.clip(np.sum(left) - excl, 0, rem)
                    y_real = y1r + split_grants_by_class(grants_m, left)
                else:
                    fb = {
                        None: int(choose_eps0(n_scale, eps_full, total, free_total,
                                              short=n_scale)),
                        "n4": n_scale // 4, "n": n_scale, "n2": n_scale // 2, "1": 1,
                    }[fb_name]
                    y_f, _pm, s2, conv2, _known = transport_fori(
                        wS, supJ, capJ, 1 << 17, alpha=2, refine_waves=8, eps0=int(fb))
                    ss_total += int(s2)
                    assert bool(conv2)
                    y_real = y_f.cpu().numpy().astype(_I64)[:, :M]
            else:
                _, e0name, alpha = strat.split(":")
                e0 = {"1": 1, "n4": n_scale // 4, "n": n_scale, "full": eps_full}[e0name]
                y_f, _pm, s2, conv2, _known = transport_fori(
                    wS, supJ, capJ, 1 << 17, alpha=int(alpha), refine_waves=8,
                    eps0=int(e0))
                ss_total += int(s2)
                assert bool(conv2)
                y_real = y_f.cpu().numpy().astype(_I64)[:, :M]
            obj = int(np.sum(wA * y_real))
            if obj_ref is None:
                obj_ref = obj
            flag = "" if obj == obj_ref else f"  OBJ DRIFT ({obj - obj_ref:+d})"
            rows.append({"strategy": strat, "ss": ss_total, "obj": obj})
            log(f"  {strat:14s}: ss={ss_total}{flag}")
        res.append({"orig_ss": orig, "two_stage_ok": two_stage_ok, "points": rows})
    return res


def replay_tiered(args, log=print) -> list:
    """Re-solve captured PREEMPT (tiered) instances under eps0 x refine
    sweeps through `transport_fori_tiered` (the tiered kernel on the
    card). Logs tools/tail_repro.py's lines; returns per instance its
    points (eps0 label, refine, ss, conv, obj)."""
    from ..solver.layered import transport_fori_tiered

    device = resolve_device(args.device)
    data = np.load(args.inst)
    assert int(data["preempt"]) == 1, "not a preempt capture"
    n, n_scale, Mp = int(data["n"]), int(data["n_scale"]), int(data["Mp"])
    discount = int(data["discount"])
    refines = [int(r) for r in args.refine.split(",")]
    res = []
    for k in range(n):
        w = data[f"w_{k}"].astype(_I64)
        supply = data[f"supply_{k}"]
        col_cap = data[f"colcap_{k}"]
        R = data[f"residents_{k}"].astype(_I64)
        orig = int(data[f"ss_{k}"])
        C, M = w.shape
        wHiP = np.zeros((C, Mp), _I64)
        wHiP[:, :M] = w
        wLoP = wHiP.copy()
        wLoP[:, :M] -= discount
        RP = np.zeros((C, Mp), _I64)
        RP[:, :M] = R
        wHi, wLo = _i32(wHiP * n_scale, device), _i32(wLoP * n_scale, device)
        RJ = _i32(RP, device)
        supJ, capJ = _i32(supply, device), _i32(col_cap, device)
        eps_full = int(max(1, np.abs(wHiP).max() * n_scale))
        log(f"inst {k}: C={C} total={int(np.sum(supply, dtype=_I64))} "
            f"residents={int(np.sum(R))} cap={int(np.sum(col_cap[:M], dtype=_I64))} "
            f"orig_ss={orig}")
        obj_ref = None
        points = []
        for label, eps0 in [("full", eps_full), ("n", n_scale),
                            ("n/4", n_scale // 4), ("n/16", n_scale // 16)]:
            for rw in refines:
                y, _pm, steps, conv, _known = transport_fori_tiered(
                    wLo, wHi, RJ, supJ, capJ, 1 << 17,
                    alpha=8, eps0=int(max(1, eps0)), refine_waves=rw)
                yr = y.cpu().numpy().astype(_I64)[:, :M]
                ret = np.minimum(yr, R)
                obj = int(np.sum(wHiP[:, :M] * yr) - discount * np.sum(ret))
                if obj_ref is None:
                    obj_ref = obj
                drift = "" if obj == obj_ref else f"  OBJ {obj - obj_ref:+d}"
                points.append({"eps0": label, "refine": rw, "ss": int(steps),
                               "conv": bool(conv), "obj": obj})
                log(f"  eps0={label:5s} refine={rw:2d}: ss={int(steps)} "
                    f"conv={bool(conv)}{drift}")
        res.append({"orig_ss": orig, "points": points})
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m ksched_tpu_torch.tools.tail_repro")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    sub = ap.add_subparsers(dest="cmd", required=True)
    cap = sub.add_parser("capture")
    cap.add_argument("--config", default="whare",
                     choices=["whare", "coco", "quincy", "multiblock", "coco-preempt"])
    cap.add_argument("--rounds", type=int, default=200)
    cap.add_argument("--warmup", type=int, default=0)
    cap.add_argument("--threshold", type=int, default=5000)
    cap.add_argument("--out", default="tails.npz")
    cap.add_argument("--verbose", action="store_true")
    cap.set_defaults(fn=capture)
    rep = sub.add_parser("replay")
    rep.add_argument("--inst", default="tails.npz")
    rep.add_argument("--alpha", default="2,8")
    rep.add_argument("--refine", default="8,32")
    rep.set_defaults(fn=replay)
    repg = sub.add_parser("replay-grouped")
    repg.add_argument("--inst", default="tails_q.npz")
    repg.add_argument("--strategies", default="two:1:256,two:n4:1024,full:n4:2,full:n:2",
                      help="comma list: two:<eps0>:<budget> or full:<eps0>:<alpha>")
    repg.set_defaults(fn=replay_grouped)
    rept = sub.add_parser("replay-tiered")
    rept.add_argument("--inst", default="tails_preempt.npz")
    rept.add_argument("--refine", default="0,8")
    rept.set_defaults(fn=replay_tiered)
    args = ap.parse_args(argv)
    resolve_device(args.device)
    args.fn(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
