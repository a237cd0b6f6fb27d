"""The event-path chaos soak: the SchedulerService under a seeded fault
schedule (runtime/chaos.py) — control-plane outages, dropped binding
POSTs, machine heartbeat flaps, forced solver faults (non-convergence,
backend exceptions, NaN'd costs) — with mid-soak kill-and-restore from
a service checkpoint. It asserts, every chunk: zero scheduler crashes
(any exception fails the soak), supply/binding/capacity invariants,
and at the end that every injected fault is accounted for in the
per-round RoundRecord counters. The acceptance arms (`chaos_main`):
determinism (two runs, identical placements and fault totals),
recovery (device bit flips audited every round and kill-and-restores
through the warm manifest, against a clean control run) and loop
parity (sync, pipelined, pipelined + device-resident).

Run: python -m ksched_tpu_torch.drivers.soak --rounds 96 --chunk 32 \
         --seed 0 --machines 6 --slots 8 --chaos-restore-every 48 \
         --verify-determinism [--device cpu]

Port of the chaos soak of ksched_tpu's tools/soak.py (its device-bulk
soak and its tenant soak are not ported). The soak's solves run on
``args.device`` ("cuda" by default, "cpu" for the plain versions).
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time

import numpy as np


def check_service_invariants(svc, where: str) -> None:
    """The event-path soak's state invariants: supply conservation in
    the flow graph, binding/table consistency, per-PU capacity, and no
    binding onto a machine the resource map no longer holds."""
    from ..data import TaskState

    sched = svc.scheduler
    assert sched.gm.sink_node.excess == -len(sched.gm.task_to_node), (
        f"supply invariant broken {where}: sink excess "
        f"{sched.gm.sink_node.excess} vs {len(sched.gm.task_to_node)} tasks"
    )
    per_pu: dict = {}
    for tid, rid in sched.task_bindings.items():
        rs = svc.resource_map.find(rid)
        assert rs is not None, f"binding onto missing resource {rid} {where}"
        td = svc.task_map.find(tid)
        assert td is not None and td.state == TaskState.RUNNING, (
            f"bound task {tid} not RUNNING {where}"
        )
        assert tid in svc.task_to_pod, f"bound task {tid} missing pod map {where}"
        per_pu[rid] = per_pu.get(rid, 0) + 1
    for rid, n in per_pu.items():
        assert n <= svc.max_tasks_per_pu, (
            f"PU {rid} over capacity ({n} > {svc.max_tasks_per_pu}) {where}"
        )
    for pod_id, tid in svc.pod_to_task.items():
        assert svc.task_to_pod.get(tid) == pod_id, (
            f"pod map asymmetry for {pod_id} {where}"
        )


def reconcile_obs(served: dict, tracer, injector) -> None:
    """Assert the LIVE Prometheus text (scraped over HTTP) agrees
    exactly with the soak's two other accounting surfaces: the
    injector's deterministic Counter and the summed RoundRecord JSONL.
    Any drift between what the registry served and what the rounds
    recorded is a bug in the publication path."""

    def served_value(name, **labels):
        return served.get((name, tuple(sorted(labels.items()))), 0.0)

    for kind, n in injector.counters.items():
        got = served_value("ksched_chaos_injected_total", kind=kind)
        assert got == n, f"served chaos_injected[{kind}]={got} != injector {n}"
    attributed: dict = {}
    for rec in tracer.records:
        for k, v in rec.faults_injected.items():
            attributed[k] = attributed.get(k, 0) + v
    for kind, n in attributed.items():
        got = served_value("ksched_faults_attributed_total", kind=kind)
        assert got == n, f"served faults_attributed[{kind}]={got} != records {n}"
    checks = {
        "ksched_retries_total": sum(r.retries for r in tracer.records),
        "ksched_round_degradations_total": sum(
            r.degradations for r in tracer.records
        ),
        "ksched_deadline_misses_total": sum(
            1 for r in tracer.records if r.deadline_miss
        ),
        "ksched_machines_lost_total": sum(r.machines_lost for r in tracer.records),
        "ksched_scheduled_tasks_total": sum(
            r.num_scheduled for r in tracer.records
        ),
    }
    for name, want in checks.items():
        got = served_value(name)
        assert got == want, f"served {name}={got} != summed records {want}"
    kinds = {
        "noop": sum(1 for r in tracer.records if r.noop_round),
        "idle": sum(
            1 for r in tracer.records if r.solver_rung == -1 and not r.noop_round
        ),
    }
    kinds["sched"] = len(tracer.records) - kinds["noop"] - kinds["idle"]
    for kind, want in kinds.items():
        got = served_value("ksched_rounds_total", kind=kind)
        assert got == want, f"served rounds_total[{kind}]={got} != {want}"


def run_chaos_soak(args, log=print) -> dict:
    """Drive the SchedulerService for args.rounds rounds under a seeded
    fault schedule, single-threaded and in logical time (1 round = 1 s
    of heartbeat clock) so the whole run is deterministic. Returns the
    final placements and fault totals for cross-run comparison.

    The run gets a PRIVATE metrics registry (scoped_registry) so its
    counters start from zero — the determinism double-run would
    otherwise accumulate in the process registry. With --metrics-port
    the registry is served live during the run and scraped back over
    HTTP at the end; reconcile_obs then asserts the served text, the
    injector totals, and the summed RoundRecords agree exactly."""
    from ..obs import scoped_registry

    with scoped_registry() as reg:
        return _run_chaos_soak_in_registry(args, reg, log)


def _run_chaos_soak_in_registry(args, reg, log=print) -> dict:
    from ..obs import DeviceProfiler, MetricsServer, set_profiler
    from ..utils import seed_rng

    seed_rng(args.seed)  # task/job/machine ids come from the global RNG
    set_profiler(DeviceProfiler())  # per-run solve/export accounting
    server = None
    # getattr: callers (tests) build a bare Namespace without obs flags
    metrics_port = getattr(args, "metrics_port", None)
    if metrics_port is not None:
        server = MetricsServer(port=metrics_port, registry=reg)
        log(f"metrics: {server.url}/metricsz", flush=True)
    try:
        return _chaos_soak_body(args, reg, server, log)
    finally:
        # an invariant/reconcile assertion mid-run must not leak the
        # HTTP thread or leave the module profiler pinned to this run's
        # (popped) scoped registry for later in-process callers
        set_profiler(None)
        if server is not None:
            server.stop()


def _chaos_soak_body(args, reg, server, log=print) -> dict:
    from ..cli import SchedulerService
    from ..cluster import NodeEvent, PodEvent, SyntheticClusterAPI
    from ..obs import dump_registry, scrape
    from ..runtime import (
        ChaosClusterAPI,
        ChaosPolicy,
        FaultInjector,
        RoundTracer,
    )
    from ..solver.select import make_backend

    device = getattr(args, "device", "cuda")
    corruption = bool(getattr(args, "corruption", False))
    if getattr(args, "control_clean_policy", False):
        # the recovery soak's clean control arm: zero faults of any
        # kind, same seed — the bit-identical baseline the corruption
        # arm must match after detection + repair
        policy = ChaosPolicy(seed=args.seed)
    elif corruption:
        # the recovery soak isolates the state-corruption fault domains
        # (device bit flips + WAL damage at kill points) so its clean
        # control arm is comparable bit-for-bit; the mixed-domain fault
        # schedule stays covered by chaos/obs/pipeline smokes
        policy = ChaosPolicy(
            seed=args.seed,
            device_corrupt_prob=0.25,
            wal_corrupt_prob=float(getattr(args, "wal_chaos", 0.0)),
        )
    else:
        policy = ChaosPolicy(
            seed=args.seed,
            api_outage_prob=0.04,
            api_outage_rounds=(1, 3),
            binding_drop_prob=0.08,
            machine_flap_prob=0.008,
            machine_flap_rounds=(2, 5),
            solver_fault_prob=0.06,
            solver_total_outage_prob=getattr(args, "solver_outage_prob", None)
            if getattr(args, "solver_outage_prob", None) is not None
            else 0.01,
        )
    injector = FaultInjector(policy)
    api = ChaosClusterAPI(SyntheticClusterAPI(), injector)
    tracer = RoundTracer()
    hb_timeout_s = 2.5  # a 3-round flap kills a machine; 2-round flaps survive

    # optional flight recorder (the obs smoke's stall-dump assertion):
    # NOOP rounds auto-dump the ring, and each dump embeds the soltel
    # stall ring — the structured reasons + telemetry tails the
    # degradation ladder deposited
    flight = None
    span_tracer = None
    flight_dir = getattr(args, "flight_dir", None)
    if flight_dir:
        from ..obs import FlightRecorder, SpanTracer
        from ..obs import soltel

        soltel.reset_stalls()  # assert THIS run's stalls, not a prior run's
        flight = FlightRecorder(
            capacity=32, dump_dir=flight_dir, registry=reg,
            min_rounds_between_dumps=8,
        )
        span_tracer = SpanTracer().install()

    pipeline = getattr(args, "loop", "sync") == "pipelined"
    device_resident = bool(getattr(args, "device_resident", False))
    if getattr(args, "corruption", False):
        device_resident = True  # the poison scatter needs a device mirror

    audit_every = int(getattr(args, "audit_every", 0) or 0)
    if corruption:
        # corruption mode pins the cadence to 1: the soak's acceptance
        # (every flip detected the round it happens, divergences ==
        # injected flips) is only well-defined per-round — a sparser
        # cadence would collapse multiple flips into one detection
        audit_every = 1

    def make_service():
        return SchedulerService(
            api,
            max_tasks_per_pu=args.slots,
            backend=make_backend(args.chaos_backend, device=device),
            backend_name=args.chaos_backend,
            injector=injector,
            tracer=tracer,
            round_deadline_s=30.0,
            flight=flight,
            span_tracer=span_tracer,
            pipeline=pipeline,
            device_resident=device_resident,
            audit_every=audit_every,
            device=device,
        )

    svc = make_service()
    svc.enable_heartbeats(machine_timeout_s=hb_timeout_s, task_timeout_s=1e9)
    svc.init_topology(fake_machines=args.machines, pus_per_core=2)

    wrng = np.random.default_rng(np.random.SeedSequence([args.seed, 0xC0C0]))
    pod_seq = 0
    pending_rejoin: list = []  # (due_round, node_id)
    cooldown = 16  # fault-free tail so dropped bindings settle
    total_rounds = args.rounds + cooldown
    restores = 0
    warm_restores = 0
    from collections import Counter as _Counter

    integrity_totals: _Counter = _Counter()  # summed across restores
    all_latencies: list = []  # round latencies summed across restores
    awaiting_recovery = False  # assert the first post-restore SOLVED round
    restore_had_warm_solver = False
    restore_caps = (0, 0)  # pow2 buckets at restore (growth waiver)
    restore_overflows = 0  # plan overflow count at restore (rebuild waiver)
    recovery_strict = 0  # recovery rounds that held the delta-kind asserts
    recovery_latencies: list = []
    t0 = time.perf_counter()

    for r in range(total_rounds):
        now = float(r)
        if r == args.rounds:
            injector.quiesce()
        injector.begin_round(r)

        # node rejoin: machines lost to heartbeat expiry come back
        while pending_rejoin and pending_rejoin[0][0] <= r:
            _, node_id = pending_rejoin.pop(0)
            svc.add_node(NodeEvent(node_id=node_id, num_cores=1, pus_per_core=2))

        # workload: seeded pod arrivals (bounded backlog) + completions
        if r < args.rounds:
            if len(svc.pod_to_task) < args.machines * args.slots * 2:
                for _ in range(int(wrng.integers(0, 4))):
                    api.submit_pod(PodEvent(pod_id=f"pod_{pod_seq}"))
                    pod_seq += 1
            if r % 2 == 1:
                bound = sorted(
                    p for p, t in svc.pod_to_task.items()
                    if t in svc.scheduler.task_bindings
                )
                if bound:
                    k = int(wrng.integers(1, min(5, len(bound)) + 1))
                    for j in sorted(
                        int(x) for x in wrng.choice(len(bound), k, replace=False)
                    ):
                        svc.complete_pod(bound[j])

        # heartbeats: every machine beats unless the injector flaps it
        nodes_before = dict(svc.node_to_machine)
        for node_id, mid in sorted(nodes_before.items()):
            if not injector.machine_silent(mid):
                svc.monitor.record_machine_heartbeat(mid, now=now)

        # Pipelined loops post round r's bindings in round r+1's
        # dispatch window — AFTER that round's poll, which would shift
        # a dropped binding's pod resurface by one poll vs the sync
        # loop. The soak drives LOGICAL rounds and asserts cross-loop
        # placement parity, so it flushes before polling: the POST
        # sequence (and every drop draw) hits the API in the same
        # order and poll alignment as the synchronous loop. The live
        # service (cli.run) keeps the overlap window instead.
        svc.flush_pending_bindings()
        pods = api.poll_pod_batch(0.005)
        svc.run_round(pods, now=now)

        # first post-restore SOLVED round: warm restores must resume on
        # the delta-sized warm path — no full_build export, delta plan
        # sync, fresh/warm solve scope — and its latency is reported
        # alongside the p50/p99 summary (the recovery-round cost class)
        if awaiting_recovery and tracer.records and tracer.records[-1].solver_rung >= 0:
            rec = tracer.records[-1]
            sol = svc.scheduler.solver
            lat = svc.round_latencies_s[-1] if svc.round_latencies_s else 0.0
            recovery_latencies.append(lat)
            scope = kind = plan_kind = "-"
            st = sol.state
            # a pow2 bucket growth landing on this very round rebuilds
            # the mirror legitimately (it would without the kill too) —
            # the delta-kind asserts apply when the bucket held
            grew = (st.n_cap, st.m_cap) != restore_caps
            if svc.restored_warm and rec.solver_rung == 0 and not rec.noop_round:
                assert sol._started, (
                    f"post-restore round {r + 1} fell back to the cold "
                    "full_build export path"
                )
                overflowed = (
                    sol.state.plan.region_overflows > restore_overflows
                )
                if sol.resident is not None and not grew and not overflowed:
                    kind = sol.resident.last_upload_kind
                    plan_kind = sol.resident.last_plan_kind
                    assert kind == "delta", (
                        f"post-restore round {r + 1} re-uploaded the problem "
                        f"wholesale (upload kind {kind!r}, want 'delta')"
                    )
                    assert plan_kind in ("delta", "clean"), (
                        f"post-restore round {r + 1} rebuilt the CSR plan "
                        f"(plan sync {plan_kind!r}, want delta/clean)"
                    )
                    recovery_strict += 1
                from ..runtime.checkpoint import find_jax_solver

                csr = find_jax_solver(sol.backend)
                if csr is not None and restore_had_warm_solver:
                    scope = csr.last_warm_scope
                    assert scope in ("warm", "fresh"), (
                        f"post-restore round {r + 1} solved COLD "
                        f"(scope {scope!r}): the warm endpoints did not survive"
                    )
            log(
                f"recovery round {r + 1}: latency={lat * 1e3:.2f}ms "
                f"upload={kind} plan_sync={plan_kind} warm_scope={scope} "
                f"(restored_warm={svc.restored_warm})",
                flush=True,
            )
            awaiting_recovery = False

        # machines the sweep expired rejoin (as fresh registrations) later
        for node_id in sorted(set(nodes_before) - set(svc.node_to_machine)):
            pending_rejoin.append((r + 5, node_id))

        if (r + 1) % args.chunk == 0 or r == total_rounds - 1:
            check_service_invariants(svc, f"at round {r + 1}")
            rec = tracer.records[-1]
            log(
                f"round {r + 1:6d}: live_pods={len(svc.pod_to_task)} "
                f"bound={len(svc.scheduler.task_bindings)} "
                f"machines={len(svc.node_to_machine)} "
                f"noop={svc.noop_rounds} restores={restores} "
                f"faults={sum(injector.counters.values())}",
                flush=True,
            )

        # mid-soak kill-and-restore: the service process "dies" and a new
        # one resumes from the checkpoint, with cold solver state
        if (
            args.chaos_restore_every
            and r < args.rounds
            and (r + 1) % args.chaos_restore_every == 0
        ):
            # this service object dies here: bank its integrity totals
            # and its latency history (round_latencies_s resets with it)
            integrity_totals.update(svc.scheduler.solver.integrity_counts)
            all_latencies.extend(svc.round_latencies_s)
            with tempfile.TemporaryDirectory() as td:
                ckpt = os.path.join(td, "svc.ckpt")
                svc.save_checkpoint(ckpt)
                # checkpoint chaos: damage the warm manifest the way a
                # torn write / dropped / duplicated WAL record would —
                # restore must DETECT it (never load garbage) and fall
                # back to the cold event replay
                wal_fault = injector.checkpoint_corruption()
                if wal_fault is not None:
                    from ..runtime.integrity import corrupt_wal_file

                    kind, wal_seed = wal_fault
                    corrupt_wal_file(
                        ckpt + ".wal", kind, np.random.default_rng(wal_seed)
                    )
                before_bindings = dict(svc.scheduler.task_bindings)
                before_pods = dict(svc.pod_to_task)
                svc = SchedulerService.restore(
                    api,
                    ckpt,
                    backend=make_backend(args.chaos_backend, device=device),
                    backend_name=args.chaos_backend,
                    injector=injector,
                    tracer=tracer,
                    round_deadline_s=30.0,
                    flight=flight,
                    span_tracer=span_tracer,
                    pipeline=pipeline,
                    device_resident=device_resident,
                    device=device,
                )
            if wal_fault is not None:
                assert not svc.restored_warm, (
                    f"restore at round {r + 1} loaded a CORRUPTED warm "
                    f"manifest ({wal_fault[0]}) instead of detecting it"
                )
            else:
                assert svc.restored_warm, (
                    f"restore at round {r + 1} fell back to cold replay "
                    "with an intact warm manifest"
                )
            svc.enable_heartbeats(machine_timeout_s=hb_timeout_s, task_timeout_s=1e9)
            assert dict(svc.scheduler.task_bindings) == before_bindings, (
                f"checkpoint restore changed bindings at round {r + 1}"
            )
            assert dict(svc.pod_to_task) == before_pods, (
                f"checkpoint restore changed pod maps at round {r + 1}"
            )
            check_service_invariants(svc, f"after restore at round {r + 1}")
            restores += 1
            if svc.restored_warm:
                warm_restores += 1
            from ..runtime.checkpoint import find_jax_solver

            _j = find_jax_solver(svc.scheduler.solver.backend)
            restore_had_warm_solver = _j is not None and _j._prev is not None
            st = svc.scheduler.solver.state
            restore_caps = (st.n_cap, st.m_cap)
            restore_overflows = st.plan.region_overflows
            awaiting_recovery = True

    # every injected fault must be attributed to some round's record
    attributed: dict = {}
    for rec in tracer.records:
        for k, v in rec.faults_injected.items():
            attributed[k] = attributed.get(k, 0) + v
    assert attributed == dict(injector.counters), (
        f"fault accounting mismatch: rounds say {attributed}, "
        f"injector says {dict(injector.counters)}"
    )
    noops = sum(1 for rec in tracer.records if rec.noop_round)
    degr = sum(rec.degradations for rec in tracer.records)
    integrity_totals.update(svc.scheduler.solver.integrity_counts)
    all_latencies.extend(svc.round_latencies_s)
    dt = time.perf_counter() - t0
    # a pipelined loop holds the final round's POSTs for a dispatch
    # window that will never come; flush before reading api.bindings()
    svc.flush_pending_bindings()
    placements = {
        pod: api.bindings().get(pod)
        for pod in sorted(svc.pod_to_task)
        if svc.pod_to_task[pod] in svc.scheduler.task_bindings
    }
    log(
        f"CHAOS SOAK OK: {total_rounds} rounds in {dt:.1f}s — "
        f"faults={dict(sorted(injector.counters.items()))} "
        f"degradations={degr} noop_rounds={noops} restores={restores} "
        f"(warm={warm_restores}) final_bound={len(placements)}"
    )
    if integrity_totals or recovery_latencies:
        lat_ms = sorted(x * 1e3 for x in recovery_latencies)
        lats = sorted(x * 1e3 for x in all_latencies) or [0.0]
        p50 = lats[len(lats) // 2]
        p99 = lats[min(len(lats) - 1, (99 * len(lats)) // 100)]
        log(
            f"INTEGRITY: audits "
            f"divergences={integrity_totals.get('divergences', 0)} "
            f"repairs={{"
            + ", ".join(
                f"{k[len('repair_'):]}: {v}"
                for k, v in sorted(integrity_totals.items())
                if k.startswith("repair_")
            )
            + "} "
            f"device_flips={injector.counters.get('device_bit_flip', 0)}; "
            f"recovery rounds "
            f"{[f'{x:.1f}ms' for x in lat_ms]} vs service p50={p50:.1f}ms "
            f"p99={p99:.1f}ms"
        )
    if span_tracer is not None:
        span_tracer.uninstall()
    if getattr(args, "assert_stall_flight", False):
        # the solver-interior acceptance check: a seeded nonconvergence
        # fault (ladder exhaustion → NOOP round) must have produced a
        # flight dump whose solver_stalls carry the stall detector's
        # STRUCTURED reason and the final supersteps of telemetry
        import json as _json

        assert flight is not None, "--assert-stall-flight needs --flight-dir"
        assert flight.dumps, (
            "no flight dump was written: the fault schedule produced no "
            "NOOP round — raise --solver-outage-prob or the round count"
        )
        with open(flight.dumps[-1]) as fh:
            dump = _json.load(fh)
        stalls = dump.get("solver_stalls") or []
        assert stalls, "flight dump has no solver_stalls section"
        kinds = {s.get("kind") for s in stalls}
        assert kinds & {
            "injected_fault", "superstep_budget_exhausted",
            "excess_plateau", "eps_plateau", "rejected_input",
        }, f"no structured stall reason in dump (kinds={kinds})"
        with_tail = [s for s in stalls if s.get("telemetry_tail")]
        assert with_tail, (
            "no stall event carries a telemetry tail — solver-interior "
            "telemetry was not recorded before the failure"
        )
        cols = with_tail[-1].get("telemetry_cols")
        assert cols and cols[0] == "eps", f"bad telemetry cols {cols}"
        log(
            f"STALL FLIGHT OK: {len(flight.dumps)} dump(s); last carries "
            f"{len(stalls)} structured stall reason(s) "
            f"({sorted(k for k in kinds if k)}), "
            f"{len(with_tail)} with a telemetry tail of "
            f"{len(with_tail[-1]['telemetry_tail'])} supersteps"
        )
    if server is not None:
        # scrape our own live endpoint (text format over a real socket)
        # and reconcile it against the injector + the RoundRecord sums
        # (the caller's finally stops the server)
        served = scrape(server.url + "/metricsz")
        reconcile_obs(served, tracer, injector)
        log(
            f"OBS RECONCILE OK: {len(served)} served series match the "
            "injector totals and the summed RoundRecord JSONL"
        )
    obs_out = getattr(args, "obs_out", None)
    if obs_out:
        dump_registry(reg, obs_out)
        log(f"obs: registry snapshot -> {obs_out}")
    return {
        "placements": placements,
        "all_bindings": dict(api.bindings()),
        "fault_totals": dict(injector.counters),
        "noop_rounds": noops,
        "degradations": degr,
        "rounds": len(tracer.records),
        "restores": restores,
        "warm_restores": warm_restores,
        "divergences": integrity_totals.get("divergences", 0),
        "repairs": {
            k[len("repair_"):]: v
            for k, v in integrity_totals.items()
            if k.startswith("repair_")
        },
        "device_flips": injector.counters.get("device_bit_flip", 0),
        "recovery_strict": recovery_strict,
        "recovery_latencies_s": recovery_latencies,
    }


def soak_summary(res: dict) -> dict:
    """What a run of `run_chaos_soak` is held to across packages and
    runs: the final placements' and all bindings' sha256, the fault
    totals, NOOP rounds, ladder degradations, restores and the
    integrity counts."""
    import hashlib
    import json

    def sha(d):
        return hashlib.sha256(json.dumps(sorted(d.items())).encode()).hexdigest()

    return {
        "placements_sha256": sha(res["placements"]),
        "bindings_sha256": sha(res["all_bindings"]),
        "placed": len(res["placements"]),
        "fault_totals": dict(sorted(res["fault_totals"].items())),
        "noop_rounds": res["noop_rounds"],
        "degradations": res["degradations"],
        "rounds": res["rounds"],
        "restores": res["restores"],
        "warm_restores": res["warm_restores"],
        "divergences": res["divergences"],
        "repairs": dict(sorted(res["repairs"].items())),
        "device_flips": res["device_flips"],
    }


def chaos_main(args, log=print) -> dict:
    """The chaos soak's acceptance arms: --verify-recovery (corruption
    and kills against a clean control), --verify-loop-parity (sync,
    pipelined and pipelined + device-resident loops), else one soak and,
    with --verify-determinism, a second run that must equal it. Returns
    each arm's run_chaos_soak result by name; raises AssertionError on
    a failed check."""
    import copy

    if getattr(args, "verify_recovery", False):
        # The state-integrity acceptance check (make recovery-smoke):
        # a corruption soak (seeded device bit flips, per-round audits,
        # mid-soak kill-and-restores through the warm manifest) must be
        # bit-identical to a CLEAN control run with no corruption and
        # no kills — every injected corruption detected and repaired
        # the round it happened, every restore resuming warm on the
        # delta-sized path — and the clean control run must report
        # ZERO divergence events (no false positives).
        rec_args = copy.copy(args)
        rec_args.corruption = True
        rec_args.device_resident = True
        log("--- recovery arm: corruption + kills ---", flush=True)
        recovered = run_chaos_soak(rec_args, log)
        ctl_args = copy.copy(args)
        ctl_args.corruption = False
        ctl_args.audit_every = 1
        ctl_args.device_resident = True
        ctl_args.chaos_restore_every = 0
        # the control must see the same (empty) fault schedule the
        # corruption policy produces on its other domains
        ctl_args.solver_outage_prob = 0.0
        ctl_args.control_clean_policy = True
        log("--- control arm: clean, no kills ---", flush=True)
        control = run_chaos_soak(ctl_args, log)
        assert recovered["device_flips"] > 0, (
            "corruption soak injected no device bit flips — raise "
            "--rounds or the corrupt probability"
        )
        assert recovered["divergences"] == recovered["device_flips"], (
            f"DETECTION GAP: {recovered['device_flips']} injected flips "
            f"but only {recovered['divergences']} divergences detected"
        )
        assert sum(recovered["repairs"].values()) >= recovered["divergences"], (
            f"unrepaired divergences: {recovered['repairs']} vs "
            f"{recovered['divergences']} detections"
        )
        assert recovered["restores"] >= 2 and recovered["warm_restores"] == recovered["restores"], (
            f"expected every mid-soak kill to restore WARM: "
            f"{recovered['warm_restores']}/{recovered['restores']}"
        )
        assert recovered["recovery_strict"] >= 1, (
            "no recovery round held the strict delta-sized cost-class "
            "asserts (every restore collided with a pow2 bucket growth "
            "— move --chaos-restore-every)"
        )
        assert control["divergences"] == 0, (
            f"FALSE POSITIVES: clean control run reported "
            f"{control['divergences']} divergence event(s)"
        )
        for key in ("placements", "all_bindings"):
            assert recovered[key] == control[key], (
                f"corruption+kill soak diverged from the clean control: "
                f"{key} differs"
            )
        log(
            "RECOVERY SOAK OK: "
            f"{recovered['device_flips']} corruptions all detected within "
            f"their round and repaired ({recovered['repairs']}), "
            f"{recovered['restores']} kill-and-restores all resumed warm "
            "on the delta-sized path, placements bit-identical to the "
            "clean control run, zero false positives"
        )
        return {"recovered": recovered, "control": control}

    if getattr(args, "verify_loop_parity", False):
        # The pipeline-parity acceptance check: the SAME seeded chaos
        # soak through the synchronous, pipelined, and pipelined+
        # device-resident service loops must produce bit-identical
        # placements (and identical API-side bindings once the deferred
        # POSTs flush). Fault TOTALS are compared per-domain except
        # binding drops: deferring POSTs by one dispatch window can
        # shift which re-post batch a drop draw lands on — placements
        # are unaffected (drops never touch the scheduler's graph).
        runs = {}
        for label, loop, resident in (
            ("sync", "sync", False),
            ("pipelined", "pipelined", False),
            ("device-resident", "pipelined", True),
        ):
            a = copy.copy(args)
            a.loop = loop
            a.device_resident = resident
            log(f"--- loop parity arm: {label} ---", flush=True)
            runs[label] = run_chaos_soak(a, log)
        base = runs["sync"]
        for label in ("pipelined", "device-resident"):
            got = runs[label]
            for key in ("placements", "all_bindings"):
                assert got[key] == base[key], (
                    f"loop mode {label!r} diverged from sync: {key} differs"
                )
            for k, v in base["fault_totals"].items():
                if k == "binding_drop":
                    continue
                assert got["fault_totals"].get(k, 0) == v, (
                    f"loop mode {label!r}: fault {k} {got['fault_totals'].get(k, 0)} != {v}"
                )
            assert got["noop_rounds"] == base["noop_rounds"], (
                f"loop mode {label!r}: noop_rounds differ "
                f"({got['noop_rounds']} != {base['noop_rounds']})"
            )
        log(
            "LOOP PARITY OK: bit-identical placements and bindings across "
            "sync / pipelined / device-resident loops "
            f"({len(base['placements'])} placements, "
            f"noop_rounds={base['noop_rounds']}, "
            f"degradations={base['degradations']})"
        )
        return runs
    got = run_chaos_soak(args, log)
    if not getattr(args, "verify_determinism", False):
        return {"run": got}
    again = run_chaos_soak(args, log)
    for key in ("placements", "all_bindings", "fault_totals"):
        assert got[key] == again[key], (
            f"seed {args.seed} not deterministic: {key} differs across runs"
        )
    log("DETERMINISM OK: identical placements and fault totals across two runs")
    return {"run": got, "again": again}



def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m ksched_tpu_torch.drivers.soak")
    ap.add_argument("--rounds", type=int, default=512)
    ap.add_argument("--chunk", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--machines", type=int, default=10)
    ap.add_argument("--slots", type=int, default=16,
                    help="task slots per PU")
    ap.add_argument("--chaos-backend", default="jax",
                    help="configured solver backend (first ladder rung)")
    ap.add_argument("--chaos-restore-every", type=int, default=128, metavar="N",
                    help="kill-and-restore from a service checkpoint every "
                    "N rounds (0 = never)")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--verify-determinism", action="store_true",
                    help="run twice, require identical placements + fault "
                    "totals")
    ap.add_argument("--loop", choices=["sync", "pipelined"], default="sync")
    ap.add_argument("--device-resident", action="store_true")
    ap.add_argument("--corruption", action="store_true",
                    help="inject seeded device-tensor bit flips (implies "
                    "--device-resident and --audit-every 1)")
    ap.add_argument("--wal-chaos", type=float, default=0.0, metavar="P",
                    help="corruption mode: probability a kill-point "
                    "checkpoint's warm manifest is damaged")
    ap.add_argument("--audit-every", type=int, default=0, metavar="N")
    ap.add_argument("--verify-recovery", action="store_true",
                    help="corruption faults + mid-soak kills vs a clean "
                    "control run")
    ap.add_argument("--verify-loop-parity", action="store_true",
                    help="sync, pipelined and pipelined + device-resident "
                    "loops must place alike")
    ap.add_argument("--metrics-port", type=int, default=None, metavar="PORT",
                    help="serve live Prometheus text during the soak and "
                    "reconcile the scrape against the RoundRecords at exit")
    ap.add_argument("--obs-out", metavar="PATH", default=None)
    ap.add_argument("--flight-dir", metavar="DIR", default=None)
    ap.add_argument("--assert-stall-flight", action="store_true")
    ap.add_argument("--solver-outage-prob", type=float, default=None, metavar="P")
    chaos_main(ap.parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
