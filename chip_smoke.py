"""Smoke run of ksched_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Phases, each of which must pass (any failure exits non-zero and prints
no result line):

1. the card (nvidia-smi name and power limit), versions, and the build
   of every kernel of the path from the sources in this checkout;
2. kernel parity: the transport kernel against its plain PyTorch
   version on the card, bit for bit, on seeded instances, those at the
   row-split plan's edges among them (ops/transport.py row_plan: the
   main [4, 1024], Mp not a multiple of 4, one warp per row, more rows
   than warps, warps without columns) and two with all the state in
   global memory;
3. a reference check at a small size: Scenario W(20, 200) on the card,
   each round's objective equal to the exact cpu_ref oracle's;
4. the main path: Scenario W(1000, 10000) — a Whare-Map cluster of 1k
   machines receiving 10k tasks of mixed classes over four rounds —
   through FlowScheduler.schedule_all_jobs with the default backend,
   make_backend("auto") on cuda; per-round values equal to those of
   the JAX package, every captured transport solve re-solved by the
   plain version with the same bits, and the kernel's launch count;
5. timing of the transport kernel at the main path's shapes (CUDA
   events) beside its plain version and its bound, with the phase
   probe's split of each solve (ops/transport.py PROBE_SLOTS);
6. tiered kernel parity: the tiered transport kernel against its plain
   PyTorch version on the card, bit for bit, on seeded instances with
   random resident tiles, at the same plan edges as phase 2;
7. the device-resident path: coco50k-preempt-full (50k tasks on 1k
   machines, CoCo, preemption on with a full tiered re-solve every
   round) through DeviceBulkCluster on cuda — the fill and 4
   host-driven rounds, each round's values and the final placements
   equal to those of the JAX package, the tiered kernel's launch count,
   the fill's and two later captured solves re-solved by the plain
   version with the same bits; then coco50k (preemption off: the
   transport kernel) and 10kx1k (the closed form: no kernel) likewise,
   and 32 steady churn rounds of coco50k-preempt-full on a
   torch.Generator with the occupancy invariants held; host reads
   throughout equal to the flag reads that the solves' retries, the
   grouped stage 1 and the incremental tier's escalation need (one per
   solve attempt in these runs) plus the counted branch reads;
7b. coco50k-preempt at bench.py's three-tier arguments: the fill and 4
   host-driven rounds, a device checkpoint round trip
   (save_device_checkpoint, load_device_checkpoint on the card: the
   loaded state, hybrid carry and placements equal the saved ones), then
   130 steady rounds on the loaded cluster on the JAX package's
   draws (incremental rounds on the transport kernel under an 8,192-
   superstep budget, scoped and global re-solves on the tiered one),
   each round's tier, supersteps, census drift and wall time printed;
   the count of rounds of each tier, the sha256 of the stacked per-round
   stats and the final placements equal to the JAX package's; a scoped
   tiered solve and a capped incremental solve re-solved by the plain
   versions with the same bits, and timed with their bounds;
7c. quincy10k (group mode: 480 blocks x 3 replicas, 512 groups): the
   fill, 2 host-driven rounds and 32 steady rounds on the JAX package's
   draws, each round's compaction rung and two-stage or full solve
   printed, per-round values and the final placements equal to the JAX
   package's; a stage-1 and a second grouped transport solve re-solved
   by the plain version with the same bits, and the transport kernel's
   time per superstep at these shapes beside its bound;
7d. whare-hetero (Whare-Map with platform factors: the transport
   kernel) and ref100 (the closed form): the fill, 2 host-driven rounds
   and 32 or 64 steady rounds on the JAX package's draws, per-round
   values, the stats' and the final placements' sha256 equal to the JAX
   package's;
7e. trace replay at 12,500 machines: gtrace12k, gtrace12k-burst (the
   closed form) and gtrace12k-coco (the transport kernel at [4, 12,544]
   every window), each trace staged on the host and its first 1,024
   windows replayed in 4 chunks of 256 (seeds 1-4): per chunk its wall
   and per-window times, supersteps, evictions, launches, host reads and
   decode time, its summed stats, per-window convergence and the sha256
   of all its stats equal to the JAX package's, the final placements'
   sha256 too; gtrace12k-coco's longest solve of its first chunk
   re-solved by the plain version with the same bits and timed beside
   its bound;
7f. gtrace12k-host: the host BulkCluster's replay, 60 rounds through
   TraceReplayDriver on a LayeredTransportSolver on the card, per-round
   placed, unscheduled and evicted counts and the final placements equal
   to the JAX package's, with ReplayStats' p50 and the rounds' spans;
7g. quincy10k-multiblock: the fill, 3 chunks of 32 steady rounds each
   after the table maintenance (LRU eviction, fresh templates, re-sync)
   and the compression-loss probe, each chunk's stats sha256, the
   table's counters, the placements, the probe's gaps and its 16
   solves' flows (sha256) equal to the JAX package's; the widest ladder rung's transport solve re-solved by
   the plain version with the same bits and timed beside its bound;
8. timing of the tiered kernel at its captured shapes beside its plain
   version and its bound, with the phase split (round 2's solve too);
9. mcmf kernel parity: the general-graph kernel (one cooperative grid)
   against its plain PyTorch version on the card, bit for bit, its
   64-row soltel ring included (a cold solve wraps it), on seeded
   scheduling graphs at 512 and 8 lanes, at eps 1 and cold, with a pad
   segment; on grids of 1 to 128 blocks: a segment over four blocks with
   headless middle blocks, heads on blocks' first entries, ragged and
   full last blocks, a cold solve that converges across blocks, the 10k
   x 1k shape (R = 256, 128 blocks on 132 SMs) and R = 300 (two steps
   per warp), the long ones cut short; each case also run with the ring
   off: the same flow and the same grid barriers; the wrapper's scratch
   count against the kernel's;
10. the general-graph path: Scenario W(1000, 10000) through
   FlowScheduler.schedule_all_jobs with make_backend("mega") on cuda,
   rounds 0-2, soltel on (its default), every round on the mcmf kernel
   and never on the CSR fallback, each round's values, bindings and the
   sha256 of its soltel ring equal to the JAX package's (round 2's
   3,376 supersteps wrap the 512-row ring), the kernel's launch count,
   every captured solve re-solved by the plain version with the same
   bits (its ring too), and round 2's solve captured by the device
   profiler (obs/devprof.py, torch.profiler): the kernel's device time
   and the device's busy share from the trace;
11. the ladder: Scenario P(1000, 10000) (trivial model, preemption on)
   with make_backend("auto") on cuda: round 0 dense, round 1 on the mega
   rung with the JAX package's values and ring, round 2 stalling as the
   JAX package's does (50,000 supersteps in the cold attempt), with the
   JAX package's SolverStallError.reason;
12. timing of the mcmf kernel at the re-solved shapes (blocks, grid
   barriers per superstep, time per superstep with the soltel ring on
   and off, the same barriers either way) beside its plain version and
   its bound, and of its grid barrier alone;
13. the device-resident general-graph path: Scenario W(1000, 10000)
   through make_backend("mega") with the problem kept on the card
   (PlacementSolver(device_resident=True)), rounds 0-2, each round's
   values equal to phase 10's JAX values, every mcmf launch reading the
   mirror's own cap, scaled-cost and supply tensors (data_ptr), cap never
   re-uploaded, round 2's solve re-solved by the plain version with the
   same bits and timed as in phase 12;
14. bench.py's churn config (drivers/churn.py): 10k tasks on 1k
   machines at 1% churn, the three export arms (full_rebuild,
   delta_scatter, device_resident) round-robin for 6 warm-up and 24
   measured rounds on the scan-CSR solve on cuda (plain PyTorch, no
   hand-written kernel): each round's supersteps, warm scope, placements'
   sha256 and the resident arm's plan sync kind and bytes equal to the
   JAX package's, the arms equal to each other, the resident mirror and
   plan parity checks every round; per arm the wall p50/p99 over the
   measured rounds, the export/pack/upload/solve/decode span p50s and
   the bytes per round copied to the card (the mirror's records on the
   resident arm, the solver's uploads of the problem's arrays and the
   plan's tensors on the host arms, both counted where they are made);
   with soltel on, each round's CSR ring (sha256) equal to the JAX
   package's in every arm, no warm price war, and the resident arm's
   host->device bytes by kind (its device profiler's counter) equal to
   the JAX package's; then two more resident arms round-robin in turns,
   the CSR ring on and off, over the warm-up and 12 measured rounds,
   their wall p50 and p99 side by side;
15. the ELL line: make_backend("ell") on the churn config's resident
   export, the fill and 3 rounds, equal to the JAX package's EllSolver;
16. the scheduler service (cli.SchedulerService through
   drivers/service.py) at BASELINE's width, 10k pods on 1,000 fabricated
   machines x 4 PUs x 4 slots through make_backend("auto") on the card:
   the one-shot and 4 rounds of 1% completions and 100 arrivals, on the
   trivial model (one class row: the dense rung's closed form, no
   kernel) and on Whare-Map with four task classes (the transport
   kernel from round 2), each sync and then pipelined with the same
   placements, every round's bound count, AutoSolver path, supersteps
   and placements' sha256 equal to the JAX package's and its RoundRecord
   phases printed; the Whare-Map transport solves re-solved by the plain
   version with the same bits and timed beside their bound; then
   cli.main's one-shot at that width binding its whole batch;
17. service-resident: the same width through "jax" (the scan-CSR solve)
   on the device-resident mirror, audited every round, in two arms: a
   clean one, and one with seeded device bit flips and a checkpoint and
   warm restore after round 3; every flip detected in its round, the
   clean arm without a divergence, both arms' placements equal to each
   other and to the JAX package's; the audit's and repairs' spans, and
   one audit split into its device fingerprints and its host twins;
18. the chaos soaks (drivers/soak.py) at 6 machines x 8 slots: the
   Makefile's chaos-smoke (96 rounds, seed 0, a restore every 48, run
   twice) and its recovery-smoke cut to 128 rounds (seed 11, chunk 32, a
   restore every 48: at 64 the JAX package fails its own check), each
   run's placements, bindings, fault totals, NOOP rounds, ladder steps,
   restores and integrity counts equal to the JAX package's;
19. http: cli.main against the loopback FakeAPIServer, 100 nodes and
   1,000 pods created through the server, every pod bound;
20. native: the C++ solver built from this checkout (forced, no
   fallback) on the service's one-shot, placements equal to the JAX
   package's native solver's;
   then the `kernels` line and the result line. The transport kernel's
   entry there covers three paths, each counted from 0 just before it
   ran: Scenario W(1000, 10000) (phase 4), gtrace12k-coco (phase 7e) and
   the Whare-Map service (phase 16, sync and pipelined). Its `launches`
   is the sum of their launches, and its `ms`, `plain_ms` and `bound_ms`
   sum the solves timed on them: W's two, gtrace12k-coco's longest at
   [4, 12,544] and the Whare-Map service's sync run's two. The mcmf
   kernel's entry covers W-mega
   (phase 10) and W-mega-resident (phase 13) the same way: `launches`
   sums both, and `ms`, `plain_ms` and `bound_ms` sum W-mega's timed
   solves and W-mega-resident's round 2 solve. The other paths'
   launches are printed before the line.

Imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import hashlib
import json
import subprocess
import sys
import time

import numpy as np
import torch

# Scenario W(1000, 10000) per round, as produced by the JAX package
# (ksched_tpu, AutoSolver(ReferenceSolver()), this scenario, on the
# CPU): placed tasks, supersteps, objective; every round on the dense
# path.
REF_W_FULL = {
    "placed": [10000, 2500, 2500, 1000],
    "supersteps": [0, 0, 149, 1186],
    "objective": [0, 0, 0, 3752040],
}
# Scenario W(20, 200), likewise from the JAX package on the CPU.
REF_W_SMALL = {
    "placed": [200, 50, 50, 20],
    "supersteps": [0, 84, 3207, 170],
    "objective": [0, 0, 166, 76756],
}

# DeviceBulkCluster scenarios (drivers/device_bulk.py: the fill, then
# host-driven rounds), per round, as produced by the JAX package
# (ksched_tpu DeviceBulkCluster with the same constructor arguments and
# the same host-driven sequence, on the CPU; tests/torch_device_bulk_reference.py,
# which builds quincy10k's groups with the JAX package's QuincyGroupTable),
# with the sha256 of the final `pu` array (int32 bytes).
REF_BULK = {
    "coco50k-preempt-full": {
        "placed": [50000, 500, 500, 500, 500],
        "migrated": [0, 49398, 49036, 49407, 49129],
        "preempted": [0, 0, 0, 0, 0],
        "unscheduled": [0, 0, 0, 0, 0],
        "objective": [254504, 1747299, 1478165, 1304970, 1410419],
        "supersteps": [527, 2898, 7411, 6585, 4571],
        "converged": [1, 1, 1, 1, 1],
        "pu_sha256": "ad34f333b515aad6ced7cb817e6f77bea04f86b85f58858332ba0d6aabf61317",
    },
    "coco50k": {
        "placed": [50000, 500, 500],
        "unscheduled": [0, 0, 0],
        "objective": [254504, 5490, 5406],
        "supersteps": [405, 93, 85],
        "converged": [1, 1, 1],
        "pu_sha256": "d90b9b0fda8c4fa5eeba610d24e2563de2b2ed668f3d6a9da287d72733bb6361",
    },
    "10kx1k": {
        "placed": [10000, 100, 100],
        "unscheduled": [0, 0, 0],
        "objective": [20000, 200, 200],
        "supersteps": [0, 0, 0],
        "converged": [1, 1, 1],
        "pu_sha256": "880c6eda2ff26eca0b50254549715dbc2c2cee21be58afe5ef2aa9efbed05426",
    },
    "coco50k-preempt": {
        "placed": [50000, 500, 500, 500, 500],
        "migrated": [0, 49398, 49036, 49407, 49129],
        "preempted": [0, 0, 0, 0, 0],
        "unscheduled": [0, 0, 0, 0, 0],
        "objective": [254504, 1747299, 1478165, 1304970, 1410419],
        "supersteps": [527, 2898, 7411, 6585, 4571],
        "converged": [1, 1, 1, 1, 1],
        "pu_sha256": "ad34f333b515aad6ced7cb817e6f77bea04f86b85f58858332ba0d6aabf61317",
    },
    "quincy10k": {
        "placed": [10000, 100, 100],
        "unscheduled": [0, 0, 0],
        "objective": [0, 264, 176],
        "supersteps": [115, 287, 287],
        "converged": [1, 1, 1],
        "pu_sha256": "d64a1a01aaa95205f1bf575210eedd2e56306ff05294a8a471786288622bc242",
    },
    "whare-hetero": {
        "placed": [20000, 200, 200],
        "unscheduled": [0, 0, 0],
        "objective": [0, 0, 0],
        "supersteps": [19, 19, 19],
        "converged": [1, 1, 1],
        "pu_sha256": "2c96d9c17de92f80deaf8285696cad0de503a06d2c2572709f654ba5432f3f12",
    },
    "ref100": {
        "placed": [100, 5, 5],
        "unscheduled": [0, 0, 0],
        "objective": [200, 10, 10],
        "supersteps": [0, 0, 0],
        "converged": [1, 1, 1],
        "pu_sha256": "8075d1f56c6b2e7d49ce705490014afadc39f27aac1fab472836db821aaa1499",
    },
}

# Steady rounds after those (`run_steady_rounds(seed=STEADY_SEED)` at
# the bench's churn, the JAX package's draws), likewise: the rounds of
# each tier (hybrid), per-round values (quincy10k), the sha256 of every
# round's stats stacked as int32 in key order, and of the final `pu`.
STEADY_SEED = 1
REF_STEADY = {
    "coco50k-preempt": {
        "rounds": 130,
        "tiers": {"global": 1, "scoped": 9, "escalated": 0, "incremental": 120},
        "stats_sha256": "6616a135b6b465d5ab29328425fe5980f3417f952005b7b735847a07bc9dc036",
        "pu_sha256": "cbbce10a845b59467716f54181273074e1dfebd8737e689313a678922b0d8bf1",
    },
    "quincy10k": {
        "rounds": 32,
        "placed": [100, 100, 100, 100, 100, 100, 100, 100, 100, 100, 100, 100, 100, 100, 100, 100, 100, 100, 100, 100, 100, 100, 100, 100, 100, 100, 100, 100, 100, 100, 100, 100],
        "unscheduled": [0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0],
        "objective": [160, 184, 176, 88, 88, 120, 120, 48, 72, 88, 56, 80, 144, 96, 112, 88, 72, 48, 72, 72, 56, 32, 48, 64, 56, 48, 64, 64, 72, 64, 96, 88],
        "supersteps": [287, 12, 9, 287, 12, 295, 295, 9, 9, 287, 287, 300, 9, 9, 24, 295, 12, 12, 12, 9, 9, 9, 9, 9, 290, 300, 9, 12, 13, 9, 287, 9],
        "active_groups": [93, 92, 92, 93, 91, 96, 96, 93, 92, 89, 90, 92, 93, 89, 87, 88, 91, 92, 91, 90, 92, 94, 89, 93, 89, 93, 91, 92, 96, 87, 92, 91],
        "stats_sha256": "34547a27ffb6c9796f6753a8718e8713c19539a06e3aafe7e918661b818ea6dc",
        "pu_sha256": "f032d51a4682e963eda9649683210c4c346326924a7f9c58ade8afe6b92aaf10",
    },
    "whare-hetero": {
        "rounds": 32,
        "placed": [200, 200, 200, 200, 200, 200, 200, 200, 200, 200, 200, 200, 200, 200, 200, 200, 200, 200, 200, 200, 200, 200, 200, 200, 200, 200, 200, 200, 200, 200, 200, 200],
        "unscheduled": [0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0],
        "objective": [0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0],
        "supersteps": [19, 19, 19, 19, 19, 19, 19, 19, 19, 19, 19, 19, 19, 19, 19, 19, 19, 19, 19, 19, 19, 19, 19, 19, 19, 19, 19, 19, 19, 19, 19, 19],
        "stats_sha256": "e6fbe68cb2afa8d94255281a0b5c2c639b73c3e755e4dabaef11bccb4c1d9919",
        "pu_sha256": "68c3e2a58a67fafd819d1e740aa73c6b757c05e94b63b63f8fbece9c59712144",
    },
    "ref100": {
        "rounds": 64,
        "placed": [5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5],
        "unscheduled": [0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0],
        "objective": [10, 10, 10, 10, 10, 10, 10, 10, 10, 10, 10, 10, 10, 10, 10, 10, 10, 10, 10, 10, 10, 10, 10, 10, 10, 10, 10, 10, 10, 10, 10, 10, 10, 10, 10, 10, 10, 10, 10, 10, 10, 10, 10, 10, 10, 10, 10, 10, 10, 10, 10, 10, 10, 10, 10, 10, 10, 10, 10, 10, 10, 10, 10, 10],
        "supersteps": [0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0],
        "stats_sha256": "809480819b0dee4d674288462e103d7fbde5536c52ba57c969c599871efed520",
        "pu_sha256": "a044e921d3fdd2689cf9072329f71fcd7805f3e7f7df846057c603fe9108f87e",
    },
}

# Scenario W(1000, 10000) through make_backend("mega"), rounds 0-2, and
# P(1000, 10000) through make_backend("auto"), rounds 0-1 and round 2's
# stall, per round, as produced by the JAX package
# (tests/torch_event_mega_reference.py: MegaSolver(fallback=JaxSolver())
# and AutoSolver(JaxSolver(), mega=MegaSolver()), on the CPU): placed
# tasks, path, supersteps, objective, sha256 of the sorted bindings;
# with soltel on, the sha256 of each mega round's soltel ring
# (drivers/churn.py telemetry_sha256) and the stall's
# SolverStallError.reason.
REF_MEGA = {
    "W": {
        "placed": [10000, 2500, 2500],
        "path": ["mega", "mega", "mega"],
        "supersteps": [25, 32, 3376],
        "objective": [0, 0, 0],
        "bindings_sha256": [
            "24142376967188b7c269456fbcdb974d38776159f7670760e9b289680435efb3",
            "54ae55ac59f54275e04de9a53ac023b0e31d096177568df6cdf5a74696de6fc5",
            "37250afb748eccf84e6151dc49c0480f226540f1e7f8c57fbdf1c7681023a358",
        ],
        "telemetry_sha256": [
            "11aa4ea7c483a3ff9c7658b5b046732e87cb2ca85363b2f6ce18cf99c8001615",
            "e133fd51b6e07f70bcdc849a054f3cb2a5b30ae9d3400cc66a861e492b2573fa",
            "9527352a9685626b13bc253a50c8d69f52a7d34c218d902388ddb2a30becd982",
        ],
    },
    "P": {
        "placed": [10000, 2500],
        "path": ["dense", "mega"],
        "supersteps": [0, 10],
        "objective": [20000, 5000],
        "bindings_sha256": [
            "46119ab9c2289c3341a526de32789cb95a566b30f9601de0869cb73bc44a5a52",
            "f360ae7496b92e52cbf3a8652d93e092b617e0217ecabcfcc05bcc23d49a1262",
        ],
        "telemetry_sha256": [
            None,
            "518d9e28a58c8beef24173b4a01fe1b58a72a2db02df1546d9eef51843ce7b9b",
        ],
        "stall": {"round": 2, "path": "mega", "last_supersteps": 50000,
                  "reason": {"kind": "excess_plateau", "window": 64,
                             "detail": "64 supersteps without excess decrease (1 -> 1 units at eps 40)",
                             "backend": "mega", "supersteps": 50000, "budget": 50000,
                             "converged": False, "eps": 40, "excess": 1,
                             "active": 1}},
    },
}

# Trace replay (drivers/gtrace.py, the card branch of bench.py's gtrace
# cells at 1,024 windows), as produced by the JAX package on the CPU
# (tests/torch_replay_reference.py): the staging counts and the fixed
# widths [Amax, Dmax, Emax]; per chunk of 256 windows (seeds 1-4) its
# stats summed, supersteps max and p50, whether every window converged,
# `live` after its last window and the sha256 of all its stats stacked
# as int32 in key order; the `pu` sha256 after the four chunks.
REF_REPLAY = {
    "gtrace12k": {
        "rounds": 1644,
        "submitted": 102400,
        "finished": 102400,
        "dropped": 0,
        "widths": [131, 129, 12500],
        "chunks": [
            {"placed": 25753, "evicted": 48, "admitted": 25706, "completed": 14921, "unscheduled": 0, "supersteps_max": 0, "supersteps_p50": 0, "converged": True, "live_last": 10785, "stats_sha256": "66eea00cfeb6c962c468be899994ef4a255422e83befc65a476dbe7ee9ed2115"},
            {"placed": 25630, "evicted": 96, "admitted": 25534, "completed": 24341, "unscheduled": 0, "supersteps_max": 0, "supersteps_p50": 0, "converged": True, "live_last": 11978, "stats_sha256": "b8be4c625587fc896d7633b87ed738e7b55c2ac99991440c4bfbf48ee81df536"},
            {"placed": 25680, "evicted": 96, "admitted": 25584, "completed": 25505, "unscheduled": 0, "supersteps_max": 0, "supersteps_p50": 0, "converged": True, "live_last": 12057, "stats_sha256": "ce7acef064adadeb9af22225203f44a59baeb2b16d7757d5a85b996a3f308c63"},
            {"placed": 25592, "evicted": 16, "admitted": 25576, "completed": 25528, "unscheduled": 0, "supersteps_max": 0, "supersteps_p50": 0, "converged": True, "live_last": 12105, "stats_sha256": "a6ab200d2477fa7526dc7de051245dbda22f00e8464dca90515e953fd1c17584"},
        ],
        "pu_sha256": "893920d86d9c508b23457b63c99b2ddd4af529f5871b66c843ac22861ab021f4",
    },
    "gtrace12k-burst": {
        "rounds": 1657,
        "submitted": 102400,
        "finished": 102400,
        "dropped": 0,
        "widths": [554, 194, 12500],
        "chunks": [
            {"placed": 16411, "evicted": 152, "admitted": 16260, "completed": 9531, "unscheduled": 0, "supersteps_max": 0, "supersteps_p50": 0, "converged": True, "live_last": 6729, "stats_sha256": "0584a29d31f6f458a7532cbeb46538061d5b53f201ae06f99839fb99a16b8564"},
            {"placed": 28842, "evicted": 152, "admitted": 28691, "completed": 17984, "unscheduled": 0, "supersteps_max": 0, "supersteps_p50": 0, "converged": True, "live_last": 17436, "stats_sha256": "4c38f8c78f91585bef9b91dc299429cf95b9a07058c78fee696d16822877d0df"},
            {"placed": 29459, "evicted": 739, "admitted": 28721, "completed": 30330, "unscheduled": 0, "supersteps_max": 0, "supersteps_p50": 0, "converged": True, "live_last": 15827, "stats_sha256": "3d15084b151faaca0ce5fa46836575d69a0247b4dd22f08c322de07a84a35775"},
            {"placed": 28746, "evicted": 18, "admitted": 28728, "completed": 31667, "unscheduled": 0, "supersteps_max": 0, "supersteps_p50": 0, "converged": True, "live_last": 12888, "stats_sha256": "0054006891e07aef28353871f873a4a305b179bc543d7bcbcab678e408953338"},
        ],
        "pu_sha256": "8971c71b5ca8776fc01c826395c0a3185c2029965a6e54be0249197d031e2050",
    },
    "gtrace12k-coco": {
        "rounds": 1698,
        "submitted": 163840,
        "finished": 163840,
        "dropped": 0,
        "widths": [199, 204, 12500],
        "chunks": [
            {"placed": 40958, "evicted": 54, "admitted": 40905, "completed": 23763, "unscheduled": 0, "supersteps_max": 3316, "supersteps_p50": 36, "converged": True, "live_last": 17142, "stats_sha256": "ff335497c5efdf531ddce35872eec0326723c098a2d3df1c377271589aa1df43"},
            {"placed": 41093, "evicted": 140, "admitted": 40953, "completed": 39085, "unscheduled": 0, "supersteps_max": 301, "supersteps_p50": 104, "converged": True, "live_last": 19010, "stats_sha256": "b899a0e3bdc438f03f3a9b62dcc8b25f1d678ea61b7ea37977889f9cf8258295"},
            {"placed": 41114, "evicted": 155, "admitted": 40960, "completed": 40605, "unscheduled": 0, "supersteps_max": 338, "supersteps_p50": 122, "converged": True, "live_last": 19365, "stats_sha256": "6da17c2534a00dbd314a2bd8a524957a7be755f5cab71e82dfbbbe1ddef479d8"},
            {"placed": 41051, "evicted": 29, "admitted": 41022, "completed": 41236, "unscheduled": 0, "supersteps_max": 341, "supersteps_p50": 121, "converged": True, "live_last": 19151, "stats_sha256": "330b073ab279b415718759831ee321caafe2c0d260bf4266ea8459a88dc9b182"},
        ],
        "pu_sha256": "d47263d2c3b4bcd670c24717604b80d8a3205ecf096f850213a5d9cd2bbc927f",
    },
}
# gtrace12k-host (TraceReplayDriver on LayeredTransportSolver, 60 rounds
# of 5 s windows), likewise: per round placed, unscheduled and evicted,
# the ReplayStats totals and the sha256 of the final task_pu (int32).
REF_HOST = {
    "placed": [515, 479, 471, 499, 479, 474, 479, 480, 523, 460, 472, 479, 506, 520, 514, 505, 473, 460, 483, 481, 514, 464, 498, 493, 532, 471, 506, 530, 523, 460, 484, 506, 517, 489, 494, 528, 466, 474, 492, 503, 505, 511, 514, 465, 461, 485, 535, 481, 508, 452, 504, 483, 488, 511, 505, 482, 506, 508, 478, 484],
    "unscheduled": [0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0],
    "evicted": [0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 8, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 24, 8, 0, 0, 0, 0, 8, 0, 8, 0, 0, 0, 8, 0, 8, 16, 0, 0, 8, 0, 16, 0, 16, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 8, 0],
    "totals": {"rounds": 60, "submitted": 30048, "finished": 18927, "placed": 29562, "evicted": 136},
    "task_pu_sha256": "ec8a045d8f79b3383d95b0282b4166d09e8048974999a59201c1337c19b7fa87",
}
# quincy10k-multiblock (drivers/multiblock.py), likewise: the fill's
# stats, per chunk of 32 steady rounds (seeds 2-4, each after the table
# maintenance) its stats sha256 and summary, the table's counters, the
# final `pu` sha256 and bench.py's quality probe (8 rounds): its gaps
# and the sha256 of its 16 solves' flows y (int32, in order).
REF_MULTIBLOCK = {
    "fill": {"active_groups": 483, "converged": 1, "cost_overflow": 0, "live": 10000, "objective": 163360, "placed": 10000, "supersteps": 1704, "unscheduled": 0},
    "chunks": [
        {"stats_sha256": "07af11689d97a53a83b7a7393689c70340455e01a39f3afbcae31841ce114448", "converged": True, "placed": 3200, "supersteps_max": 1549, "active_groups_max": 96},
        {"stats_sha256": "9d999ed2e0be00c975d27a473b11b771940a53e42f135893bde813d871db048d", "converged": True, "placed": 3200, "supersteps_max": 1391, "active_groups_max": 96},
        {"stats_sha256": "c9f452b865e6328327c9731ce3fb6a0b0de9bd881a8e3a60e20d9349fc5484bb", "converged": True, "placed": 3200, "supersteps_max": 1276, "active_groups_max": 98},
    ],
    "counters": {"signatures_initial": 483, "signatures_final": 506, "overflow_distinct": 0, "evicted": 0},
    "pu_sha256": "1889130ffbbfe4602f2de76541d0215df626060cf91329997bceaf0744ef3255",
    "probe": {"realized_cost_gap_mean": 4e-05, "realized_cost_gap_max": 0.00034,
              "y_sha256": "aa149b3bfa0e13865355e9b6f2a1117a263ad13757274ead135e954151ab0b67"},
}

# bench.py's `churn` config (drivers/churn.py: 10,000 tasks on 1,000 x 1
# x 4 x 4, 1% churn, 6 warm-up + 24 measured rounds), per round, as
# produced by the JAX package's device-resident arm on the CPU
# (tests/torch_churn_reference.py, a twin of bench.py's
# `_churn_pipeline_bench`): supersteps, warm scope, the placements'
# sha256, the plan sync kind and the bytes shipped to the device; the
# fill's supersteps; the plan's rebuild, overflow and relocation counts;
# and its EllSolver run on the same export, the fill and 3 rounds.
REF_CHURN = {
    "fill_supersteps": 10,
    "supersteps": [
        10, 9, 9, 9, 10, 9, 9, 9, 9, 9, 9, 9, 10, 9, 9,
        9, 9, 9, 9, 9, 9, 9, 9, 9, 9, 9, 9, 9, 9, 9,
    ],
    "warm_scope": [
        "fresh", "fresh", "fresh", "fresh", "fresh", "fresh", "fresh", "fresh",
        "fresh", "fresh", "fresh", "fresh", "fresh", "fresh", "fresh", "fresh",
        "fresh", "fresh", "fresh", "fresh", "fresh", "fresh", "fresh", "fresh",
        "fresh", "fresh", "fresh", "fresh", "fresh", "fresh",
    ],
    "sha256": [
        "b2d0e40063f3a035f70e2878326c0f14040a19f2e650b7414468bc9482a9bc19",
        "33669641ee65917bc2569655e8a2fd6e27fa8f6dfe467bd77c3da138fc4d41a0",
        "da0381812d3db577272038cbca0be309b654dfa0fd9d0c5460e73e2334b0f10b",
        "28e6c34f8e01af314dcf8ef24c3911980cde6f1a9d2c22b28a74b1efea81c71f",
        "ba4d896a7ba9eafa2826ca061dbc30ef6b1c2adfc81c75e5e460b7112cb2e016",
        "cc6f0d7a9d17e136d9a817c8f13dbc3e1994ba243a198c2b1d47834ef97fe27b",
        "b9dd62132b92682974df503a7b3fab8e87f73a5d78a3e8d2479832f9231285d9",
        "be9d6f803996b1e95d24bf43c0fff0a0b22de79d6c8728c69ceb66a032ca226d",
        "76be0407a56d5b2fa9df8963a117537da0398997e1fa613ddab19868759f6ace",
        "4024504efd520893953bbca6992afbc16943a4ca5bd3849f028e151096b5a1b2",
        "4f75f1db45d73d6c86f7c1ecf7c81d8331841ea6e7ca5d50f746248a8c1a1afe",
        "c9709569cb7944d58edaf54903f7b8ae20bfee4a89107fbd084affbb75f13e79",
        "4d1cfb1e508457dac71a3eff1e15fb56a8aed7e0c87b489f5ec31d5c590372e8",
        "e3a4580a719860be053eb9c9fddf45407cfe1971006884d7eccfe11cd10cb486",
        "1f6511336654041115eb3fcd43e6806b641d2f5d0c613b7d1dadeabe645e6303",
        "80d51fc1c95e0051e2d3a6ad1a8d2dcba36c1e3b5b41082e97852778d35db9a5",
        "dc8b3ca29a2218e73f5127fa5e56e6712123f0d0711926af93af6dc3a4f354e5",
        "c5fc46570906529c4170a1c599987df3afb12b9dff7e283533e03245b2a19ecf",
        "4bb04b50bddb4f302cda41140b42ac89c4556c6aca7106e9728657767b2adc67",
        "afe0003dc19ad6cee6d2f0493f0eeb3d46637efed8d56864993dc0f56a3c0719",
        "76a9d95af82bd65155bcca590569b62597959eefabb5f86e68b0e82d168e5571",
        "1fef7db45fe1745f044ca2c60baddb6fba76f20964157d5608572050a785d191",
        "e563ab275e43ff201f8829dc29767fe32e64c2c98107fa348f2e4686a2a9833e",
        "ced135e2cbc77d0ea6552395b641c537e86c8487679c6e0032af1151bca1bae3",
        "e8a76ea3320f1da78b50d07833dbe216089e8b4dbc593dd079723ac22cb6bd26",
        "12ec798256c95e72792087a41f1b15925f83b867f6ad6e5d5b67619190b49814",
        "0db99d675803a09a26a6c499587e54e9eb51d74c145428842dd61d921304fac6",
        "e960142be0e0e053fd56dd891562a806fe19edc86c19d462c29a17783439736d",
        "aefe59ff7fb1bc5933c7bde02e021431f52e7fefd32fc458150ea1d16a5e9a13",
        "d1965f740491992859467b51a7d8a3084c0f0e6cdc19372b98a645d97b0475bc",
    ],
    "plan_kind": [
        "rebuild", "delta", "delta", "delta", "delta", "delta", "delta", "delta",
        "delta", "delta", "delta", "delta", "delta", "delta", "delta", "delta",
        "delta", "delta", "delta", "delta", "delta", "delta", "delta", "delta",
        "delta", "delta", "delta", "delta", "delta", "delta",
    ],
    "upload_bytes": [
        3948544, 356864, 278656, 184448, 94336, 184448, 94336, 147584,
        94336, 184448, 147584, 209024, 94336, 184448, 94336, 184448,
        94336, 168064, 94336, 168064, 94336, 168064, 94336, 168064,
        94336, 184448, 106624, 192640, 94336, 147584,
    ],
    "plan_counters": [1, 0, 2849],
    # soltel on: the sha256 of each round's CSR ring
    # (drivers/churn.py telemetry_sha256), the warm price wars and the
    # host->device bytes by kind of the arm's own registry
    "telemetry_sha256": [
        "2cce565271ed07246557d84270380e2a81e5751298ad4f7038289be667ae3e40",
        "0d7f36635591584ce272273046e0a8f0a1ef4479ed2c1cef93e932cdbf67188c",
        "feabe920e22c731fc9bc10bfdf929c4c99fbf4aa35c43f3c3b4b442a18e09bd6",
        "0eed0e633fead728be74cc250d6eba0bb55f9d85aecd7e8d366e05e40752c1a7",
        "b86618e49abf72bdf3e42ef3213a0e83760427eddb47634c5fb9dce5dccf1109",
        "b81951bf3db25699f9e4a5bfbd0bec3a41d6a51309cd5729e6872470006a1328",
        "e7b034a86db85e1cc1e7dbe528124d85cfc251a55d1e454fd7f90c921679316d",
        "bcc15069d16edde5bbdb9153d8e0878795bf7fc155819736153e9697005192f5",
        "3daa46fbd77ebaac21506c528919edc279aac4e534d274fd202f79b0f9362283",
        "55b05a77cd0689d63055596b8d767505782eb477b9b892863f05eff164ef6303",
        "a566d8f0fecaa8e03da38efe476b95a0deec806f98611a1fdbf7590313058acb",
        "0478a2da2ddf1e13d5a87e29fc5e1b2e241005e417d43a1a0d273604b22e77c1",
        "7ddbee65973ea385d0ea8b45061fd4474c017eec63662dc7a14b153031341e1e",
        "7394d44306ba19bab6296af8089afd2df355880f742a710d91407aab98bdabb7",
        "9c1d118e03efe9691419af70a763b1d2842e150ccc62f34810620e9cd6c4a756",
        "e2ed64be92c92283d23e25944a577e7c2840ecb847127c32dd003c43187b9738",
        "a51ac44135948013438602a034bab67e95678db238d889247fba8e588be423e3",
        "d9a211bbe4d3ca3785c0c1cda41ac6bc5d3a9eef3d2c8d46e9c016e5aad70054",
        "99962708d47cc7b121ea772acf05846ea7049543792c1bf6ce746a3f84f42480",
        "f7cd7e6ca7ff71f373092add444c4d46ff075409d574bd4b2271995201cc163a",
        "ebad6cb95c333d2ac3b2998eaa8fca9bc07ede47f992b7c708002a7e3d346297",
        "3a8c2d28d04ccf991a92fe7f47de2dc740235cd88b594a4ff84abaa2bc3bd598",
        "d47e4fa01d4c063c0242d260cc9a0fcbd8a19fe555e34c00bcf902630341db7b",
        "6fdc22969628299604e8c3aee1e7cc826fc1cba16cfa51297f75ac7f647652b2",
        "9948f783368ea209c095c89e95b95f56aef971e632559b3b7c96c79192b817c5",
        "9a1fccc7efdcad3d9cba2558639bf2b60938f2848acd75fca7a7fc4bda468e5a",
        "6f68e1663cad4386ffab7fb206ab35b3cf4207665f062ae56778b6f61777c7db",
        "f68e4147dd40a99d9f9e6ba28ca1f5b707c522795cceeb6b3d885aa08d6acc1d",
        "dcc740715d2587ea67fa0b5bef8dd4ca3694abba109f048b4dc35b937f46e88d",
        "ea30614468bac1b33a2f626f7ee60a0ab288f226012587a03645b2bd93cfe9e0",
    ],
    "price_wars": 0,
    "h2d_bytes": {"full_build": 589824, "delta": 8351744},
    "ell": {
        "fill_supersteps": 10,
        "supersteps": [54, 627, 100],
        "sha256": [
            "b2d0e40063f3a035f70e2878326c0f14040a19f2e650b7414468bc9482a9bc19",
            "c3b8a21a469334217f3f1df72caa8022030469f3d8bdf4b2a54efa5cc88e5d41",
            "92c747b61b675ae9a3b7271a4cf7596f6aca2bd327da653d15c2a4d90f494615",
        ],
    },
}

# The service phases' per-round values, as produced by the JAX package
# (ksched_tpu's SchedulerService on the CPU, through the same driver,
# ksched_tpu_torch/drivers/service.py; tests/torch_service_reference.py):
# [bound, placed, AutoSolver path, solver work, live placements' sha256]
# (+ [bit flips, divergences] on the resident arms).
REF_SERVICE = {
    "service": [
        [10000, 10000, "dense", 0, "1706cb559bc12fe1eb69fcb7f3787796733a0ed7f4b2c548b36e4058ec3f3414"],
        [100, 10000, "dense", 0, "0a1f96b5bdeaa98f91d2f0693d08282943c1551ab03c4aca887eb739378851af"],
        [100, 10000, "dense", 0, "02dfff92c3bbc17d40b0b65c9a88ba823fb6a38594f40e99cc6052bc3adba213"],
        [100, 10000, "dense", 0, "eaf4fb4baa5ada7f6342fe49fcd6af3dfffdcdad9282fa133aacbbd7f78788c6"],
        [100, 10000, "dense", 0, "a6d4621b38ee7152442aa02ebc1c1161729a8716675c57ad25fa94972e20dcd9"],
    ],
    "service-whare": [
        [10000, 10000, "dense", 0, "5ed4494c9cf201b9d5a48d5c45c7876cd3d2f35b99cb733a3d458ce79fc43d73"],
        [100, 10000, "dense", 0, "67ffc2ba803ad1184db9b46e25b69ce945e412a2049af7bb0dec315358737580"],
        [100, 10000, "dense", 5527, "3bf68bd445607ae6735938dc67ce0cc76e0c6a4587e6b5ea4601bc2404724e8d"],
        [100, 10000, "dense", 6101, "7179dd3ab44a64fd8a693abf83c91603beac29dd192ce4c286ab5c546f8b08e7"],
    ],
    "service-resident": [
        [10000, 10000, None, 10, "1706cb559bc12fe1eb69fcb7f3787796733a0ed7f4b2c548b36e4058ec3f3414", 0, 0],
        [100, 10000, None, 10, "0a1f96b5bdeaa98f91d2f0693d08282943c1551ab03c4aca887eb739378851af", 0, 0],
        [100, 10000, None, 9, "02dfff92c3bbc17d40b0b65c9a88ba823fb6a38594f40e99cc6052bc3adba213", 0, 0],
        [100, 10000, None, 10, "1340e874c2c8fe19b3d924f5b547ea3076686fe01d9c0e2afb8d97015609fd00", 0, 0],
        [100, 10000, None, 9, "f4265741a94802d3eb92276142c5eae8ea83bd8705cb91528464c29f42ccc0a1", 0, 0],
        [100, 10000, None, 9, "9938adcd5aecee09d3a631e1a8b0dabb3e37b0c856759a1d346917c9e8be335b", 0, 0],
    ],
    "service-resident-faults": [
        [10000, 10000, None, 10, "1706cb559bc12fe1eb69fcb7f3787796733a0ed7f4b2c548b36e4058ec3f3414", 1, 1],
        [100, 10000, None, 10, "0a1f96b5bdeaa98f91d2f0693d08282943c1551ab03c4aca887eb739378851af", 1, 1],
        [100, 10000, None, 9, "02dfff92c3bbc17d40b0b65c9a88ba823fb6a38594f40e99cc6052bc3adba213", 0, 0],
        [100, 10000, None, 10, "1340e874c2c8fe19b3d924f5b547ea3076686fe01d9c0e2afb8d97015609fd00", 0, 0],
        [100, 10000, None, 9, "f4265741a94802d3eb92276142c5eae8ea83bd8705cb91528464c29f42ccc0a1", 0, 0],
        [100, 10000, None, 9, "9938adcd5aecee09d3a631e1a8b0dabb3e37b0c856759a1d346917c9e8be335b", 0, 0],
    ],
    "native": [
        [10000, 10000, None, 428919, "45782b512df025e9bca21c51ddee1b1b3365b34f4c3230a5d8b7cc9a37949e95"],
    ],
}

# tools/soak.py's chaos soak in the JAX package at the smoke's arguments
# (drivers/soak.py soak_summary of each run).
REF_SOAK = {
    "determinism": {
        "run": {"placements_sha256": "8f31787a410a1de43958883da9f68e571bf089597debffba7b2a9b484af4ee9e", "bindings_sha256": "a39975ad1927a6f5c6d4195a0b1556d06b8bc69e36224e7d2508b388f89f2c65", "placed": 5, "fault_totals": {"api_outage_round": 8, "binding_drop": 15, "machine_flap": 4, "machine_flap_round": 12, "solver_exception": 2}, "noop_rounds": 0, "degradations": 2, "rounds": 112, "restores": 2, "warm_restores": 2, "divergences": 0, "repairs": {}, "device_flips": 0},
    },
    "recovery": {
        "recovered": {"placements_sha256": "4ef4ade2cc6b92b36ceff4f925f1909f9454e032a39b8f8904437f084fbffac2", "bindings_sha256": "83faaf081859782edd6243c5ad113e5fb703478915d8bb4edd96855764567b57", "placed": 25, "fault_totals": {"device_bit_flip": 28}, "noop_rounds": 0, "degradations": 0, "rounds": 144, "restores": 2, "warm_restores": 2, "divergences": 28, "repairs": {"rescatter": 25, "reupload": 3}, "device_flips": 28},
        "control": {"placements_sha256": "4ef4ade2cc6b92b36ceff4f925f1909f9454e032a39b8f8904437f084fbffac2", "bindings_sha256": "83faaf081859782edd6243c5ad113e5fb703478915d8bb4edd96855764567b57", "placed": 25, "fault_totals": {}, "noop_rounds": 0, "degradations": 0, "rounds": 144, "restores": 0, "warm_restores": 0, "divergences": 0, "repairs": {}, "device_flips": 0},
    },
}

# The service phases' configurations (ksched_tpu_torch/drivers/service.py
# ServiceConfig): BASELINE's round, 10k pods on 1,000 fabricated machines
# x 4 PUs x 4 slots, then 1% completions and 100 arrivals a round; the
# resident arms' bit flips drawn per solve at 0.5, a checkpoint and warm
# restore after round 3. Chaos soaks at the Makefile's chaos-smoke
# arguments and its recovery-smoke's shapes cut to 128 rounds.
SERVICE_CONFIGS = {
    "service": dict(),
    "service-whare": dict(cost_model="whare", classes=4, rounds=3),
    "service-resident": dict(backend="jax", rounds=5, device_resident=True,
                             audit_every=1),
    "service-resident-faults": dict(backend="jax", rounds=5, device_resident=True,
                                    audit_every=1, corrupt_prob=0.5, restore_after=3),
    "native": dict(backend="native", rounds=0),
}
SOAK_ARGS = {
    "determinism": dict(rounds=96, chunk=32, seed=0, machines=6, slots=8,
                        chaos_restore_every=48, verify_determinism=True),
    "recovery": dict(rounds=128, chunk=32, seed=11, machines=6, slots=8,
                     chaos_restore_every=48, verify_recovery=True),
}

# H100 SXM peaks (NVIDIA data sheet and Hopper white paper): HBM3 at
# 3.35 TB/s; int32 ALU work outside the tensor cores at 64 INT32 lanes
# per SM x 132 SMs x 1.98 GHz boost = 16.7 TOP/s (the same basis as
# the data sheet's 67 TFLOP/s float32 figure).
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 64 * 132 * 1.98e9
# int32 operations per [C, Mp] cell of one push/relabel superstep, as
# counted in solver/layered.py transport_superstep: excesses 2, reduced
# costs 4, forward admissibility and push 9, backward admissibility and
# push 10, flow update 2, relabel candidates and push tests 11.
OPS_PER_CELL_STEP = 38
# per cell of one phase start (transport_saturate: reduced cost 2,
# two compares and two selects 4)
OPS_PER_CELL_PHASE = 6
# The tiered solve, counted in solver/layered.py the same way, per
# [C, Mp] cell: transport_superstep_tiered 73 (excesses 2, tier split 2,
# two reduced costs 4, tier residuals with U 4, forward admissibility
# and push 14, two backward reduced costs 4, backward admissibility 8,
# the two-tier column prefix 8, backward pushes 7, flow update 2,
# relabel candidates and push tests 18); a phase start
# (transport_saturate_eps_tiered) 17; a price-refine wave
# (_price_refine_tiered) 25.
OPS_PER_CELL_STEP_TIERED = 73
OPS_PER_CELL_PHASE_TIERED = 17
OPS_PER_CELL_WAVE_TIERED = 25
# The mcmf solve, counted in ops/mcmf.py mcmf_loop_plain (every
# elementwise op, gather, cumsum or scatter step one operation), per
# entry (E) and per segment (S, one per source node and the pad):
# a superstep 33 E + 28 S (excess 2 E + 6 S, the active test 2 S,
# residuals 3 E, partner and own prices 2 E, admissibility 9 E, the
# in-segment prefix 4 E + 3 S, the push 3 E, the flow update 4 E, the
# relabel bound 4 E, pushed and residual sums 2 E + 10 S, the relabel
# 7 S); a phase start 11 E + 8 S (excess and the active test, then the
# saturate 9 E); a tightening sweep 5 E + 4 S; the prologue and the
# end 14 E + 12 S, plus the 12 E of the gathers into entry order.
OPS_MCMF_STEP = (33, 28)
OPS_MCMF_PHASE = (11, 8)
OPS_MCMF_SWEEP = (5, 4)
OPS_MCMF_ONCE = (26, 12)
# the soltel ring's counters a superstep (ops/mcmf.py mcmf_loop_plain):
# saturated entries 3 E, admissible entries 1 E, units pushed 1 E; the
# active and excess sums 4 S, the relabels 1 S
OPS_MCMF_RING = (5, 5)


#: the soltel ring's rows in the mcmf parity cases (a cold solve wraps it)
PARITY_RING = 64


class Failed(Exception):
    pass


def check(cond, what):
    if not cond:
        raise Failed(what)


def say(*a):
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# instances
# ---------------------------------------------------------------------------


def random_instance_m(seed, C, Mp):
    """A padded transport instance in the form the dense path emits:
    scaled costs, a zero-cost unsched column of capacity sum(supply),
    padded columns of capacity 0. The real machine count M is drawn so
    that pad_geometry gives exactly Mp. Returns (wS, supply, col_cap,
    n_scale, M)."""
    from ksched_tpu_torch.solver.layered import pad_geometry

    rng = np.random.default_rng(seed)
    M = int(rng.integers(max(1, Mp - 127), Mp))
    Mp2, n_scale = pad_geometry(M, C)
    check(Mp2 == Mp, f"pad_geometry({M}, {C}) = {Mp2}, want {Mp}")
    w = rng.integers(-30, 30, (C, M)).astype(np.int64)
    wS = np.zeros((C, Mp), np.int32)
    wS[:, :M] = w * n_scale
    supply = rng.integers(0, 60, C).astype(np.int32)
    col_cap = np.zeros(Mp, np.int32)
    col_cap[:M] = rng.integers(0, 25, M).astype(np.int32)
    col_cap[-1] = supply.sum()
    return wS, supply, col_cap, n_scale, M


def random_tiered_instance(seed, C, Mp):
    """A tiered instance (tiered_from) on random_instance's costs."""
    return tiered_from(seed, random_instance_m(seed, C, Mp))


def edge_instance(seed, C, Mp):
    """A transport instance of exactly Mp columns, for the row-split
    plan's edges (Mp need not be a multiple of 128, or of 4): Mp - 1
    machines and the zero-cost escape column of capacity sum(supply),
    costs scaled by the smallest power of two above the node count.
    Returns (wS, supply, col_cap, n_scale, M)."""
    rng = np.random.default_rng(seed)
    M = Mp - 1
    n_scale = 1 << (C + Mp + 2).bit_length()
    wS = np.zeros((C, Mp), np.int32)
    wS[:, :M] = rng.integers(-30, 30, (C, M)) * n_scale
    supply = rng.integers(0, 60, C).astype(np.int32)
    col_cap = np.zeros(Mp, np.int32)
    col_cap[:M] = rng.integers(0, 25, M)
    col_cap[-1] = supply.sum()
    return wS, supply, col_cap, n_scale, M


def tiered_from(seed, inst):
    """A tiered instance from a transport instance: its costs as the dear
    tier wHi, a random continuation discount of 1-11 cost units off every
    real column for the cheap tier wLo, and a random resident tile R (0-5
    per cell, none on the escape column). Returns (wLo, wHi, R, supply,
    col_cap)."""
    wS, supply, col_cap, n_scale, M = inst
    rng = np.random.default_rng(seed + 77)
    wLo = wS.copy()
    wLo[:, :M] -= int(rng.integers(1, 12)) * n_scale
    R = rng.integers(0, 6, wS.shape).astype(np.int32)
    R[:, -1] = 0
    return wLo, wS, R, supply, col_cap


# Parity shapes at the row-split plan's edges (ops/transport.py
# row_plan): the main [4, 1024]; Mp not a multiple of 4, uneven slices;
# one warp per row (32 rows); more rows than warps; most warps without a
# column. The last two cases put the whole state in global memory.
PLAN_EDGES = [((4, 1024), False), ((6, 1021), False), ((31, 777), False),
              ((33, 64), False), ((3, 4), False), ((4, 1024), True), ((6, 1021), True)]


class GlobalState:
    """Inside the block, the transport kernels' layout keeps nothing in
    shared memory (their shared-memory budget taken as 0)."""

    def __init__(self, on):
        self.on = on

    def __enter__(self):
        from ksched_tpu_torch.ops import transport

        self.saved = dict(transport._budgets)
        if self.on:
            for kind in ("transport", "transport_tiered"):
                transport._budgets[(kind, 0)] = 0
        return self

    def __exit__(self, *exc):
        from ksched_tpu_torch.ops import transport

        transport._budgets.clear()
        transport._budgets.update(self.saved)


def on(dev, *arrays):
    return [torch.as_tensor(a, device=dev) for a in arrays]


def max_abs_diff(a, b):
    """Largest |a - b| over the solve outputs (y, pm, steps, converged),
    in int64 so nothing wraps."""
    err = 0
    for x, y in zip(a, b):
        d = (x.to(torch.int64) - y.to(torch.int64)).abs().max()
        err = max(err, int(d))
    return err


def same_bits(a, b):
    return all(
        x.dtype == y.dtype and x.shape == y.shape and torch.equal(x, y)
        for x, y in zip(a, b)
    )


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_parity(dev):
    from ksched_tpu_torch.ops.transport import transport_loop
    from ksched_tpu_torch.solver.layered import _solve_transport

    worst = 0
    cases = [((C, Mp), False, random_instance_m(100 + i, C, Mp)) for i, (C, Mp)
             in enumerate([(2, 128), (4, 1024), (16, 1152), (64, 4096)])]
    cases += [(shape, glob, edge_instance(150 + i, *shape))
              for i, (shape, glob) in enumerate(PLAN_EDGES)]
    for shape_i, ((C, Mp), glob, inst) in enumerate(cases):
        wS, supply, col_cap, n_scale, _M = inst
        eps_full = int(max(1, np.abs(wS).max()))
        # the carried prices of a cold solve, on a perturbed instance
        rng = np.random.default_rng(200 + shape_i)
        supply2 = np.maximum(0, supply + rng.integers(-3, 4, C)).astype(np.int32)
        cap2 = col_cap.copy()
        cap2[-1] = supply2.sum()
        a = on(dev, wS, supply, col_cap)
        a2 = on(dev, wS, supply2, cap2)
        where = " global" if glob else ""
        for refine in (0, 2):
            with GlobalState(glob):
                cold = transport_loop(*a, eps_full, alpha=8, max_supersteps=50_000,
                                      refine_waves=refine)
                pm0 = cold[1].clone()
                warm = transport_loop(*a2, n_scale, pm0, alpha=8,
                                      max_supersteps=50_000, refine_waves=refine)
            plain = _solve_transport(*a, eps_full, alpha=8, max_supersteps=50_000,
                                     refine_waves=refine)
            warm_p = _solve_transport(*a2, n_scale, pm0, alpha=8,
                                      max_supersteps=50_000, refine_waves=refine)
            for label, k, p in (("zero pm0", cold, plain), ("carried pm0", warm, warm_p)):
                torch.cuda.synchronize()
                err = max_abs_diff(k, p)
                worst = max(worst, err)
                ok = same_bits(k, p) and bool(k[3])
                say(f"parity [{C},{Mp}]{where} refine={refine} {label}: steps={int(k[2])} "
                    f"converged={bool(k[3])} max_abs_err={err} "
                    f"{'bit-identical' if ok else 'MISMATCH'}")
                check(ok, f"kernel != plain at [{C},{Mp}]{where} refine={refine} {label}")
    return worst


class Recorder:
    """Wraps ops.<name> (a solve entry point) for a run of the main
    path: records each solve's inputs and outputs, and its kernel time
    from CUDA events."""

    def __init__(self, ops, name="transport_solve"):
        self.ops = ops
        self.name = name
        self.inner = getattr(ops, name)
        self.calls = []

    def __enter__(self):
        setattr(self.ops, self.name, self)
        return self

    def __exit__(self, *exc):
        setattr(self.ops, self.name, self.inner)

    def __call__(self, *args, **kw):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = self.inner(*args, **kw)
        end.record()
        self.calls.append({
            "args": tuple(a.clone() if isinstance(a, torch.Tensor) else a
                          for a in args),
            "kw": dict(kw), "out": tuple(t.clone() for t in out),
            "events": (start, end),
        })
        return out

    def kernel_ms(self, first=0):
        torch.cuda.synchronize()
        return sum(c["events"][0].elapsed_time(c["events"][1])
                   for c in self.calls[first:])


class EventTimer:
    """Wraps a callable: CUDA events around each call, summed on
    request. `wrap(fn)` times another callable into the same sum."""

    def __init__(self, fn):
        self.fn = fn
        self.events = []

    def __call__(self, *args, **kw):
        return self.wrap(self.fn)(*args, **kw)

    def wrap(self, fn):
        def timed(*args, **kw):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kw)
            end.record()
            self.events.append((start, end))
            return out

        return timed

    def ms(self, first=0):
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in self.events[first:])


class SolveLog(EventTimer):
    """EventTimer over the bounded solves (transport_fori(_tiered)) that
    also records, per call, its solve attempts (kernel launches), how it
    reads its flags — `retry`: the first attempt's flag decides the
    full-range retry inside the call; `stage1`: retry off, the caller
    reads the flag — and what the host knew of the flag on return."""

    def __init__(self, fn):
        super().__init__(fn)
        self.calls = []

    def wrap(self, fn):
        from ksched_tpu_torch.ops.transport import transport_loop, transport_loop_tiered

        timed = super().wrap(fn)

        def logged(*args, **kw):
            first = transport_loop.launches + transport_loop_tiered.launches
            out = timed(*args, **kw)
            iterative = kw.get("eps0") is not None
            self.calls.append({
                "attempts": transport_loop.launches + transport_loop_tiered.launches - first,
                "retry": iterative and kw.get("eps0_retry", True),
                "stage1": iterative and not kw.get("eps0_retry", True),
                "known": out[4],
            })
            return out

        return logged


def phase_reference(dev):
    """W(20, 200) on the card; each round's objective equals the exact
    cpu_ref oracle's on the same flow problem."""
    from ksched_tpu_torch.drivers import whare_mixed_rounds
    from ksched_tpu_torch.solver.cpu_ref import ReferenceSolver
    from ksched_tpu_torch.solver.select import make_backend

    backend = make_backend("auto", device=dev)
    for r, sched, placed in whare_mixed_rounds(20, 200, backend):
        obj = sched.solver.last_result.objective
        ref = ReferenceSolver().solve(sched.solver.state.problem()).objective
        say(f"W(20,200) round {r}: placed={placed} path={backend.last_path} "
            f"supersteps={backend.last_supersteps} objective={obj} cpu_ref={ref}")
        check(obj == ref, f"round {r}: objective {obj} != cpu_ref {ref}")
        check(placed == REF_W_SMALL["placed"][r]
              and backend.last_supersteps == REF_W_SMALL["supersteps"][r]
              and obj == REF_W_SMALL["objective"][r],
              f"W(20,200) round {r} differs from the JAX package's values")


def phase_main(dev):
    """W(1000, 10000) through the scheduler's default backend."""
    import ksched_tpu_torch.ops as ops
    from ksched_tpu_torch.drivers import whare_mixed_rounds
    from ksched_tpu_torch.ops.transport import transport_loop
    from ksched_tpu_torch.solver.graph_collapse import AutoSolver

    from ksched_tpu_torch.obs import SpanTracer

    transport_loop.launches = 0
    with Recorder(ops) as rec, SpanTracer() as tracer:
        rounds = whare_mixed_rounds(1000, 10000, backend=None)
        seen = 0
        mark = tracer.mark()
        t0 = time.perf_counter()
        for r, sched, placed in rounds:
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            backend = sched.solver.backend
            check(isinstance(backend, AutoSolver) and backend.device.type == "cuda",
                  "the scheduler's default backend is not AutoSolver on cuda")
            obj = sched.solver.last_result.objective
            tm = sched.last_timing
            say(f"W(1000,10000) round {r}: placed={placed} path={backend.last_path} "
                f"supersteps={backend.last_supersteps} objective={obj} "
                f"wave_s={wall:.4f} round_s={tm.total_s:.4f} solve_s={tm.solve_s:.4f} "
                f"kernel_ms={rec.kernel_ms(first=seen):.4f} "
                f"stats_s={tm.stats_s:.4f} graph_update_s={tm.graph_update_s:.4f} "
                f"deltas_s={tm.deltas_s:.4f} apply_s={tm.apply_s:.4f} "
                f"launches={len(rec.calls) - seen}")
            say_spans(tracer, mark)
            seen = len(rec.calls)
            mark = tracer.mark()
            check(backend.last_path == "dense", f"round {r} left the dense path")
            check(placed == REF_W_FULL["placed"][r], f"round {r}: placed {placed}")
            check(backend.last_supersteps == REF_W_FULL["supersteps"][r],
                  f"round {r}: supersteps {backend.last_supersteps}")
            check(obj == REF_W_FULL["objective"][r], f"round {r}: objective {obj}")
            check(sched.gm.sink_node.excess == -len(sched.gm.task_to_node),
                  f"round {r}: supply invariant broken")
            t0 = time.perf_counter()
    launches = transport_loop.launches
    say(f"main path: {len(rec.calls)} iterative transport solves, "
        f"{launches} kernel launches")
    check(launches == len(rec.calls) and launches >= 2,
          f"kernel launches {launches} != iterative attempts {len(rec.calls)}")
    # every captured solve re-solved by the plain version on the card
    from ksched_tpu_torch.solver.layered import _solve_transport

    worst = 0
    for i, c in enumerate(rec.calls):
        plain = _solve_transport(*c["args"], **c["kw"])
        torch.cuda.synchronize()
        err = max_abs_diff(c["out"], plain)
        worst = max(worst, err)
        say(f"main-path solve {i}: shape={list(c['args'][0].shape)} "
            f"eps={c['args'][3]} steps={int(c['out'][2])} "
            f"max_abs_err={err} vs plain")
        check(same_bits(c["out"], plain), f"main-path solve {i}: kernel != plain")
    return launches, worst, rec.calls


def say_spans(tracer, mark):
    """The solve's spans since `mark`, summed by name."""
    spans = {}
    for ev in tracer.events_since(mark):
        spans[ev["name"]] = spans.get(ev["name"], 0.0) + ev["dur"] / 1e6
    say("  solve spans: " + " ".join(
        f"{k}_s={spans.get(k, 0.0):.4f}"
        for k in ("graph_export", "backend_solve", "decode")))


def eps_phases(eps, alpha):
    """The eps phases after the first that a solve from eps runs."""
    phases, e = 0, int(eps)
    while e > 1:
        e = max(1, e // alpha)
        phases += 1
    return phases


def bound_ms(nbytes, ops_n):
    """(bytes bound, operations bound) in ms: the bytes over the card's
    memory rate, the int32 operations over its int32 rate."""
    return nbytes / HBM_BYTES_PER_S * 1e3, ops_n / INT32_OPS_PER_S * 1e3


def timed_ms(fn, n):
    """Mean CUDA-event time of n calls of fn after one warm-up call."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def probe_split(run, steps):
    """One more launch of `run(cycles)` with the kernels' phase probe
    (ops/transport.py PROBE_SLOTS), timed with CUDA events: the SM clock
    the probe's cycles imply, and each phase's share of the launch and
    its microseconds per superstep."""
    from ksched_tpu_torch.ops.transport import PROBE_SLOTS

    cyc = torch.zeros(len(PROBE_SLOTS), dtype=torch.int64, device="cuda")
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    run(cyc)
    end.record()
    torch.cuda.synchronize()
    c = dict(zip(PROBE_SLOTS, cyc.tolist()))
    ms = start.elapsed_time(end)
    per_us = c["total"] / (1e3 * ms)  # cycles per microsecond
    return (f"  phase split: probed_ms={ms:.4f} clock_GHz={per_us / 1e3:.3f} "
            + " ".join(f"{k}={100 * c[k] / c['total']:.1f}%"
                       f"/{c[k] / per_us / max(steps, 1):.3f}us"
                       for k in PROBE_SLOTS[:-1])
            + " (share of the launch / per superstep)")


def transport_bound(c):
    """(bytes bound, operations bound) in ms of a captured transport
    solve: the bytes it must move once against the int32 operations
    this data needs."""
    wS, _supply, _col_cap, eps, *rest = c["args"]
    pm0 = rest[0] if rest else None
    C, Mp = wS.shape
    steps = int(c["out"][2])
    nbytes = 4 * (2 * C * Mp + C + 2 * Mp + (Mp if pm0 is not None else 0) + 2)
    phases = eps_phases(eps, c["kw"].get("alpha", 8))
    return bound_ms(
        nbytes, C * Mp * (OPS_PER_CELL_STEP * steps + OPS_PER_CELL_PHASE * phases))


def phase_timing(calls, reps=10):
    """Kernel and plain times per main-path solve (CUDA events), and
    the bound for the same work."""
    from ksched_tpu_torch.ops.transport import transport_loop
    from ksched_tpu_torch.solver.layered import _solve_transport

    tot_k = tot_p = tot_b = 0.0
    by = {"bytes": 0.0, "operations": 0.0}
    for i, c in enumerate(calls):
        wS, supply, col_cap, eps, *rest = c["args"]
        pm0 = rest[0] if rest else None
        kw = c["kw"]
        C, Mp = wS.shape
        steps = int(c["out"][2])
        b_bytes, b_ops = transport_bound(c)
        k_ms = timed_ms(lambda: transport_loop(wS, supply, col_cap, eps, pm0, **kw), reps)
        p_ms = timed_ms(lambda: _solve_transport(wS, supply, col_cap, eps, pm0, **kw), 1)
        say(f"timing solve {i} [{C},{Mp}] steps={steps}: kernel_ms={k_ms:.4f} "
            f"plain_ms={p_ms:.3f} bound_ms={max(b_bytes, b_ops):.6f} "
            f"(bytes {b_bytes:.6f}, operations {b_ops:.6f}) "
            f"kernel_us_per_step={1e3 * k_ms / max(steps, 1):.3f}")
        say(probe_split(lambda cyc: transport_loop(wS, supply, col_cap, eps, pm0,
                                                   cycles=cyc, **kw), steps))
        tot_k += k_ms
        tot_p += p_ms
        tot_b += max(b_bytes, b_ops)
        by["bytes"] += b_bytes
        by["operations"] += b_ops
    bound_by = max(by, key=by.get)
    return tot_k, tot_p, tot_b, bound_by


def phase_parity_tiered(dev):
    """The tiered kernel against its plain version on seeded instances
    with random resident tiles, refine 0 and 8."""
    from ksched_tpu_torch.ops.transport import transport_loop_tiered
    from ksched_tpu_torch.solver.layered import _solve_transport_tiered

    worst = 0
    cases = [((C, Mp), False, random_tiered_instance(300 + i, C, Mp)) for i, (C, Mp)
             in enumerate([(2, 128), (4, 1024), (16, 1152), (64, 4096)])]
    cases += [(shape, glob, tiered_from(350 + i, edge_instance(350 + i, *shape)))
              for i, (shape, glob) in enumerate(PLAN_EDGES)]
    for (C, Mp), glob, inst in cases:
        eps_full = int(max(1, np.abs(inst[1]).max()))
        a = on(dev, *inst)
        where = " global" if glob else ""
        for refine in (0, 8):
            with GlobalState(glob):
                k = transport_loop_tiered(*a, eps_full, alpha=8, max_supersteps=50_000,
                                          refine_waves=refine)
            p = _solve_transport_tiered(*a, eps_full, alpha=8, max_supersteps=50_000,
                                        refine_waves=refine)
            torch.cuda.synchronize()
            err = max_abs_diff(k, p)
            worst = max(worst, err)
            ok = same_bits(k, p) and bool(k[3])
            say(f"tiered parity [{C},{Mp}]{where} refine={refine}: steps={int(k[2])} "
                f"converged={bool(k[3])} max_abs_err={err} "
                f"{'bit-identical' if ok else 'MISMATCH'}")
            check(ok, f"tiered kernel != plain at [{C},{Mp}]{where} refine={refine}")
    return worst


def pu_sha256(cluster):
    return hashlib.sha256(
        cluster.fetch_state()["pu"].astype(np.int32).tobytes()).hexdigest()


def run_bulk(dev, config, rounds):
    """A DeviceBulkCluster scenario (drivers/device_bulk.py) on the card,
    every kernel count set to 0 just before it: per round its wall time
    (host clock from a synchronize before round() to one after it),
    kernel time (CUDA events around each solve), decode time (CUDA
    events around each rank-match decode), host reads and launches;
    each round's values checked against the JAX package's. Returns
    (cluster, tasks, recorders, launches)."""
    import ksched_tpu_torch.ops as ops
    import ksched_tpu_torch.scheduler.device_bulk as device_bulk
    from ksched_tpu_torch.drivers.device_bulk import (
        churn_of,
        device_cluster,
        group_setup,
        run_rounds,
    )
    from ksched_tpu_torch.ops.transport import transport_loop, transport_loop_tiered
    from ksched_tpu_torch.solver.layered import read_branch, read_flag

    ref = REF_BULK[config]
    cluster, tasks = device_cluster(config, device=dev)
    decode = cluster.rank_match_decode = EventTimer(cluster.rank_match_decode)
    # the bounded solves (closed forms, eps start, attempts and the retry
    # read), as the round calls them
    solvers = {name: getattr(device_bulk, name)
               for name in ("transport_fori", "transport_fori_tiered")}
    solve = SolveLog(None)
    for name, fn in solvers.items():
        setattr(device_bulk, name, solve.wrap(fn))
    walls = []
    plain_round = cluster.round

    def timed_round():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stats = plain_round()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        return stats

    cluster.round = timed_round
    transport_loop.launches = transport_loop_tiered.launches = 0
    read_flag.count = read_branch.count = 0
    with Recorder(ops, "transport_solve") as rec, \
            Recorder(ops, "transport_solve_tiered") as rec_t:
        # solves, tiered solves, decodes, reads, launches, bounded solves
        seen = [0, 0, 0, 0, 0, 0]
        for r, stats in run_rounds(cluster, tasks, rounds, setup=group_setup(config),
                                   churn=churn_of(config)):
            got = cluster.fetch_stats(stats)
            launches = transport_loop.launches + transport_loop_tiered.launches
            now = [len(rec.calls), len(rec_t.calls), len(decode.events),
                   read_flag.count + read_branch.count, launches, len(solve.events)]
            say(f"{config} round {r}: "
                + " ".join(f"{k}={int(got[k])}" for k in ref if k in got)
                + f" wall_ms={1e3 * walls[r]:.3f}"
                f" solve_ms={solve.ms(seen[5]):.3f}"
                f" kernel_ms={rec.kernel_ms(seen[0]) + rec_t.kernel_ms(seen[1]):.3f}"
                f" decode_ms={decode.ms(seen[2]):.3f}"
                f" host_reads={now[3] - seen[3]} launches={now[4] - seen[4]}")
            seen = now
            for k in ref:
                if k != "pu_sha256":
                    check(int(got[k]) == ref[k][r],
                          f"{config} round {r}: {k}={int(got[k])}, the JAX package "
                          f"gives {ref[k][r]}")
    del cluster.round, cluster.rank_match_decode
    for name, fn in solvers.items():
        setattr(device_bulk, name, fn)
    sha = pu_sha256(cluster)
    say(f"{config}: final pu sha256 {sha}")
    check(sha == ref["pu_sha256"], f"{config}: final placements differ from the "
          "JAX package's")
    check_reads(config, read_flag.count, read_branch.count, solve.calls,
                rounds + 1 if cluster.grouped else 0)
    launches = (transport_loop.launches, transport_loop_tiered.launches)
    check(launches == (len(rec.calls), len(rec_t.calls)),
          f"{config}: launches {launches} != attempts "
          f"{(len(rec.calls), len(rec_t.calls))}")
    say(f"{config}: launches transport={launches[0]} transport_tiered={launches[1]}")
    return cluster, tasks, (rec, rec_t), launches


def check_reads(where, flags, branches, calls, branch_points, escalations=0):
    """Every host read of a device-bulk run decided something: a
    bounded solve's flag where it decides the full-range retry (one per
    call with a retry that launched), where the grouped stage 1's caller
    branches on it (one per launched stage 1) or where the incremental
    tier's escalation needs a flag the host does not know
    (`escalations`), and a branch point's predicates (one per hybrid
    steady round, one per grouped solve). Retried attempts whose flag no
    decision needs are not read."""
    attempts = sum(c["attempts"] for c in calls)
    retries = sum(c["attempts"] > 0 and c["retry"] for c in calls)
    stage1 = sum(c["attempts"] > 0 and c["stage1"] for c in calls)
    say(f"{where}: host reads {flags + branches} = {flags} flag reads "
        f"+ {branches} branch reads; {attempts} solve attempts; flags needed "
        f"by {retries} retry decisions, {stage1} stage-1 outcomes and "
        f"{escalations} escalation tests; {branch_points} branch points")
    check(flags == retries + stage1 + escalations and branches == branch_points,
          f"{where}: {flags} flag reads and {branches} branch reads for "
          f"{retries + stage1 + escalations} flag decisions and {branch_points} "
          "branch points")


def phase_device_bulk(dev):
    """coco50k-preempt-full, then coco50k and 10kx1k, on the card."""
    from ksched_tpu_torch.solver.layered import _solve_transport_tiered

    cluster, tasks, (rec, rec_t), (l1, l2) = run_bulk(dev, "coco50k-preempt-full", 4)
    check(l1 == 0 and l2 > 0, "coco50k-preempt-full did not run the tiered kernel alone")
    # the fill's and two later captured solves, re-solved by the plain
    # version on the card (timed with CUDA events: it syncs every superstep)
    picked = sorted({0, 1, len(rec_t.calls) - 1})
    check(len(picked) >= 3, "fewer than three captured tiered solves")
    worst, plain_ms = 0, {}
    for i in picked:
        c = rec_t.calls[i]
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        plain = _solve_transport_tiered(*c["args"], **c["kw"])
        end.record()
        torch.cuda.synchronize()
        plain_ms[i] = start.elapsed_time(end)
        err = max_abs_diff(c["out"], plain)
        worst = max(worst, err)
        say(f"coco50k-preempt-full solve {i}: shape={list(c['args'][0].shape)} "
            f"eps={int(c['args'][5])} steps={int(c['out'][2])} "
            f"max_abs_err={err} vs plain (plain_ms={plain_ms[i]:.1f})")
        check(same_bits(c["out"], plain),
              f"coco50k-preempt-full solve {i}: kernel != plain")

    _c, _t, _r, (b1, b2) = run_bulk(dev, "coco50k", 2)
    check(b1 > 0 and b2 == 0, "coco50k did not run the transport kernel alone")
    _c, _t, _r, (z1, z2) = run_bulk(dev, "10kx1k", 2)
    check(z1 == 0 and z2 == 0, "10kx1k launched a kernel (expected the closed form)")
    return cluster, tasks, l2, b1, rec_t.calls, picked, plain_ms, worst


def check_occupancy(cluster, where):
    """tools/soak.py's invariants: pu_running equals a recount, no PU
    above its slots, disabled machines empty."""
    st = cluster.fetch_state()
    placed = st["live"] & (st["pu"] >= 0)
    recount = np.bincount(st["pu"][placed], minlength=cluster.num_pus)
    check((recount == st["pu_running"]).all(), f"{where}: pu_running drift")
    check((st["pu_running"] <= cluster.S).all(), f"{where}: slot overflow")
    on_disabled = placed & ~np.repeat(st["machine_enabled"], cluster.P)[
        np.clip(st["pu"], 0, cluster.num_pus - 1)]
    check(not on_disabled.any(), f"{where}: a task on a disabled machine")


def phase_steady(dev, cluster, tasks):
    """32 steady churn rounds of coco50k-preempt-full on a torch.Generator:
    16, then 1% of the machines disabled, then 16 more."""
    from ksched_tpu_torch.drivers.device_bulk import steady_rounds
    from ksched_tpu_torch.ops.transport import transport_loop_tiered
    from ksched_tpu_torch.solver.layered import read_flag

    gen = torch.Generator(device=dev).manual_seed(11)
    down = np.random.default_rng(5).choice(cluster.M, cluster.M // 100, replace=False)
    for chunk in range(2):
        if chunk == 1:
            for m in down:
                cluster.set_machine_enabled(int(m), False)
        transport_loop_tiered.launches = read_flag.count = 0
        t0 = time.perf_counter()
        got = cluster.fetch_stats(steady_rounds(cluster, tasks, 16, gen))
        wall = time.perf_counter() - t0
        say(f"steady chunk {chunk} (16 rounds, {len(down) if chunk else 0} machines "
            f"down): wall_ms_per_round={1e3 * wall / 16:.3f} "
            f"supersteps mean={got['supersteps'].mean():.1f} max={int(got['supersteps'].max())} "
            f"placed={int(got['placed'].sum())} migrated={int(got['migrated'].sum())} "
            f"preempted={int(got['preempted'].sum())} live={int(got['live'][-1])} "
            f"launches={transport_loop_tiered.launches} host_reads={read_flag.count}")
        check(bool(got["converged"].all()), f"steady chunk {chunk}: a round did not converge")
        check_occupancy(cluster, f"steady chunk {chunk}")


def phase_timing_tiered(calls, picked, plain_ms, reps=5, extra=(2,)):
    """The tiered kernel's time at the picked captured solves (CUDA
    events), beside its plain version's (measured at the re-solve) and
    its bound; and, for the phase split, at the `extra` solves too (not
    in the sums)."""
    from ksched_tpu_torch.ops.transport import transport_loop_tiered

    tot_k = tot_p = tot_b = 0.0
    by = {"bytes": 0.0, "operations": 0.0}
    for i in sorted(set(picked) | set(extra)):
        c = calls[i]
        wLo, wHi, R, supply, col_cap, eps = c["args"]
        kw = c["kw"]
        C, Mp = wLo.shape
        steps = int(c["out"][2])
        # bound: bytes moved once (wLo, wHi, R, supply, col_cap, eps in;
        # y, pm, steps, converged out) vs int32 operations this data needs
        nbytes = 4 * (4 * C * Mp + C + 2 * Mp + 3)
        phases = eps_phases(eps, kw.get("alpha", 8))
        per_phase = (OPS_PER_CELL_PHASE_TIERED
                     + OPS_PER_CELL_WAVE_TIERED * kw.get("refine_waves", 0))
        b_bytes, b_ops = bound_ms(
            nbytes, C * Mp * (OPS_PER_CELL_STEP_TIERED * steps + per_phase * phases))
        k_ms = timed_ms(lambda: transport_loop_tiered(*c["args"], **kw), reps)
        say(f"timing tiered solve {i} [{C},{Mp}] steps={steps}: kernel_ms={k_ms:.4f} "
            f"plain_ms={plain_ms.get(i, float('nan')):.3f} "
            f"bound_ms={max(b_bytes, b_ops):.6f} "
            f"(bytes {b_bytes:.6f}, operations {b_ops:.6f}) "
            f"kernel_us_per_step={1e3 * k_ms / max(steps, 1):.3f}")
        say(probe_split(lambda cyc: transport_loop_tiered(*c["args"], cycles=cyc, **kw),
                        steps))
        if i not in picked:
            continue
        tot_k += k_ms
        tot_p += plain_ms[i]
        tot_b += max(b_bytes, b_ops)
        by["bytes"] += b_bytes
        by["operations"] += b_ops
    return tot_k, tot_p, tot_b, max(by, key=by.get)


def tier_of(got, r):
    if not got.get("full_round", np.zeros(r + 1))[r]:
        return "incremental"
    if got["global_round"][r]:
        return "global"
    return "escalated" if got["escalated_round"][r] else "scoped"


def round_summary(rows):
    """rounds, and wall ms (mean, p50, max) beside the mean solve,
    kernel and decode ms of `rows` (run_steady's per-round records)."""
    walls = np.array([p[2] for p in rows])
    kms = [sum(c["events"][0].elapsed_time(c["events"][1]) for c in p[0] + p[1])
           for p in rows]
    return (f"rounds={len(rows)} wall_ms mean={walls.mean():.3f} "
            f"p50={np.median(walls):.3f} max={walls.max():.3f} "
            f"solve_ms mean={np.mean([p[4][0] for p in rows]):.3f} "
            f"kernel_ms mean={np.mean(kms):.3f} "
            f"decode_ms mean={np.mean([p[4][1] for p in rows]):.3f}")


def run_steady(dev, config, restore=False):
    """The config's scenario (run_bulk: the fill and host-driven rounds
    against the JAX package's values), then REF_STEADY's steady rounds
    on the JAX package's draws with every count set to 0 just before:
    per round its tier or grouped path, supersteps, census drift, wall
    time (host clock, a synchronize on each side) and kernel time (CUDA
    events around each solve); the tiers or per-round values, the stats'
    and the final placements' sha256 against the JAX package's; host
    reads against attempts and branch points. Returns (cluster, per-round
    stats, per-round (B1 calls, B2 calls, wall ms, grouped path),
    launches (B1, B2)). With `restore`, the steady rounds run on a
    cluster saved after the host-driven rounds with
    save_device_checkpoint and loaded on the card with
    load_device_checkpoint."""
    import ksched_tpu_torch.ops as ops
    from ksched_tpu_torch.drivers.device_bulk import churn_of, stats_sha256
    from ksched_tpu_torch.ops.transport import transport_loop, transport_loop_tiered
    from ksched_tpu_torch.solver.layered import read_branch, read_flag

    import ksched_tpu_torch.scheduler.device_bulk as device_bulk

    ref = REF_STEADY[config]
    cluster, tasks, _rec, _l = run_bulk(dev, config, len(REF_BULK[config]["placed"]) - 1)
    if restore:
        cluster = device_checkpoint_round_trip(dev, config, cluster)
    per_round = []
    plain_step = cluster.steady_round
    decode = cluster.rank_match_decode = EventTimer(cluster.rank_match_decode)
    solvers = {name: getattr(device_bulk, name)
               for name in ("transport_fori", "transport_fori_tiered")}
    solve = SolveLog(None)
    for name, fn in solvers.items():
        setattr(device_bulk, name, solve.wrap(fn))

    def timed_step(*a, **kw):
        torch.cuda.synchronize()
        first = (len(rec.calls), len(rec_t.calls), len(solve.events), len(decode.events))
        t0 = time.perf_counter()
        out = plain_step(*a, **kw)
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
        per_round.append((rec.calls[first[0]:], rec_t.calls[first[1]:], wall,
                          cluster.last_grouped_path,
                          (solve.ms(first[2]), decode.ms(first[3])),
                          solve.calls[first[2]:]))
        return out

    cluster.steady_round = timed_step
    transport_loop.launches = transport_loop_tiered.launches = 0
    read_flag.count = read_branch.count = 0
    with Recorder(ops, "transport_solve") as rec, \
            Recorder(ops, "transport_solve_tiered") as rec_t:
        t0 = time.perf_counter()
        churn = churn_of(config)
        stats = cluster.run_steady_rounds(ref["rounds"], churn, max(1, int(tasks * churn)),
                                          seed=STEADY_SEED)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
    del cluster.steady_round, cluster.rank_match_decode
    for name, fn in solvers.items():
        setattr(device_bulk, name, fn)
    launches = (transport_loop.launches, transport_loop_tiered.launches)
    got = cluster.fetch_stats(stats)
    say(f"{config} steady: {ref['rounds']} rounds in {total:.3f} s, "
        f"{total - sum(p[2] for p in per_round) / 1e3:.3f} s of it outside the "
        f"rounds' walls (the run's keys on the host, each chunk's draws on the card)")
    for r, (c1, c2, wall, path, (solve_ms, decode_ms), _s) in enumerate(per_round):
        kms = sum(c["events"][0].elapsed_time(c["events"][1]) for c in c1 + c2)
        if cluster.hybrid_preempt:
            where = f"tier={tier_of(got, r)} census_drift={int(got['census_drift'][r])}"
        elif cluster.grouped:
            where = (f"rows={path[0]} solve={path[1]} "
                     f"active_groups={int(got['active_groups'][r])}")
        else:
            where = "rows=" + str(cluster.G)
        say(f"{config} steady {r}: {where} supersteps={int(got['supersteps'][r])} "
            f"placed={int(got['placed'][r])} migrated={int(got.get('migrated', got['placed'] * 0)[r])} "
            f"objective={int(got['objective'][r])} wall_ms={wall:.3f} "
            f"solve_ms={solve_ms:.3f} kernel_ms={kms:.3f} decode_ms={decode_ms:.3f} "
            f"b1={len(c1)} b2={len(c2)}")
    check(bool(got["converged"].all()), f"{config} steady: a round did not converge")
    if cluster.hybrid_preempt:
        tiers = {t: sum(tier_of(got, r) == t for r in range(ref["rounds"]))
                 for t in ("global", "scoped", "escalated", "incremental")}
        tiers["scoped"] += tiers["escalated"]  # an escalated round is a scoped one
        for t in ("incremental", "scoped", "escalated", "global"):
            rows = [i for i in range(ref["rounds"]) if tier_of(got, i) == t]
            if rows:
                say(f"{config} tier {t}: " + round_summary([per_round[i] for i in rows])
                    + f" supersteps mean={got['supersteps'][rows].mean():.1f} "
                    f"max={int(got['supersteps'][rows].max())}")
        say(f"{config} steady tiers: {tiers} (JAX package: {ref['tiers']})")
        check(tiers == ref["tiers"], f"{config}: tier counts differ from the JAX package's")
        check(min(tiers["incremental"], tiers["scoped"], tiers["global"]) > 0,
              f"{config}: not every tier ran")
    else:
        for k in ("placed", "unscheduled", "objective", "supersteps", "active_groups"):
            if k in ref:
                check(got[k].astype(np.int64).tolist() == ref[k],
                      f"{config} steady: {k} differs from the JAX package's")
        for kind in ("two-stage", "fallback", "full"):
            rows = [p for p in per_round if p[3] is not None and p[3][1] == kind]
            if rows:
                say(f"{config} steady {kind} rounds: " + round_summary(rows))
        if not cluster.grouped:
            say(f"{config} steady rounds: " + round_summary(per_round))
    sha = stats_sha256(got)
    say(f"{config} steady: stats sha256 {sha}")
    check(sha == ref["stats_sha256"], f"{config} steady: stats differ from the JAX package's")
    sha = pu_sha256(cluster)
    say(f"{config} steady: final pu sha256 {sha}")
    check(sha == ref["pu_sha256"], f"{config} steady: placements differ from the JAX package's")
    check_occupancy(cluster, f"{config} steady")
    # the incremental tier tests its capped solve's flag for escalation,
    # a read only where the host does not know it (the attempt retried)
    escalations = sum(
        bool(p[5]) and p[5][0]["known"] is None for r, p in enumerate(per_round)
        if cluster.hybrid_preempt and tier_of(got, r) in ("incremental", "escalated"))
    branch_points = ref["rounds"] if cluster.hybrid_preempt or cluster.grouped else 0
    check_reads(f"{config} steady", read_flag.count, read_branch.count,
                solve.calls, branch_points, escalations)
    check(launches == (len(rec.calls), len(rec_t.calls)),
          f"{config} steady: launches {launches} != attempts")
    say(f"{config} steady: launches transport={launches[0]} "
        f"transport_tiered={launches[1]}")
    return cluster, got, per_round, launches


def device_checkpoint_round_trip(dev, config, cluster):
    """save_device_checkpoint, then load_device_checkpoint on `dev`: the
    loaded cluster's state, hybrid carry and placements equal the
    saved one's. Returns the loaded cluster."""
    import os
    import tempfile

    from ksched_tpu_torch.runtime import load_device_checkpoint, save_device_checkpoint

    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "cluster.npz")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        save_device_checkpoint(cluster, path)
        t_save = time.perf_counter() - t0
        size = os.path.getsize(path)
        t0 = time.perf_counter()
        loaded = load_device_checkpoint(path, class_cost_fn=cluster.class_cost_fn,
                                        device=dev)
        torch.cuda.synchronize()
        t_load = time.perf_counter() - t0
    a, b = cluster.fetch_state(), loaded.fetch_state()
    same = all(np.array_equal(a[k], b[k]) and a[k].dtype == b[k].dtype for k in a)
    if cluster.hybrid_preempt:
        same = same and torch.equal(cluster._hyb_census, loaded._hyb_census) and (
            (cluster._hyb_k, cluster._hyb_kg) == (loaded._hyb_k, loaded._hyb_kg))
    say(f"{config}: device checkpoint {size} bytes, saved in {t_save:.3f} s, "
        f"loaded on {loaded.device} in {t_load:.3f} s; state equal: {same}; "
        f"pu sha256 {pu_sha256(loaded)}")
    check(same and loaded.device.type == dev.type,
          f"{config}: the loaded cluster differs from the saved one")
    return loaded


def resolve_plain(tag, c, tiered):
    """A captured solve re-solved by the plain version on the card,
    timed with CUDA events: bits equal or the phase fails. Returns
    (max_abs_err, plain ms)."""
    from ksched_tpu_torch.solver.layered import _solve_transport, _solve_transport_tiered

    plain_fn = _solve_transport_tiered if tiered else _solve_transport
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    plain = plain_fn(*c["args"], **c["kw"])
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end)
    err = max_abs_diff(c["out"], plain)
    say(f"{tag}: shape={list(c['args'][0].shape)} eps={int(c['args'][3 if not tiered else 5])} "
        f"budget={c['kw'].get('max_supersteps')} alpha={c['kw'].get('alpha')} "
        f"steps={int(c['out'][2])} converged={bool(c['out'][3])} "
        f"max_abs_err={err} vs plain (plain_ms={ms:.1f})")
    check(same_bits(c["out"], plain), f"{tag}: kernel != plain")
    return err, ms


def phase_tiers(dev):
    """coco50k-preempt at bench.py's three-tier arguments: the host-driven
    rounds, 130 steady rounds, then a scoped tiered solve and a capped
    incremental solve re-solved by the plain versions and timed."""
    _cluster, got, per_round, launches = run_steady(dev, "coco50k-preempt", restore=True)
    check(launches[0] > 0 and launches[1] > 0,
          "coco50k-preempt steady rounds did not run both transport kernels")
    scoped = [c for r, p in enumerate(per_round) if tier_of(got, r) == "scoped"
              for c in p[1]]
    incr = [c for r, p in enumerate(per_round) if tier_of(got, r) == "incremental"
            for c in p[0]]
    check(scoped and incr, "no scoped tiered solve or no incremental solve captured")
    s_pick = min(scoped, key=lambda c: int(c["out"][2]))
    i_pick = max(incr, key=lambda c: int(c["out"][2]))
    check(i_pick["kw"]["max_supersteps"] == 8192, "the incremental solve was not capped")
    err_s, ms_s = resolve_plain("coco50k-preempt scoped solve", s_pick, True)
    err_i, ms_i = resolve_plain("coco50k-preempt capped incremental solve", i_pick, False)
    phase_timing_tiered([s_pick], [0], {0: ms_s}, extra=())
    phase_timing([i_pick], reps=5)
    say(f"  (plain_ms of the incremental solve above: {ms_i:.3f})")
    return launches, max(err_s, err_i)


def phase_quincy(dev):
    """quincy10k: the host-driven rounds, 32 steady rounds, then a
    stage-1 solve and the longest other grouped solve re-solved by the
    plain version and timed beside their bound."""
    _cluster, _got, per_round, launches = run_steady(dev, "quincy10k")
    check(launches[0] > 0 and launches[1] == 0,
          "quincy10k steady rounds did not run the transport kernel alone")
    calls = [c for p in per_round for c in p[0]]
    stage1 = [c for c in calls if int(c["args"][3]) == 1 and c["kw"]["max_supersteps"] == 256]
    done = [c for c in stage1 if bool(c["out"][3])]
    spent = [c for c in stage1 if not bool(c["out"][3])]
    full = [c for c in calls if all(c is not x for x in stage1)]
    check(done and full, "no converged stage-1 solve or no full grouped solve captured")
    other = max(full, key=lambda c: int(c["out"][2]))
    worst = 0
    for tag, c in (("quincy10k stage-1 solve", done[0]),
                   ("quincy10k full (fallback) solve", other)):
        err, _ms = resolve_plain(tag, c, False)
        worst = max(worst, err)
    # B1 at the grouped shapes: a converged and a budget-exhausted
    # stage 1, and the fallback's full solve
    phase_timing(done[:1] + spent[:1] + [other], reps=10)
    return launches, worst


def phase_suite_bulk(dev):
    """whare-hetero (kernel B1) and ref100 (the closed form): the fill, 2
    host-driven rounds and the steady rounds on the JAX package's draws,
    against the JAX package's values."""
    _c, _g, _p, (w1, w2) = run_steady(dev, "whare-hetero")
    check(w1 > 0 and w2 == 0, "whare-hetero steady rounds did not run the transport kernel alone")
    _c, _g, _p, (r1, r2) = run_steady(dev, "ref100")
    check(r1 == 0 and r2 == 0, "ref100 launched a kernel (expected the closed form)")
    return w1


def run_gtrace(dev, config):
    """A gtrace cell (drivers/gtrace.py) on the card: the trace staged on
    the host, then its first 1,024 windows replayed as replay_chunks
    replays them (4 chunks of 256, seeds 1-4), every count set to 0 just
    before each chunk and read just after it. Per chunk its wall (host
    clock, a synchronize on each side), the per-window p50 and p99 (wall
    / windows, and CUDA events around each window), supersteps,
    evictions, transport launches and kernel ms, host reads and decode
    ms; its values against the JAX package's; the final placements'
    sha256. Returns the transport solve with the most supersteps of each
    chunk that ran one, and the launches."""
    import ksched_tpu_torch.ops as ops
    import ksched_tpu_torch.scheduler.device_bulk as device_bulk
    from ksched_tpu_torch.drivers.gtrace import (
        CHUNK_WINDOWS,
        WINDOW_S,
        chunk_summary,
        gtrace_driver,
        replay_chunks,
    )
    from ksched_tpu_torch.ops.transport import transport_loop
    from ksched_tpu_torch.solver.layered import read_branch, read_flag

    ref = REF_REPLAY[config]
    t0 = time.perf_counter()
    driver, events = gtrace_driver(config, device=dev)
    sch = driver.stage(events, window_s=WINDOW_S)
    widths = [int(sch[k].shape[1]) for k in ("adm_job", "done_rows", "tog_idx")]
    say(f"{config}: {driver.num_machines} machines, staged {sch['rounds']} windows "
        f"({sch['submitted']} submits, {sch['finished']} finishes, {sch['dropped']} "
        f"dropped; widths {widths}) in {time.perf_counter() - t0:.2f} s on the host")
    check([int(sch[k]) for k in ("rounds", "submitted", "finished", "dropped")] + [widths]
          == [ref[k] for k in ("rounds", "submitted", "finished", "dropped", "widths")],
          f"{config}: the staged schedule differs from the JAX package's")
    cluster = driver.cluster
    decode = cluster.rank_match_decode = EventTimer(cluster.rank_match_decode)
    window = cluster.replay_round = EventTimer(cluster.replay_round)
    solver = device_bulk.transport_fori
    solve = SolveLog(None)
    device_bulk.transport_fori = solve.wrap(solver)
    worst, launches, n_chunks = [], 0, 0
    chunk = CHUNK_WINDOWS

    def start():
        """Every count to 0 and the clock started, just before a chunk."""
        transport_loop.launches = read_flag.count = read_branch.count = 0
        torch.cuda.synchronize()
        return ((len(rec.calls), len(decode.events), len(window.events), len(solve.calls)),
                time.perf_counter())

    try:
        with Recorder(ops, "transport_solve") as rec:
            first, t0 = start()
            for c, stats in replay_chunks(driver, sch):
                torch.cuda.synchronize()
                wall = 1e3 * (time.perf_counter() - t0)
                flags, branches = read_flag.count, read_branch.count
                n_launch = transport_loop.launches
                want = ref["chunks"][c]
                summary = chunk_summary(cluster.fetch_stats(stats))
                spans = np.array([a.elapsed_time(b) for a, b in window.events[first[2]:]])
                calls = rec.calls[first[0]:]
                say(f"{config} chunk {c} ({chunk} windows, seed {1 + c}): wall_ms={wall:.3f} "
                    f"per_window_ms={wall / chunk:.4f} window_span_ms p50={np.median(spans):.4f} "
                    f"p99={np.percentile(spans, 99):.4f} max={spans.max():.4f} "
                    f"supersteps p50={summary['supersteps_p50']} max={summary['supersteps_max']} "
                    f"evicted={summary['evicted']} placed={summary['placed']} "
                    f"admitted={summary['admitted']} completed={summary['completed']} "
                    f"live={summary['live_last']} transport_launches={n_launch} "
                    f"kernel_ms={rec.kernel_ms(first[0]):.3f} host_reads={flags + branches} "
                    f"decode_ms={decode.ms(first[1]):.3f} "
                    f"(per window {decode.ms(first[1]) / chunk:.4f})")
                say(f"  stats sha256 {summary['stats_sha256']}")
                check(summary == want, f"{config} chunk {c}: {summary} differs from the JAX "
                      f"package's {want}")
                check(n_launch == len(calls), f"{config} chunk {c}: launches {n_launch} != "
                      f"attempts {len(calls)}")
                check_reads(f"{config} chunk {c}", flags, branches, solve.calls[first[3]:], 0)
                launches += n_launch
                n_chunks += 1
                if calls:
                    worst.append(max(calls, key=lambda x: int(x["out"][2])))
                first, t0 = start()
    finally:
        device_bulk.transport_fori = solver
        del cluster.rank_match_decode, cluster.replay_round
    check(n_chunks == len(ref["chunks"]), f"{config}: {n_chunks} chunks replayed")
    sha = pu_sha256(cluster)
    say(f"{config}: final pu sha256 {sha}; transport launches {launches}")
    check(sha == ref["pu_sha256"], f"{config}: final placements differ from the JAX package's")
    check_occupancy(cluster, config)
    return worst, launches


def phase_gtrace(dev):
    """gtrace12k and gtrace12k-burst (the closed form: no kernel), then
    gtrace12k-coco (kernel B1 at [4, 12,544] every window); the coco
    cell's solve with the most supersteps in its first chunk re-solved
    by the plain version with the same bits, and timed beside its
    bound."""
    for config in ("gtrace12k", "gtrace12k-burst"):
        _w, n = run_gtrace(dev, config)
        check(n == 0, f"{config} launched a kernel (expected the closed form)")
    worst, n = run_gtrace(dev, "gtrace12k-coco")
    check(n >= 1024, f"gtrace12k-coco: {n} transport launches for 1,024 windows")
    pick = worst[0]
    check(tuple(pick["args"][0].shape) == (4, 12_544), "gtrace12k-coco's solve is not [4, 12544]")
    err, plain_ms = resolve_plain("gtrace12k-coco solve", pick, False)
    k_ms, _p, b_ms, bound_by = phase_timing([pick], reps=3)
    say(f"  (plain_ms of the gtrace12k-coco solve above: {plain_ms:.3f})")
    return n, err, (k_ms, plain_ms, b_ms, bound_by)


def phase_gtrace_host(dev):
    """gtrace12k-host: TraceReplayDriver on the host BulkCluster with a
    LayeredTransportSolver on the card, 60 rounds of 5 s windows; per
    round placed, unscheduled and evicted, the totals and the final
    placements against the JAX package's; ReplayStats' p50 and the p50
    of the round's spans."""
    from ksched_tpu_torch.drivers.gtrace import HOST_REPLAY, host_driver, placements_sha256
    from ksched_tpu_torch.ops.transport import transport_loop
    from ksched_tpu_torch.solver.layered import LayeredTransportSolver

    t0 = time.perf_counter()
    driver, events = host_driver(LayeredTransportSolver(device=dev))
    say(f"gtrace12k-host: {driver.num_machines} machines, {len(events)} events, "
        f"cluster of {driver.cluster.task_cap} task rows built in "
        f"{time.perf_counter() - t0:.2f} s")
    transport_loop.launches = 0
    t0 = time.perf_counter()
    stats = driver.replay(events, **HOST_REPLAY)
    rows = stats.round_log
    wall = time.perf_counter() - t0
    spans = {k: np.median([r[3][k] for r in rows]) * 1e3
             for k in ("stats_s", "solve_s", "decode_s", "apply_s")}
    totals = {k: getattr(stats, k) for k in ("rounds", "submitted", "finished", "placed",
                                             "evicted")}
    say(f"gtrace12k-host: {stats.rounds} rounds in {wall:.3f} s, p50_ms={stats.p50_ms:.3f} "
        f"p99_ms={1e3 * np.percentile(stats.round_latencies_s, 99):.3f} span p50 ms "
        + " ".join(f"{k[:-2]}={v:.3f}" for k, v in spans.items())
        + f" totals={totals} transport_launches={transport_loop.launches}")
    for i, name in enumerate(("placed", "unscheduled", "evicted")):
        check([r[i] for r in rows] == REF_HOST[name],
              f"gtrace12k-host: per-round {name} differs from the JAX package's")
    check(totals == REF_HOST["totals"], "gtrace12k-host: totals differ from the JAX package's")
    sha = placements_sha256(driver.cluster)
    say(f"gtrace12k-host: final task_pu sha256 {sha}")
    check(sha == REF_HOST["task_pu_sha256"], "gtrace12k-host: placements differ")
    return transport_loop.launches


def phase_multiblock(dev):
    """quincy10k-multiblock: the fill, 3 chunks of 32 steady rounds, each
    after the table maintenance, then the quality probe; against the JAX
    package's values. The transport solve of the widest ladder rung that
    fired (in the fill or the chunks) re-solved by the plain version with
    the same bits, and timed beside its bound."""
    import ksched_tpu_torch.ops as ops
    from ksched_tpu_torch.drivers.device_bulk import stats_sha256
    from ksched_tpu_torch.drivers.multiblock import CHUNK_ROUNDS, FIRST_SEED, Multiblock
    from ksched_tpu_torch.ops.transport import transport_loop
    from ksched_tpu_torch.solver.layered import read_branch, read_flag

    ref = REF_MULTIBLOCK
    transport_loop.launches = read_flag.count = read_branch.count = 0
    with Recorder(ops, "transport_solve") as rec:
        t0 = time.perf_counter()
        mb = Multiblock(device=dev)
        set_up = time.perf_counter() - t0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fill = {k: int(v) for k, v in mb.cluster.fetch_stats(mb.fill()).items()}
        say(f"quincy10k-multiblock fill: {fill} set-up_s={set_up:.3f} "
            f"wall_ms={1e3 * (time.perf_counter() - t0):.3f} rows={mb.cluster.last_grouped_path} "
            f"kernel_ms={rec.kernel_ms():.3f} launches={transport_loop.launches}")
        check(fill == ref["fill"], "quincy10k-multiblock fill differs from the JAX package's")
        launches = transport_loop.launches
        for c, want in enumerate(ref["chunks"]):
            first = len(rec.calls)
            transport_loop.launches = read_flag.count = read_branch.count = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            stats = mb.chunk(CHUNK_ROUNDS, FIRST_SEED + c)
            torch.cuda.synchronize()
            wall = 1e3 * (time.perf_counter() - t0)
            got = mb.cluster.fetch_stats(stats)
            calls = rec.calls[first:]
            summary = {"stats_sha256": stats_sha256(got),
                       "converged": bool(got["converged"].all()),
                       "placed": int(got["placed"].sum()),
                       "supersteps_max": int(got["supersteps"].max()),
                       "active_groups_max": int(got["active_groups"].max())}
            rungs = sorted({int(x["args"][0].shape[0]) for x in calls})
            say(f"quincy10k-multiblock chunk {c} ({CHUNK_ROUNDS} rounds, seed {FIRST_SEED + c}, "
                f"table maintenance included): wall_ms={wall:.3f} "
                f"per_round_ms={wall / CHUNK_ROUNDS:.3f} supersteps "
                f"p50={int(np.median(got['supersteps']))} max={summary['supersteps_max']} "
                f"active_groups max={summary['active_groups_max']} solve rows {rungs} "
                f"transport_launches={transport_loop.launches} kernel_ms={rec.kernel_ms(first):.3f} "
                f"host_reads={read_flag.count + read_branch.count}")
            check(summary == want, f"quincy10k-multiblock chunk {c}: {summary} differs from the "
                  f"JAX package's {want}")
            check(transport_loop.launches == len(calls), "multiblock: launches != attempts")
            launches += transport_loop.launches
        grouped_calls = list(rec.calls)  # the fill's and the chunks' solves
        counters = mb.counters()
        say(f"quincy10k-multiblock table: {counters}")
        check(counters == ref["counters"], "quincy10k-multiblock: table counters differ")
        sha = pu_sha256(mb.cluster)
        check(sha == ref["pu_sha256"], "quincy10k-multiblock: placements differ")
        first = len(rec.calls)
        transport_loop.launches = 0
        t0 = time.perf_counter()
        probe = mb.quality_probe()
        say(f"quincy10k-multiblock probe: {probe} wall_s={time.perf_counter() - t0:.3f} "
            f"transport_launches={transport_loop.launches} "
            f"kernel_ms={rec.kernel_ms(first):.3f} shapes "
            f"{sorted({tuple(x['args'][0].shape) for x in rec.calls[first:]})}")
        for k in ("realized_cost_gap_mean", "realized_cost_gap_max", "y_sha256"):
            check(probe[k] == ref["probe"][k], f"quincy10k-multiblock probe: {k} differs")
        launches += transport_loop.launches
    widest = max(grouped_calls, key=lambda x: (x["args"][0].shape[0], int(x["out"][2])))
    err, plain_ms = resolve_plain("quincy10k-multiblock widest-rung solve", widest, False)
    phase_timing([widest], reps=5)
    say(f"  (plain_ms of the multiblock solve above: {plain_ms:.3f})")
    return launches, err


def bindings_sha256(sched) -> str:
    """sha256 of the sorted (task id, resource id) bindings, as
    tests/torch_event_mega_reference.py computes it."""
    rows = sorted((int(t), str(r)) for t, r in sched.get_task_bindings().items())
    return hashlib.sha256(json.dumps(rows).encode()).hexdigest()


def mcmf_case(seed, dev, lanes=None, tasks=40, machines=4, slots=3, arc_slots=None):
    """A seeded scheduling graph (drivers.random_flow_problem) as
    mcmf_loop's arguments on `dev`: (args, R, L, cold eps, has a pad
    segment)."""
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
    a = on(dev, *arrays)
    t = on(dev, *tables)
    eps_cold = max(1, int(np.abs(p.cost).max()) * n)
    return (a, t), plan.R, plan.L, eps_cold, plan.R * plan.L > 2 * len(p.src)


def phase_parity_mcmf(dev):
    """The mcmf kernel against its plain version on seeded graphs, one
    block to the full grid (the layouts of the cross-block cases are
    checked on the CPU in tests/test_torch_mcmf_grid.py)."""
    from ksched_tpu_torch.ops.build import load
    from ksched_tpu_torch.ops.mcmf import (
        _SIGNATURES,
        mcmf_loop,
        mcmf_loop_plain,
        mcmf_scratch_words,
    )

    lib = load("mcmf", _SIGNATURES)
    for E, blocks in ((512, 1), (15_872, 16), (131_072, 128), (153_600, 75)):
        check(lib.ksched_mcmf_scratch_words(E, blocks) == mcmf_scratch_words(E, blocks),
              f"scratch words at E={E}, {blocks} blocks: the wrapper and kernel differ")
    worst, pads, grids = 0, 0, set()
    # (seed, lanes, tasks, machines, slots, arc_slots, budget)
    cases = [(0, None, 40, 4, 3, None, 50_000), (1, 8, 40, 4, 3, None, 50_000),
             (2, None, 200, 15, 4, None, 50_000), (3, 8, 200, 15, 4, None, 50_000),
             (4, None, 15_000, 1000, 8, 65_536, 300),
             # a segment over four blocks, heads on blocks' first entries, R = 31
             (0, None, 3000, 100, 4, None, 2000),
             # twelve full blocks (R = 24)
             (8, None, 2500, 60, 3, None, 2000),
             # five blocks, the cold solve converges
             (2, None, 800, 30, 4, None, 3000),
             # R = 300: two 32-entry steps per warp
             (5, None, 15_000, 1000, 8, 76_800, 300)]
    wraps = 0
    for seed, lanes, tasks, machines, slots, arc_slots, budget in cases:
        (a, t), R, L, eps_cold, pad = mcmf_case(seed, dev, lanes, tasks, machines,
                                                slots, arc_slots)
        pads += pad
        for eps in (1, eps_cold):
            args = (*a, eps, *t, R, L)
            # the ring off, then on: the same flow and the same barriers
            off = mcmf_loop(*args, max_supersteps=budget)
            barriers_off = int(mcmf_loop.last_barriers)
            k = mcmf_loop(*args, max_supersteps=budget, telemetry_cap=PARITY_RING)
            blocks = mcmf_loop.last_blocks
            p = mcmf_loop_plain(*args, max_supersteps=budget, telemetry_cap=PARITY_RING)
            torch.cuda.synchronize()
            err = max_abs_diff(k, p)
            worst = max(worst, err)
            ok = same_bits(k, p)
            grids.add(blocks)
            rows = k[4].shape[0]
            wraps += int(k[1]) > rows
            say(f"mcmf parity R={R} L={L} blocks={blocks} pad={pad} eps={eps} "
                f"budget={budget}: steps={int(k[1])} converged={bool(k[2])} "
                f"barriers={int(mcmf_loop.last_barriers)} (ring off {barriers_off}) "
                f"ring_rows={rows} max_abs_err={err} "
                f"{'bit-identical' if ok else 'MISMATCH'}")
            check(ok, f"mcmf kernel != plain at R={R} L={L} eps={eps}")
            check(same_bits(k[:4], off), f"R={R} L={L} eps={eps}: the ring moved the flow")
            check(int(mcmf_loop.last_barriers) == barriers_off,
                  f"R={R} L={L} eps={eps}: the ring changed the barrier count")
            check(bool(k[2]) or budget < 50_000, f"R={R} L={L} eps={eps}: no convergence")
            check(blocks > 1 or R * L <= 1024, f"R={R} L={L} ran on one block")
    check(pads > 0, "no parity case had a pad segment")
    check(wraps > 0, "no parity case wrapped its ring")
    check(1 in grids and max(grids) >= 128, f"parity grids {sorted(grids)}")
    return worst


def mega_round_line(tag, r, placed, backend, sched, rec, seen, wall):
    tm = sched.last_timing
    say(f"{tag} round {r}: placed={placed} path={getattr(backend, 'last_path', 'mega')} "
        f"supersteps={backend.last_supersteps} "
        f"objective={sched.solver.last_result.objective} "
        f"wave_s={wall:.4f} round_s={tm.total_s:.4f} solve_s={tm.solve_s:.4f} "
        f"kernel_ms={rec.kernel_ms(first=seen):.4f} "
        f"stats_s={tm.stats_s:.4f} graph_update_s={tm.graph_update_s:.4f} "
        f"deltas_s={tm.deltas_s:.4f} apply_s={tm.apply_s:.4f} "
        f"launches={len(rec.calls) - seen}")


def check_mega_round(name, r, placed, backend, sched):
    from ksched_tpu_torch.drivers.churn import telemetry_sha256

    ref = REF_MEGA[name]
    path = getattr(backend, "last_path", "mega")
    got = {"placed": placed, "path": path,
           "supersteps": backend.last_supersteps,
           "objective": sched.solver.last_result.objective,
           "bindings_sha256": bindings_sha256(sched),
           # the soltel ring of a mega round's solve (kernel B3's)
           "telemetry_sha256": telemetry_sha256(backend.last_telemetry)
           if path == "mega" else None}
    for k, v in got.items():
        check(v == ref[k][r], f"{name}(1000,10000) round {r}: {k}={v}, the JAX "
              f"package gives {ref[k][r]}")
    check(sched.gm.sink_node.excess == -len(sched.gm.task_to_node),
          f"{name} round {r}: supply invariant broken")


def trace_device_ms(path, kernel="mcmf_kernel"):
    """From a torch.profiler Chrome trace: (the device ms of the kernels
    named `kernel`, the device's busy ms (the union of its kernel,
    memcpy and memset intervals), the capture's window ms (its first
    event's start to its last event's end)), or None without device
    events."""
    with open(path) as f:
        evs = [e for e in json.load(f).get("traceEvents", [])
               if e.get("ph") == "X" and "dur" in e]
    gpu = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e.get("name", ""))
                 for e in evs if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    if not gpu:
        return None
    busy, end = 0.0, -1e300
    for t0, t1, _name in gpu:
        busy += max(0.0, t1 - max(t0, end))
        end = max(end, t1)
    window = (max(float(e["ts"]) + float(e["dur"]) for e in evs)
              - min(float(e["ts"]) for e in evs))
    k_us = sum(t1 - t0 for t0, t1, name in gpu if kernel in name)
    return k_us / 1e3, busy / 1e3, window / 1e3


def phase_mega_main(dev):
    """W(1000, 10000) through make_backend("mega") on cuda, rounds 0-2,
    soltel on (its default): each round's ring equal to the JAX
    package's, every captured solve re-solved by the plain version (its
    ring too), round 2's solve captured by the device profiler's
    torch.profiler hook; round 0's and round 2's solves are timed."""
    import ksched_tpu_torch.ops as ops
    from ksched_tpu_torch.drivers import whare_mixed_rounds
    from ksched_tpu_torch.ops.mcmf import mcmf_loop, mcmf_loop_plain
    from ksched_tpu_torch.obs import Registry, SpanTracer, devprof, soltel
    from ksched_tpu_torch.ops.transport import transport_loop, transport_loop_tiered
    from ksched_tpu_torch.solver.csr_solver import CsrSolver
    from ksched_tpu_torch.solver.mega_solver import MegaSolver
    from ksched_tpu_torch.solver.select import make_backend

    backend = make_backend("mega", device=dev)
    check(isinstance(backend, MegaSolver) and isinstance(backend.fallback, CsrSolver)
          and backend.device.type == "cuda", "make_backend('mega') on cuda")
    check(soltel.resolve_cap(backend.telemetry) == soltel.SOLTEL_DEFAULT_CAP,
          "soltel is not on by default")
    # a torch.profiler capture of the third solve: round 2's
    prof = devprof.DeviceProfiler(registry=Registry(), capture_solve=3)
    devprof.set_profiler(prof)
    walls = []
    mcmf_loop.launches = transport_loop.launches = transport_loop_tiered.launches = 0
    with Recorder(ops, "mcmf_solve") as rec, SpanTracer() as tracer:
        seen = 0
        mark = tracer.mark()
        t0 = time.perf_counter()
        for r, sched, placed in whare_mixed_rounds(1000, 10000, backend):
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            walls.append(wall)
            mega_round_line("W-mega(1000,10000)", r, placed, backend, sched, rec,
                            seen, wall)
            say_spans(tracer, mark)
            tel = backend.last_telemetry
            say(f"  soltel: steps={tel.steps} rows={len(tel.rows)} cap={tel.cap} "
                f"truncated={tel.truncated} start_step={tel.start_step} "
                f"last_row={tel.tail(1)[0]}")
            check_mega_round("W", r, placed, backend, sched)
            check(len(rec.calls) > seen, f"W-mega round {r} did not launch the kernel")
            seen = len(rec.calls)
            if r == 2:
                break
            mark = tracer.mark()
            t0 = time.perf_counter()
    devprof.set_profiler(None)
    launches = mcmf_loop.launches
    say(f"W-mega: {len(rec.calls)} mcmf solves, {launches} kernel launches; "
        f"transport launches {transport_loop.launches + transport_loop_tiered.launches}")
    check(launches == len(rec.calls) and launches >= 3,
          f"mcmf launches {launches} != solves {len(rec.calls)}")
    check(backend.fallback.last_supersteps == 0, "MegaSolver delegated to the CSR fallback")
    got = prof.last_capture_path and trace_device_ms(prof.last_capture_path)
    if not got:
        say(f"W-mega round 2 devprof capture ({prof.last_capture_path}): no device "
            f"events in the trace; device time and busy share not measured")
    else:
        # the round's wall less the profiler's own start, stop and export
        k_ms, busy_ms, window_ms = got
        round_ms = 1e3 * (walls[2] - prof.last_capture_cost_s)
        say(f"W-mega round 2 devprof capture ({prof.last_capture_path}): "
            f"mcmf_kernel device_ms={k_ms:.4f} device_busy_ms={busy_ms:.4f} "
            f"capture_window_ms={window_ms:.4f} busy_share_of_window="
            f"{busy_ms / window_ms:.4f} capture_cost_ms="
            f"{1e3 * prof.last_capture_cost_s:.1f} round_ms_less_capture={round_ms:.4f} "
            f"busy_share_of_round={busy_ms / round_ms:.4f}")
    # every solve re-solved by the plain version on the card (its ring
    # too); round 0's and round 2's are the ones timed
    picked = [0, len(rec.calls) - 1]
    worst, plain_ms = 0, {}
    for i in range(len(rec.calls)):
        c = rec.calls[i]
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        plain = mcmf_loop_plain(*c["args"], **c["kw"])
        end.record()
        torch.cuda.synchronize()
        plain_ms[i] = start.elapsed_time(end)
        err = max_abs_diff(c["out"], plain)
        worst = max(worst, err)
        say(f"W-mega solve {i}: R={c['args'][13]} eps={c['args'][4]} "
            f"steps={int(c['out'][1])} ring_rows={c['out'][4].shape[0]} "
            f"max_abs_err={err} vs plain "
            f"(plain_ms={plain_ms[i]:.1f}, sweeps={mcmf_loop_plain.sweeps})")
        c["sweeps"] = mcmf_loop_plain.sweeps
        check(len(c["out"]) == 5, f"W-mega solve {i}: the kernel made no ring")
        check(same_bits(c["out"], plain), f"W-mega solve {i}: kernel != plain")
    check(int(rec.calls[picked[-1]]["out"][1]) == REF_MEGA["W"]["supersteps"][2],
          "the re-solved last solve is not round 2's")
    return launches, worst, rec.calls, picked, plain_ms


def phase_ladder(dev):
    """P(1000, 10000) through make_backend("auto") on cuda: dense, mega,
    then the stall."""
    import ksched_tpu_torch.ops as ops
    from ksched_tpu_torch.drivers import trivial_preempt_rounds
    from ksched_tpu_torch.obs import SpanTracer
    from ksched_tpu_torch.ops.mcmf import mcmf_loop
    from ksched_tpu_torch.solver.base import SolverStallError
    from ksched_tpu_torch.solver.graph_collapse import AutoSolver
    from ksched_tpu_torch.solver.mega_solver import MegaSolver
    from ksched_tpu_torch.solver.select import make_backend

    backend = make_backend("auto", device=dev)
    check(isinstance(backend, AutoSolver) and isinstance(backend.mega, MegaSolver)
          and backend.mega.device.type == "cuda", "make_backend('auto') on cuda")
    ref = REF_MEGA["P"]
    mcmf_loop.launches = 0
    with Recorder(ops, "mcmf_solve") as rec, SpanTracer() as tracer:
        run = trivial_preempt_rounds(1000, 10000, backend)
        seen = 0
        mark = tracer.mark()
        t0 = time.perf_counter()
        stalled = None
        for r in range(3):
            try:
                _r, sched, placed = next(run)
            except SolverStallError as e:
                torch.cuda.synchronize()
                stalled = (r, time.perf_counter() - t0, str(e))
                reason = e.reason
                break
            torch.cuda.synchronize()
            mega_round_line("P(1000,10000)", r, placed, backend, sched, rec, seen,
                            time.perf_counter() - t0)
            say_spans(tracer, mark)
            check_mega_round("P", r, placed, backend, sched)
            seen = len(rec.calls)
            mark = tracer.mark()
            t0 = time.perf_counter()
    check(stalled is not None and stalled[0] == ref["stall"]["round"],
          f"P did not stall on round {ref['stall']['round']}")
    r, wall, msg = stalled
    stall_calls = rec.calls[seen:]
    steps = [int(c["out"][1]) for c in stall_calls]
    ms = [c["events"][0].elapsed_time(c["events"][1]) for c in stall_calls]
    say(f"P(1000,10000) round {r}: stalled after {wall:.3f} s ({msg}); path="
        f"{backend.last_path} last_supersteps={backend.mega.last_supersteps} "
        f"blocks={mcmf_loop.last_blocks} "
        f"attempts={steps} kernel_ms={[round(x, 3) for x in ms]} "
        f"kernel_us_per_step={1e3 * sum(ms) / max(sum(steps), 1):.3f}")
    check(backend.last_path == ref["stall"]["path"]
          and backend.mega.last_supersteps == ref["stall"]["last_supersteps"],
          f"P round {r}: stall differs from the JAX package's")
    check(steps == [4096, ref["stall"]["last_supersteps"]],
          f"P round {r}: attempts {steps}, want [4096, 50000]")
    say(f"P round {r} stall reason: {json.dumps(reason, sort_keys=True)}")
    check(reason == ref["stall"]["reason"],
          f"P round {r}: the stall reason differs from the JAX package's")
    launches = mcmf_loop.launches
    check(launches == len(rec.calls) >= 3, f"P: mcmf launches {launches}")
    say(f"P: {launches} mcmf kernel launches")
    return launches


def pctl(xs, q):
    """The q-th percentile of xs (numpy's linear interpolation)."""
    return float(np.percentile(np.asarray(xs, np.float64), q))


#: the churn phase's spans; "solve" is RoundTiming.solve_s, which also
#: holds the backend's dispatch (the CSR attempt runs there)
#: measured rounds of the churn phase's ring on/off pair (of 24)
RING_AB_ROUNDS = 12
CHURN_SPANS = ("graph_export", "delta_pack", "delta_upload", "plan_upload",
               "backend_solve", "decode", "solve")


def phase_churn(dev):
    """bench.py's churn config at 10k x 1k on cuda: the three export arms
    (drivers/churn.py), 6 warm-up + 24 measured rounds each, round-robin
    (`drive_arms`: the arms' placements equal every round, the resident
    mirror and plan parity checks every round); each arm's supersteps,
    warm scope and placements' sha256 equal to the JAX package's
    (REF_CHURN), the resident arm's plan sync kind and bytes too. No
    hand-written kernel runs on this path (the scan-CSR solve is plain
    PyTorch on the card, as the JAX package runs it as XLA)."""
    from ksched_tpu_torch.drivers.churn import ARMS, CHURN, ChurnArm, drive_arms
    from ksched_tpu_torch.obs import SpanTracer
    from ksched_tpu_torch.ops.mcmf import mcmf_loop
    from ksched_tpu_torch.solver.csr_solver import CsrSolver
    from ksched_tpu_torch.ops.transport import transport_loop, transport_loop_tiered

    ref = REF_CHURN
    warmup = CHURN["warmup"]
    mcmf_loop.launches = transport_loop.launches = transport_loop_tiered.launches = 0
    t0 = time.perf_counter()
    arms = [ChurnArm(label, device=dev) for label in ARMS]
    for a in arms:
        check(a.solver.device.type == "cuda", f"churn {a.label}: solver on {a.solver.device}")
        check(a.fill_supersteps == ref["fill_supersteps"],
              f"churn {a.label} fill: supersteps {a.fill_supersteps}")
        say(f"churn {a.label} fill: supersteps={a.fill_supersteps} fill_s={a.fill_s:.3f}")
    res = arms[-1].sched.solver.resident
    check(res is not None and res.device.type == "cuda" and res.d_cap.is_cuda,
          "churn: the resident arm's mirror is not on the card")
    spans = {a.label: [] for a in arms}
    with SpanTracer() as tracer:
        mark = [tracer.mark()]

        def on_round(a, rec):
            r = rec["round"]
            per = {}
            for ev in tracer.events_since(mark[0]):
                per[ev["name"]] = per.get(ev["name"], 0.0) + ev["dur"] / 1e3
            # the round's solve phase (export, the backend's dispatch,
            # which runs the CSR attempt, completion and decode)
            per["solve"] = a.sched.last_timing.solve_s * 1e3
            spans[a.label].append(per)
            got = {k: rec[k] for k in ("supersteps", "warm_scope", "sha256",
                                       "telemetry_sha256")}
            if a.label == "device_resident":
                got.update(plan_kind=rec["plan_kind"], upload_bytes=rec["upload_bytes"])
            for k, v in got.items():
                check(v == ref[k][r], f"churn {a.label} round {r}: {k}={v}, the "
                      f"JAX package gives {ref[k][r]}")
            say(f"churn {a.label} round {r}: wall_ms={rec['wall_ms']:.3f} "
                f"supersteps={rec['supersteps']} scope={rec['warm_scope']} "
                f"host_reads={rec['host_reads']} plan={rec['plan_kind']} "
                f"upload_bytes={rec['upload_bytes']} "
                f"solver_upload_bytes={rec['solver_upload_bytes']} " + " ".join(
                    f"{k}_ms={per.get(k, 0.0):.3f}" for k in CHURN_SPANS))
            mark[0] = tracer.mark()

        recs = drive_arms(arms, on_round=on_round)
    plan = arms[-1].sched.solver.state.plan
    counters = [plan.layout_rebuilds, plan.region_overflows, plan.region_relocations]
    check(counters == ref["plan_counters"], f"churn plan counters {counters}")
    for a in arms:
        got = a.counters()
        say(f"churn {a.label} counters: h2d_bytes={got['h2d_bytes']} "
            f"warm_price_wars={got['price_wars']}")
        check(got["price_wars"] == ref["price_wars"],
              f"churn {a.label}: {got['price_wars']} warm price wars, the JAX "
              f"package's {ref['price_wars']}")
    got = arms[-1].counters()["h2d_bytes"]
    check(got == ref["h2d_bytes"], f"churn device_resident h2d bytes {got}, the JAX "
          f"package's {ref['h2d_bytes']}")
    for a in arms:
        m = recs[a.label][warmup:]
        wall = [x["wall_ms"] for x in m]
        sp = spans[a.label][warmup:]
        # bytes copied to the card: the mirror's records (resident arm)
        # plus what the solver uploaded itself (host arms)
        up = sum((x["upload_bytes"] or 0) + x["solver_upload_bytes"] for x in m) / len(m)
        say(f"churn {a.label}: {len(m)} measured rounds wall_ms p50={pctl(wall, 50):.3f} "
            f"p99={pctl(wall, 99):.3f} mean={sum(wall) / len(wall):.3f} "
            f"host_reads_p50={pctl([x['host_reads'] for x in m], 50):.0f} "
            f"bytes_per_round={up:.0f} " + " ".join(
                f"{k}_p50_ms={pctl([s.get(k, 0.0) for s in sp], 50):.3f}"
                for k in CHURN_SPANS))
    # the resident arm twice more, round-robin in turns (on, off, off,
    # on, ...): the solver's ring on (the default) and off, for the
    # ring's cost on the round's wall; over the warm-up and the first
    # RING_AB_ROUNDS measured rounds (the smoke's time budget)
    pair = [ChurnArm("device_resident", device=dev,
                     backend=CsrSolver(restart_budget=CHURN["restart_budget"],
                                       telemetry=cap, device=dev))
            for cap in (None, 0)]
    walls = ([], [])
    for r in range(warmup + RING_AB_ROUNDS):
        order = (0, 1) if r % 2 == 0 else (1, 0)
        recs = {i: pair[i].drive_round(r) for i in order}
        check(recs[0]["sha256"] == recs[1]["sha256"] == ref["sha256"][r],
              f"churn ring on/off round {r}: placements differ")
        if r >= warmup:
            for i, w in enumerate(walls):
                w.append(recs[i]["wall_ms"])
    check(pair[1].solver.last_telemetry is None
          and pair[0].solver.last_telemetry is not None, "churn: ring on/off arms")
    say(f"churn device_resident soltel on/off (round-robin, {RING_AB_ROUNDS} "
        f"measured rounds): wall_ms p50 "
        f"{pctl(walls[0], 50):.3f} / {pctl(walls[1], 50):.3f} p99 "
        f"{pctl(walls[0], 99):.3f} / {pctl(walls[1], 99):.3f}")
    launches = mcmf_loop.launches + transport_loop.launches + transport_loop_tiered.launches
    check(launches == 0, f"churn: {launches} kernel launches on a path with none")
    say(f"churn: 3 arms x {warmup + CHURN['rounds']} rounds equal to the JAX package's, "
        f"plan counters {counters}, {time.perf_counter() - t0:.1f} s")


def phase_mega_resident(dev):
    """W(1000, 10000) through make_backend("mega") on the device-resident
    export, rounds 0-2: each round's values equal REF_MEGA["W"] (the JAX
    package's resident and host mega rounds are the same values), every
    B3 launch reading the mirror's own cap, scaled-cost and supply
    tensors, and round 2's solve re-solved by the plain version with the
    same bits and timed (`phase_timing_mcmf`). Returns B3's launches on
    this path, the worst error and that solve's timing."""
    import ksched_tpu_torch.ops as ops
    from ksched_tpu_torch.drivers import whare_mixed_rounds
    from ksched_tpu_torch.obs import SpanTracer
    from ksched_tpu_torch.ops.mcmf import mcmf_loop, mcmf_loop_plain
    from ksched_tpu_torch.solver.select import make_backend

    backend = make_backend("mega", device=dev)
    mcmf_loop.launches = 0
    cap_ptr = None
    with Recorder(ops, "mcmf_solve") as rec, SpanTracer() as tracer:
        seen = 0
        mark = tracer.mark()
        t0 = time.perf_counter()
        for r, sched, placed in whare_mixed_rounds(1000, 10000, backend,
                                                   device_resident=True):
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            res = sched.solver.resident
            mega_round_line("W-mega-resident(1000,10000)", r, placed, backend, sched,
                            rec, seen, wall)
            say_spans(tracer, mark)
            say(f"  resident: upload={res.last_upload_kind} "
                f"upload_bytes={res.last_upload_bytes} arc_records={res.last_arc_records} "
                f"node_records={res.last_node_records}")
            check_mega_round("W", r, placed, backend, sched)
            check(len(rec.calls) > seen, f"W-mega-resident round {r} launched no kernel")
            check(res._scaled is not None and res._scaled[0] == res.version,
                  f"W-mega-resident round {r}: no scaled cost of this refresh")
            want = (res.d_cap.data_ptr(), res._scaled[1].data_ptr(),
                    res.d_excess.data_ptr())
            check(mcmf_loop.last_inputs == want,
                  f"W-mega-resident round {r}: B3 did not read the mirror's tensors")
            cap_ptr = cap_ptr or want[0]
            check(want[0] == cap_ptr, f"W-mega-resident round {r}: cap re-uploaded")
            res.parity_check()
            seen = len(rec.calls)
            if r == 2:
                break
            mark = tracer.mark()
            t0 = time.perf_counter()
    launches = mcmf_loop.launches
    check(launches == len(rec.calls) >= 3, f"W-mega-resident: {launches} launches")
    check(backend.fallback.last_supersteps == 0, "MegaSolver delegated to the CSR fallback")
    check(backend._prev_dev is not None, "the warm flow did not stay on the card")
    c = rec.calls[-1]
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    plain = mcmf_loop_plain(*c["args"], **c["kw"])
    end.record()
    torch.cuda.synchronize()
    err = max_abs_diff(c["out"], plain)
    say(f"W-mega-resident round 2 solve: steps={int(c['out'][1])} "
        f"kernel_ms={c['events'][0].elapsed_time(c['events'][1]):.4f} "
        f"plain_ms={start.elapsed_time(end):.1f} max_abs_err={err}")
    check(int(c["out"][1]) == REF_MEGA["W"]["supersteps"][2],
          "the re-solved resident solve is not round 2's")
    check(same_bits(c["out"], plain), "W-mega-resident round 2: kernel != plain")
    c["sweeps"] = mcmf_loop_plain.sweeps
    timing = phase_timing_mcmf([c], [0], [start.elapsed_time(end)],
                               tag="W-mega-resident round 2 mcmf", barrier=False)
    say(f"W-mega-resident: {launches} mcmf kernel launches")
    return launches, err, timing


def phase_ell(dev):
    """make_backend("ell") on the churn config's device-resident export:
    the fill and 3 rounds, supersteps and placements equal to the JAX
    package's EllSolver's (REF_CHURN["ell"]). No hand-written kernel:
    the JAX package runs this solve as XLA."""
    from ksched_tpu_torch.drivers.churn import ChurnArm
    from ksched_tpu_torch.solver.ell_solver import EllSolver
    from ksched_tpu_torch.solver.select import make_backend

    ref = REF_CHURN["ell"]
    backend = make_backend("ell", device=dev)
    check(isinstance(backend, EllSolver) and backend.device.type == "cuda",
          "make_backend('ell') on cuda")
    arm = ChurnArm("device_resident", backend=backend)
    check(arm.fill_supersteps == ref["fill_supersteps"],
          f"ell fill: supersteps {arm.fill_supersteps}")
    say(f"ell fill: supersteps={arm.fill_supersteps} fill_s={arm.fill_s:.3f}")
    for r in range(len(ref["supersteps"])):
        rec = arm.drive_round(r)
        say(f"ell round {r}: wall_ms={rec['wall_ms']:.3f} supersteps={rec['supersteps']} "
            f"upload_bytes={rec['upload_bytes']}")
        check((rec["supersteps"], rec["sha256"]) == (ref["supersteps"][r], ref["sha256"][r]),
              f"ell round {r}: differs from the JAX package's EllSolver")
    check(backend._prev_dev is not None, "ell: the warm flow did not stay on the card")
    arm.sched.solver.resident.parity_check()


# ---------------------------------------------------------------------------
# the scheduler service (cli.py's loop), its runtime, soaks, HTTP, native
# ---------------------------------------------------------------------------


def service_row(r, name):
    """A driver round record as REF_SERVICE holds it."""
    row = [r["bound"], r["placed"], r["path"], r["solver_work"], r["sha256"]]
    if "resident" in name:
        row += [r["flips"], r["divergences"]]
    return row


def say_service(name, mode, got, wall):
    for r, rec in enumerate(got["rounds"]):
        ph = rec["phases_ms"]
        say(f"{name} {mode} round {r}: bound={rec['bound']} placed={rec['placed']} "
            f"path={rec['path']} solver_work={rec['solver_work']} "
            f"flips={rec['flips']} divergences={rec['divergences']} "
            f"sha256={rec['sha256'][:16]} round_ms: "
            + " ".join(f"{k}={ph[k]:.3f}" for k in
                       ("stats", "graph_update", "solve", "deltas", "apply", "total")))
    say(f"{name} {mode}: {len(got['rounds'])} rounds in {wall:.3f} s")


def run_service_checked(dev, name, **over):
    """One ServiceConfig run on the card, its rounds held against the
    JAX package's. Returns (driver output, wall s)."""
    from ksched_tpu_torch.drivers.service import ServiceConfig, package, run_service

    cfg = ServiceConfig(**{**SERVICE_CONFIGS[name], **over})
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = run_service(package(dev), cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    mode = "pipelined" if cfg.pipeline else "sync"
    say_service(name, mode, got, wall)
    rows = [service_row(r, name) for r in got["rounds"]]
    for r, (a, b) in enumerate(zip(rows, REF_SERVICE[name])):
        check(a == b, f"{name} {mode} round {r}: {a} != the JAX package's {b}")
    check(len(rows) == len(REF_SERVICE[name]), f"{name}: {len(rows)} rounds")
    return got, wall


def phase_service(dev):
    """SchedulerService at BASELINE's width through make_backend("auto")
    on the card: the trivial model (the dense rung's closed form) and
    Whare-Map with four task classes (the transport kernel), each sync
    and pipelined with equal placements, every round held against the
    JAX package's; the transport solves of the Whare-Map sync run
    re-solved by the plain version and timed beside their bound; then
    cli.main's one-shot. Returns (launches, max_abs_err, kernel ms,
    plain ms, bound ms, bound_by)."""
    import contextlib
    import io

    import ksched_tpu_torch.ops as ops
    from ksched_tpu_torch.cli import main as cli_main
    from ksched_tpu_torch.ops.transport import transport_loop

    launches = 0
    captured = []
    for name in ("service", "service-whare"):
        sync_rows = None
        for pipeline in (False, True):
            transport_loop.launches = 0
            with Recorder(ops) as rec:
                got, _wall = run_service_checked(dev, name, pipeline=pipeline)
            rows = [service_row(r, name) for r in got["rounds"]]
            if sync_rows is None:
                sync_rows = rows
                if name == "service-whare":
                    captured = rec.calls
            check(rows == sync_rows, f"{name}: pipelined placements != sync")
            n = transport_loop.launches
            iterative = sum(1 for r in rows if r[3] > 0)
            say(f"{name} {'pipelined' if pipeline else 'sync'}: transport launches {n} "
                f"(solves {len(rec.calls)}, rounds with supersteps {iterative}) "
                f"kernel_ms={rec.kernel_ms():.4f}")
            check(n == len(rec.calls) and n >= iterative,
                  f"{name}: launches {n} != solves {len(rec.calls)}")
            if name == "service-whare":
                launches += n
                check(n > 0, "service-whare ran no transport kernel")
            else:
                check(n == 0, "the trivial model's service left its closed form")
    worst = 0
    k_ms = p_ms = b_ms = 0.0
    by = {"bytes": 0.0, "operations": 0.0}
    for i, c in enumerate(captured):
        err, plain_ms = resolve_plain(f"service-whare solve {i}", c, False)
        worst = max(worst, err)
        wS, supply, col_cap, eps, *rest = c["args"]
        pm0 = rest[0] if rest else None
        kms = timed_ms(lambda: transport_loop(wS, supply, col_cap, eps, pm0, **c["kw"]), 3)
        b_bytes, b_ops = transport_bound(c)
        steps = int(c["out"][2])
        say(f"service-whare solve {i} [{wS.shape[0]},{wS.shape[1]}] steps={steps}: "
            f"in-round kernel_ms={c['events'][0].elapsed_time(c['events'][1]):.4f} "
            f"kernel_ms={kms:.4f} plain_ms={plain_ms:.3f} "
            f"bound_ms={max(b_bytes, b_ops):.6f} "
            f"kernel_us_per_step={1e3 * kms / max(steps, 1):.3f}")
        k_ms += kms
        p_ms += plain_ms
        b_ms += max(b_bytes, b_ops)
        by["bytes"] += b_bytes
        by["operations"] += b_ops
    # cli.main builds its backend itself: keep a handle on it to read the
    # AutoSolver's path, and read the ladder's rung from the round trace
    import os
    import tempfile

    import ksched_tpu_torch.cli as cli_mod
    from ksched_tpu_torch.solver.graph_collapse import AutoSolver

    made = []
    make = cli_mod.make_backend
    cli_mod.make_backend = lambda *a, **k: made.append(make(*a, **k)) or made[-1]
    transport_loop.launches = 0
    err = io.StringIO()
    try:
        with tempfile.TemporaryDirectory() as td, contextlib.redirect_stderr(err):
            trace = os.path.join(td, "rounds.jsonl")
            t0 = time.perf_counter()
            rc = cli_main(["--fake-machines", "-nm", "1000", "--pus-per-core", "4",
                           "-mt", "4", "--podgen", "10000", "--one-shot",
                           "--backend", "auto", "--round-trace", trace])
            wall = time.perf_counter() - t0
            with open(trace) as f:
                records = [json.loads(ln) for ln in f if ln.strip()]
    finally:
        cli_mod.make_backend = make
    lines = [ln for ln in err.getvalue().splitlines() if ln.startswith("scheduled ")]
    path = made[0].last_path if made and isinstance(made[0], AutoSolver) else None
    say(f"cli one-shot: rc={rc} {lines[-1] if lines else '(no result line)'} "
        f"in {wall:.3f} s; path={path} transport launches {transport_loop.launches} "
        f"rounds {[(r['solver_rung'], r['degradations'], r['noop_round']) for r in records]}")
    check(rc == 0 and lines, "cli one-shot printed no result")
    bound, batch = (int(x) for x in lines[-1].split()[1].split("/"))
    check(batch > 0 and bound == batch, f"cli one-shot bound {bound} of {batch}")
    check(len(made) == 1 and isinstance(made[0], AutoSolver),
          f"cli one-shot's backend is {[type(b).__name__ for b in made]}, not AutoSolver")
    # the trivial model's one-shot is the dense rung's closed form, as
    # the service's one-shot (REF_SERVICE["service"][0])
    check(path == REF_SERVICE["service"][0][2],
          f"cli one-shot took the {path!r} path, not the JAX package's "
          f"{REF_SERVICE['service'][0][2]!r}")
    check(transport_loop.launches == 0,
          f"cli one-shot left the closed form: {transport_loop.launches} transport launches")
    check(len(records) == 1 and records[0]["solver_rung"] == 0
          and records[0]["degradations"] == 0 and not records[0]["noop_round"],
          f"cli one-shot stepped down the ladder: {records}")
    return launches, worst, k_ms, p_ms, b_ms, max(by, key=by.get)


def phase_service_resident(dev):
    """The service at the same width on the device-resident mirror with
    the integrity audit every round, backend "jax" (the scan-CSR solve
    on the card): a clean arm, and an arm with seeded device bit flips
    and a checkpoint and warm restore after round 3; every flip detected
    the round it lands, the clean arm without a divergence, both arms'
    placements equal to each other and to the JAX package's."""
    from ksched_tpu_torch.obs import SpanTracer

    shas = {}
    for name in ("service-resident", "service-resident-faults"):
        with SpanTracer() as tracer:
            got, _wall = run_service_checked(dev, name)
        tot = {}
        for ev in tracer.events_since(0):
            if ev["name"] in ("state_audit", "state_repair", "graph_export"):
                tot.setdefault(ev["name"], []).append(ev["dur"] / 1e3)
        say(f"{name}: spans " + " ".join(
            f"{k} n={len(v)} sum_ms={sum(v):.3f} max_ms={max(v):.3f}"
            for k, v in sorted(tot.items())))
        flips = sum(r["flips"] for r in got["rounds"])
        div = sum(r["divergences"] for r in got["rounds"])
        counts = got["service"].scheduler.solver.integrity_counts
        say(f"{name}: flips={flips} divergences={div} restored_warm="
            f"{got['restored_warm']} the last service's integrity counts "
            f"{dict(counts)}")
        check(all(r["flips"] == r["divergences"] for r in got["rounds"]),
              f"{name}: a flip was not detected in its round")
        shas[name] = [r["sha256"] for r in got["rounds"]]
        if name == "service-resident-faults":
            check(flips >= 1 and got["restored_warm"] is True,
                  f"{name}: no flip injected or the restore was not warm")
        else:
            check(div == 0, f"{name}: divergences in the clean arm")
    check(shas["service-resident"] == shas["service-resident-faults"],
          "the faulted arm's placements differ from the clean arm's")
    audit_split(got["service"].scheduler.solver.auditor)


def audit_split(auditor, reps=5):
    """One audit's two halves on the last resident service, each the
    mean of `reps`: the 15 device fingerprints with their copies to the
    host (host clock around a synchronize, as the audit pays them) and
    the 15 host twins recomputed from the host arrays (what a round whose
    arrays and plan version changed recomputes)."""
    from ksched_tpu_torch.runtime import integrity as ig

    r = auditor.resident
    state = tuple(getattr(r, "d_" + n) for n in ig.FP_STATE_ARRAYS)
    host = [getattr(r.state.problem(), n) for n in ig.FP_STATE_ARRAYS]
    host += [getattr(r.state.plan, n) for n in ig.FP_PLAN_ARRAYS]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        dev = np.concatenate([ig.device_fingerprints(state), r.plan_fingerprints()])
    t_dev = (time.perf_counter() - t0) / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        twins = [ig.host_fingerprint(a) for a in host]
    t_host = (time.perf_counter() - t0) / reps
    check(dev.tolist() == twins, "audit split: device fingerprints != host twins")
    say(f"audit split: device fingerprints {1e3 * t_dev:.3f} ms, host twins "
        f"{1e3 * t_host:.3f} ms ({sum(a.size for a in host)} elements)")


def phase_chaos_soak(dev):
    """drivers/soak.py's chaos soak on the card: the determinism arm
    (two runs) and the recovery arm (device bit flips and warm restores
    against a clean control), each run's summary equal to the JAX
    package's."""
    import argparse

    from ksched_tpu_torch.drivers.soak import chaos_main, soak_summary

    base = dict(chaos_backend="jax", loop="sync", device_resident=False,
                corruption=False, wal_chaos=0.0, audit_every=0, verify_recovery=False,
                verify_loop_parity=False, verify_determinism=False, metrics_port=None,
                obs_out=None, flight_dir=None, assert_stall_flight=False,
                solver_outage_prob=None, device=str(dev))
    quiet = lambda *a, **k: None  # noqa: E731
    for name, over in SOAK_ARGS.items():
        t0 = time.perf_counter()
        runs = chaos_main(argparse.Namespace(**{**base, **over}), quiet)
        wall = time.perf_counter() - t0
        for arm, res in runs.items():
            got = soak_summary(res)
            want = REF_SOAK[name]["run" if arm == "again" else arm]
            say(f"chaos soak {name} {arm}: rounds={got['rounds']} placed={got['placed']} "
                f"faults={got['fault_totals']} noop={got['noop_rounds']} "
                f"degradations={got['degradations']} restores={got['restores']} "
                f"(warm {got['warm_restores']}) divergences={got['divergences']} "
                f"repairs={got['repairs']} placements_sha256="
                f"{got['placements_sha256'][:16]}")
            check(got == want, f"chaos soak {name} {arm} differs from the JAX package's")
        lat = [x for res in runs.values() for x in res.get("recovery_latencies_s", [])]
        say(f"chaos soak {name}: {wall:.3f} s"
            + (f"; recovery rounds ms {[round(1e3 * x, 3) for x in lat]}" if lat else ""))


def phase_http(dev):
    """cli.main against the port's FakeAPIServer over loopback HTTP:
    100 nodes, 1,000 pods created through the server; every pod bound."""
    import contextlib
    import io

    from ksched_tpu_torch.cli import main as cli_main
    from ksched_tpu_torch.cluster import FakeAPIServer

    server = FakeAPIServer().start()
    try:
        for i in range(100):
            server.add_node(f"node_{i}", cores=1, pus_per_core=4)
        err = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stderr(err):
            rc = cli_main(["--api-server", server.base_url, "--podgen", "1000",
                           "--one-shot", "--node-batch-timeout", "0.5",
                           "--pod-batch-timeout", "1.0", "--max-tasks-per-pu", "4",
                           "--backend", "auto", "--device", str(dev.type)])
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline and len(server.bindings()) < 1000:
            time.sleep(0.05)
        wall = time.perf_counter() - t0
        bound = len(server.bindings())
        lines = [ln for ln in err.getvalue().splitlines() if ln.startswith("scheduled ")]
        say(f"http: rc={rc} {lines[-1] if lines else '(no result line)'}; "
            f"server bindings {bound}, pending {server.pending_pods()}, {wall:.3f} s")
        check(rc == 0 and bound == 1000, f"http: {bound} of 1000 pods bound")
    finally:
        server.stop()


def phase_native(dev):
    """The C++ native solver, built from this checkout with g++ (forced,
    no fallback), on the service's one-shot at BASELINE's width: its
    placements equal to the JAX package's native solver's."""
    from ksched_tpu_torch.native import load_library

    t0 = time.perf_counter()
    load_library(force_build=True)
    say(f"native: g++ build {time.perf_counter() - t0:.2f} s")
    run_service_checked(dev, "native")


def mcmf_bound_ms(c, steps, sweeps):
    """(bytes bound, operations bound) of one captured mcmf solve."""
    (cap, cost, supply, flow0, eps, e_arc, e_sign, e_src, e_hs, e_he,
     e_prow, e_pcol, fwd_pos, R, L) = c["args"]
    E = R * L
    S = int((e_hs != 0).sum()) + int(e_hs[0] == 0)
    ring = c["out"][4].numel() if len(c["out"]) == 5 else 0  # the soltel ring's words
    nbytes = 4 * (3 * cap.numel() + supply.numel() + 7 * E + 2 * fwd_pos.numel() + 4
                  + ring)
    phases = eps_phases(eps, c["kw"].get("alpha", 8))
    ops_n = sum(k * (e * E + s * S) for (e, s), k in (
        (OPS_MCMF_STEP, steps), (OPS_MCMF_PHASE, phases),
        (OPS_MCMF_SWEEP, sweeps), (OPS_MCMF_ONCE, 1),
        (OPS_MCMF_RING, steps if ring else 0)))
    return bound_ms(nbytes, ops_n)


def phase_timing_mcmf(calls, picked, plain_ms, reps=3, tag="mcmf", barrier=True):
    """The mcmf kernel's time at the re-solved captured solves (CUDA
    events), beside its plain version's and its bound: its grid, the
    grid barriers it ran per superstep, its time per superstep with the
    soltel ring as the main path ran it and with the ring off (the
    barriers must be the same); then (`barrier`) the grid barrier alone
    at that grid."""
    from ksched_tpu_torch.ops.mcmf import barrier_probe_ms, mcmf_loop

    tot_k = tot_p = tot_b = 0.0
    by = {"bytes": 0.0, "operations": 0.0}
    for i in picked:
        c = calls[i]
        steps = int(c["out"][1])
        b_bytes, b_ops = mcmf_bound_ms(c, steps, c["sweeps"])
        kw_off = dict(c["kw"], telemetry_cap=0)
        off_ms = timed_ms(lambda: mcmf_loop(*c["args"], **kw_off), reps)
        barriers_off = int(mcmf_loop.last_barriers)
        k_ms = timed_ms(lambda: mcmf_loop(*c["args"], **c["kw"]), reps)
        blocks, barriers = mcmf_loop.last_blocks, int(mcmf_loop.last_barriers)
        ring = c["kw"].get("telemetry_cap", 0)
        say(f"timing {tag} solve {i} R={c['args'][13]} steps={steps} "
            f"sweeps={c['sweeps']} blocks={blocks} barriers={barriers} "
            f"barriers_per_step={barriers / max(steps, 1):.3f}: kernel_ms={k_ms:.4f} "
            f"plain_ms={plain_ms[i]:.3f} bound_ms={max(b_bytes, b_ops):.6f} "
            f"(bytes {b_bytes:.6f}, operations {b_ops:.6f}) "
            f"kernel_us_per_step={1e3 * k_ms / max(steps, 1):.3f} (ring {ring}); "
            f"ring off: kernel_ms={off_ms:.4f} "
            f"kernel_us_per_step={1e3 * off_ms / max(steps, 1):.3f} "
            f"barriers={barriers_off}; ring overhead {100 * (k_ms / off_ms - 1):.2f}%")
        check(barriers == barriers_off,
              f"{tag} solve {i}: {barriers} grid barriers with the ring, {barriers_off} without")
        tot_k += k_ms
        tot_p += plain_ms[i]
        tot_b += max(b_bytes, b_ops)
        by["bytes"] += b_bytes
        by["operations"] += b_ops
    n = 10_000
    for blocks in sorted({1, mcmf_loop.last_blocks}) if barrier else ():
        barrier_probe_ms(calls[0]["args"][0].device, blocks, n)  # warm-up
        ms = barrier_probe_ms(calls[0]["args"][0].device, blocks, n)
        say(f"timing mcmf grid barrier alone: blocks={blocks} "
            f"us_per_barrier={1e3 * ms / n:.4f} ({n} barriers in {ms:.3f} ms)")
    return tot_k, tot_p, tot_b, by


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 1
    # outside a checkout of the repo this import fails, before any output
    from ksched_tpu_torch.ops import build as build_mod

    t_start = time.perf_counter()
    card = card_line()
    say(f"card: {card}")
    say(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} device {torch.cuda.get_device_name(0)}")
    dev = torch.device("cuda", 0)

    t0 = time.perf_counter()
    libs = build_mod.build()  # one nvcc per source, all started together
    say(f"build: {', '.join(p.name for p in libs.values())} in "
        f"{time.perf_counter() - t0:.2f} s wall ("
        + ", ".join(f"{k} {v:.2f} s" for k, v in build_mod.build.seconds.items())
        + ")")
    check(set(libs) == {"transport", "transport_tiered", "mcmf"},
          f"built {sorted(libs)}")
    for name, log in build_mod.build.log.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                say(f"  ptxas {name}: {line.strip()}")

    last = [time.perf_counter()]

    def lap(what):
        """Print the seconds since the previous lap: each phase's cost."""
        now = time.perf_counter()
        say(f"phase time: {what} {now - last[0]:.1f} s (total {now - t_start:.1f} s)")
        last[0] = now

    parity_err = phase_parity(dev)
    lap("transport parity")
    phase_reference(dev)
    launches, main_err, calls = phase_main(dev)
    k_ms, p_ms, b_ms, bound_by = phase_timing(calls)
    lap("W(20,200), W(1000,10000) and its timing")
    t_err = phase_parity_tiered(dev)
    cluster, tasks, t_launches, b1_bulk, t_calls, picked, plain_ms, t_main_err = (
        phase_device_bulk(dev))
    phase_steady(dev, cluster, tasks)
    tk_ms, tp_ms, tb_ms, t_bound_by = phase_timing_tiered(t_calls, picked, plain_ms)
    say(f"transport launches on the coco50k path: {b1_bulk}")
    lap("tiered parity, device bulk, steady and tiered timing")
    (tier_b1, tier_b2), tier_err = phase_tiers(dev)
    lap("coco50k-preempt")
    (q_b1, _q_b2), q_err = phase_quincy(dev)
    lap("quincy10k")
    say(f"launches on the coco50k-preempt steady path: transport {tier_b1}, "
        f"transport_tiered {tier_b2}; on the quincy10k steady path: transport {q_b1}")
    w_b1 = phase_suite_bulk(dev)
    lap("whare-hetero, ref100")
    g_b1, g_err, (g_k, g_p, g_b, _g_by) = phase_gtrace(dev)
    lap("gtrace cells")
    h_b1 = phase_gtrace_host(dev)
    lap("gtrace12k-host")
    mb_b1, mb_err = phase_multiblock(dev)
    lap("quincy10k-multiblock")
    say(f"transport launches: whare-hetero steady {w_b1}, gtrace12k-coco {g_b1}, "
        f"gtrace12k-host {h_b1}, quincy10k-multiblock {mb_b1}")
    m_err = phase_parity_mcmf(dev)
    lap("mcmf parity")
    m_launches, m_main_err, m_calls, m_picked, m_plain_ms = phase_mega_main(dev)
    lap("W-mega")
    p_launches = phase_ladder(dev)
    lap("P")
    mk_ms, mp_ms, mb_ms, m_by = phase_timing_mcmf(m_calls, m_picked, m_plain_ms)
    lap("mcmf timing")
    mr_launches, mr_err, (mr_k, mr_p, mr_b, mr_by) = phase_mega_resident(dev)
    lap("W-mega-resident")
    say(f"mcmf launches: W-mega {m_launches}, P {p_launches}, "
        f"W-mega-resident {mr_launches}")
    phase_churn(dev)
    lap("churn")
    phase_ell(dev)
    lap("ell")
    s_launches, s_err, s_k, s_p, s_b, _s_by = phase_service(dev)
    lap("service")
    phase_service_resident(dev)
    lap("service-resident")
    phase_chaos_soak(dev)
    lap("chaos soak")
    phase_http(dev)
    lap("http")
    phase_native(dev)
    lap("native")
    say(f"transport launches: service-whare {s_launches}")

    kernels = [{
        "name": "transport",
        "route": "cuda",
        "source": "ksched_tpu_torch/ops/csrc/transport.cu",
        "replaces": "ksched_tpu/ops/transport_pallas.py:59",
        "launches": launches + g_b1 + s_launches,
        "max_abs_err": max(parity_err, main_err, tier_err, q_err, g_err, mb_err, s_err),
        "ms": k_ms + g_k + s_k,
        "plain_ms": p_ms + g_p + s_p,
        "bound_ms": b_ms + g_b + s_b,
        "bound_by": bound_by,
        "library_ms": None,
    }, {
        "name": "transport_tiered",
        "route": "cuda",
        "source": "ksched_tpu_torch/ops/csrc/transport_tiered.cu",
        "replaces": "ksched_tpu/ops/transport_pallas.py:233",
        "launches": t_launches,
        "max_abs_err": max(t_err, t_main_err, tier_err),
        "ms": tk_ms,
        "plain_ms": tp_ms,
        "bound_ms": tb_ms,
        "bound_by": t_bound_by,
        "library_ms": None,
    }, {
        "name": "mcmf",
        "route": "cuda",
        "source": "ksched_tpu_torch/ops/csrc/mcmf.cu",
        "replaces": "ksched_tpu/ops/mcmf_pallas.py:108",
        "launches": m_launches + mr_launches,
        "max_abs_err": max(m_err, m_main_err, mr_err),
        "ms": mk_ms + mr_k,
        "plain_ms": mp_ms + mr_p,
        "bound_ms": mb_ms + mr_b,
        "bound_by": max(m_by, key=lambda k: m_by[k] + mr_by[k]),
        "library_ms": None,
    }]
    say(f"total {time.perf_counter() - t_start:.1f} s")
    say(card_line())
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Failed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
