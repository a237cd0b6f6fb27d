"""Smoke run of ksched_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Phases, each of which must pass (any failure exits non-zero and prints
no result line):

1. the card (nvidia-smi name and power limit), versions, and the build
   of every kernel of the path from the sources in this checkout;
1b. analysis (ksched_tpu_torch/analysis/): the lint and `--coverage`
   over this checkout; each kernel's registers, spill, static shared
   bytes and co-resident blocks against the registry's pins; B3's grid
   gate (the largest size `mega_fits` admits launches) and its measured
   live set against the reckoning; the launching routes' torch calls
   independent of supersteps; the in-place appliers' memory growth; and
   the op-trace contracts and hash pins of mega_solve, layered_solve,
   csr_solve and delta_apply on CUDA tensors, the pins tier-1 reads;
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
   every window), each trace staged on the host and its first 512
   windows replayed in 2 chunks of 256 (seeds 1-2; drivers/gtrace.py
   CHUNKS): per chunk its wall
   and per-window times, supersteps, evictions, launches, host reads and
   decode time, its summed stats, per-window convergence, the sha256
   of all its stats and of the placements after it equal to the JAX
   package's; gtrace12k-coco's longest solve of its first chunk
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
21. policies: the six host cost models beyond Trivial, Quincy and
   Whare-Map (Random, SJF, CoCo with four task classes, Octopus, Void,
   Net) through drivers/service.py at
   BASELINE's width (Random cut to 200 pods on 20 machines: each task
   its own class), the one-shot and a churn round through "auto" on the
   card, every round's values equal to the JAX package's
   (tests/torch_policy_reference.py); the transport and mcmf solves they
   launch counted (Random's two transport solves; the others stay on
   the dense rung's closed form, as in the JAX package) and re-solved
   by the plain versions with the same bits, but for Random's
   (PLAIN_RESOLVE_CUT: ≈90 s plain);
22. tenancy (tenancy/, the stacked scan-CSR lane solve in plain
   PyTorch): bench.py's multitenant at its own arguments (16 cells of 3
   sizes, 4 + 24 rounds, both arms, each cell's placements equal across
   them), 4 tenants of BASELINE's round through MultiTenantService (the
   one-shot and 4 churn rounds; one stacked solve re-run on the CPU with
   the same bits), cli.main --tenants 4 (5,000 pods a cell) and the
   Makefile's tenant-smoke soak (16 cells, 40 rounds, chaos on cell 0,
   each clean cell equal to its solo run), every value equal to the JAX
   package's (tests/torch_tenancy_reference.py), each with its
   `phase time:` line;
23. sharded (parallel/, SPMD over torch.distributed): bench.py's
   gtrace100k driver (drivers/sharded_scale.py) cut to 10k tasks x 1k
   machines, keep mode, 2 warm-up and 6 rounds of 1% churn with a 10x
   burst, on 2 ranks that share the card over gloo (ranks started by
   parallel/launch.py): both arms (the single-card CsrSolver, and
   AutoSolver's sharded rung behind the forced fitting gate with the
   sharded resident mirror), every round's record (path, supersteps,
   converged, placements', flow's and potentials' sha256, plan kind, h2d bytes,
   ring sha256) equal on both ranks, between the arms and to the JAX
   package's (tests/torch_parallel_reference.py), the collectives per
   superstep printed; then one D = 1 sharded solve over NCCL equal to
   the single-card CsrSolver's;
24. sharded-layered: the seeded host BulkCluster (1,000 machines, Mp =
   1,024, 4 class rows, 10,000 tasks) through ShardedLayeredSolver on the
   2 ranks and LayeredTransportSolver on the card (the transport
   kernel), superstep for superstep equal and equal to the JAX
   package's; a tiered instance at [4, 1,024] on the ranks, the tiered
   kernel and its plain version, all equal to the JAX package's;
25. whatif: drain_scenarios (16 candidates) and surge_scenarios (8
   rows) on that cluster through the transport kernel (one launch a
   scenario), equal to the JAX package's; the two longest solves
   re-solved by the plain version with the same bits and timed;
26. the device soak (drivers/soak.py, tools/soak.py's default mode):
   20,000 tasks on 500 machines with CoCo costs, --preempt (incremental
   rounds on the transport kernel, re-solves on the tiered one), 512
   rounds in chunks of 128 with machines toggled out and back, a device
   checkpoint round trip every 2 chunks and the soak continuing on the
   restored cluster; the invariants every chunk, and every chunk's line
   equal to the JAX tool's;
27. tails (ksched_tpu_torch/tools/tail_repro.py): whare (20k x 1k, the
   transport kernel), coco-preempt (20k x 1k, the tiered kernel) and
   quincy (group mode) captured round by round at the tool's sizes, the
   capture line and the npz arrays equal to the JAX tool's; the replays
   (whare over alpha {2, 8} x refine {8, 32}, coco-preempt over its eps0
   starts x refine {0, 8}, quincy over the grouped strategies) with every
   point equal to the JAX tool's, each replayed solve's kernel ms and
   supersteps, and per capture the cheapest replayed solve re-solved by
   the plain version with the same bits and timed beside its bound;
28. profile_round (ksched_tpu_torch/tools/profile_round.py) at 10k x 1k
   x 4 x 4: the launch floor, one synchronize's round trip and the
   sustained steady round, each an obs span; the timed chains' stats
   equal to the JAX package's; the trace rendered by tools/obs_report.py;
29. shard smoke (ksched_tpu_torch/tools/shard_smoke.py) at the Makefile's
   arguments on 2 gloo ranks sharing the card: the scan-CSR, sharded and
   chaos arms equal on both ranks and to the JAX tool's arms;
30. bench (`python -m ksched_tpu_torch.bench`'s path, bench.run_config
   in-process): the headline 10kx1k at bench.py's defaults (512 rounds
   in chunks of 64, the closed form), coco50k (B1) and coco50k-preempt
   (B1 and B2, the two-regime latency fit) at their own budgets (128
   rounds in chunks of 32) and mcmf-mega at 2 solves a backend (B3, CSR,
   ELL), each record's p50, chunk walls and latency model printed and
   its non-timing values equal to bench.py's on the CPU
   (tests/torch_bench_reference.py); coco50k's longest B1 solve and a
   B3 cold solve of mcmf-mega's graph re-solved plain with the same bits;
   then the `kernels` line and the result line. The transport kernel's
   entry there covers nine paths, each counted from 0 just before it
   ran: Scenario W(1000, 10000) (phase 4), gtrace12k-coco (phase 7e),
   the Whare-Map service (phase 16, sync and pipelined), the policies
   (phase 21), sharded-layered's single-card arm (phase 24), the
   what-if batches (phase 25), the device soak (phase 26), the tails'
   captures and replays (phase 27), profile_round (phase 28, none
   there: the closed form) and the bench's coco50k and coco50k-preempt
   (phase 30). Its `launches` is the sum of their
   launches, and its `ms`, `plain_ms` and `bound_ms` sum the solves
   timed on them: W's two, gtrace12k-coco's longest at [4, 12,544], the
   Whare-Map service's sync run's two and the two longest what-if
   solves. The tiered kernel's entry adds the device soak's, the
   tails' and the bench's coco50k-preempt launches to those of phase 7
   (its times stay phase 8's). The mcmf kernel's entry covers
   W-mega (phase 10), W-mega-resident (phase 13), the policies
   (phase 21, none there) and the bench's mcmf-mega (phase 30) the same
   way: `launches` sums them, and `ms`,
   `plain_ms` and `bound_ms` sum W-mega's timed solves and
   W-mega-resident's round 2 solve. The other paths' launches are
   printed before the line.

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
# widths [Amax, Dmax, Emax]; per chunk of 256 windows (seeds 1-2) its
# stats summed, supersteps max and p50, whether every window converged,
# `live` after its last window and the sha256 of all its stats stacked
# as int32 in key order; the `pu` sha256 after each chunk.
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
        ],
        "chunk_pu_sha256": [
            "bb747b62241882e777ca7f755efe1dd62e4bfdf93dfd27392757b56fefa5a9cc",
            "f1a3549f37ed9e062e0902f5ecc21b201b732d895e0f37db72d215e23933bd42",
        ],
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
        ],
        "chunk_pu_sha256": [
            "75b7dd68ec62bc490ad26e3070236373bbe95eedb48cf35cc2d4fe4b71159662",
            "5022f6a9266d6710aa91f044a158c7a2a50620f23e7134d2de907fb0d2a04a0b",
        ],
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
        ],
        "chunk_pu_sha256": [
            "d0f95f9ae0e15d8275d5a2d5a4109b90a656bb1cc95d66d9ee69c526b055faff",
            "5851e97a13d1154ee681948a82d3af62d86726ae8c39849ef0f31e0c42272cad",
        ],
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

# The policies phase's per-round values, as produced by the JAX package
# (ksched_tpu's SchedulerService on the CPU through drivers/service.py,
# POLICY_CONFIGS; tests/torch_policy_reference.py): [bound, placed,
# AutoSolver path, solver work, live placements' sha256].
REF_POLICY = {
    "policy-random": [
        [200, 200, "dense", 35568, "589a5ebf843b56b5e689adfaa3107dfe1b81dc3370f82549772be4607b126102"],
        [100, 298, "dense", 15676, "3d5cc5d62ffa3d08750a6d599a0c87a27bc383bd8b6976ab6557143652173c41"],
    ],
    "policy-sjf": [
        [10000, 10000, "dense", 0, "1706cb559bc12fe1eb69fcb7f3787796733a0ed7f4b2c548b36e4058ec3f3414"],
        [100, 10000, "dense", 0, "0a1f96b5bdeaa98f91d2f0693d08282943c1551ab03c4aca887eb739378851af"],
    ],
    "policy-coco": [
        [10000, 10000, "dense", 0, "5ed4494c9cf201b9d5a48d5c45c7876cd3d2f35b99cb733a3d458ce79fc43d73"],
        [100, 10000, "dense", 0, "67ffc2ba803ad1184db9b46e25b69ce945e412a2049af7bb0dec315358737580"],
    ],
    "policy-octopus": [
        [10000, 10000, "dense", 0, "1706cb559bc12fe1eb69fcb7f3787796733a0ed7f4b2c548b36e4058ec3f3414"],
        [100, 10000, "dense", 0, "0a1f96b5bdeaa98f91d2f0693d08282943c1551ab03c4aca887eb739378851af"],
    ],
    "policy-void": [
        [0, 0, "dense", 0, "4f53cda18c2baa0c0354bb5f9a3ecbe5ed12ab4d8e11ba873c2f11161202b945"],
        [0, 0, "dense", 0, "4f53cda18c2baa0c0354bb5f9a3ecbe5ed12ab4d8e11ba873c2f11161202b945"],
    ],
    "policy-net": [
        [10000, 10000, "dense", 0, "1706cb559bc12fe1eb69fcb7f3787796733a0ed7f4b2c548b36e4058ec3f3414"],
        [100, 10000, "dense", 0, "0a1f96b5bdeaa98f91d2f0693d08282943c1551ab03c4aca887eb739378851af"],
    ],
}

# The tenancy phase's values, as produced by the JAX package (ksched_tpu's
# tenancy on the CPU through the same drivers, ksched_tpu_torch/drivers/
# multitenant.py and drivers/soak.py; tests/torch_tenancy_reference.py):
# multitenant per round [placements' sha256, batched supersteps,
# sequential supersteps, stacked groups]; fleet per round [groups,
# {tenant: [bound, placed, sha256, supersteps, warm scope, rung, noop]}];
# cli.main --tenants 4's report; the tenant soak's tenant_soak_summary.
REF_TENANCY = {
    "multitenant": [
        ["7efa54ce4175d6bd7bd1229deaab4637e837fb7281cbfb77e0f0e9c342268290", 160, 160, 3],
        ["16ece936d124406309d63ca74495eca53138cff936a6beb46716948eb1dc01a0", 160, 160, 3],
        ["df48c807307d3085289b190f1e6d5463a95457ec5156249202a7c15186115f7c", 152, 152, 3],
        ["96f1212d0a32a3ad7a3e36f74c27e2644dde2161002f6ad94f6cb3c358f1e45d", 162, 162, 3],
        ["24778096997308632b862df3120dc7a41895b4ff0dd084eac8276f1fa8eb33a8", 155, 155, 3],
        ["6d35ae54f58b444b25c21fdd38d5680566415722f3df721510a429d95c5eb90a", 158, 158, 3],
        ["424e6787cf461e9a613802b96ab9e5316a87f80bb8b77529a2d1791d5198cddd", 153, 153, 3],
        ["f669915140d824d2433120cadb70af817d4ed7b6168763ace1040a430ce795a9", 157, 157, 3],
        ["6696019da7228cf0ff2552158a6b84f513402ebe5e144ee2ee8a5bdfa7362f7f", 155, 155, 3],
        ["1ce98e019892b5f45b311abfec86a76e6a0ae89c282b6c0211b514058d805d8f", 157, 157, 3],
        ["1e8de72c5c61d31e2f64daea0366577c69ed08482f0ce51abc01805fdc6a7044", 154, 154, 3],
        ["25c95d4cd6db00db5de2fa3658d9e2c5fe71fb1a4d9b758b63fba34cbb154442", 154, 154, 3],
        ["dcc304cb842041df85e3232aa2a9e810a8cee36bce92ad1ee2630078477987b9", 155, 155, 3],
        ["9dbc95aca1abaf59d03a281dd6099494409572b70626495513a54da97bb2b415", 155, 155, 3],
        ["85e79616fd4b58b2dc55b7e10e1337f1ed7cca0ceb944330a29e7fb76e13ce8d", 153, 153, 3],
        ["adb98908218761ccfef0e645c257d916fdaf86cbab927b70b8205521db25c138", 159, 159, 3],
        ["5140ee6cfbc46fc56d8d5de28ed0c8cc251228e167dc82d1b38831b34b60d27f", 156, 156, 3],
        ["966044996fd9c04a5f139ed7d2dfa59e9b8f7b9dd930f09de413a15e0c12d88d", 153, 153, 3],
        ["a8cebf232016681d421a8348046ada81de734b4add591b1d42a0d234d550d473", 153, 153, 3],
        ["0eda23a41a9c5daa9bd9603dfbf6f7c28608ab1fab567625e4399c95cf35ccff", 155, 155, 3],
        ["819aece005a8a5195e05c88081fa81c18de24c6cd685d1a65b77d7548d63200b", 154, 154, 3],
        ["d4a255d4e9255aac29493028a641bbe98d615843df44c6b4461eecf375d95fa8", 157, 157, 3],
        ["a9cc4494a3cea1dfdf830e056fe556b79deb7e9b029cefa97603460f87ef84cd", 153, 153, 3],
        ["7be54a56195811e343c56ed2754b58b25b0e7b8870562eb4e230283593a3002b", 157, 157, 3],
        ["2e2a50b634e4675837ac9d440eec4cd4d72471754a41d5483f8279c3f7447240", 156, 156, 3],
        ["e6b054b159a8f7d1c095e6a67d8e3992b871ab4a870213f597f69c9c0d3d7172", 151, 151, 3],
        ["32b335e16321e316424a03f76a44df1470521ef7aa955247d93de878dcd3633d", 152, 152, 3],
        ["0cadb0cd41a93c8721bd4fd799f18f782f4f75b01596ea5be43e417ac837989d", 152, 152, 3],
    ],
    "fleet": [
        [1, {
            "cell0": [10000, 10000, "5082bc457a4dea44a7ca27f47429e21a2ecceff42d696293d0e2faeec0eb0464", 10, "cold", 0, False],
            "cell1": [10000, 10000, "a2d93b15410245a769980046a718c51345dee5b77f1d5f93521d51e9e391780a", 10, "cold", 0, False],
            "cell2": [10000, 10000, "a6dadfd7dee3914f70c87f40f45886be95d9c9a9ed2a44d50647bc5f60634b6c", 10, "cold", 0, False],
            "cell3": [10000, 10000, "09d83c7082be9b31789ca24523aa44929c5c468cb87c58fd907e82f17516bde9", 10, "cold", 0, False],
        }],
        [1, {
            "cell0": [100, 10000, "7140fdb621ec0d7c8c4d8b8ae4cf42a060394d575c48ffbf5a50823e01b9a1bc", 10, "fresh", 0, False],
            "cell1": [100, 10000, "e7f941512eaa38e620dec41d660c090d42e39a98250d59132911806a215dbf07", 10, "fresh", 0, False],
            "cell2": [100, 10000, "8c6fbaff1b7305747331780c97faa32b34ea48077f31a29e9e724f1a66399192", 10, "fresh", 0, False],
            "cell3": [100, 10000, "f2a9b8df9969110d9b71f43d3fbc2083ef56ba5b07cd7f63486feea6e49c30d8", 10, "fresh", 0, False],
        }],
        [1, {
            "cell0": [100, 10000, "3dcec9de090b5b3da73f909dc2781a7531b1d8d904cc28f6d3be362f2cc68ac7", 10, "fresh", 0, False],
            "cell1": [100, 10000, "ff768a9f2babcd4e329741190c5bb1b9762ba5e1da4863dfc777666e69ca48da", 10, "fresh", 0, False],
            "cell2": [100, 10000, "c37b23b2031bde9da496caf0a31f80e83389e9bd5a8ad69012d27c63f457e307", 10, "fresh", 0, False],
            "cell3": [100, 10000, "0958638e7364a01aaffd7a959f0f223321358d4929cc313eb94ff983f42ba9ff", 10, "fresh", 0, False],
        }],
        [1, {
            "cell0": [100, 10000, "6573da24425085f7beaa720b1c7f93a9d13f9ce57e45ee042e0473fd0dca2b10", 10, "fresh", 0, False],
            "cell1": [100, 10000, "1f8ab330aa37a2d6e6786b2de247cc3752c69593ddb0ff7bf54083518956d899", 10, "fresh", 0, False],
            "cell2": [100, 10000, "b3216af5cf691d3418b5df841461bd8da08a8ecb08b12f00f05c84f7ed9abc76", 10, "fresh", 0, False],
            "cell3": [100, 10000, "36d580d56e2d949ab3f4f0ac63ccd5fc2ae0bf57828700302558fa4ccf6f8736", 10, "fresh", 0, False],
        }],
        [1, {
            "cell0": [100, 10000, "7fd2a2bd9a0b89bf072b2d2493bf3f6fe5cb4075e50624931e8564343495f59f", 10, "fresh", 0, False],
            "cell1": [100, 10000, "cdabc948cf15c8027bd91c9755f251a47f6837ba470fde21f1d509a3270c06fa", 10, "fresh", 0, False],
            "cell2": [100, 10000, "4880e3de5083b6bcb46902072d0a151abba9d89e4f4c73e7a300a3bbafffb7a3", 10, "fresh", 0, False],
            "cell3": [100, 10000, "997c5f3558f4993d56fdf8f69d467c26ebdeb816f4f42438b90a8685880d0c2f", 10, "fresh", 0, False],
        }],
    ],
    "cli": {"rc": 0, "bound": {"cell0": 5000, "cell1": 5000, "cell2": 5000, "cell3": 5000}, "rounds": 1, "flushes": 1},
    "soak": {
        "tenants": {
            "cell_0": {"bindings_sha256": "0ea9b655cdaf54ca17de94d1a13ef42afb0bb86764a4aca55e0e01f2da65fe43", "bound": 34, "work": [10, 10, 0, 0, 0, 0, 10, 10, 10, 10, 0, 10, 0, 10, 0, 0, 10, 0, 0, 0, 0, 10, 10, 10, 10, 10, 9, 10, 10, 0, 10, 0, 0, 10, 0, 0, 10, 0, 10, 0], "scheduled": [2, 1, 0, 0, 0, 0, 2, 1, 2, 2, 0, 2, 0, 2, 0, 0, 2, 0, 0, 0, 0, 2, 1, 1, 2, 1, 1, 2, 2, 0, 1, 0, 0, 2, 0, 0, 1, 0, 2, 0], "faults": 10, "degradations": 10, "noops": 1},
            "cell_1": {"bindings_sha256": "4f15e6dfb6e8ef424f2844f33bd9a823a6ef4a70c7075b627c12bf8633dfac4d", "bound": 43, "work": [10, 10, 10, 10, 0, 10, 0, 0, 9, 10, 0, 0, 0, 10, 10, 10, 9, 0, 9, 10, 10, 0, 10, 10, 10, 10, 10, 0, 10, 0, 0, 10, 0, 10, 9, 9, 10, 10, 10, 10], "scheduled": [1, 2, 2, 1, 0, 2, 0, 0, 2, 1, 0, 0, 0, 2, 1, 1, 2, 0, 1, 1, 1, 0, 2, 1, 1, 2, 1, 0, 2, 0, 0, 2, 0, 2, 2, 1, 2, 2, 2, 1], "faults": 0, "degradations": 0, "noops": 0},
            "cell_10": {"bindings_sha256": "483393d5efc3efe2e86a7c922a127e5ae7e9e0bec5ffffbe7d00150a7d75ac4a", "bound": 28, "work": [0, 10, 10, 0, 0, 10, 10, 0, 0, 10, 10, 0, 10, 0, 10, 10, 0, 0, 0, 10, 0, 10, 0, 0, 10, 0, 10, 10, 0, 10, 10, 10, 10, 0, 0, 10, 10, 10, 0, 0], "scheduled": [0, 1, 2, 0, 0, 1, 1, 0, 0, 2, 1, 0, 1, 0, 1, 1, 0, 0, 0, 1, 0, 2, 0, 0, 1, 0, 2, 1, 0, 2, 1, 1, 2, 0, 0, 1, 1, 2, 0, 0], "faults": 0, "degradations": 0, "noops": 0},
            "cell_11": {"bindings_sha256": "291bef51bc2f05c4fa8d0e45efc506c5853673cf6e23d9aeae3f51869e6e33a9", "bound": 36, "work": [0, 10, 0, 0, 10, 10, 10, 0, 10, 10, 0, 0, 10, 10, 10, 10, 0, 0, 10, 10, 10, 10, 0, 10, 10, 10, 10, 10, 10, 10, 10, 10, 10, 10, 10, 0, 0, 0, 10, 0], "scheduled": [0, 1, 0, 0, 1, 1, 1, 0, 2, 1, 0, 0, 2, 1, 1, 1, 0, 0, 1, 1, 2, 2, 0, 1, 1, 1, 2, 1, 1, 1, 2, 1, 2, 2, 2, 0, 0, 0, 1, 0], "faults": 0, "degradations": 0, "noops": 0},
            "cell_12": {"bindings_sha256": "8548e8747ce71196ba749fadc3e1ba2a04547b3d3a48ae21ff36af197c0bf749", "bound": 36, "work": [10, 10, 9, 0, 10, 10, 10, 10, 0, 10, 0, 10, 0, 0, 10, 0, 10, 10, 9, 0, 9, 10, 9, 10, 9, 0, 0, 0, 10, 0, 0, 10, 10, 0, 10, 0, 0, 0, 10, 0], "scheduled": [2, 1, 2, 0, 2, 2, 2, 2, 0, 2, 0, 2, 0, 0, 1, 0, 2, 2, 2, 0, 2, 1, 1, 1, 1, 0, 0, 0, 1, 0, 0, 1, 2, 0, 1, 0, 0, 0, 1, 0], "faults": 0, "degradations": 0, "noops": 0},
            "cell_13": {"bindings_sha256": "a3ced4fe89518f0acaaf838e96f53be3152b62bb425ebaba566759f23a76c5ca", "bound": 47, "work": [10, 10, 10, 10, 10, 10, 10, 10, 0, 10, 10, 10, 10, 10, 10, 0, 0, 10, 0, 10, 10, 9, 10, 10, 0, 10, 0, 9, 10, 10, 10, 9, 9, 10, 9, 0, 10, 10, 10, 0], "scheduled": [2, 1, 1, 1, 1, 1, 1, 1, 0, 1, 1, 1, 1, 1, 2, 0, 0, 2, 0, 2, 2, 2, 1, 1, 0, 2, 0, 1, 1, 2, 2, 2, 2, 2, 2, 0, 2, 1, 2, 0], "faults": 0, "degradations": 0, "noops": 0},
            "cell_14": {"bindings_sha256": "c787b5d0dc273100959faffb91cad3b766f4e6841c5f5d669d9efcc312652a7e", "bound": 42, "work": [10, 10, 10, 0, 10, 10, 10, 0, 10, 10, 0, 0, 10, 10, 10, 9, 0, 10, 0, 10, 10, 10, 0, 0, 0, 10, 10, 10, 0, 10, 0, 10, 0, 10, 0, 10, 10, 9, 9, 0], "scheduled": [1, 1, 2, 0, 2, 1, 2, 0, 2, 2, 0, 0, 2, 2, 2, 1, 0, 2, 0, 1, 2, 2, 0, 0, 0, 2, 2, 1, 0, 1, 0, 2, 0, 2, 0, 1, 2, 1, 1, 0], "faults": 0, "degradations": 0, "noops": 0},
            "cell_15": {"bindings_sha256": "584d9a004744eebed913dbf202a3410c022f5f2021238abd46b3784524cd7fe2", "bound": 47, "work": [10, 10, 10, 10, 10, 9, 0, 10, 9, 9, 9, 9, 0, 9, 10, 10, 10, 9, 9, 9, 10, 0, 0, 9, 9, 0, 9, 0, 9, 0, 9, 9, 0, 9, 10, 10, 9, 0, 9, 10], "scheduled": [2, 1, 1, 2, 2, 2, 0, 1, 2, 2, 1, 2, 0, 1, 1, 2, 2, 2, 2, 1, 2, 0, 0, 2, 1, 0, 1, 0, 1, 0, 2, 2, 0, 1, 1, 1, 2, 0, 1, 1], "faults": 0, "degradations": 0, "noops": 0},
            "cell_2": {"bindings_sha256": "b6af97905b2b9eea38d8ac3240dbfbdc71dd09fa453a618659f15a5785810c1d", "bound": 32, "work": [10, 0, 0, 10, 10, 0, 10, 0, 0, 10, 10, 10, 10, 10, 0, 10, 10, 10, 10, 10, 0, 0, 0, 10, 0, 10, 10, 10, 0, 10, 0, 0, 0, 0, 10, 10, 10, 0, 10, 10], "scheduled": [2, 0, 0, 1, 2, 0, 2, 0, 0, 1, 1, 1, 1, 2, 0, 2, 1, 2, 2, 2, 0, 0, 0, 1, 0, 1, 1, 1, 0, 1, 0, 0, 0, 0, 1, 1, 1, 0, 1, 1], "faults": 0, "degradations": 0, "noops": 0},
            "cell_3": {"bindings_sha256": "240e52bf8c961e16d7d4badb67637a8a4c1deb57b616040f13590bf4e90fc982", "bound": 32, "work": [10, 10, 10, 10, 9, 9, 0, 10, 10, 0, 0, 0, 0, 10, 9, 0, 10, 10, 10, 0, 0, 0, 0, 10, 10, 10, 10, 0, 10, 0, 10, 0, 10, 0, 0, 10, 0, 10, 0, 10], "scheduled": [1, 2, 2, 2, 1, 2, 0, 2, 2, 0, 0, 0, 0, 1, 1, 0, 1, 1, 1, 0, 0, 0, 0, 1, 1, 1, 1, 0, 1, 0, 2, 0, 1, 0, 0, 2, 0, 2, 0, 1], "faults": 0, "degradations": 0, "noops": 0},
            "cell_4": {"bindings_sha256": "711f3d2889d472d1783a42ca013d9316ccb2823532ccfae8f17ffa8e119b1e93", "bound": 43, "work": [10, 10, 10, 0, 10, 0, 10, 10, 0, 10, 10, 0, 0, 10, 10, 10, 10, 10, 10, 9, 9, 10, 0, 10, 0, 9, 0, 0, 0, 0, 10, 10, 10, 0, 0, 10, 10, 0, 10, 9], "scheduled": [1, 2, 1, 0, 2, 0, 2, 2, 0, 1, 2, 0, 0, 1, 2, 2, 2, 2, 1, 2, 2, 2, 0, 1, 0, 1, 0, 0, 0, 0, 2, 1, 2, 0, 0, 1, 2, 0, 2, 2], "faults": 0, "degradations": 0, "noops": 0},
            "cell_5": {"bindings_sha256": "eacef566c221fd1f1bda5f560abd0915c519d78d07bf946bf901322fd2d2f68c", "bound": 43, "work": [10, 10, 10, 0, 0, 10, 10, 0, 10, 0, 10, 10, 10, 10, 10, 0, 0, 10, 0, 10, 9, 10, 10, 10, 10, 9, 9, 10, 0, 9, 10, 0, 0, 10, 0, 10, 10, 10, 10, 10], "scheduled": [2, 1, 1, 0, 0, 2, 1, 0, 1, 0, 1, 1, 2, 2, 2, 0, 0, 2, 0, 2, 2, 1, 1, 2, 2, 1, 2, 1, 0, 1, 1, 0, 0, 1, 0, 2, 1, 2, 1, 2], "faults": 0, "degradations": 0, "noops": 0},
            "cell_6": {"bindings_sha256": "eb237cdc0a81e02e6d4f167bd3f509ab439ecebc1a433a99bbff1112230c3cde", "bound": 43, "work": [10, 10, 10, 0, 10, 10, 10, 10, 0, 0, 10, 0, 10, 0, 10, 0, 10, 10, 0, 10, 0, 10, 9, 9, 9, 9, 10, 10, 9, 9, 10, 0, 10, 0, 10, 10, 0, 9, 0, 9], "scheduled": [1, 1, 1, 0, 1, 1, 1, 1, 0, 0, 2, 0, 2, 0, 2, 0, 1, 2, 0, 2, 0, 2, 2, 1, 1, 2, 1, 2, 2, 1, 1, 0, 2, 0, 2, 2, 0, 2, 0, 2], "faults": 0, "degradations": 0, "noops": 0},
            "cell_7": {"bindings_sha256": "472f55c38ad92ac98daded66ba7f8bee135aa0adad78cf7004043cc00ad9bc1d", "bound": 52, "work": [10, 0, 10, 10, 10, 10, 10, 0, 0, 10, 10, 10, 10, 9, 9, 10, 10, 9, 9, 10, 0, 10, 10, 0, 10, 10, 9, 10, 10, 9, 9, 10, 10, 9, 0, 9, 0, 10, 10, 0], "scheduled": [2, 0, 1, 2, 2, 2, 1, 0, 0, 1, 2, 1, 1, 1, 2, 1, 2, 1, 1, 2, 0, 1, 2, 0, 2, 1, 2, 2, 2, 2, 2, 2, 1, 2, 0, 2, 0, 2, 2, 0], "faults": 0, "degradations": 0, "noops": 0},
            "cell_8": {"bindings_sha256": "303a0f9ada9af38851a64b3bed424613cf45e1a9c974ca817e1e02947ec66664", "bound": 33, "work": [0, 10, 10, 10, 10, 0, 10, 10, 10, 10, 9, 9, 10, 10, 9, 9, 0, 0, 10, 0, 10, 0, 10, 10, 0, 0, 0, 10, 0, 10, 10, 0, 10, 0, 0, 10, 0, 10, 0, 10], "scheduled": [0, 2, 2, 2, 2, 0, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 1, 0, 1, 0, 1, 2, 0, 0, 0, 1, 0, 1, 2, 0, 1, 0, 0, 2, 0, 1, 0, 2], "faults": 0, "degradations": 0, "noops": 0},
            "cell_9": {"bindings_sha256": "37910ec2bff1aa7a94b9eeb1c6d065ca8aa9b9f62c7e0d113b4f3c6948f2bcac", "bound": 33, "work": [0, 10, 0, 10, 10, 0, 10, 0, 10, 0, 10, 10, 10, 10, 10, 0, 10, 0, 10, 0, 10, 0, 0, 0, 10, 10, 0, 10, 10, 0, 0, 10, 10, 10, 9, 10, 10, 10, 0, 10], "scheduled": [0, 1, 0, 2, 1, 0, 1, 0, 1, 0, 1, 2, 2, 1, 2, 0, 2, 0, 1, 0, 1, 0, 0, 0, 1, 1, 0, 1, 1, 0, 0, 1, 2, 1, 1, 1, 1, 2, 0, 2], "faults": 0, "degradations": 0, "noops": 0},
        },
        "flushes": 40,
        "last_groups": 4,
        "last_lanes": 9,
        "quarantines": 0.0,
        "checked": 15,
    },
}
#: cli.main --tenants 4 at BASELINE's width with 5,000 pods a cell: the
#: synthetic pod channel holds 5,000, and --tenants fills each cell's
#: channel before its first round (so does the JAX package's)
# The multi-device phases' values, as produced by the JAX package on the
# CPU (tests/torch_parallel_reference.py: gtrace100k's scenario cut to
# 10k x 1k on a 2-device mesh, both arms' round records; the seeded
# BulkCluster through LayeredTransportSolver and ShardedLayeredSolver, the
# tiered instance; the what-if batches on that cluster).
REF_PARALLEL = {'sharded': {'args': {'burst_every': 8,
                      'burst_factor': 10,
                      'churn': 0.01,
                      'devices': 2,
                      'machines': 1000,
                      'restart_budget': 64,
                      'rounds': 6,
                      'tasks': 10000,
                      'warmup': 2},
             'arms': {'scan_csr': [{'converged': True,
                                    'flow_sha256': '298862043cb4e61a0701670961470e9569fcb4a855d6229444d117d0a26d67b2',
                                    'h2d_delta': 0,
                                    'h2d_full': 1703936,
                                    'kind': 'churn',
                                    'p_sha256': 'd8b3598bc92fa1d3f80677aea078886ba87441da966e6b56f91f433730985810',
                                    'path': 'csr',
                                    'plan_kind': 'none',
                                    'round': 0,
                                    'sha256': '3a43c5cb82e462e7822a2c710e3a5f9fa9a5ae0a6d8c955f452be755450e71c2',
                                    'supersteps': 10,
                                    'telemetry_sha256': '8998caf7aecc7014acc8bf23cd301498ce90b93ed3b23600a7d4be268f23b498',
                                    'warm_scope': 'cold'},
                                   {'converged': True,
                                    'flow_sha256': '06455d4438fcf727adf1fdb44928a5aeb7cfed8fc50a46cebc83326cbfbb6f6f',
                                    'h2d_delta': 6833152,
                                    'h2d_full': 1703936,
                                    'kind': 'churn',
                                    'p_sha256': 'f90c75244a18d63df0c9f697cd822653b9cdb2ea474c98e8131e16c821c79d78',
                                    'path': 'csr',
                                    'plan_kind': 'rebuild',
                                    'round': 1,
                                    'sha256': 'd4112c3ef400836b4b3070bd75d311703e001b630974d696c469034c72497a35',
                                    'supersteps': 16,
                                    'telemetry_sha256': '5d7e116732b1b0ef394879a3dbaace3cfb77b6a4c0da6e8eed1a6e93070b5d10',
                                    'warm_scope': 'fresh'},
                                   {'converged': True,
                                    'flow_sha256': 'fd1f6d16f75fc89364bad4a26d42c4c8868b49f9510207ad7cbbea561466cfca',
                                    'h2d_delta': 8636416,
                                    'h2d_full': 1703936,
                                    'kind': 'churn',
                                    'p_sha256': 'fb93b12512fc31e0a18d2f5c53153a6c6d66c10cea0eef18b1685b15f73a849d',
                                    'path': 'csr',
                                    'plan_kind': 'delta',
                                    'round': 2,
                                    'sha256': '95c269de95e922382f99b231b166474f9cf6e10be97f9af43266c09cfc48daf6',
                                    'supersteps': 10,
                                    'telemetry_sha256': 'ba519a0c86dc7cf08ca72a112efe00da7a6ce75e82aef5772dd5e5054798a8ae',
                                    'warm_scope': 'fresh'},
                                   {'converged': True,
                                    'flow_sha256': '9c152c6dcd42ebceaefc404778062bcf1c9cf6a2a1b3f5b72858f3d5a5b79761',
                                    'h2d_delta': 10210816,
                                    'h2d_full': 1703936,
                                    'kind': 'churn',
                                    'p_sha256': 'b4cb461894dcba08e1c20af010c3e86a9b6691f1e5ce895cbee2490b8f64c575',
                                    'path': 'csr',
                                    'plan_kind': 'delta',
                                    'round': 3,
                                    'sha256': '4a0c4e9d5dcc085fc5e071c23c37b55167119b050b1859ce63bb94b057376db8',
                                    'supersteps': 11,
                                    'telemetry_sha256': 'f8f2be58461409c1333ff3efc0299ab45b81088e37ba7e4a4c0038278cc4c802',
                                    'warm_scope': 'fresh'},
                                   {'converged': True,
                                    'flow_sha256': '285aec213402549155046c3d58dddde2eaf0494c9f209b38da98f8b6cd98bcc5',
                                    'h2d_delta': 11784928,
                                    'h2d_full': 1703936,
                                    'kind': 'churn',
                                    'p_sha256': 'bd6a0cdd010b947a9b5724bcdf3e0f53ff91cb64f14ff7e96267b7fc3f1f4fc9',
                                    'path': 'csr',
                                    'plan_kind': 'delta',
                                    'round': 4,
                                    'sha256': '49eeb816810815871af205cfeaa03b03e6c9398496a4911aedf13c29a5c92941',
                                    'supersteps': 10,
                                    'telemetry_sha256': 'a7cf253fb1627fc30a1d70de2c53a7365ac00323741e85ff458ffbaa37b76ea7',
                                    'warm_scope': 'fresh'},
                                   {'converged': True,
                                    'flow_sha256': '268d63dc0655ae219c2577725b6e92e8d048f4586e3b433c544a0e202c74016d',
                                    'h2d_delta': 13359712,
                                    'h2d_full': 1703936,
                                    'kind': 'churn',
                                    'p_sha256': '38cd92052ed4e17572785322c371561c0f336098a9e3223358d9061fa90676c2',
                                    'path': 'csr',
                                    'plan_kind': 'delta',
                                    'round': 5,
                                    'sha256': '1c65a6a5edbbcd8708e5c0c27069cdd8a85ea6af8b17b04c03aefd8a1763dd90',
                                    'supersteps': 11,
                                    'telemetry_sha256': '1ef0a2106978e0973aecfb8f9a287ff28c9ed5571893d4c1121091edadaddce1',
                                    'warm_scope': 'fresh'},
                                   {'converged': True,
                                    'flow_sha256': 'e1bc61b5a096c8f5aab561634bd7586c1cb9e79162cb603f2d31eb6c97017540',
                                    'h2d_delta': 14933824,
                                    'h2d_full': 1703936,
                                    'kind': 'churn',
                                    'p_sha256': '61bce40062f231e20cae68d8078d6f26844754d49002b9c2d3048cc22ff2556f',
                                    'path': 'csr',
                                    'plan_kind': 'delta',
                                    'round': 6,
                                    'sha256': '27fa1f5771e76f3281ccfce2a256cece44aa8240e85de062996018591647ec13',
                                    'supersteps': 10,
                                    'telemetry_sha256': '9df6f0caeda0d6c517aaa4c5124b619008b67c4bf033e05908fb26721a973949',
                                    'warm_scope': 'fresh'},
                                   {'converged': True,
                                    'flow_sha256': '6e83dacf754c1fdd0e5caedc8eee22fc40d1693d0778a5b62094c2e7edec1cce',
                                    'h2d_delta': 16508960,
                                    'h2d_full': 1703936,
                                    'kind': 'burst',
                                    'p_sha256': '524d6c1dac6effa300b9baaa8dd08cb0dd05f6ccef4d9d1cc5421fd22a85491d',
                                    'path': 'csr',
                                    'plan_kind': 'delta',
                                    'round': 7,
                                    'sha256': '9c94d0ab8273575fd859cd36b603fbae33d7bf00aebdbadeca4fe34ad897ae26',
                                    'supersteps': 10,
                                    'telemetry_sha256': 'fb59b61f14141d75a02f990d1204238de99b637914c6c0c3be88d1d7633848b9',
                                    'warm_scope': 'fresh'}],
                      'sharded': [{'converged': True,
                                   'flow_sha256': '298862043cb4e61a0701670961470e9569fcb4a855d6229444d117d0a26d67b2',
                                   'h2d_delta': 0,
                                   'h2d_full': 1703936,
                                   'kind': 'churn',
                                   'p_sha256': 'd8b3598bc92fa1d3f80677aea078886ba87441da966e6b56f91f433730985810',
                                   'path': 'csr',
                                   'plan_kind': 'none',
                                   'round': 0,
                                   'sha256': '3a43c5cb82e462e7822a2c710e3a5f9fa9a5ae0a6d8c955f452be755450e71c2',
                                   'supersteps': 10,
                                   'telemetry_sha256': '8998caf7aecc7014acc8bf23cd301498ce90b93ed3b23600a7d4be268f23b498',
                                   'warm_scope': 'cold'},
                                  {'converged': True,
                                   'flow_sha256': '06455d4438fcf727adf1fdb44928a5aeb7cfed8fc50a46cebc83326cbfbb6f6f',
                                   'h2d_delta': 6833152,
                                   'h2d_full': 1703936,
                                   'kind': 'churn',
                                   'p_sha256': 'f90c75244a18d63df0c9f697cd822653b9cdb2ea474c98e8131e16c821c79d78',
                                   'path': 'csr',
                                   'plan_kind': 'rebuild',
                                   'round': 1,
                                   'sha256': 'd4112c3ef400836b4b3070bd75d311703e001b630974d696c469034c72497a35',
                                   'supersteps': 16,
                                   'telemetry_sha256': '5d7e116732b1b0ef394879a3dbaace3cfb77b6a4c0da6e8eed1a6e93070b5d10',
                                   'warm_scope': 'fresh'},
                                  {'converged': True,
                                   'flow_sha256': 'fd1f6d16f75fc89364bad4a26d42c4c8868b49f9510207ad7cbbea561466cfca',
                                   'h2d_delta': 9488384,
                                   'h2d_full': 1703936,
                                   'kind': 'churn',
                                   'p_sha256': 'fb93b12512fc31e0a18d2f5c53153a6c6d66c10cea0eef18b1685b15f73a849d',
                                   'path': 'sharded',
                                   'plan_kind': 'delta',
                                   'round': 2,
                                   'sha256': '95c269de95e922382f99b231b166474f9cf6e10be97f9af43266c09cfc48daf6',
                                   'supersteps': 10,
                                   'telemetry_sha256': 'f14a7296197c6357b6807ef2fea78200dc90f5191609cfd0dcd1c9e5ce7a879c',
                                   'warm_scope': 'cold'},
                                  {'converged': True,
                                   'flow_sha256': '9c152c6dcd42ebceaefc404778062bcf1c9cf6a2a1b3f5b72858f3d5a5b79761',
                                   'h2d_delta': 11063168,
                                   'h2d_full': 1703936,
                                   'kind': 'churn',
                                   'p_sha256': 'b4cb461894dcba08e1c20af010c3e86a9b6691f1e5ce895cbee2490b8f64c575',
                                   'path': 'sharded',
                                   'plan_kind': 'delta',
                                   'round': 3,
                                   'sha256': '4a0c4e9d5dcc085fc5e071c23c37b55167119b050b1859ce63bb94b057376db8',
                                   'supersteps': 11,
                                   'telemetry_sha256': 'e6f99eab4e0da35800fd7a1a10d074f1c83a61781de5ca4bf11990d67fa473a1',
                                   'warm_scope': 'fresh'},
                                  {'converged': True,
                                   'flow_sha256': '285aec213402549155046c3d58dddde2eaf0494c9f209b38da98f8b6cd98bcc5',
                                   'h2d_delta': 12637376,
                                   'h2d_full': 1703936,
                                   'kind': 'churn',
                                   'p_sha256': 'bd6a0cdd010b947a9b5724bcdf3e0f53ff91cb64f14ff7e96267b7fc3f1f4fc9',
                                   'path': 'sharded',
                                   'plan_kind': 'delta',
                                   'round': 4,
                                   'sha256': '49eeb816810815871af205cfeaa03b03e6c9398496a4911aedf13c29a5c92941',
                                   'supersteps': 10,
                                   'telemetry_sha256': 'e269101f9c4401edb6e61b636fc06d343c2479bd9d276be632775c36ef2cee12',
                                   'warm_scope': 'fresh'},
                                  {'converged': True,
                                   'flow_sha256': '268d63dc0655ae219c2577725b6e92e8d048f4586e3b433c544a0e202c74016d',
                                   'h2d_delta': 14212928,
                                   'h2d_full': 1703936,
                                   'kind': 'churn',
                                   'p_sha256': '38cd92052ed4e17572785322c371561c0f336098a9e3223358d9061fa90676c2',
                                   'path': 'sharded',
                                   'plan_kind': 'delta',
                                   'round': 5,
                                   'sha256': '1c65a6a5edbbcd8708e5c0c27069cdd8a85ea6af8b17b04c03aefd8a1763dd90',
                                   'supersteps': 11,
                                   'telemetry_sha256': '241135803e42fc95b9c691b6042c71de035bd0a8158d6f484aee462c72606b28',
                                   'warm_scope': 'fresh'},
                                  {'converged': True,
                                   'flow_sha256': 'e1bc61b5a096c8f5aab561634bd7586c1cb9e79162cb603f2d31eb6c97017540',
                                   'h2d_delta': 15787136,
                                   'h2d_full': 1703936,
                                   'kind': 'churn',
                                   'p_sha256': '61bce40062f231e20cae68d8078d6f26844754d49002b9c2d3048cc22ff2556f',
                                   'path': 'sharded',
                                   'plan_kind': 'delta',
                                   'round': 6,
                                   'sha256': '27fa1f5771e76f3281ccfce2a256cece44aa8240e85de062996018591647ec13',
                                   'supersteps': 10,
                                   'telemetry_sha256': 'c40cbd2d0c33a615f4c51f2ff24fa8977aa83240265e2f783055f2617b859a08',
                                   'warm_scope': 'fresh'},
                                  {'converged': True,
                                   'flow_sha256': '6e83dacf754c1fdd0e5caedc8eee22fc40d1693d0778a5b62094c2e7edec1cce',
                                   'h2d_delta': 17362368,
                                   'h2d_full': 1703936,
                                   'kind': 'burst',
                                   'p_sha256': '524d6c1dac6effa300b9baaa8dd08cb0dd05f6ccef4d9d1cc5421fd22a85491d',
                                   'path': 'sharded',
                                   'plan_kind': 'delta',
                                   'round': 7,
                                   'sha256': '9c94d0ab8273575fd859cd36b603fbae33d7bf00aebdbadeca4fe34ad897ae26',
                                   'supersteps': 10,
                                   'telemetry_sha256': '73c33c0a575edffe405a22cb6799fcdffb3e3362fb28c8e579319f87be3c31ed',
                                   'warm_scope': 'fresh'}]},
             'bucket': {'block_extent': 131072,
                        'entry_cap': 262144,
                        'm_cap': 65536,
                        'n_cap': 16384},
             'budget': 7602176},
 'sharded_layered': {'sharded': {'num_placed': 10000,
                                 'num_unscheduled': 0,
                                 'placements_sha256': 'ddf1e98cbe11e541b058efbb19f871796db872d84695eb33e37f2914d80308f7',
                                 'supersteps': 2637},
                     'single': {'num_placed': 10000,
                                'num_unscheduled': 0,
                                'placements_sha256': 'ddf1e98cbe11e541b058efbb19f871796db872d84695eb33e37f2914d80308f7',
                                'supersteps': 2637},
                     'tiered': {'converged': True,
                                'steps': 1639,
                                'y_sha256': '5c12a84fb37f9936a198ab4b83fe19d300a479942c793526f14c2caa1508ba99'}},
 'whatif': {'drain': {'converged': [True,
                                    True,
                                    True,
                                    True,
                                    True,
                                    True,
                                    True,
                                    True,
                                    True,
                                    True,
                                    True,
                                    True,
                                    True,
                                    True,
                                    True,
                                    True],
                      'num_unsched': [0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0],
                      'objective': [64, 0, 0, 64, 0, 64, 0, 0, 64, 64, 0, 0, 64, 0, 64, 64],
                      'y_sha256': 'bdfe8e91b2241690cc638b6789029434fc29b72b29443f3b1ef949e50cd7f475'},
            'surge': {'converged': [True, True, True, True, True, True, True, True],
                      'num_unsched': [0, 0, 0, 0, 0, 0, 10384, 34960],
                      'objective': [0, 60, 192, 640, 3072, 10572, 290512, 904912],
                      'y_sha256': 'b379ef7d9042771faa5f4ec7bd84d02d2472ef53bab453fdc6ca188b19cbaa47'}}}

# The tool phases' values, as produced by ksched_tpu's tools on the CPU
# (tests/torch_tools_reference.py): tools/soak.py's chunk lines at the
# smoke's device-soak arguments; tools/tail_repro.py's capture line, npz
# arrays' sha256 and replay lines per capture; each timed chain's stats
# sha256 for tools/profile_round.py's round sequence; tools/shard_smoke.py's
# arms on 2 virtual devices.
REF_TOOLS = {'args': {'profile': {'J': 10,
                      'M': 1000,
                      'P': 4,
                      'R': 64,
                      'S': 4,
                      'T': 10000,
                      'Tcap': 16384,
                      'reps': 7},
          'shard': {'devices': 2,
                    'machines': 6,
                    'rounds': 24,
                    'seed': 7,
                    'tasks': 48,
                    'warmup': 4},
          'soak': ['--tasks',
                   '20000',
                   '--machines',
                   '500',
                   '--preempt',
                   '--rounds',
                   '512',
                   '--chunk',
                   '128',
                   '--checkpoint-every',
                   '2'],
          'tails': {'coco-preempt': {'refine': '0,8',
                                     'replay': 'replay-tiered',
                                     'rounds': 4,
                                     'threshold': 5000},
                    'quincy': {'replay': 'replay-grouped',
                               'rounds': 4,
                               'strategies': 'two:1:256,two:n4:1024,full:n4:2,full:n:2',
                               'threshold': 280},
                    'whare': {'alpha': '2,8',
                              'refine': '8,32',
                              'replay': 'replay',
                              'rounds': 60,
                              'threshold': 40}}},
 'profile': ['1029bdfdbc59accf16efae04dd5d3656b1115fe32f1ec4496d1ad7bbec5ad473',
             '41f9ae950a2ebf57e08c71729ab1a50854f0bacefafd1247ab34ffa86153fc39',
             'df2ac9f2f5bed1a8ac048ae5b78fa34b49a36f412a78539617b91d9f690fc486',
             '7173b7df2f7d4b01282d9809748229c130d11eb4b848fe0781209b748ca2f746',
             'b472e1cad9cec126825f1ee4dc1c0b3755401564b96156d06d6c90a5356748a6',
             '90e44bb874d04084acab0bc1f10447c88d6fb5a3c478b457589835fe70f994f4',
             'ea0e9da8828da2bd0951654de03275e089765dbe672c30026b1a49d7feecb591'],
 'shard': {'chaos': {'degradations': 10,
                     'faults': {'solver_exception': 2,
                                'solver_nan_cost': 3,
                                'solver_nonconverge': 5},
                     'placements_sha256': ['66e0c1dcb5c6024d519ef8a36cd93898cb2b292090f37c0ad21b1639604ef0f1',
                                           '642b7f3ff99dddd0cc92577a8026b1037d6cf0d54643233f3914dbc4c61ad095',
                                           'd52d669faccf35b8850ff6d3587561b85a9c264e99c5d954be6d60737e448e04',
                                           '7c28574cef29416ea730776d4bcaf4151da8cd13220fc8a7eeb94e90d4ad477c',
                                           '0bd342f5e81bfee1125cf3db8f7e8f3fb0d34642ece452131867a67a523f5228',
                                           '5a1d0a2795f3dc63e6657d32c36e9f0e8e051b7a4bea0c9df84cff387cfdfce4',
                                           '4696dc93d8293bbc948784304d04873ea4c974d639b2385e2744f74a74c9db12',
                                           '41a9269f0b8d3738cd82dbf38f77502bac98c1712f3ff13fc8ac54c465fd1c36',
                                           '58b78fc3acba6661ad0042ee00d5ee6b7d8c74c3f1869238d99dad7e7c3a979c',
                                           '18102d136984cf9b0a4c9dc1878d2d1ca9db2b9275bd1d550dbdbfb418233273',
                                           '663ffbeed26122c376c8491bfb3ad8549308b6ff6eb95b0b31dcc9c531926a88',
                                           '30ccfd556023ce5529dbeabb3e8ad55e3bebcfbdfd0f5779c28aeb32ce7705fd',
                                           '65d0a5cc7a09df246387256047b2620b1ca42d9fd5e40112c190825da6384918',
                                           '3be769e319cfe2e7b3370d278f561dc5047e0aff8cb80adc81e73e7f74c9e279',
                                           '05ce34b50309b99dc44c75ce9c0416220cebca6fe27b2f74cd32fb6157cd267a',
                                           '7b5be2e0da7efb0f93a78124b8772c6103230dd5df7065c0a0af621c0beccb15',
                                           '5471e5037e4f38c43af8e3d03c9498905d1635fa75e16c62db85fb47d947ade7',
                                           '3eb47927c9570655b17a98ed5f59e4a7a28d053c0cd519d92dac97f0c7cddd51',
                                           '5bb49b562a488b5a8a8dfbf439fd3b6112d30cd706882ee5d5d8b007ec4b4deb',
                                           'e638b4875ea141d99c1b90d37750c090fe5d7eb639027552c77183c9626fae74',
                                           '9d42f53b370003fd06b6de64297e4d4ff23ddcc8644b266fbd4c1997b65633d4',
                                           '118f7cc003143220d66c41465d274dde907868ff959fb20747bb2c3439aeaf3a',
                                           '299f33ad3659613ec3750947a1c89714147b32b951c401838fd7d8944939a7fc',
                                           '87927b59639730366e7c87c88ac7d63a05d464dbb08b6724effb23257c2c2fd5'],
                     'rungs': {'jax': 10, 'sharded': 14}},
           'scan_csr': {'kinds': {'delta': 19},
                        'placements_sha256': ['66e0c1dcb5c6024d519ef8a36cd93898cb2b292090f37c0ad21b1639604ef0f1',
                                              '642b7f3ff99dddd0cc92577a8026b1037d6cf0d54643233f3914dbc4c61ad095',
                                              'd52d669faccf35b8850ff6d3587561b85a9c264e99c5d954be6d60737e448e04',
                                              '7c28574cef29416ea730776d4bcaf4151da8cd13220fc8a7eeb94e90d4ad477c',
                                              '0bd342f5e81bfee1125cf3db8f7e8f3fb0d34642ece452131867a67a523f5228',
                                              '5a1d0a2795f3dc63e6657d32c36e9f0e8e051b7a4bea0c9df84cff387cfdfce4',
                                              '4696dc93d8293bbc948784304d04873ea4c974d639b2385e2744f74a74c9db12',
                                              '41a9269f0b8d3738cd82dbf38f77502bac98c1712f3ff13fc8ac54c465fd1c36',
                                              '58b78fc3acba6661ad0042ee00d5ee6b7d8c74c3f1869238d99dad7e7c3a979c',
                                              '18102d136984cf9b0a4c9dc1878d2d1ca9db2b9275bd1d550dbdbfb418233273',
                                              '663ffbeed26122c376c8491bfb3ad8549308b6ff6eb95b0b31dcc9c531926a88',
                                              '30ccfd556023ce5529dbeabb3e8ad55e3bebcfbdfd0f5779c28aeb32ce7705fd',
                                              '65d0a5cc7a09df246387256047b2620b1ca42d9fd5e40112c190825da6384918',
                                              '3be769e319cfe2e7b3370d278f561dc5047e0aff8cb80adc81e73e7f74c9e279',
                                              '05ce34b50309b99dc44c75ce9c0416220cebca6fe27b2f74cd32fb6157cd267a',
                                              '7b5be2e0da7efb0f93a78124b8772c6103230dd5df7065c0a0af621c0beccb15',
                                              '5471e5037e4f38c43af8e3d03c9498905d1635fa75e16c62db85fb47d947ade7',
                                              '3eb47927c9570655b17a98ed5f59e4a7a28d053c0cd519d92dac97f0c7cddd51',
                                              '5bb49b562a488b5a8a8dfbf439fd3b6112d30cd706882ee5d5d8b007ec4b4deb',
                                              'e638b4875ea141d99c1b90d37750c090fe5d7eb639027552c77183c9626fae74',
                                              '9d42f53b370003fd06b6de64297e4d4ff23ddcc8644b266fbd4c1997b65633d4',
                                              '118f7cc003143220d66c41465d274dde907868ff959fb20747bb2c3439aeaf3a',
                                              '299f33ad3659613ec3750947a1c89714147b32b951c401838fd7d8944939a7fc',
                                              '87927b59639730366e7c87c88ac7d63a05d464dbb08b6724effb23257c2c2fd5']},
           'sharded': {'kinds': {'delta': 19},
                       'placements_sha256': ['66e0c1dcb5c6024d519ef8a36cd93898cb2b292090f37c0ad21b1639604ef0f1',
                                             '642b7f3ff99dddd0cc92577a8026b1037d6cf0d54643233f3914dbc4c61ad095',
                                             'd52d669faccf35b8850ff6d3587561b85a9c264e99c5d954be6d60737e448e04',
                                             '7c28574cef29416ea730776d4bcaf4151da8cd13220fc8a7eeb94e90d4ad477c',
                                             '0bd342f5e81bfee1125cf3db8f7e8f3fb0d34642ece452131867a67a523f5228',
                                             '5a1d0a2795f3dc63e6657d32c36e9f0e8e051b7a4bea0c9df84cff387cfdfce4',
                                             '4696dc93d8293bbc948784304d04873ea4c974d639b2385e2744f74a74c9db12',
                                             '41a9269f0b8d3738cd82dbf38f77502bac98c1712f3ff13fc8ac54c465fd1c36',
                                             '58b78fc3acba6661ad0042ee00d5ee6b7d8c74c3f1869238d99dad7e7c3a979c',
                                             '18102d136984cf9b0a4c9dc1878d2d1ca9db2b9275bd1d550dbdbfb418233273',
                                             '663ffbeed26122c376c8491bfb3ad8549308b6ff6eb95b0b31dcc9c531926a88',
                                             '30ccfd556023ce5529dbeabb3e8ad55e3bebcfbdfd0f5779c28aeb32ce7705fd',
                                             '65d0a5cc7a09df246387256047b2620b1ca42d9fd5e40112c190825da6384918',
                                             '3be769e319cfe2e7b3370d278f561dc5047e0aff8cb80adc81e73e7f74c9e279',
                                             '05ce34b50309b99dc44c75ce9c0416220cebca6fe27b2f74cd32fb6157cd267a',
                                             '7b5be2e0da7efb0f93a78124b8772c6103230dd5df7065c0a0af621c0beccb15',
                                             '5471e5037e4f38c43af8e3d03c9498905d1635fa75e16c62db85fb47d947ade7',
                                             '3eb47927c9570655b17a98ed5f59e4a7a28d053c0cd519d92dac97f0c7cddd51',
                                             '5bb49b562a488b5a8a8dfbf439fd3b6112d30cd706882ee5d5d8b007ec4b4deb',
                                             'e638b4875ea141d99c1b90d37750c090fe5d7eb639027552c77183c9626fae74',
                                             '9d42f53b370003fd06b6de64297e4d4ff23ddcc8644b266fbd4c1997b65633d4',
                                             '118f7cc003143220d66c41465d274dde907868ff959fb20747bb2c3439aeaf3a',
                                             '299f33ad3659613ec3750947a1c89714147b32b951c401838fd7d8944939a7fc',
                                             '87927b59639730366e7c87c88ac7d63a05d464dbb08b6724effb23257c2c2fd5']}},
 'soak': ['round    128: live=19977 placed/round=200.0 supersteps mean=273 max=8221 down=0 '
          'full=9 migrated=174489 preempted=0',
          'round    256: live=20160 placed/round=200.6 supersteps mean=301 max=6176 down=5 '
          'full=10 migrated=194301 preempted=0',
          'round    256: checkpoint round-trip OK (soak continues on the restored cluster)',
          'round    384: live=20146 placed/round=200.0 supersteps mean=329 max=7454 down=0 '
          'full=10 migrated=195527 preempted=0',
          'round    512: live=19935 placed/round=201.5 supersteps mean=281 max=6252 down=5 '
          'full=10 migrated=194237 preempted=0',
          'round    512: checkpoint round-trip OK (soak continues on the restored cluster)'],
 'tails': {'coco-preempt': {'capture': 'rounds=4 supersteps p50=5384 p90=7658 p99=7673 '
                                       'max=7675 tails>=5000: 2',
                            'npz_sha256': {'Mp': 'c51265ddabbdce236a39a59abd7573b162b83a1e5122ccf193f32776058dd8eb',
                                           'colcap_0': '206629ffe1a68d057804bd6cfe8b998aa705e3e7d31b771bff22147dd341317b',
                                           'colcap_1': '206629ffe1a68d057804bd6cfe8b998aa705e3e7d31b771bff22147dd341317b',
                                           'discount': '4c2306da2ed72d266aaec21ec11681d5f0bb5fe93f4e8b4ee49c3f54d66e09fd',
                                           'n': '3d542c565a8cf404b353c49a40c7e2175943338ab69b45b07e5572ba19a9345b',
                                           'n_scale': 'c51265ddabbdce236a39a59abd7573b162b83a1e5122ccf193f32776058dd8eb',
                                           'preempt': '12ceaa6bd0c061443528cc7e9f37fdb11e6ad3806f9d321ca8935dbdc50b1e72',
                                           'residents_0': '449656ce044a850064655808beda481b9378b557f3566305bc3dd20faff2382e',
                                           'residents_1': 'ff645deda42ac6706fdc28487fb9a238cb8fe7f3a7d561a538e656109da660bd',
                                           'ss_0': 'cd3ed6b4dd81cde92b9c2dfd6e89cc6d8e80a954fef63daa8ba0d1c2324a1f29',
                                           'ss_1': '6e6421007f948903a45041990c9225f5a8ce3412ac46d5cd257017d4358f04b7',
                                           'supply_0': '9f9d51b6caad95cc5caabeaa66fe458d55ec1b6e1be96f6ad0c1ce7d59971c25',
                                           'supply_1': 'f61920a48c16b58c4cbb738694751f99708693e54c8a12687e9b63d3bec60867',
                                           'w_0': 'e06e2756b3acd092b88948f788848900ae97b2f3076d1dac9e09614193cfbe9a',
                                           'w_1': '6a214de75f311c6d2f17e8a4454e3eac9091ab3d7140a5d10c59fb9c6c6fc808'},
                            'replay': ['inst 0: C=4 total=20000 residents=19800 cap=32000 '
                                       'orig_ss=7617',
                                       '  eps0=full  refine= 0: ss=57569 conv=True',
                                       '  eps0=full  refine= 8: ss=4934 conv=True',
                                       '  eps0=n     refine= 0: ss=16080 conv=True',
                                       '  eps0=n     refine= 8: ss=7617 conv=True',
                                       '  eps0=n/4   refine= 0: ss=35002 conv=True',
                                       '  eps0=n/4   refine= 8: ss=22650 conv=True',
                                       '  eps0=n/16  refine= 0: ss=89568 conv=True',
                                       '  eps0=n/16  refine= 8: ss=84465 conv=True',
                                       'inst 1: C=4 total=20000 residents=19800 cap=32000 '
                                       'orig_ss=7675',
                                       '  eps0=full  refine= 0: ss=47031 conv=True',
                                       '  eps0=full  refine= 8: ss=7197 conv=True',
                                       '  eps0=n     refine= 0: ss=20025 conv=True',
                                       '  eps0=n     refine= 8: ss=7675 conv=True',
                                       '  eps0=n/4   refine= 0: ss=25377 conv=True',
                                       '  eps0=n/4   refine= 8: ss=20344 conv=True',
                                       '  eps0=n/16  refine= 0: ss=78255 conv=True',
                                       '  eps0=n/16  refine= 8: ss=75533 conv=True']},
           'quincy': {'capture': 'rounds=4 supersteps p50=282 p90=287 p99=287 max=287 '
                                 'tails>=280: 2',
                      'npz_sha256': {'Mp': 'c51265ddabbdce236a39a59abd7573b162b83a1e5122ccf193f32776058dd8eb',
                                     'active_cap': 'e6a09f376781f14729455ae1cf2e05d8fbc76edd9e23671605939c376d24732c',
                                     'free_0': 'c200602eb8fd26871843a731c1e1983179234ea7f21bbe263a8e75a2f868282e',
                                     'free_1': 'ab9803d8e7c7c441d788cb30d575003e7ee2f66e4bcc4a87be7c37b8bb8ca90d',
                                     'g_e': '47d2543f576cf9e03801e71168536029133c394a48ae0c5a316fe25dd87f1c0e',
                                     'g_pref': '57aee1efdb70506c82c65292fa72c9891c07edc019920a4131dee23b1c8a48fe',
                                     'g_u': '18bcc55dc0ad029d53660f3da523127450a1c07873c35cf5556b7124f68aed65',
                                     'grouped': '12ceaa6bd0c061443528cc7e9f37fdb11e6ad3806f9d321ca8935dbdc50b1e72',
                                     'n': '3d542c565a8cf404b353c49a40c7e2175943338ab69b45b07e5572ba19a9345b',
                                     'n_scale': 'b418762a97348dded7db1c5f761dad977ea3e782b54ea2b9bafe58a7b04a9343',
                                     'ss_0': '05eeff6a9da4a839e0fceba038da189627ac0767ed73f7dc8f4dc702d538e7f3',
                                     'ss_1': '05eeff6a9da4a839e0fceba038da189627ac0767ed73f7dc8f4dc702d538e7f3',
                                     'supply_0': '7a5e4a2188f735ded7b915440c85ffda8c598e6d6c349d8db96049305ceab9dd',
                                     'supply_1': '2755df39f7ebca28faef87dbf427db122bc69e16d2f3aeacc9dc5dd7d6eb6d3f'},
                      'replay': ['inst 0: rows=94 total=100 free=6100 two_stage_ok=True '
                                 'orig_ss=287',
                                 '  two:1:256     : ss=287',
                                 '  two:n4:1024   : ss=121',
                                 '  full:n4:2     : ss=115',
                                 '  full:n:2      : ss=31',
                                 'inst 1: rows=89 total=100 free=6100 two_stage_ok=True '
                                 'orig_ss=287',
                                 '  two:1:256     : ss=287',
                                 '  two:n4:1024   : ss=121',
                                 '  full:n4:2     : ss=115',
                                 '  full:n:2      : ss=31']},
           'whare': {'capture': 'rounds=60 supersteps p50=19 p90=19 p99=51 max=61 tails>=40: 3',
                     'npz_sha256': {'Mp': 'c51265ddabbdce236a39a59abd7573b162b83a1e5122ccf193f32776058dd8eb',
                                    'colcap_0': '993bf710d5f5b7cae79728ac1abe39723300e16d9f9e3876f6006555812388f8',
                                    'colcap_1': '605901d8e0a9b5940cb6e0085e0f1447b47c13e2a3c12e8ecd9a9649b9c32c36',
                                    'colcap_2': 'da297bd07d51c83269f73625f493006229bd2e3a5a8cbc0d8bb0dd44d450caeb',
                                    'discount': '12ceaa6bd0c061443528cc7e9f37fdb11e6ad3806f9d321ca8935dbdc50b1e72',
                                    'n': '556dffc4bb2f17c8d57345cc40fe77e4d572c1590acec9b560654f4ddfdda88e',
                                    'n_scale': 'c51265ddabbdce236a39a59abd7573b162b83a1e5122ccf193f32776058dd8eb',
                                    'preempt': '3e2a673ae9594b60e56b7004349ef5706cb53e6686a2b494e5accfce12f684e6',
                                    'ss_0': '1cb13bde8e48a5df803e7bb9cd21bcb3049cda8beda59b32acd6465397353311',
                                    'ss_1': 'd5eb4361c0f34fa0e7668f6df28bfba62d18068c09673e8f5fd47fef08f22fdf',
                                    'ss_2': '779f279bb43b90d658b524739ac78e9cd2be48dea0b43c8fbe3cfebdf04f7ded',
                                    'supply_0': '1d4adf259fd355c615a7601a007fecb7e7b4d0e04fb29e116076e87317f25d48',
                                    'supply_1': '6e87acbb7a824451233f2e4848a74325c6330cc880e6fac45e5ad488a6e7f2c2',
                                    'supply_2': 'efcb18468c80df8b9110dfe86b4d639d66cdaea66eb47bcb9c5422eb8be30fff',
                                    'w_0': '315f1d1275ef46f47e085a2dcd7c76c998f646ceb9c7805c80fce6c69db7ffbe',
                                    'w_1': '99b7055bd1393464577f360cae37ac43c64c4459fc50455a96a916118286b071',
                                    'w_2': '9bbf907418eebbb1b51cf3f7895929e872106d898d688588301456a14cef8582'},
                     'replay': ['instance 0: C=4 M=1000 supply=[53, 42, 51, 54] '
                                'cap_total=12200 orig_ss=41',
                                '  alpha=2 refine=8: ss=41 conv=True obj=-485311',
                                '  alpha=2 refine=32: ss=41 conv=True obj=-485311',
                                '  alpha=8 refine=8: ss=41 conv=True obj=-485311',
                                '  alpha=8 refine=32: ss=41 conv=True obj=-485311',
                                'instance 1: C=4 M=1000 supply=[40, 64, 49, 47] '
                                'cap_total=12200 orig_ss=61',
                                '  alpha=2 refine=8: ss=61 conv=True obj=-484874',
                                '  alpha=2 refine=32: ss=61 conv=True obj=-484874',
                                '  alpha=8 refine=8: ss=61 conv=True obj=-484874',
                                '  alpha=8 refine=32: ss=61 conv=True obj=-484874',
                                'instance 2: C=4 M=1000 supply=[58, 52, 37, 53] '
                                'cap_total=12200 orig_ss=44',
                                '  alpha=2 refine=8: ss=44 conv=True obj=-484439',
                                '  alpha=2 refine=32: ss=44 conv=True obj=-484439',
                                '  alpha=8 refine=8: ss=44 conv=True obj=-484439',
                                '  alpha=8 refine=32: ss=44 conv=True obj=-484439']}}}

#: the bench phase's values, from bench.py's functions on the CPU with
#: the same arguments (tests/torch_bench_reference.py): per run its
#: metric up to the platform and every detail field but the chunk walls
#: and the latency model (mcmf-mega: the graph and each backend's
#: supersteps)
REF_BENCH = {'10kx1k': {'detail': {'floor_bar_ms': 0.0,
                       'live_final': 9993,
                       'placed_per_round_mean': 100.0,
                       'rounds_per_chunk': 64,
                       'supersteps_max': 0,
                       'supersteps_p50': 0,
                       'supersteps_p99': 0,
                       'top_rounds': [{'round': 511, 'supersteps': 0},
                                      {'round': 510, 'supersteps': 0},
                                      {'round': 509, 'supersteps': 0},
                                      {'round': 508, 'supersteps': 0},
                                      {'round': 507, 'supersteps': 0},
                                      {'round': 506, 'supersteps': 0},
                                      {'round': 505, 'supersteps': 0},
                                      {'round': 504, 'supersteps': 0}]},
            'metric': 'p50 scheduling-round latency, 10000 tasks x 1000 machines, trivial '
                      'cost model, 1% churn, device-resident rounds (64-round chains), '
                      'backend=device'},
 'args': {'10kx1k': {'chunk': 64, 'config': '10kx1k', 'override': [], 'rounds': 512},
          'coco50k': {'chunk': 64, 'config': 'coco50k', 'override': [], 'rounds': 512},
          'coco50k-preempt': {'chunk': 64,
                              'config': 'coco50k-preempt',
                              'override': [],
                              'rounds': 512},
          'mcmf-mega': {'chunk': 64,
                        'config': 'mcmf-mega',
                        'override': ['solves=2'],
                        'rounds': 512}},
 'coco50k': {'detail': {'floor_bar_ms': 0.0,
                        'live_final': 50033,
                        'placed_per_round_mean': 500.0,
                        'rounds_per_chunk': 32,
                        'supersteps_max': 1113,
                        'supersteps_p50': 206,
                        'supersteps_p99': 866,
                        'top_rounds': [{'round': 10, 'supersteps': 1113},
                                       {'round': 12, 'supersteps': 869},
                                       {'round': 14, 'supersteps': 860},
                                       {'round': 15, 'supersteps': 846},
                                       {'round': 11, 'supersteps': 828},
                                       {'round': 17, 'supersteps': 775},
                                       {'round': 7, 'supersteps': 671},
                                       {'round': 8, 'supersteps': 661}]},
             'metric': 'p50 scheduling-round latency, 50000 tasks x 1000 machines, CoCo '
                       'interference cost model (4 classes), 1% churn, device-resident '
                       'rounds (32-round chains), backend=device'},
 'coco50k-preempt': {'detail': {'escalated_rounds': 0,
                                'floor_bar_ms': 0.0,
                                'full_rounds': 17,
                                'global_rounds': 2,
                                'live_final': 50012,
                                'placed_per_round_mean': 500.0,
                                'rounds_per_chunk': 32,
                                'rounds_total': 224,
                                'supersteps_global_max': 4126,
                                'supersteps_max': 4126,
                                'supersteps_p50': 40,
                                'supersteps_p99': 1482,
                                'supersteps_scoped_max': 1477,
                                'supersteps_scoped_p99': 1458,
                                'top_rounds': [{'census_drift': 10015,
                                                'round': 63,
                                                'supersteps': 4126,
                                                'tier': 'global'},
                                               {'census_drift': 5240,
                                                'round': 191,
                                                'supersteps': 2420,
                                                'tier': 'global'},
                                               {'census_drift': 8770,
                                                'round': 47,
                                                'supersteps': 1484,
                                                'tier': 'incremental'},
                                               {'census_drift': 10105,
                                                'round': 35,
                                                'supersteps': 1477,
                                                'tier': 'scoped'},
                                               {'census_drift': 10054,
                                                'round': 99,
                                                'supersteps': 1344,
                                                'tier': 'scoped'},
                                               {'census_drift': 10351,
                                                'round': 7,
                                                'supersteps': 1278,
                                                'tier': 'scoped'},
                                               {'census_drift': 10173,
                                                'round': 21,
                                                'supersteps': 1267,
                                                'tier': 'scoped'},
                                               {'census_drift': 10331,
                                                'round': 185,
                                                'supersteps': 1154,
                                                'tier': 'scoped'}]},
                     'metric': 'p50 scheduling-round latency, 50000 tasks x 1000 machines, '
                               'CoCo interference cost model (4 classes), preemption ON '
                               '(three-tier: budgeted incremental rounds escalating to '
                               'scoped re-solves over drifted columns every 16 or on '
                               'census drift + global re-solve every 128), 1% churn, '
                               'device-resident rounds (32-round chains), backend=device'},
 'mcmf-mega': {'detail': {'arcs': 65536,
                          'csr': 4,
                          'ell': 4,
                          'entries': 131072,
                          'mega': 4,
                          'nodes': 32768,
                          'solves': 2},
               'metric': 'p50 cold-solve latency, general-graph MCMF megakernel vs scan '
                         'backends, 10000 tasks x 1000 machines (32768 nodes, 65536 arcs), '
                         'backend=mega'}}

CLI_TENANTS = ["--tenants", "4", "--podgen", "20000", "-nm", "1000", "--pus-per-core", "4",
               "-mt", "4"]
#: the Makefile's tenant-smoke
TENANT_SOAK = dict(tenants=16, rounds=40, seed=0, chaos_tenant=0)

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

#: the B1/B2 parity phases' plain solves of at most HOST_CELLS cells (C x
#: Mp) run on the CPU, on HOST_WORKERS processes, while the wider ones run
#: on the card. A plain solve is bound by its launches on the host: about
#: 1.2 ms a superstep on the card, and on one CPU core 0.4-0.6 ms below
#: ~8k cells and 0.9-1.8 ms up to ~32k, so the host's cores share out
#: what one process would queue on the card.
HOST_CELLS = 32_768
HOST_WORKERS = 4


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


def plain_on_host(job):
    """One parity case's plain solve on the CPU, in a worker of
    check_parity's pool: (function name in solver/layered.py, its
    positional arguments with arrays as numpy, keyword arguments) ->
    its outputs as numpy arrays."""
    import ksched_tpu_torch.solver.layered as layered

    name, args, kw = job
    torch.set_num_threads(1)
    args = [torch.as_tensor(x) if isinstance(x, np.ndarray) else x for x in args]
    return [o.numpy() for o in getattr(layered, name)(*args, **kw)]


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_parity(dev):
    """The transport kernel against its plain version, both to
    convergence: seeded instances at the main shapes and at the row
    plan's edges, refine 0 and 2, from zero prices and from the prices
    a cold solve carries into a perturbed instance."""
    from ksched_tpu_torch.ops.transport import transport_loop

    cases = [((C, Mp), False, random_instance_m(100 + i, C, Mp)) for i, (C, Mp)
             in enumerate([(2, 128), (4, 1024), (16, 1152), (64, 4096)])]
    cases += [(shape, glob, edge_instance(150 + i, *shape))
              for i, (shape, glob) in enumerate(PLAN_EDGES)]
    rows = []  # (label, kernel's outputs, the plain solve's job)
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
            kw = dict(alpha=8, max_supersteps=50_000, refine_waves=refine)
            with GlobalState(glob):
                cold = transport_loop(*a, eps_full, **kw)
                pm0 = cold[1].clone()
                warm = transport_loop(*a2, n_scale, pm0, **kw)
            rows.append((f"[{C},{Mp}]{where} refine={refine} zero pm0", cold,
                         ("_solve_transport", [*a, eps_full], kw)))
            rows.append((f"[{C},{Mp}]{where} refine={refine} carried pm0", warm,
                         ("_solve_transport", [*a2, n_scale, pm0], kw)))
    return check_parity("parity", rows)


def check_parity(tag, rows):
    """Each row's kernel outputs against its plain solve's: bit-identical
    and converged. A row's job is (function name in solver/layered.py,
    positional arguments, keyword arguments); the solves of at most
    HOST_CELLS cells run on HOST_WORKERS CPU processes (plain_on_host)
    while this process runs the wider ones on the card. Returns the
    largest |kernel - plain|."""
    import multiprocessing as mp

    import ksched_tpu_torch.solver.layered as layered

    def on_host(job):
        return job[1][0].numel() <= HOST_CELLS

    host = [i for i, (_, _, job) in enumerate(rows) if on_host(job)]
    # the longest first, by the kernel's superstep count
    host.sort(key=lambda i: -int(rows[i][1][2]))
    plains = {}
    t0 = time.perf_counter()
    with mp.get_context("spawn").Pool(HOST_WORKERS) as pool:
        pending = {i: pool.apply_async(plain_on_host, (
            (rows[i][2][0], [x.cpu().numpy() if torch.is_tensor(x) else x
                             for x in rows[i][2][1]], rows[i][2][2]),)) for i in host}
        for i, (_, _, (name, args, kw)) in enumerate(rows):
            if i not in pending:
                plains[i] = getattr(layered, name)(*args, **kw)
        t_card = time.perf_counter() - t0
        for i, res in pending.items():
            plains[i] = [torch.from_numpy(x) for x in res.get(timeout=600)]
    worst = 0
    for i, (label, k, _) in enumerate(rows):
        p = plains[i]
        k = [x.to(p[0].device) for x in k]
        err = max_abs_diff(k, p)
        worst = max(worst, err)
        ok = same_bits(k, p) and bool(k[3])
        say(f"{tag} {label}: steps={int(k[2])} converged={bool(k[3])} "
            f"max_abs_err={err} {'bit-identical' if ok else 'MISMATCH'} "
            f"(plain on {p[0].device.type})")
        check(ok, f"{tag}: kernel != plain or no convergence at {label}")
    say(f"{tag}: {len(rows)} solves, each converged and bit-identical to its plain "
        f"version ({sum(int(k[2]) for _, k, _ in rows)} supersteps a side; the plain "
        f"ones: {len(rows) - len(host)} on the card in {t_card:.1f} s, {len(host)} on "
        f"{HOST_WORKERS} CPU processes, {time.perf_counter() - t0:.1f} s in all)")
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
    """The tiered kernel against its plain version, both to convergence,
    on seeded instances with random resident tiles, refine 0 and 8."""
    from ksched_tpu_torch.ops.transport import transport_loop_tiered

    cases = [((C, Mp), False, random_tiered_instance(300 + i, C, Mp)) for i, (C, Mp)
             in enumerate([(2, 128), (4, 1024), (16, 1152), (64, 4096)])]
    cases += [(shape, glob, tiered_from(350 + i, edge_instance(350 + i, *shape)))
              for i, (shape, glob) in enumerate(PLAN_EDGES)]
    rows = []
    for (C, Mp), glob, inst in cases:
        eps_full = int(max(1, np.abs(inst[1]).max()))
        a = on(dev, *inst)
        where = " global" if glob else ""
        for refine in (0, 8):
            kw = dict(alpha=8, max_supersteps=50_000, refine_waves=refine)
            with GlobalState(glob):
                k = transport_loop_tiered(*a, eps_full, **kw)
            rows.append((f"[{C},{Mp}]{where} refine={refine}", k,
                         ("_solve_transport_tiered", [*a, eps_full], kw)))
    return check_parity("tiered parity", rows)


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


def tiered_bound(c):
    """(bytes bound, operations bound) in ms of a captured tiered solve:
    the bytes moved once (wLo, wHi, R, supply, col_cap, eps in; y, pm,
    steps, converged out) against the int32 operations this data needs."""
    wLo, _wHi, _R, _supply, _col_cap, eps = c["args"]
    kw = c["kw"]
    C, Mp = wLo.shape
    steps = int(c["out"][2])
    nbytes = 4 * (4 * C * Mp + C + 2 * Mp + 3)
    phases = eps_phases(eps, kw.get("alpha", 8))
    per_phase = (OPS_PER_CELL_PHASE_TIERED
                 + OPS_PER_CELL_WAVE_TIERED * kw.get("refine_waves", 0))
    return bound_ms(
        nbytes, C * Mp * (OPS_PER_CELL_STEP_TIERED * steps + per_phase * phases))


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
        b_bytes, b_ops = tiered_bound(c)
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
    the host, then its first CHUNKS chunks of windows replayed by
    replay_chunks (chunks of 256, seeds 1, 2), every count set to 0 just before each chunk and read just
    after it. Per chunk its wall (host
    clock, a synchronize on each side), the per-window p50 and p99 (wall
    / windows, and CUDA events around each window), supersteps,
    evictions, transport launches and kernel ms, host reads and decode
    ms; its values and the placements' sha256 after it against the JAX
    package's. Returns the transport solve with the most supersteps of
    each chunk that ran one, and the launches."""
    import ksched_tpu_torch.ops as ops
    import ksched_tpu_torch.scheduler.device_bulk as device_bulk
    from ksched_tpu_torch.drivers.gtrace import (
        CHUNK_WINDOWS,
        CHUNKS,
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
                sha = pu_sha256(cluster)
                check(sha == ref["chunk_pu_sha256"][c], f"{config} chunk {c}: placements "
                      "differ from the JAX package's")
                first, t0 = start()
    finally:
        device_bulk.transport_fori = solver
        del cluster.rank_match_decode, cluster.replay_round
    check(n_chunks == CHUNKS, f"{config}: {n_chunks} chunks replayed")
    say(f"{config}: pu sha256 after chunk {n_chunks - 1} {sha}; transport launches {launches}")
    check_occupancy(cluster, config)
    return worst, launches


def phase_gtrace(dev):
    """gtrace12k and gtrace12k-burst (the closed form: no kernel), then
    gtrace12k-coco (kernel B1 at [4, 12,544] every window); the coco
    cell's solve with the most supersteps in its first chunk re-solved
    by the plain version with the same bits, and timed beside its
    bound."""
    from ksched_tpu_torch.drivers.gtrace import CHUNK_WINDOWS, CHUNKS

    for config in ("gtrace12k", "gtrace12k-burst"):
        _w, n = run_gtrace(dev, config)
        check(n == 0, f"{config} launched a kernel (expected the closed form)")
    worst, n = run_gtrace(dev, "gtrace12k-coco")
    windows = CHUNKS * CHUNK_WINDOWS
    check(n >= windows, f"gtrace12k-coco: {n} transport launches for {windows} windows")
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


#: policies whose transport solves are not re-solved by the plain
#: version: policy-random's two take ≈90 s plain on the card (35,568 and
#: 15,676 supersteps at [186, 128] and [96, 128]), the first cut that
#: keeps the smoke within its time
PLAIN_RESOLVE_CUT = ("policy-random",)


def phase_policies(dev):
    """One service run per host cost model beyond Trivial, Quincy and
    Whare-Map (drivers/service.py POLICY_CONFIGS: BASELINE's round and one round
    of 1% completions and 100 arrivals through make_backend("auto") on
    the card): every round's bound count, placements' sha256, AutoSolver
    path and solver work equal to the JAX package's, its RoundRecord
    phases printed; the transport and mcmf solves they launch counted
    and re-solved by the plain versions with the same bits, but for the
    policies in PLAIN_RESOLVE_CUT. Returns (transport launches, mcmf
    launches, max_abs_err)."""
    import ksched_tpu_torch.ops as ops
    from ksched_tpu_torch.drivers.service import POLICY_CONFIGS, package, run_service
    from ksched_tpu_torch.ops.mcmf import mcmf_loop, mcmf_loop_plain
    from ksched_tpu_torch.ops.transport import transport_loop

    b1 = b3 = worst = 0
    for name, cfg in POLICY_CONFIGS.items():
        transport_loop.launches = mcmf_loop.launches = 0
        with Recorder(ops) as rec1, Recorder(ops, "mcmf_solve") as rec3:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = run_service(package(dev), cfg)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        say_service(name, "sync", got, wall)
        rows = [service_row(r, name) for r in got["rounds"]]
        check(rows == REF_POLICY[name], f"{name}: {rows} != the JAX package's {REF_POLICY[name]}")
        n1, n3 = transport_loop.launches, mcmf_loop.launches
        say(f"{name}: transport launches {n1} (solves {len(rec1.calls)}), mcmf launches "
            f"{n3} (solves {len(rec3.calls)}); kernel_ms transport="
            f"{rec1.kernel_ms():.4f} mcmf={rec3.kernel_ms():.4f}")
        check(n1 == len(rec1.calls) and n3 == len(rec3.calls),
              f"{name}: launches {n1}/{n3} != solves {len(rec1.calls)}/{len(rec3.calls)}")
        b1, b3 = b1 + n1, b3 + n3
        if name in PLAIN_RESOLVE_CUT:
            say(f"{name}: the plain re-solves of its {len(rec1.calls)} transport solves are "
                "cut (their values are held against the JAX package's above)")
            rec1.calls = []
        for i, c in enumerate(rec1.calls):
            err, _ms = resolve_plain(f"{name} transport solve {i}", c, False)
            worst = max(worst, err)
        for i, c in enumerate(rec3.calls):
            plain = mcmf_loop_plain(*c["args"], **c["kw"])
            err = max_abs_diff(c["out"], plain)
            say(f"{name} mcmf solve {i}: R={c['args'][13]} steps={int(c['out'][1])} "
                f"max_abs_err={err} vs plain")
            check(same_bits(c["out"], plain), f"{name} mcmf solve {i}: kernel != plain")
            worst = max(worst, err)
    return b1, b3, worst


def bench_rows(got):
    """run_multitenant_bench's rounds as REF_TENANCY holds them."""
    return [[r["batched"]["sha256"], r["batched"]["supersteps"],
             r["sequential"]["supersteps"], r["batched"]["groups"]] for r in got["rounds"]]


def fleet_rows(got):
    """run_tenant_fleet's rounds as REF_TENANCY holds them."""
    keys = ("bound", "placed", "sha256", "supersteps", "scope", "rung", "noop")
    return [[r["groups"], {t: [v[k] for k in keys] for t, v in r["tenants"].items()}]
            for r in got["rounds"]]


def cli_tenants(argv):
    """cli.main --tenants: each cell's bound count, the rounds and the
    batch flushes from its report."""
    import contextlib
    import io

    from ksched_tpu_torch.cli import main as cli_main
    from ksched_tpu_torch.obs.metrics import Registry, scoped_registry

    err = io.StringIO()
    # a registry of its own: the earlier phases registered the service's
    # families without the tenant label that the cells' scoped views add
    with contextlib.redirect_stderr(err), scoped_registry(Registry()):
        rc = cli_main(argv)
    lines = err.getvalue().splitlines()
    for ln in lines:
        if ln.startswith(("cell", "tenancy:")):
            say(f"cli --tenants: {ln}")
    bound = {ln.split(":")[0]: int(ln.split()[1].split("=")[1])
             for ln in lines if ln.startswith("cell")}
    tail = [ln for ln in lines if ln.startswith("tenancy:") and "rounds" in ln]
    check(tail, "cli --tenants printed no report")
    words = tail[-1].split()
    return {"rc": rc, "bound": bound, "rounds": int(words[1]), "flushes": int(words[3])}


def phase_tenancy(dev, lap):
    """The multi-tenant service on the card (tenancy/, the stacked
    scan-CSR solve in plain PyTorch): bench.py's multitenant at its own
    arguments, both arms, each cell's placements equal across them and
    every round equal to the JAX package's; 4 tenants of BASELINE's
    round through MultiTenantService, every tenant's round equal to the
    JAX package's, and one stacked solve re-run on the CPU with the same
    bits; cli.main --tenants 4; the Makefile's tenant-smoke soak (zero
    cross-tenant interference, each clean tenant equal to its solo run)
    equal to the JAX package's."""
    import argparse

    import ksched_tpu_torch.tenancy.batch as batch_mod
    from ksched_tpu_torch.drivers.multitenant import (
        FleetConfig,
        package,
        run_multitenant_bench,
        run_tenant_fleet,
    )
    from ksched_tpu_torch.drivers.soak import run_tenant_soak, tenant_soak_summary

    got = run_multitenant_bench(package(dev))
    for r, rec in enumerate(got["rounds"]):
        b, q = rec["batched"], rec["sequential"]
        say(f"multitenant round {r}: batched fleet_ms={b['fleet_ms']:.3f} "
            f"groups={b['groups']} stack_supersteps={b['stack_supersteps']} "
            f"stack_reads={b['stack_reads']} lane_supersteps={b['supersteps']}; "
            f"sequential fleet_ms={q['fleet_ms']:.3f} supersteps={q['supersteps']}; "
            f"sha256={b['sha256'][:16]}")
    for arm, st in got["arms"].items():
        cells = st["per_tenant"].values()
        say(f"multitenant {arm}: fleet p50_ms={st['fleet_p50_ms']:.3f} "
            f"p99_ms={st['fleet_p99_ms']:.3f} mean_ms={st['fleet_mean_ms']:.3f} "
            f"supersteps_per_round_p50={st['supersteps_per_round_p50']}; cell p50_ms "
            f"{min(c['p50_ms'] for c in cells):.3f}-{max(c['p50_ms'] for c in cells):.3f}")
    rows = bench_rows(got)
    check(rows == REF_TENANCY["multitenant"], "multitenant rounds differ from the JAX package's")
    lap("tenancy multitenant")

    captured = []
    inner = batch_mod.stacked_solve_fn

    def capture(**statics):
        fn = inner(**statics)

        def run(*args):
            out = fn(*args)
            if not captured and args[0].shape[0] > 1:
                captured.append((statics, [a.clone() for a in args], [o.clone() for o in out]))
            return out

        return run

    batch_mod.stacked_solve_fn = capture
    try:
        got = run_tenant_fleet(package(dev), FleetConfig())
    finally:
        batch_mod.stacked_solve_fn = inner
    for r, rec in enumerate(got["rounds"]):
        say(f"tenant fleet round {r}: wall_ms={rec['wall_ms']:.3f} groups={rec['groups']} "
            f"stack_supersteps={rec['stack_supersteps']} stack_reads={rec['stack_reads']} "
            + " ".join(f"{t}:bound={v['bound']},steps={v['supersteps']},{v['scope']}"
                       for t, v in rec["tenants"].items()))
    for tid, s in sorted(got["service"].tenant_summary().items()):
        say(f"tenant fleet {tid}: p50_ms={s.get('p50_ms', 0):.3f} p99_ms={s.get('p99_ms', 0):.3f}")
    check(fleet_rows(got) == REF_TENANCY["fleet"], "tenant fleet differs from the JAX package's")
    check(captured, "the tenant fleet ran no stacked solve of more than one lane")
    statics, args, out = captured[0]
    cpu = inner(**statics)(*(a.cpu() for a in args))
    check(same_bits([o.cpu() for o in out], cpu),
          "the card's stacked solve differs from the CPU's")
    say(f"tenant fleet: a stacked solve of {args[0].shape[0]} lanes x {args[0].shape[1]} arcs "
        f"({int(out[2].max())} supersteps) equal on the card and the CPU")
    lap("tenancy fleet")

    t0 = time.perf_counter()
    got = cli_tenants(CLI_TENANTS)
    say(f"cli --tenants: {got} in {time.perf_counter() - t0:.3f} s")
    check(got == REF_TENANCY["cli"], f"cli --tenants: {got} != {REF_TENANCY['cli']}")
    lap("tenancy cli")

    t0 = time.perf_counter()
    res = run_tenant_soak(package(dev), argparse.Namespace(**TENANT_SOAK),
                          lambda *a, **k: None)
    got = tenant_soak_summary(res)
    say(f"tenant soak: {TENANT_SOAK} in {time.perf_counter() - t0:.3f} s; checked "
        f"{got['checked']} clean tenants, flushes {got['flushes']}, chaos tenant "
        f"faults={got['tenants']['cell_0']['faults']} "
        f"degradations={got['tenants']['cell_0']['degradations']}")
    check(got == REF_TENANCY["soak"], "tenant soak differs from the JAX package's")
    lap("tenancy soak")


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


# ---------------------------------------------------------------------------
# the multi-device rung (parallel/): D ranks share the one card over gloo
# ---------------------------------------------------------------------------

#: ranks of the sharded phases (one card holds them all, over gloo)
SHARD_RANKS = 2


def rank_sharded(rank, world, args):
    """One rank of the `sharded` phase: bench.py's gtrace100k driver
    (drivers/sharded_scale.py) at REF_PARALLEL's arguments on
    `args["device"]` as the caller names it (the plain "cuda" on the
    card), over the launch's gloo group."""
    from ksched_tpu_torch.drivers.sharded_scale import run_sharded_scale
    from ksched_tpu_torch.parallel.mesh import ShardMesh

    args = dict(args)
    dev = args.pop("device")
    mesh = ShardMesh(None, device=dev)
    t0 = time.perf_counter()
    out = run_sharded_scale(mesh, device=dev, **args)
    out.pop("objects")
    out["wall_s"] = time.perf_counter() - t0
    out["backend"] = mesh.backend
    out["mesh_device"] = str(mesh.device)
    return out


def rank_layered(rank, world, device):
    """One rank of the `sharded-layered` phase: the seeded BulkCluster's
    round through ShardedLayeredSolver, then the tiered instance through
    sharded_transport_solve_tiered, on `device` as the caller names it
    (the plain "cuda" on the card) over gloo."""
    from ksched_tpu_torch.drivers.parallel_scenarios import (
        LAYERED, TIERED, layered_cluster, round_record, tiered_instance)
    from ksched_tpu_torch.parallel.mesh import ShardMesh
    from ksched_tpu_torch.parallel.sharded_transport import (
        ShardedLayeredSolver, sharded_transport_solve_tiered)
    from ksched_tpu_torch.scheduler.bulk import BulkCluster

    mesh = ShardMesh(None, device=device)
    dev = mesh.device
    solver = ShardedLayeredSolver(mesh)
    cluster = layered_cluster(BulkCluster, solver, **LAYERED)
    t0 = time.perf_counter()
    rec = dict(round_record(cluster, cluster.round()), supersteps=int(solver.last_supersteps))
    rec["wall_s"] = time.perf_counter() - t0
    rec["collectives"] = mesh.by_site()
    wLo, wHi, R, sup, cap, eps0 = tiered_instance(**TIERED)
    on_card = [torch.tensor(x, dtype=torch.int32, device=dev) for x in (wLo, wHi, R, sup, cap)]
    mesh.reset_counts()
    t0 = time.perf_counter()
    y, steps, conv = sharded_transport_solve_tiered(
        mesh, *on_card, eps0, refine_waves=TIERED["refine_waves"])
    tiered = {"y_sha256": hashlib.sha256(y.cpu().numpy().tobytes()).hexdigest(),
              "steps": int(steps), "converged": bool(conv),
              "wall_s": time.perf_counter() - t0, "collectives": mesh.by_site()}
    return rec, tiered, mesh.backend, str(mesh.device)


def per_superstep(sites, steps):
    """The collectives of `steps` supersteps per superstep, by kind."""
    out = {}
    for site in ("loop", "superstep"):
        for kind, n in sites.get(site, {}).items():
            out[kind] = out.get(kind, 0) + n
    return {k: round(v / max(steps, 1), 3) for k, v in sorted(out.items())}


def phase_sharded(dev):
    """The sharded rung at the north star's size (drivers/sharded_scale.py,
    bench.py's gtrace100k cut to 10k x 1k): SHARD_RANKS gloo ranks on the
    card run both arms, every round's record (supersteps, converged, path,
    placements, flow and potentials sha256, plan kind, h2d bytes, ring
    sha256) equal across the ranks, to the single-card CsrSolver arm and
    to the JAX package's; the collectives per superstep beside the JAX
    program's 3 psum, 2 pmax, 1 pmin; then one D = 1 solve over NCCL."""
    from ksched_tpu_torch.drivers.sharded_scale import COMPARED
    from ksched_tpu_torch.parallel.launch import run_ranks

    ref = REF_PARALLEL["sharded"]
    args = {k: v for k, v in ref["args"].items() if k != "devices"}
    args["device"] = dev.type  # the entry points' default, "cuda" on the card
    check(ref["args"]["devices"] == SHARD_RANKS, "REF_PARALLEL is for another D")
    got = run_ranks("chip_smoke:rank_sharded", SHARD_RANKS, args, deadline_s=700,
                    timeout_s=300)
    for r, g in enumerate(got):
        check(g["backend"] == "gloo", f"rank {r} on {g['backend']}")
        check(g["mesh_device"] == str(dev), f"rank {r}'s mesh on {g['mesh_device']}")
        check(g["budget"] == ref["budget"] and g["bucket"] == ref["bucket"],
              f"rank {r}: gate {g['budget']} {g['bucket']} != {ref['budget']} {ref['bucket']}")
        for arm in ("scan_csr", "sharded"):
            rows = [{f: rec[f] for f in COMPARED} for rec in g["arms"][arm]]
            for i, (a, b) in enumerate(zip(rows, ref["arms"][arm])):
                check(a == b, f"rank {r} {arm} round {i}: "
                      f"{ {f: (a[f], b[f]) for f in COMPARED if a[f] != b[f]} }")
            check(len(rows) == len(ref["arms"][arm]), f"{arm}: {len(rows)} rounds")
    g = got[0]
    for rec_c, rec_s in zip(g["arms"]["scan_csr"], g["arms"]["sharded"]):
        say(f"sharded round {rec_s['round']} ({rec_s['kind']}): path {rec_s['path']} "
            f"steps {rec_s['supersteps']} converged {rec_s['converged']} "
            f"plan {rec_s['plan_kind']} "
            f"h2d delta bytes so far {rec_s['h2d_delta']} (global), this round's plan "
            f"bytes on rank 0 {rec_s['plan_rank_bytes']} "
            f"wall_ms sharded {rec_s['wall_ms']:.1f} scan_csr {rec_c['wall_ms']:.1f} "
            f"(rank 1 sharded {got[1]['arms']['sharded'][rec_s['round']]['wall_ms']:.1f}) "
            f"sha256 {rec_s['sha256'][:12]}")
    steps = g["measured_supersteps"]
    say(f"sharded collectives over {steps} measured supersteps (rank 0): "
        f"{json.dumps(g['collectives'], sort_keys=True)}")
    say(f"sharded collectives per superstep: {per_superstep(g['collectives'], steps)} "
        "(the JAX program's loop budget: psum 3, pmax 2 at a phase change, pmin 1 "
        "a tightening sweep)")
    check(g["collectives"]["superstep"] == {"psum": 2 * steps},
          f"superstep collectives {g['collectives']['superstep']} != 2 psum x {steps}")
    say(f"sharded: ranks given device {args['device']!r}, meshes on "
        f"{[x['mesh_device'] for x in got]}")
    say(f"sharded: fill_s {json.dumps(g['fill_s'])} rank walls "
        f"{[round(x['wall_s'], 1) for x in got]} s")
    if dev.type == "cuda":
        phase_nccl(dev)


def phase_nccl(dev):
    """One D = 1 sharded solve over NCCL (the backend of one card per
    rank) in this process, every entry point on its default device: the
    mesh's collectives on the card, and the legacy sharded solve equal to
    the single-card CsrSolver's (at D = 1 both order the entries alike)
    on a seeded scheduling graph."""
    import os
    import shutil
    import tempfile

    import torch.distributed as dist

    from ksched_tpu_torch.drivers.synthetic import random_flow_problem
    from ksched_tpu_torch.parallel.mesh import ShardMesh, init_group
    from ksched_tpu_torch.parallel.sharded_solver import ShardedJaxSolver
    from ksched_tpu_torch.solver.csr_solver import CsrSolver

    tmp = tempfile.mkdtemp(prefix="ksched_nccl_")
    try:
        init_group("nccl", 0, 1, f"file://{os.path.join(tmp, 'store')}",
                   timeout_s=120, device="cuda")
        mesh = ShardMesh(None)
        check(mesh.backend == "nccl", f"backend {mesh.backend}")
        check(mesh.device == dev, f"nccl mesh on {mesh.device}, not {dev}")
        x = torch.arange(-5, 7, dtype=torch.int32, device=dev)
        check(torch.equal(mesh.psum(x), x) and torch.equal(mesh.pmax(x), x)
              and torch.equal(mesh.pmin(x), x)
              and torch.equal(mesh.all_gather(x), x[None]), "nccl collectives")
        p = random_flow_problem(np.random.default_rng(0), 40, 4, 3)
        sh = ShardedJaxSolver(mesh, telemetry=0)
        t0 = time.perf_counter()
        a = sh.solve(p)
        wall = time.perf_counter() - t0
        cs = CsrSolver(slot_stable=False, telemetry=0)
        b = cs.solve(p)
        check(np.array_equal(a.flow, b.flow) and a.objective == b.objective
              and sh.last_supersteps == cs.last_supersteps,
              f"nccl D=1: {a.objective}/{sh.last_supersteps} != "
              f"{b.objective}/{cs.last_supersteps}")
        say(f"nccl D=1 sharded solve: objective {a.objective} steps {sh.last_supersteps} "
            f"equal to CsrSolver; wall {wall:.2f} s; collectives {mesh.totals()}")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)


def phase_sharded_layered(dev):
    """The sharded layered transport: the seeded BulkCluster (1,000
    machines, Mp = 1,024, 4 class rows, 10,000 tasks) scheduled through
    ShardedLayeredSolver on SHARD_RANKS gloo ranks and through
    LayeredTransportSolver on the card (the transport kernel), the same
    placements and supersteps on every rank, the card and the JAX
    package; the tiered instance at [4, 1,024] on the ranks, the tiered
    kernel and its plain version, all equal to the JAX package's.
    Returns (the single-card cluster after its round, transport
    launches, captured solves)."""
    import ksched_tpu_torch.ops as ops
    from ksched_tpu_torch.drivers.parallel_scenarios import (
        LAYERED, TIERED, layered_cluster, round_record, tiered_instance)
    from ksched_tpu_torch.ops.transport import transport_loop, transport_loop_tiered
    from ksched_tpu_torch.parallel.launch import run_ranks
    from ksched_tpu_torch.scheduler.bulk import BulkCluster
    from ksched_tpu_torch.solver.layered import (
        LayeredTransportSolver, _solve_transport_tiered)

    ref = REF_PARALLEL["sharded_layered"]
    got = run_ranks("chip_smoke:rank_layered", SHARD_RANKS, dev.type, deadline_s=400,
                    timeout_s=300)
    single = LayeredTransportSolver(device=dev)
    cluster = layered_cluster(BulkCluster, single, **LAYERED)
    transport_loop.launches = 0
    with Recorder(ops) as rec:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = cluster.round()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = transport_loop.launches
    card = dict(round_record(cluster, res), supersteps=int(single.last_supersteps))
    check(card == ref["single"], f"card round {card} != the JAX package's {ref['single']}")
    check(launches == len(rec.calls) and launches >= 1, f"launches {launches}")
    for r, (rr, tiered, backend, mesh_device) in enumerate(got):
        check(backend == "gloo", f"rank {r} on {backend}")
        check(mesh_device == str(dev), f"rank {r}'s mesh on {mesh_device}")
        row = {k: rr[k] for k in card}
        check(row == card, f"rank {r}: {row} != card {card}")
        say(f"sharded-layered rank {r}: steps {rr['supersteps']} wall {rr['wall_s']:.1f} s "
            f"(card {wall:.3f} s, {launches} transport launches) collectives "
            f"{json.dumps(rr['collectives'], sort_keys=True)}")
    wLo, wHi, R, sup, cap, eps0 = tiered_instance(**TIERED)
    on_card = [torch.tensor(x, dtype=torch.int32, device=dev) for x in (wLo, wHi, R, sup, cap)]
    kw = dict(max_supersteps=1 << 17, refine_waves=TIERED["refine_waves"])
    transport_loop_tiered.launches = 0
    kernel = ops.transport_solve_tiered(*on_card, eps0, **kw)
    plain = _solve_transport_tiered(*on_card, eps0, **kw)
    check(transport_loop_tiered.launches == 1, "tiered launches")
    check(same_bits(kernel, plain), "tiered kernel != plain on the sharded instance")
    k_sha = hashlib.sha256(kernel[0].cpu().numpy().tobytes()).hexdigest()
    want = ref["tiered"]
    check({"y_sha256": k_sha, "steps": int(kernel[2]), "converged": bool(kernel[3])}
          == want, f"tiered kernel {k_sha[:12]}/{int(kernel[2])} != the JAX package's {want}")
    for r, (_rr, tiered, _b, _d) in enumerate(got):
        t = {k: tiered[k] for k in want}
        check(t == want, f"rank {r} tiered {t} != {want}")
        say(f"sharded tiered rank {r}: steps {tiered['steps']} wall {tiered['wall_s']:.1f} s "
            f"collectives {json.dumps(tiered['collectives'], sort_keys=True)}")
    say(f"sharded tiered: the tiered kernel and its plain version equal the ranks "
        f"and the JAX package ({want['steps']} supersteps)")
    return cluster, launches, rec.calls


def phase_whatif(dev, cluster):
    """parallel/whatif.py on the scheduled cluster: drain_scenarios over
    16 candidates and surge_scenarios over 8 rows through the transport
    kernel (one launch per scenario of C >= 2), objectives, unscheduled
    counts, converged flags and y equal to the JAX package's; the two
    longest scenario solves re-solved by the plain version with the same
    bits and timed beside their bound. Returns (launches, max_abs_err,
    kernel ms, plain ms, bound ms, bound_by)."""
    import ksched_tpu_torch.ops as ops
    from ksched_tpu_torch.drivers.parallel_scenarios import WHATIF, whatif_inputs
    from ksched_tpu_torch.ops.transport import transport_loop
    from ksched_tpu_torch.parallel.whatif import drain_scenarios, surge_scenarios
    from ksched_tpu_torch.solver.layered import _solve_transport

    machines, surge = whatif_inputs(cluster, **WHATIF)
    transport_loop.launches = 0
    with Recorder(ops) as rec:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results = {"drain": drain_scenarios(cluster, machines, device=dev),
                   "surge": surge_scenarios(cluster, surge, device=dev)}
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = transport_loop.launches
    # one launch per scenario, two where the short eps start is retried
    check(launches == len(rec.calls) >= len(machines) + len(surge),
          f"whatif launches {launches} (solves {len(rec.calls)})")
    for name, res in results.items():
        row = {"objective": [int(x) for x in res.objective],
               "num_unsched": [int(x) for x in res.num_unsched],
               "converged": [bool(x) for x in res.converged],
               "y_sha256": hashlib.sha256(np.ascontiguousarray(res.y).tobytes()).hexdigest()}
        check(row == REF_PARALLEL["whatif"][name],
              f"whatif {name}: {row} != the JAX package's {REF_PARALLEL['whatif'][name]}")
        say(f"whatif {name}: K={len(res.objective)} objective {row['objective']} "
            f"unsched {row['num_unsched']}")
    say(f"whatif: {launches} transport launches in {wall:.3f} s wall, supersteps "
        f"{[int(c['out'][2]) for c in rec.calls]}")
    picked = sorted(range(len(rec.calls)), key=lambda i: -int(rec.calls[i]["out"][2]))[:2]
    worst = 0
    tot_k = tot_p = tot_b = 0.0
    by = {"bytes": 0.0, "operations": 0.0}
    for i in picked:
        c = rec.calls[i]
        err, _ms = resolve_plain(f"whatif transport solve {i}", c, False)
        worst = max(worst, err)
        wS, supply, col_cap, eps, *rest = c["args"]
        b_bytes, b_ops = transport_bound(c)
        k_ms = timed_ms(lambda: ops.transport_solve(wS, supply, col_cap, eps, *rest,
                                                    **c["kw"]), 5)
        p_ms = timed_ms(lambda: _solve_transport(wS, supply, col_cap, eps, *rest,
                                                 **c["kw"]), 1)
        steps = int(c["out"][2])
        say(f"timing whatif solve {i} [{wS.shape[0]},{wS.shape[1]}] steps={steps}: "
            f"kernel_ms={k_ms:.4f} plain_ms={p_ms:.3f} bound_ms={max(b_bytes, b_ops):.6f} "
            f"kernel_us_per_step={1e3 * k_ms / max(steps, 1):.3f}")
        tot_k, tot_p, tot_b = tot_k + k_ms, tot_p + p_ms, tot_b + max(b_bytes, b_ops)
        by["bytes"] += b_bytes
        by["operations"] += b_ops
    return launches, worst, tot_k, tot_p, tot_b, max(by, key=by.get)


# ---------------------------------------------------------------------------
# the operator tools: drivers/soak.py's device soak, ksched_tpu_torch/tools/
# ---------------------------------------------------------------------------

#: the smoke's tool arguments (tests/torch_tools_reference.py's, read back
#: from REF_TOOLS["args"] and held equal there)
TOOL_SOAK = ["--tasks", "20000", "--machines", "500", "--preempt", "--rounds", "512",
             "--chunk", "128", "--checkpoint-every", "2"]


def reset_transport_launches():
    from ksched_tpu_torch.ops.transport import transport_loop, transport_loop_tiered

    transport_loop.launches = 0
    transport_loop_tiered.launches = 0


def transport_launches():
    from ksched_tpu_torch.ops.transport import transport_loop, transport_loop_tiered

    return transport_loop.launches, transport_loop_tiered.launches


def phase_device_soak(dev):
    """drivers/soak.py's device soak at tools/soak.py's 20,000 tasks on
    500 machines, --preempt, 512 rounds in chunks of 128 with a
    checkpoint round trip every 2 chunks (the soak continues on the
    restored cluster): every chunk's line equal to the JAX tool's, the
    wall per round, and the launches of B1 (incremental rounds) and B2
    (tiered re-solves). Returns (B1 launches, B2 launches)."""
    from ksched_tpu_torch.drivers.soak import bulk_soak_summary, parse_args, run_bulk_soak

    check(REF_TOOLS["args"]["soak"] == TOOL_SOAK, "REF_TOOLS is for other soak arguments")
    args = parse_args(TOOL_SOAK + ["--device", dev.type])
    reset_transport_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = run_bulk_soak(args, lambda *a, **k: say("  device soak:", *a))
    wall = time.perf_counter() - t0
    b1, b2 = transport_launches()
    got = bulk_soak_summary(res)
    for i, (a, b) in enumerate(zip(got, REF_TOOLS["soak"])):
        check(a == b, f"device soak line {i}: {a!r} != the JAX tool's {b!r}")
    check(len(got) == len(REF_TOOLS["soak"]), f"device soak: {len(got)} lines")
    check(b1 >= 1 and b2 >= 1, f"device soak launches B1 {b1} B2 {b2}")
    say(f"device soak: {res['rounds']} rounds, {res['checkpoints']} checkpoint round "
        f"trips, {wall:.3f} s wall, {1e3 * wall / res['rounds']:.3f} ms a round (the "
        f"invariant fetches and round trips included); launches B1 {b1}, B2 {b2}; "
        f"every chunk equal to the JAX tool's")
    return b1, b2


#: the smoke's captures (tools/tail_repro.py's full configs): rounds and
#: thresholds that keep two or three tails, and each capture's replay
TOOL_TAILS = {
    "whare": dict(rounds=60, threshold=40, replay="replay", alpha="2,8", refine="8,32"),
    "coco-preempt": dict(rounds=4, threshold=5000, replay="replay-tiered", refine="0,8"),
    "quincy": dict(rounds=4, threshold=280, replay="replay-grouped",
                   strategies="two:1:256,two:n4:1024,full:n4:2,full:n:2"),
}


def npz_sha256(path) -> dict:
    """sha256 of each array of an npz, by key (dtype and shape included)."""
    data = np.load(path)
    return {k: hashlib.sha256(
        f"{data[k].dtype}{data[k].shape}".encode() + np.ascontiguousarray(data[k]).tobytes()
    ).hexdigest() for k in sorted(data.files)}


def phase_tails(dev):
    """tools/tail_repro.py on the card: for whare (B1), coco-preempt (B2)
    and quincy (group mode, B1) at the tool's full sizes, the capture loop
    (each round driven from the host, its pre-solve instance kept when
    its supersteps reach the threshold), the capture line and every npz
    array equal to the JAX tool's; then the capture's replay (`replay`
    over alpha x refine, `replay-tiered` over eps0 x refine,
    `replay-grouped` over its strategies), every point's line equal to
    the JAX tool's, each replayed solve's supersteps and kernel ms
    printed, and the cheapest replayed solve re-solved by the plain
    version with the same bits and timed beside its bound. Returns (B1
    launches, B2 launches, max_abs_err, per kernel [kernel ms, plain ms,
    bound ms] of the re-solved solves)."""
    import argparse
    import os
    import tempfile

    import ksched_tpu_torch.ops as ops
    from ksched_tpu_torch.tools import tail_repro

    check(REF_TOOLS["args"]["tails"] == TOOL_TAILS, "REF_TOOLS is for other captures")
    replays = {"replay": tail_repro.replay, "replay-tiered": tail_repro.replay_tiered,
               "replay-grouped": tail_repro.replay_grouped}
    b1 = b2 = worst = 0
    timing = {"transport": [0.0, 0.0, 0.0], "transport_tiered": [0.0, 0.0, 0.0]}
    with tempfile.TemporaryDirectory() as td:
        for name, spec in TOOL_TAILS.items():
            want = REF_TOOLS["tails"][name]
            reset_transport_launches()
            t0 = time.perf_counter()
            cluster, tasks, groups = tail_repro.build_config(name, device=dev)
            insts, ss_all = tail_repro.capture_rounds(cluster, tasks, spec["rounds"],
                                                      spec["threshold"], groups=groups)
            torch.cuda.synchronize()
            cap_s = time.perf_counter() - t0
            line = tail_repro.capture_summary(ss_all, spec["threshold"], len(insts))
            say(f"tails {name} capture: {line} in {cap_s:.3f} s "
                f"({1e3 * cap_s / spec['rounds']:.3f} ms a captured round, the build, "
                f"fill and host churn included); launches {transport_launches()}")
            check(line == want["capture"], f"tails {name}: {line!r} != {want['capture']!r}")
            path = os.path.join(td, f"{name}.npz")
            np.savez_compressed(path, **tail_repro.instances_npz(cluster, insts,
                                                                 groups is not None))
            check(npz_sha256(path) == want["npz_sha256"],
                  f"tails {name}: the npz differs from the JAX tool's")
            c1, c2 = transport_launches()
            tiered = spec["replay"] == "replay-tiered"
            entry = "transport_solve_tiered" if tiered else "transport_solve"
            kw = {k: v for k, v in spec.items() if k in ("alpha", "refine", "strategies")}
            lines = []
            reset_transport_launches()
            with Recorder(ops, entry) as rec:
                t0 = time.perf_counter()
                replays[spec["replay"]](argparse.Namespace(inst=path, device=str(dev), **kw),
                                        lambda s, **k: lines.append(s))
                torch.cuda.synchronize()
                rep_s = time.perf_counter() - t0
            r1, r2 = transport_launches()
            for i, (a, b) in enumerate(zip(lines, want["replay"])):
                check(a == b, f"tails {name} {spec['replay']} line {i}: {a!r} != {b!r}")
            check(len(lines) == len(want["replay"]), f"tails {name}: {len(lines)} lines")
            check(len(rec.calls) == r1 + r2 >= 1, f"tails {name}: launches {r1} {r2}")
            for ln in lines:
                say(f"  tails {name} {spec['replay']}: {ln.strip()}")
            say(f"tails {name} {spec['replay']}: {len(rec.calls)} solves in {rep_s:.3f} s, "
                "kernel ms / supersteps: "
                + ", ".join(f"{c['events'][0].elapsed_time(c['events'][1]):.3f}/"
                            f"{int(c['out'][2])}" for c in rec.calls))
            b1, b2 = b1 + c1 + r1, b2 + c2 + r2
            i = min(range(len(rec.calls)), key=lambda j: int(rec.calls[j]["out"][2]))
            c = rec.calls[i]
            err, p_ms = resolve_plain(f"tails {name} replayed solve {i}", c, tiered)
            worst = max(worst, err)
            b_bytes, b_ops = tiered_bound(c) if tiered else transport_bound(c)
            k_ms = timed_ms(lambda: getattr(ops, entry)(*c["args"], **c["kw"]), 5)
            steps = int(c["out"][2])
            say(f"timing tails {name} solve {i} {list(c['args'][0].shape)} steps={steps}: "
                f"kernel_ms={k_ms:.4f} plain_ms={p_ms:.3f} "
                f"bound_ms={max(b_bytes, b_ops):.6f} (bytes {b_bytes:.6f}, operations "
                f"{b_ops:.6f}) kernel_us_per_step={1e3 * k_ms / max(steps, 1):.3f}")
            t = timing["transport_tiered" if tiered else "transport"]
            t[0], t[1], t[2] = t[0] + k_ms, t[1] + p_ms, t[2] + max(b_bytes, b_ops)
    return b1, b2, worst, timing


def phase_profile_round(dev):
    """tools/profile_round.py on the card at its 10k tasks x 1k machines x
    4 PUs x 4 slots: the launch floor (64 trivial launches and one
    synchronize), one synchronize's round trip and the sustained steady
    round (64 chained rounds over their wall), each an obs span; each
    timed chain's stats equal to the JAX package's for the same round
    sequence; the session's Chrome trace rendered by tools/obs_report.py.
    Returns (B1 launches, B2 launches)."""
    import os
    import tempfile

    from ksched_tpu_torch.tools import obs_report, profile_round

    reset_transport_launches()
    out = profile_round.profile(str(dev), log=say)
    launches = transport_launches()
    check(out["converged"], "profile_round: a chained round did not converge")
    check(out["chunks_sha256"] == REF_TOOLS["profile"],
          "profile_round: the timed chains' stats differ from the JAX package's")
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "profile_round_trace.json")
        out["tracer"].dump(path)
        lines = []
        obs_report.load_and_report(path, log=lambda *a, **k: lines.append(" ".join(a)))
    for ln in lines:
        say(f"  profile_round trace: {ln}")
    check(any(ln.startswith("steady_chunk ") for ln in lines), "obs_report: no steady_chunk")
    say(f"profile_round: launch floor {out['launch_us']:.3f} us a launch, one synchronize's "
        f"round trip {1e3 * out['sync_round_trip_ms']:.3f} us, steady round "
        f"{out['steady_round_us']:.3f} us ({out['steady_chunk_ms']:.3f} ms a chain of "
        f"{out['rounds']}); launches B1 {launches[0]}, B2 {launches[1]}")
    return launches


def phase_shard_smoke(dev):
    """ksched_tpu_torch/tools/shard_smoke.py at the Makefile's arguments on
    SHARD_RANKS gloo ranks sharing the card: the scan-CSR reference, the
    sharded arm (placements equal every round, delta-sized plan syncs
    after warm-up) and chaos containment on the sharded -> jax -> cpu_ref
    ladder (twin runs alike), each arm's placements, plan syncs,
    degradations, fault snapshot and landing rungs equal on both ranks
    and to the JAX tool's arms on 2 virtual devices."""
    from ksched_tpu_torch.parallel.launch import run_ranks
    from ksched_tpu_torch.tools.shard_smoke import MAKEFILE

    check(REF_TOOLS["args"]["shard"] == dict(MAKEFILE, devices=SHARD_RANKS),
          "REF_TOOLS is for other shard-smoke arguments")
    got = run_ranks("ksched_tpu_torch.tools.shard_smoke:rank_smoke", SHARD_RANKS,
                    dict(MAKEFILE, verbose=False, device=dev.type), deadline_s=600,
                    timeout_s=300)
    for r, g in enumerate(got):
        check(g["backend"] == "gloo", f"rank {r} on {g['backend']}")
        for arm in ("scan_csr", "sharded", "chaos"):
            check(g[arm] == REF_TOOLS["shard"][arm],
                  f"shard smoke rank {r} {arm}: {g[arm]} != the JAX tool's")
    for ln in got[0]["log"]:
        say(f"  shard smoke: {ln}")
    say(f"shard smoke: {SHARD_RANKS} ranks equal to each other and to the JAX tool's "
        f"arms; rank walls {[round(g['wall_s'], 3) for g in got]} s")


# ---------------------------------------------------------------------------
# python -m ksched_tpu_torch.bench: the timed protocol on the card
# ---------------------------------------------------------------------------

#: the bench phase's runs, (config, --rounds, --chunk, --override), as
#: tests/torch_bench_reference.py runs bench.py: the headline at its
#: defaults, coco50k and coco50k-preempt at their own budgets (128
#: rounds in chunks of 32; --rounds does not govern them), mcmf-mega at 2
#: timed solves a backend
BENCH_RUNS = (("10kx1k", 512, 64, []), ("coco50k", 512, 64, []),
              ("coco50k-preempt", 512, 64, []), ("mcmf-mega", 512, 64, ["solves=2"]))
#: the kernel each run must launch (transport, transport_tiered, mcmf),
#: and the one it must not
BENCH_KERNELS = {"10kx1k": (), "coco50k": ("transport",),
                 "coco50k-preempt": ("transport", "transport_tiered"), "mcmf-mega": ("mcmf",)}
#: a record's timed detail fields: the chunk walls and their fit
BENCH_TIMED = ("chunks_wall_ms", "latency_model")


def bench_untimed(rec):
    """A bench record's values that do not depend on the clock, as
    tests/torch_bench_reference.py reads them."""
    metric = rec["metric"].rsplit("/", 1)[0]
    d = rec["detail"]
    if rec.get("config") == "mcmf-mega":
        keep = {k: d[k] for k in ("nodes", "arcs", "entries", "solves")}
        keep.update({b: d[b]["supersteps"] for b in ("mega", "csr", "ell") if b in d})
        return {"metric": metric, "detail": keep}
    return {"metric": metric, "detail": {k: v for k, v in d.items() if k not in BENCH_TIMED}}


def phase_bench(dev):
    """`python -m ksched_tpu_torch.bench`'s configs in-process on the card
    (bench.run_config, the CLI's path): the headline 10kx1k (the closed
    form: no kernel), coco50k (B1), coco50k-preempt (B1 and B2, the
    two-regime latency fit) and mcmf-mega (B3, CSR and ELL cold solves);
    per run its wall, p50, chunk walls and latency model printed, every
    count set to 0 just before it; its non-timing values equal to
    bench.py's (REF_BENCH); coco50k's longest B1 solve and a B3 cold
    solve of mcmf-mega's graph (launched after the counts were read)
    re-solved by the plain versions with the same bits.
    Returns ((B1, B2, B3) launches over the phase, max_abs_err)."""
    import ksched_tpu_torch.ops as ops
    from ksched_tpu_torch import bench
    from ksched_tpu_torch.ops.mcmf import mcmf_loop, mcmf_loop_plain
    from ksched_tpu_torch.ops.transport import transport_loop, transport_loop_tiered

    check(REF_BENCH is not None and REF_BENCH["args"] == {
        name: dict(config=name, rounds=r, chunk=c, override=ov)
        for name, r, c, ov in BENCH_RUNS}, "REF_BENCH is for other bench runs")
    total = [0, 0, 0]
    worst = 0
    for name, rounds, chunk, ov in BENCH_RUNS:
        transport_loop.launches = transport_loop_tiered.launches = mcmf_loop.launches = 0
        # coco50k's B1 solves are captured as they run (a [4, 1024]
        # clone a round); mcmf-mega's timed solves run uncaptured
        with Recorder(ops, "transport_solve") as rec1:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = bench.run_config(name, rounds, chunk, ov, device=dev)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        counts = (transport_loop.launches, transport_loop_tiered.launches,
                  mcmf_loop.launches)
        d = out["detail"]
        lm = d.get("latency_model", {})
        say(f"bench {name}: {wall:.2f} s, p50 {out['value']} ms, chunks "
            f"{d.get('chunks_wall_ms')} ms of {d.get('rounds_per_chunk')} rounds, "
            f"latency model {json.dumps(lm)}; launches B1 {counts[0]} B2 {counts[1]} "
            f"B3 {counts[2]}; {out['metric']}")
        if name == "mcmf-mega":
            say("bench mcmf-mega: " + ", ".join(
                f"{b} {d[b]['p50_ms']} ms ({d[b]['supersteps']} supersteps)"
                for b in ("mega", "csr", "ell")) + f"; mega vs csr {d['mega_vs_csr_speedup']}x")
        check(out["metric"].endswith("backend=device/cuda")
              or out["metric"].endswith("backend=mega/cuda"), f"bench {name}: not on the card")
        check(bench_untimed(out) == REF_BENCH[name],
              f"bench {name}: {bench_untimed(out)} != bench.py's {REF_BENCH[name]}")
        want = BENCH_KERNELS[name]
        for k, n in zip(("transport", "transport_tiered", "mcmf"), counts):
            check((n > 0) == (k in want), f"bench {name}: {n} {k} launches")
        if name == "coco50k":
            pick = max(rec1.calls, key=lambda c: int(c["out"][2]))
            err, _ms = resolve_plain("bench coco50k longest B1 solve", pick, False)
            k_ms = pick["events"][0].elapsed_time(pick["events"][1])
            say(f"  (kernel_ms of that solve in the run: {k_ms:.4f}, "
                f"{1e3 * k_ms / max(int(pick['out'][2]), 1):.3f} us a superstep)")
            worst = max(worst, err)
        if name == "mcmf-mega":
            # one more cold solve of the run's graph, captured, after the
            # counts were read
            from ksched_tpu_torch.tools.mega_bench import build_problem, launchers

            launch, _s, _c = launchers(build_problem(), 4096, ("mega",), dev)["mega"]
            with Recorder(ops, "mcmf_solve") as rec3:
                launch()
            c = rec3.calls[0]
            plain = mcmf_loop_plain(*c["args"], **c["kw"])
            torch.cuda.synchronize()
            err = max_abs_diff(c["out"], plain)
            say(f"bench mcmf-mega B3 solve: R={c['args'][13]} steps={int(c['out'][1])} "
                f"max_abs_err={err} vs plain")
            check(same_bits(c["out"], plain), "bench mcmf-mega: kernel != plain")
            worst = max(worst, err)
        total = [a + b for a, b in zip(total, counts)]
    return tuple(total), worst


# ---------------------------------------------------------------------------
# the static-analysis suite on the card
# ---------------------------------------------------------------------------

#: the programs whose op-trace contracts the analysis phase records on
#: CUDA tensors, against the pins tier-1 reads on the CPU
ANALYSIS_PROGRAMS = ("mega_solve", "layered_solve", "csr_solve", "delta_apply")


def phase_analysis(dev, build_log):
    """Phase 1b: the lint and its coverage over this checkout, every card
    check of the engine (each kernel's resources against its pins, B3's
    grid gate and measured live set, the launching routes, the in-place
    appliers' memory), and the op-trace contracts and hash pins of
    ANALYSIS_PROGRAMS on CUDA tensors. Any contract failure fails the
    run."""
    from ksched_tpu_torch.analysis import engine
    from ksched_tpu_torch.analysis.__main__ import main as lint_main
    from ksched_tpu_torch.analysis.program_registry import KERNELS, PROGRAMS

    t0 = time.perf_counter()
    check(lint_main(["--coverage"]) == 0, "kschedlint-torch --coverage found problems")

    def run(name, what, fn):
        try:
            return fn(PROGRAMS[name], dev)
        except engine.ContractError as e:
            raise Failed(f"analysis {what}: {e}") from None

    for name in ("layered_solve", "mega_solve"):
        for kernel, variants in run(name, "kernel resources",
                                    engine.check_kernel_resources).items():
            for variant, a in variants.items():
                say(f"  kernel {kernel} {variant}: registers {a['registers']}, spill "
                    f"(local) {a['local_bytes']} B, static shared {a['shared_bytes']} B, "
                    f"max threads {a['max_threads']}, co-resident blocks "
                    f"{a['blocks_per_sm']}/SM")
            for line in build_log.get(kernel, "").splitlines():
                if "registers" in line or "spill" in line:
                    say(f"    ptxas {kernel}: {line.strip()}")
        for kernel, r in run(name, "kernel route", engine.check_kernel_route).items():
            say(f"  route {kernel}: one launch a solve, {r['ops']} torch calls for "
                f"{r['supersteps'][0]} and {r['supersteps'][1]} supersteps")
    g = run("mega_solve", "grid gate", engine.check_grid_gate)
    say(f"  mcmf grid gate: largest admitted E={g['largest_entries']} on "
        f"{g['largest_blocks']} blocks (most asked {g['most_blocks']}; co-resident "
        f"{g['sms']} SMs x {g['blocks_per_sm']}), its launch accepted")
    ls = run("mega_solve", "live set", engine.check_live_set)
    say(f"  mcmf live set at E={ls['entries']}: measured {ls['measured_bytes']} B "
        f"({ls['tables']:.2f} tables), mega_fits reckons {ls['reckoned_bytes']} B "
        f"(+{ls['slack_bytes']} B slack)")
    for name, spec in PROGRAMS.items():
        if "inplace_memory" in engine.applicable_card_checks(spec):
            m = run(name, "in-place memory", engine.check_inplace_memory)
            say(f"  {name} in place: peak growth {m['growth_bytes']} B, new outputs "
                f"{m['new_output_bytes']} B, smallest in-place buffer "
                f"{m['smallest_buffer']} B")
    for name in ANALYSIS_PROGRAMS:
        spec = PROGRAMS[name]
        run(name, "contracts", engine.check_default_call)
        run(name, "hash pin", engine.check_hash_pin)
        rep = engine.report(spec, device=dev)
        say(f"  {name} on {dev}: trace {rep.trace_hash} (pinned "
            f"{spec.telemetry_off_hash or '-'}), int64 calls {sum(rep.wide.values())}, "
            f"scatters {dict(rep.scatters)}, host reads a superstep "
            f"{sorted(rep.reads_by_kind.get('superstep', ()))}")
    check(len(KERNELS) == 3, f"{len(KERNELS)} kernels registered")
    say(f"analysis: {len(PROGRAMS)} programs, {len(KERNELS)} kernels checked in "
        f"{time.perf_counter() - t0:.1f} s")


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

    phase_analysis(dev, build_mod.build.log)
    lap("analysis")

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
    pol_b1, pol_b3, pol_err = phase_policies(dev)
    lap("policies")
    say(f"launches on the policies path: transport {pol_b1}, mcmf {pol_b3}")
    phase_tenancy(dev, lap)
    phase_sharded(dev)
    lap("sharded")
    w_cluster, sl_b1, _sl_calls = phase_sharded_layered(dev)
    lap("sharded-layered")
    wi_b1, wi_err, wi_k, wi_p, wi_b, _wi_by = phase_whatif(dev, w_cluster)
    lap("whatif")
    say(f"transport launches: sharded-layered single-card arm {sl_b1}, whatif {wi_b1}")
    so_b1, so_b2 = phase_device_soak(dev)
    lap("device soak")
    ta_b1, ta_b2, ta_err, ta_timing = phase_tails(dev)
    lap("tails")
    pr_b1, pr_b2 = phase_profile_round(dev)
    lap("profile_round")
    phase_shard_smoke(dev)
    lap("shard smoke")
    (be_b1, be_b2, be_b3), be_err = phase_bench(dev)
    lap("bench")
    say(f"launches on the bench path: B1 {be_b1}, B2 {be_b2}, B3 {be_b3}")
    say(f"launches on the tool paths: device soak B1 {so_b1} B2 {so_b2}, tails B1 {ta_b1} "
        f"B2 {ta_b2}, profile_round B1 {pr_b1} B2 {pr_b2}; the re-solved tail solves "
        f"[kernel ms, plain ms, bound ms]: {json.dumps(ta_timing)}")

    kernels = [{
        "name": "transport",
        "route": "cuda",
        "source": "ksched_tpu_torch/ops/csrc/transport.cu",
        "replaces": "ksched_tpu/ops/transport_pallas.py:59",
        "launches": (launches + g_b1 + s_launches + pol_b1 + sl_b1 + wi_b1 + so_b1 + ta_b1
                     + pr_b1 + be_b1),
        "max_abs_err": max(parity_err, main_err, tier_err, q_err, g_err, mb_err, s_err,
                           pol_err, wi_err, ta_err, be_err),
        "ms": k_ms + g_k + s_k + wi_k,
        "plain_ms": p_ms + g_p + s_p + wi_p,
        "bound_ms": b_ms + g_b + s_b + wi_b,
        "bound_by": bound_by,
        "library_ms": None,
    }, {
        "name": "transport_tiered",
        "route": "cuda",
        "source": "ksched_tpu_torch/ops/csrc/transport_tiered.cu",
        "replaces": "ksched_tpu/ops/transport_pallas.py:233",
        "launches": t_launches + so_b2 + ta_b2 + pr_b2 + be_b2,
        "max_abs_err": max(t_err, t_main_err, tier_err, ta_err),
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
        "launches": m_launches + mr_launches + pol_b3 + be_b3,
        "max_abs_err": max(m_err, m_main_err, mr_err, pol_err, be_err),
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
