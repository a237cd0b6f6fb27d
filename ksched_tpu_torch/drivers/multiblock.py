"""quincy10k-multiblock: Quincy beyond the maximally-compressive case.

ksched_tpu's bench.py config (`_quincy_multiblock_bench`,
bench.py:1846-2090, and its compression-loss oracle
`_multiblock_quality_probe`, bench.py:2091-2202), with bench.py's
arguments, all drawn from one default_rng(7) in bench.py's order:
tasks read 2-3 blocks each (a task's signature is the SET of its
blocks), drawn from a skewed template pool larger than the group table,
with fresh templates arriving between chunks — so the scenario
exercises signature diversity, overflow, and LRU eviction
(QuincyGroupTable.evict_idle) rather than the one-block-per-task regime
of quincy10k.

The scenario: 480 blocks of heavy-tailed sizes (128 MB .. 4 GB) on 3
machines each, 640 templates of 2-3 blocks with popularity 1 / k^0.8,
10k tasks on 1,000 machines x 4 PUs x 4 slots in G = 1024 groups (64 MB
cost units, 128 MB signature units), the compaction ladder (128, 256,
512) with the quarter-eps stage 1, decode width 2048. The fill, then
chunks of steady rounds (100 arrivals, 1% churn, the JAX package's
draws), each after `maintain_table` (evict idle signatures, 32 fresh
templates, re-sync, restrict arrivals to the registered groups), then
the quality probe: for 8 synthetic backlogs of 200 tasks, the capped
table's solve against the exact full-diversity solve, both priced at
the tasks' true costs. bench.py runs a warm-up and a probe chunk (seed
1) before its timed chunks; this scenario runs only the chunks.
"""

from __future__ import annotations

import hashlib

import numpy as np

from ..costmodels.quincy import MB, PREFERENCE_FRACTION
from ..costmodels.quincy_device import QuincyGroupTable, _transfer_cost
from ..scheduler.device_bulk import DeviceBulkCluster
from ..solver.layered import LayeredProblem, LayeredTransportSolver
from ..utils import next_pow2

#: bench.py's sizes
FULL = dict(tasks=10_000, machines=1_000, pus=4, slots=4, jobs=10, n_blocks=480,
            num_groups=1024, n_templates=640, caps=(128, 256, 512),
            decode_width=2048, churn_n=100)
CHURN = 0.01
#: chunks of steady rounds and their rounds, as the card smoke runs them
CHUNKS, CHUNK_ROUNDS, FIRST_SEED = 3, 32, 2


class Multiblock:
    """The scenario's state: the rng, the group table, the templates and
    their popularity, and the cluster (on `device`, the card by default).
    Construction makes bench.py's draws up to the fill's admissions."""

    def __init__(self, device="cuda", **sizes):
        z = dict(FULL, **sizes)
        self.sizes = z
        self.rng = rng = np.random.default_rng(7)
        n_blocks, machines = z["n_blocks"], z["machines"]
        self.table = QuincyGroupTable(num_groups=z["num_groups"], num_machines=machines,
                                      cost_unit_mb=64, sig_unit_mb=128)
        block_sizes = np.minimum(
            (128 * MB * np.exp(rng.exponential(1.2, n_blocks))).astype(np.int64),
            4096 * MB)
        for b in range(1, n_blocks + 1):
            self.table.blocks.register(
                b, int(block_sizes[b - 1]),
                rng.choice(machines, size=3, replace=False).tolist())
        n_templates = z["n_templates"]
        self.templates = [self.new_template() for _ in range(n_templates)]
        popularity = 1.0 / np.arange(1, n_templates + 1) ** 0.8
        self.popularity = popularity / popularity.sum()
        self.cluster = DeviceBulkCluster(
            num_machines=machines, pus_per_machine=z["pus"], slots_per_pu=z["slots"],
            num_jobs=z["jobs"], task_capacity=next_pow2(z["tasks"] + 4096),
            num_groups=z["num_groups"], supersteps=1 << 17,
            decode_width=z["decode_width"], active_groups_cap=z["caps"],
            two_stage_eps0="quarter", device=device)
        self.init_groups, _ = self.draw_groups(z["tasks"])
        self.table.sync(self.cluster)
        self.signatures_initial = len(self.table._sig2gid)

    def new_template(self):
        k = int(self.rng.integers(2, 4))  # 2-3 blocks
        return sorted(self.rng.choice(self.sizes["n_blocks"], size=k, replace=False) + 1)

    def draw_groups(self, n: int):
        """(groups of n tasks drawn from the template pool, their
        template indices)."""
        t_idx = self.rng.choice(len(self.templates), size=n, p=self.popularity)
        return self.table.groups_for(
            np.zeros(n, np.int32), [self.templates[t] for t in t_idx]), t_idx

    def fill(self):
        """Admit the tasks (jobs drawn after the groups) and schedule
        them in one round; returns the round's un-fetched stats."""
        tasks, jobs = self.sizes["tasks"], self.sizes["jobs"]
        self.cluster.add_tasks(tasks, self.rng.integers(0, jobs, tasks).astype(np.int32),
                               groups=self.init_groups)
        return self.cluster.round()

    def maintain_table(self) -> None:
        """Between chunks: idle signatures age out, fresh templates
        arrive, the table re-syncs, and on-device arrivals draw only the
        registered groups."""
        st = self.cluster.fetch_state()
        live_per_group = np.bincount(st["grp"][st["live"]], minlength=self.table.G)
        self.table.evict_idle(live_per_group, keep_fraction=0.75)
        for _ in range(32):
            self.templates[int(self.rng.integers(0, len(self.templates)))] = (
                self.new_template())
        self.draw_groups(256)  # registers new signatures, counts overflow
        self.table.sync(self.cluster)
        self.cluster.set_arrival_groups(np.unique(sorted(self.table._sig2gid.values())))

    def chunk(self, rounds: int, seed: int):
        """maintain_table, then `rounds` steady rounds on the JAX
        package's draws for `seed`; returns their un-fetched stats."""
        self.maintain_table()
        return self.cluster.run_steady_rounds(rounds, CHURN, self.sizes["churn_n"],
                                              seed=seed)

    def counters(self) -> dict:
        return {"signatures_initial": self.signatures_initial,
                "signatures_final": len(self.table._sig2gid),
                "overflow_distinct": self.table.overflowed,
                "evicted": self.table.evicted}

    def quality_probe(self, n_rounds: int = 8) -> dict:
        """The compression-loss oracle (bench.py
        `_multiblock_quality_probe`), continuing the scenario's rng: for
        synthetic backlogs drawn from the template pool, solve (a) the
        CAPPED-table grouping (tasks of overflowed signatures pooled in
        the conservative overflow row, preferences lost) and (b) the
        EXACT full-diversity grouping (every distinct signature its own
        row, all preferences kept) on identical machine capacity — then
        price BOTH placements at the TRUE per-task costs. The
        realized-cost gap is the price of the static G cap. The solves
        run on a LayeredTransportSolver on the cluster's device (bench.py's
        1 << 17 supersteps). Returns realized_a, realized_b (per round),
        the gap's mean and max, rounded as bench.py rounds them, and
        `y_sha256` over the solves' flows in order (ys_sha256)."""
        solver = LayeredTransportSolver(max_supersteps=1 << 17, device=self.cluster.device)
        ys = []
        table, templates, rng = self.table, self.templates, self.rng
        machines = self.sizes["machines"]

        def true_row(t):
            total = 0
            local = {}
            for b in templates[t]:
                size = table.blocks.size(b)
                total += size
                for m in table.blocks.holders(b):
                    local[m] = local.get(m, 0) + size
            unit = table.cost_unit_mb
            worst = _transfer_cost(total, 0, unit)
            row = np.full(machines, worst, np.int64)
            # the same preference rule and cost quantum as group_for, so the
            # gap measures the G cap, not a policy difference
            threshold = PREFERENCE_FRACTION * total
            for m, loc in local.items():
                if loc > threshold and 0 <= m < machines:
                    row[m] = min(row[m], _transfer_cost(total, loc, unit))
            return row, worst

        true_rows = {t: true_row(t) for t in range(len(templates))}

        def realized_cost(y, row_tasks):
            """Tasks of each solved row take that row's machine grants in
            order; unplaced ones pay their true escape cost."""
            total = 0
            for r, tasks_r in enumerate(row_tasks):
                ti = 0
                for m in np.nonzero(y[r])[0]:
                    for _ in range(int(y[r][m])):
                        total += int(true_rows[tasks_r[ti]][0][m])
                        ti += 1
                for t in tasks_r[ti:]:
                    total += int(true_rows[t][1] + 1)
            return total

        out = {"realized_a": [], "realized_b": []}
        gaps = []
        for _ in range(n_rounds):
            n = 200
            t_idx = rng.choice(len(templates), size=n, p=self.popularity)
            cap = rng.integers(0, 3, machines).astype(np.int32)
            # (a) capped table rows
            groups = table.groups_for(np.zeros(n, np.int32), [templates[t] for t in t_idx])
            sup_a = np.bincount(groups, minlength=table.G).astype(np.int32)
            route_a = np.minimum(np.broadcast_to(table.e[:, None], (table.G, machines)),
                                 table.pref_w).astype(np.int64)
            act = np.nonzero(sup_a > 0)[0]
            res_a = solver.solve_layered(LayeredProblem(
                supply=sup_a[act], col_cap=cap, cost_cm=route_a[act].astype(np.int32),
                unsched_cost=0, ec_cost=0, row_unsched_cost=table.effective_u()[act]))
            ys.append(res_a.y)
            realized_a = realized_cost(res_a.y, [
                [int(t) for t, g in zip(t_idx, groups) if g == gid] for gid in act])
            # (b) exact full-diversity rows (one per distinct template)
            uniq, inv = np.unique(t_idx, return_inverse=True)
            sup_b = np.bincount(inv, minlength=len(uniq)).astype(np.int32)
            route_b = np.stack([true_rows[t][0] for t in uniq])
            u_b = np.array([true_rows[t][1] + 1 for t in uniq], np.int64)
            res_b = solver.solve_layered(LayeredProblem(
                supply=sup_b, col_cap=cap, cost_cm=route_b.astype(np.int32),
                unsched_cost=0, ec_cost=0, row_unsched_cost=u_b))
            ys.append(res_b.y)
            realized_b = realized_cost(res_b.y, [
                [int(t) for t in t_idx[inv == r]] for r in range(len(uniq))])
            out["realized_a"].append(realized_a)
            out["realized_b"].append(realized_b)
            gaps.append((realized_a - realized_b) / max(1, realized_b))
        out["realized_cost_gap_mean"] = round(float(np.mean(gaps)), 5)
        out["realized_cost_gap_max"] = round(float(np.max(gaps)), 5)
        out["y_sha256"] = ys_sha256(ys)
        return out


def ys_sha256(ys) -> str:
    """sha256 of solves' flows y, each as int32 bytes, in order."""
    h = hashlib.sha256()
    for y in ys:
        h.update(np.ascontiguousarray(np.asarray(y), np.int32).tobytes())
    return h.hexdigest()
