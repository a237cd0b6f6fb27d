"""Traffic of a data-locality cluster: blocks, task templates, churn.

A deployment (its configuration file) holds `n_blocks` input blocks of
heavy-tailed sizes, each on `replicas` machines, and `n_templates` task
templates, each a set of 2 to 3 blocks, popular as 1 / k^zipf. The
fill admits `tasks` tasks drawn from the templates by popularity. A
steady mix (its traffic file) then runs closed-loop rounds: each placed
task completes with probability `churn`, `arrivals` tasks arrive, each
drawn by popularity; every `upkeep_every` rounds `refresh_templates`
templates are replaced by fresh ones.

The deployment's data (the blocks, their holders, the template pool
and the fresh templates of each upkeep) is drawn from the
configuration's own `data_seed`, the same in every run, as a cluster's
data is; the run's seed draws its traffic: the fill's templates and
jobs, and each round's completions and arrivals. So every seed offers
the same work in another order. Every draw is a function of its seed
and of the round's or the upkeep's index alone, so the program and the
reference read the same traffic, whatever either does in between.

The shapes follow the scenario of `ksched_tpu_torch/drivers/
multiblock.py` (Quincy, SOSP 2009: blocks on 3 machines, tasks
preferring the machines that hold their input).
"""

from __future__ import annotations

import numpy as np

MB = 1 << 20


def _rng(seed: int, *key: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) % (1 << 64), *key])


class Scenario:
    """The deployment's data (block sizes and holders, the template pool
    and its popularity) and one seed's traffic (the fill's templates and
    jobs, the rounds' draws)."""

    def __init__(self, cfg: dict, seed: int):
        self.cfg, self.seed = cfg, int(seed)
        rng = _rng(cfg["data_seed"], 0)
        n_blocks, machines = cfg["n_blocks"], cfg["machines"]
        mb = cfg["block_mb"]
        sizes = np.minimum(
            (mb[0] * MB * np.exp(rng.exponential(cfg["block_size_scale"], n_blocks))
             ).astype(np.int64),
            mb[1] * MB)
        self.block_sizes = [int(s) for s in sizes]
        self.block_holders = [
            sorted(int(m) for m in rng.choice(machines, size=cfg["replicas"], replace=False))
            for _ in range(n_blocks)]
        self.templates = [self._template(rng) for _ in range(cfg["n_templates"])]
        pop = 1.0 / np.arange(1, cfg["n_templates"] + 1) ** cfg["zipf"]
        self.popularity = pop / pop.sum()
        self._cum = np.cumsum(self.popularity)
        rng = _rng(seed, 0)
        self.fill_templates = self.draw_templates(rng, cfg["tasks"])
        self.fill_jobs = rng.integers(0, cfg["jobs"], cfg["tasks"]).astype(np.int32)

    def _template(self, rng) -> list:
        lo, hi = self.cfg["template_blocks"]
        k = int(rng.integers(lo, hi + 1))
        return sorted(int(b) + 1 for b in rng.choice(self.cfg["n_blocks"], size=k,
                                                       replace=False))

    def draw_templates(self, rng, n: int) -> np.ndarray:
        """n template indices drawn by popularity."""
        u = rng.random(n)
        return np.minimum(np.searchsorted(self._cum, u, side="right"),
                          len(self.templates) - 1).astype(np.int64)

    def round_draws(self, r: int, task_capacity: int, churn: float):
        """Round r's draws: (done_u float32[Tcap] — a placed row completes
        where done_u < churn —, the arriving template of each row int64
        [Tcap] — a row that takes an arrival takes its own —, and the
        decode window's rotation, an int in [0, 2**30))."""
        rng = _rng(self.seed, 2, r)
        done_u = rng.random(task_capacity, dtype=np.float32)
        tmpl = self.draw_templates(rng, task_capacity)
        return done_u, tmpl, int(rng.integers(0, 1 << 30))

    def refresh(self, k: int, count: int) -> None:
        """Upkeep k: `count` templates of the pool replaced by fresh ones
        (the pool's popularity by position stays), the deployment's own
        for every seed."""
        rng = _rng(self.cfg["data_seed"], 1, k)
        for _ in range(count):
            i = int(rng.integers(0, len(self.templates)))
            self.templates[i] = self._template(rng)
