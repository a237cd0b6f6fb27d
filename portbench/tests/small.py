"""A quincy deployment small enough for the CPU, and its mix."""

import json

from portbench.harness import HERE

_CFG = json.loads((HERE / "configs" / "quincy10k-multiblock.json").read_text())
_MIX = json.loads((HERE / "traffic" / "steady.json").read_text())

#: the quincy configuration at a size the CPU holds: its shapes, fewer
#: of everything
QUINCY = dict(_CFG, tasks=120, machines=24, pus=2, slots=4, jobs=3, task_capacity=256,
              n_blocks=40, n_templates=30, num_groups=48, active_groups_cap=[8, 16, 32],
              decode_width=64, supersteps=1 << 14)
STEADY = dict(_MIX, churn=0.05, arrivals=6, upkeep_every=5, refresh_templates=4,
              warmup_rounds=6)

_GCFG = json.loads((HERE / "configs" / "gtrace12k-coco.json").read_text())
_REPLAY = json.loads((HERE / "traffic" / "replay.json").read_text())

#: the gtrace configuration at a size the CPU holds
GTRACE = dict(_GCFG, machines=300, task_capacity=2048, decode_width=128, n_windows=1500)
REPLAY = dict(_REPLAY, rate=8, mean_runtime_s=60, warmup_windows=20)
_BURST = json.loads((HERE / "traffic" / "burst.json").read_text())
#: the burst mix at the small size: bursts that fill every slot, so the
#: decode window binds and rotates
BURST = dict(_BURST, rate=8, mean_runtime_s=60, burst_count=12, burst_windows=20,
             burst_spike=8.0, outage_block=10, warmup_windows=20,
             scheduler_sizes={"task_capacity": 4096, "decode_width": 64})
