"""The operator tools of ksched_tpu's tools/, on the port.

- `tail_repro`: capture superstep-tail rounds of the steady-state
  configs and replay them under solver-knob sweeps (the transport kernel
  for `replay` and `replay-grouped`, the tiered one for `replay-tiered`);
- `superstep_trace`: a numpy replica of the transport superstep loop
  that writes the solver-telemetry rows of obs/soltel.py;
- `obs_report`: the one reader of every observability artifact the port
  writes (round-trace JSONL, registry snapshot, flight dump, Chrome
  trace, solver telemetry);
- `profile_round`: the launch floor, one synchronize's round trip and the
  sustained steady round on the card, each an obs span;
- `shard_smoke`: the multi-device rung's fixed-seed churn soak over
  parallel/launch.py ranks (scan-CSR reference, sharded, chaos
  containment).

Each runs as `python -m ksched_tpu_torch.tools.<name>`, on the card by
default (`--device cpu` for the plain versions). The device soak lives
in drivers/soak.py.
"""
