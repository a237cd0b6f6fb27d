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
  containment);
- the tools that read the bench (ksched_tpu_torch/bench.py, `python -m
  ksched_tpu_torch.bench`): `coco_anatomy` (coco50k's round floor by
  ablation), `mega_bench` (kernel B3 against the CSR and ELL cold
  solves; the bench's `--config mcmf-mega`), `csr_bench` (chunks of
  cold scan-CSR solves), `primitives_bench` (PyTorch's gather, cumsum,
  segmented max and row reductions at the graph's shapes),
  `model_check` and `assemble_model_check` (the latency model's slope
  against captured tails re-solved on B1/B2) and `bench_compare` (the
  trajectory ratchet: append, gate, show).

Each runs as `python -m ksched_tpu_torch.tools.<name>`, on the card by
default (`--device cpu` for the plain versions; `assemble_model_check`
and `bench_compare` read files on the host). The device soak lives in
drivers/soak.py.
"""
