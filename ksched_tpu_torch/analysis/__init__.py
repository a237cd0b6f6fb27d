"""Static-analysis suite of the port: its invariants, machine-checked.

The port of ksched_tpu/analysis/ (whose catalog is
docs/static_analysis.md). Three levels, as there:

- Level 1, `ast_rules`: an AST lint over ksched_tpu_torch/ and
  chip_smoke.py (`python -m ksched_tpu_torch.analysis`, gated by
  tests/test_torch_static_analysis.py).
- Level 2, `op_contracts`: each registered program run on a small
  seeded problem under two recorders, a `TorchFunctionMode` (the torch
  calls the port's own source makes: the trace behind the hash pins,
  the dtype, scatter, gather and host-read counts) and a
  `TorchDispatchMode` (the aten ops underneath: no float64 anywhere, no
  float accumulation, one `_local_scalar_dense` for each scalar read).
  Loop marks (`marks.loop_mark`) cut the record into supersteps, sweeps
  and waves, and a ShardMesh collective is recorded where it is issued.
- Level 3, `program_registry` + `engine`: the 23 programs of the JAX
  registry under the same names and kinds, and the 3 kernels, each with
  its contract; one engine checks every spec (CPU checks in tier-1,
  card checks in the smoke's `analysis` phase and
  tests/test_torch_cuda_analysis.py); `--coverage` sweeps every site.

Rule catalog (Level 1), the JAX rule → the port's:

- `dtype64` → `dtype64`, over device modules (library files that import
  torch): `torch.int64`/`torch.long`/`torch.float64`/`torch.double`,
  `.long()`, `.double()`, `np.int64` and 64-bit dtype strings.
  `host-only` silences it as before; `index-only` is new: a 64-bit
  INDEX operand (torch's gathers, indexing and `index_copy_` take int64
  indices), never a value.
- `implicit-dtype` → `torch.zeros/ones/empty/full/arange/tensor`
  without `dtype=` (float32 or int64 by default, where the solves need
  int32).
- (new) `int32-reduce`: `torch.sum`/`cumsum`/`prod` and `.sum(` /
  `.cumsum(` / `.prod(` without `dtype=` in device modules, the
  source-level half of the no-64-bit contract (they promote int32 to
  int64).
- (new) `foreign-import`: `import jax`, `jaxlib` or `ksched_tpu`
  anywhere in the port (tests/test_torch_isolation.py holds it too).
- `jit-static` → none: the port has no `jit`, so no static argument a
  trace could miss.
- `traced-branch` → none at Level 1: its torch meaning is a host sync
  (a Python branch on a device value reads it back), held at Level 2 as
  an exact host-read count per superstep and per sweep, not by a
  name-based heuristic.
- `mutable-default`, `bare-except`, `raw-print` (library modules but
  `cli.py` and `__main__.py`), `unregistered-program`, `stale-waiver`,
  `bad-waiver` and the implicit `syntax-error`: as they are. The sites of
  `unregistered-program` are the port's: a kernel launch
  (`lib.ksched_*_solve(`/`_probe(`), a `torch.distributed` collective,
  the `def` of a registered plain program.

Contract catalog (Levels 2 and 3), the JAX field or check → the port's:

- `dtype_policy` int32 → no call yields a float64 tensor and no aten op
  a float64 value; calls yielding int64 are pinned by function and count
  (`int64_ops`: index operands, and the fingerprints' declared wide
  arithmetic), so a forced `.long()` on a value fails.
- `scatter_policy` → the TPU serialisation is gone; its torch meaning
  is determinism on CUDA. "forbidden" becomes "deterministic": the
  scatter-family calls are pinned by kind and count (`scatters`), a
  float accumulation fails, a non-accumulating write through a tensor
  index is allowed only as a declared permutation (`permutation`).
  "scoped-exempt" programs must scatter; "chaos-only" stays chaos-only.
- `gathers` → on the card `mega_solve` runs its loop in one launch, so
  the launching route records the same number of torch calls for two
  solves of different superstep counts (`kernel=0`: no op a superstep);
  the CSR solve shows gathers in a superstep (the canary); a plain
  loop's gathers a superstep are pinned where the spec says.
- (traced-branch) → `host_reads`: exact reads a superstep, a sweep and
  outside the loops.
- `collectives` → the ShardMesh calls by kind: `loop` the most in any
  one iteration (the JAX "loop body counts once"), `total` the folded
  program; forbidden kinds hold always, so a single-device program makes
  no ShardMesh call.
- `donation` → in-place update: the declared arguments keep their
  `data_ptr()` and bump `_version`; on the card the call's peak memory
  growth, less its declared new outputs, stays below the smallest
  declared buffer.
- `telemetry_off_hash`, `telemetry_knob`, `distinct_from` → the sha256
  of the normalised function-level trace (names, shapes and dtypes;
  Python numbers by type; property reads dropped; each loop's distinct
  iteration bodies once, sorted) of the default call is pinned;
  telemetry 0 records the default trace, 512 a different one; variants
  hash apart. The same pins are read on torch 2.13 (CPU) and on the
  card, where the plain programs run on CUDA tensors.
- `hash_stability` → two raw sizes in one bucket record identical
  traces, shapes included; cross pairs differ; `ell` and the legacy
  sharded solve stay `exempt` with the JAX reason.
- `vmem_gate` → CPU: `mega_fits`' constants equal those parsed from
  csrc/mcmf.cu and transport_common.cuh, and its reckoning grows by
  exactly one table with the ring. Card: the kernel's scratch count at
  three sizes, the measured live set of a solve against the reckoning
  (`MEGA_LIVE_SLACK_TABLES`), and no grid `mcmf_grid` sizes for an
  admitted problem asks for more blocks than can be co-resident.
- AOT `.lower().compile()` artifacts → card only: each `__global__`'s
  registers, local (spill) bytes, static shared bytes and max threads a
  block, read from the loaded library (`ksched_<kernel>_kernel_attrs`)
  and pinned in `KERNELS`.
"""

from .ast_rules import (
    RULES,
    Directive,
    ProgramSite,
    Violation,
    collect_program_sites,
    iter_directives,
    lint_file,
    lint_paths,
    lint_source,
    parse_directive,
    program_coverage,
)
from .baseline import fingerprint, load_baseline, split_by_baseline, write_baseline
from .program_registry import (
    KERNELS,
    PROGRAMS,
    SITE_NAMES,
    CollectiveBudget,
    DonationSpec,
    GatherBudget,
    HashStability,
    HostReadBudget,
    KernelSpec,
    ProgramSpec,
    declare_programs,
    donating_programs,
    registered_names,
    specs_for_site,
)

__all__ = [
    "RULES",
    "Directive",
    "ProgramSite",
    "Violation",
    "collect_program_sites",
    "iter_directives",
    "lint_file",
    "lint_paths",
    "lint_source",
    "parse_directive",
    "program_coverage",
    "fingerprint",
    "load_baseline",
    "split_by_baseline",
    "write_baseline",
    "KERNELS",
    "PROGRAMS",
    "SITE_NAMES",
    "CollectiveBudget",
    "DonationSpec",
    "GatherBudget",
    "HashStability",
    "HostReadBudget",
    "KernelSpec",
    "ProgramSpec",
    "declare_programs",
    "donating_programs",
    "registered_names",
    "specs_for_site",
]
