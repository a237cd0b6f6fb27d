"""Run one cell of the port's benchmark once and print its result.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (building the traffic from the seed, the program's kernels from
the checkout's build cache, the fill and the warm-up) counts from the
start of this process to the first measured round. The last line of
standard output is the result: `correct`, `attempted`, `failed`,
`metrics`, `device`, with `--trace 1` a `breakdown`, and last `checks`,
each number compared with its limit; the same numbers end standard
error. Without a CUDA card, or with a forbidden module loaded once the
window has closed, it prints no result and exits non-zero.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # a library the port loads must not load JAX behind it
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")
    import torch

    from portbench import harness

    bench = harness.load_benchmark()
    cell, cfg, mix = harness.find_cell(bench, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    line, faults = harness.run_cell(bench, args.workload, cfg, mix, args.seed,
                                    args.seconds, bool(args.trace), "cuda", T_START)
    bad = harness.forbidden_modules()
    if bad:
        print(f"forbidden modules loaded in the run's process: {bad}", file=sys.stderr)
        return 3
    for label, what in faults:
        print(f"fault in round {label}: {'; '.join(what)}", file=sys.stderr)
    for text in harness.check_lines(line["checks"]):
        print(text, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
