"""Assemble a model-check artifact: measured kappas (tools/model_check.py
runs on captured instances) against a suite artifact's fitted
per-superstep slopes, with the re-based p99 column:
p99_rebased = fixed_ms + kappa_measured * supersteps_p99.

The port of ksched_tpu's tools/assemble_model_check.py (:22-89), which
reads its three model_check outputs from fixed paths and writes
MODEL_CHECK_r05.json; here every path is an argument:

  python -m ksched_tpu_torch.tools.assemble_model_check SUITE.jsonl \\
      --preempt mc_preempt.json --whare mc_whare.json \\
      --multiblock mc_multiblock.json --out MODEL_CHECK_torch.json

Host only (json).
"""

from __future__ import annotations

import argparse
import json
import sys

#: (suite config, its model_check input's flag, what its chains time)
JOBS = (
    ("coco50k-preempt", "preempt",
     "tiered full/scoped re-solve (transport_fori_tiered, the fired-round "
     "regime — compare per_superstep_us_full)"),
    ("whare-hetero", "whare", "plain class transport (transport_fori)"),
    ("quincy10k-multiblock", "multiblock",
     "grouped two-stage dispatch incl. the refined full fallback"),
)


def suite_rec(path: str, config: str):
    """`config`'s record in a suite artifact, or None."""
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            if rec.get("config") == config:
                return rec
    return None


def assemble(suite: str, mc_paths: dict, log=print) -> dict:
    """{"suite_artifact", "configs"} for the model_check outputs
    `mc_paths` (suite config -> path); logs one summary line a config."""
    out = {"suite_artifact": suite, "configs": {}}
    for config, _flag, what in JOBS:
        with open(mc_paths[config]) as f:
            mc = json.load(f)
        entry = {
            "what_was_timed": what,
            "kappa_measured_us": mc["fit"]["kappa_measured_us"],
            "t_loop_ms": mc["fit"]["t_loop_ms"],
            "instances": mc["instances"],
            "inst_file": mc["inst_file"],
        }
        rec = suite_rec(suite, config)
        if rec is not None:
            d = rec["detail"]
            lm = d["latency_model"]
            if config == "coco50k-preempt" and "per_superstep_us_full" in lm:
                km = lm["per_superstep_us_full"]
                # the fired-round regime is what the captures replay;
                # re-base the SCOPED p99 (the fired-regime tail)
                ss99 = d.get("supersteps_scoped_p99", d["supersteps_p99"])
            else:
                km = lm["per_superstep_us"]
                ss99 = d["supersteps_p99"]
            kmeas = mc["fit"]["kappa_measured_us"]
            entry["suite_fit"] = {
                "fixed_ms": lm["fixed_ms"],
                "per_superstep_us": lm["per_superstep_us"],
                **({"per_superstep_us_full": lm["per_superstep_us_full"]}
                   if "per_superstep_us_full" in lm else {}),
                "p99_ms_fitted": lm["p99_ms"],
            }
            entry["comparison"] = {
                "kappa_model_us": km,
                "measured_over_model": round(kmeas / km, 3) if km else None,
                "supersteps_p99_used": ss99,
                "p99_ms_rebased_measured_kappa": round(
                    lm["fixed_ms"] + kmeas * 1e-3 * ss99, 3),
                "under_10ms_bar_with_measured_kappa": bool(
                    lm["fixed_ms"] + kmeas * 1e-3 * ss99 < 10.0),
            }
        out["configs"][config] = entry
    for c, e in out["configs"].items():
        cmp = e.get("comparison", {})
        log(c, "k_meas", e["kappa_measured_us"],
            "ratio", cmp.get("measured_over_model"),
            "p99_rebased", cmp.get("p99_ms_rebased_measured_kappa"),
            "under_bar", cmp.get("under_10ms_bar_with_measured_kappa"))
    return out


def main(argv=None, log=print) -> int:
    ap = argparse.ArgumentParser(prog="python -m ksched_tpu_torch.tools.assemble_model_check")
    ap.add_argument("suite", help="suite artifact (python -m ksched_tpu_torch.bench --suite)")
    for config, flag, _what in JOBS:
        ap.add_argument(f"--{flag}", required=True, metavar="PATH",
                        help=f"tools/model_check.py's output for {config}")
    ap.add_argument("--out", default="MODEL_CHECK_torch.json", metavar="PATH")
    args = ap.parse_args(argv)
    out = assemble(args.suite, {c: getattr(args, f) for c, f, _w in JOBS}, log)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
