"""The port's scheduler service (ksched_tpu_torch/cli.py
SchedulerService, podgen, main) and its chaos soak
(drivers/soak.py) against the JAX package's on the CPU, tolerance 0:
the service at 6 machines x 2 PUs x 8 slots through "jax", "auto" and
"ref" places every round as the JAX package's does (pod name -> node
name), pipelined equals sync, cli.main's one-shot binds its batch, and
the chaos soak at 48 rounds ends with the JAX package's placements,
bindings and fault totals."""

import contextlib
import io

import pytest
import torch

from ksched_tpu_torch.cli import main as cli_main
from ksched_tpu_torch.drivers import soak as tsoak
from ksched_tpu_torch.drivers.service import ServiceConfig, package, run_service
from torch_service_reference import jax_package, soak_args  # puts tools/ on sys.path

SMALL = dict(machines=6, pus_per_core=2, slots=8, pods=60, rounds=5, arrivals=8,
             churn=0.1, classes=4)
KEEP = ("bound", "placed", "path", "sha256", "solver_work")


def _rows(got):
    return [[r[k] for k in KEEP] for r in got["rounds"]]


@pytest.mark.parametrize("backend,model", [("jax", "trivial"), ("auto", "trivial"),
                                           ("auto", "whare"), ("ref", "quincy")])
def test_service_matches_the_jax_package(backend, model):
    cfg = ServiceConfig(**SMALL, backend=backend, cost_model=model)
    port = run_service(package("cpu"), cfg)
    assert _rows(port) == _rows(run_service(jax_package(), cfg))
    assert [r["bound"] for r in port["rounds"]][0] == 60


@pytest.mark.parametrize("backend,resident", [("auto", False), ("jax", True)])
def test_pipelined_equals_sync(backend, resident):
    cfg = ServiceConfig(**SMALL, backend=backend, device_resident=resident)
    sync = run_service(package("cpu"), cfg)
    piped = run_service(package("cpu"), ServiceConfig(**SMALL, backend=backend,
                                                      device_resident=resident,
                                                      pipeline=True))
    assert _rows(piped) == _rows(sync)
    assert piped["service"].api.bindings() == sync["service"].api.bindings()


def _cli(argv):
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc = cli_main(argv)
    return rc, err.getvalue()


def test_cli_one_shot():
    rc, err = _cli(["--fake-machines", "-nm", "6", "--pus-per-core", "2", "-mt", "8",
                    "--podgen", "40", "--one-shot", "--device", "cpu",
                    "--pod-batch-timeout", "0.3"])
    line = [ln for ln in err.splitlines() if ln.startswith("scheduled ")]
    assert rc == 0 and line, err
    bound, batch = (int(x) for x in line[-1].split()[1].split("/"))
    assert batch > 0 and bound == batch


@pytest.mark.parametrize("extra,what", [
    (["--tenants", "2"], "ROADMAP item 11"),
    (["--cost-model", "sjf"], "ROADMAP item 7"),
    (["--audit-every", "1"], "--device-resident"),
])
def test_cli_refusals(capsys, extra, what):
    with pytest.raises(SystemExit):
        cli_main(["--fake-machines", "--podgen", "4", "--one-shot", "--device", "cpu"]
                 + extra)
    assert what in capsys.readouterr().err


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs a machine with no card")
def test_cli_defaults_to_the_card():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli_main(["--fake-machines", "--podgen", "4", "--one-shot"])


def test_cli_round_trace_and_obs_dump(tmp_path):
    trace, dump = tmp_path / "rounds.jsonl", tmp_path / "obs.json"
    rc, _err = _cli(["--fake-machines", "-nm", "4", "--podgen", "6", "--one-shot",
                     "--device", "cpu", "--pod-batch-timeout", "0.3",
                     "--round-trace", str(trace), "--obs-dump", str(dump)])
    assert rc == 0
    lines = trace.read_text().splitlines()
    assert len(lines) == 1 and '"num_scheduled": 6' in lines[0]
    assert "ksched_rounds_total" in dump.read_text()


def _soak(**over):
    kw = dict(rounds=48, chunk=16, seed=0, machines=6, slots=8,
              chaos_restore_every=24, device="cpu")
    return soak_args(**{**kw, **over})


@pytest.mark.parametrize("seed", [0, 3])
def test_chaos_soak_matches_the_jax_package(seed):
    import soak as jsoak

    quiet = lambda *a, **k: None  # noqa: E731
    got = tsoak.soak_summary(tsoak.run_chaos_soak(_soak(seed=seed), quiet))
    want = tsoak.soak_summary(jsoak.run_chaos_soak(_soak(seed=seed), quiet))
    assert got == want
    assert got["restores"] == got["warm_restores"] == 2
    assert sum(got["fault_totals"].values()) > 0


def test_chaos_soak_determinism_and_loop_parity():
    quiet = lambda *a, **k: None  # noqa: E731
    runs = tsoak.chaos_main(_soak(seed=5, verify_determinism=True), quiet)
    assert tsoak.soak_summary(runs["run"]) == tsoak.soak_summary(runs["again"])
    arms = tsoak.chaos_main(_soak(seed=5, rounds=32, verify_loop_parity=True), quiet)
    assert set(arms) == {"sync", "pipelined", "device-resident"}


def test_soak_cli(capsys):
    assert tsoak.main(["--rounds", "8", "--chunk", "8", "--machines", "4", "--slots", "4",
                       "--chaos-restore-every", "4", "--device", "cpu"]) == 0
    assert "CHAOS SOAK OK" in capsys.readouterr().out
