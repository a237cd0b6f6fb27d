"""The port's control planes (ksched_tpu_torch/cluster: the synthetic
channel, the HTTP adapter and the loopback FakeAPIServer) and
utils/backoff.py, against the JAX package's: tests/test_http_api.py,
test_cluster_concurrency.py and test_l7_integration.py's cluster and
service cases, each run through both packages where the outcome is a
value (bindings, batches, delays) and held equal; the service runs on
the CPU. The TLS cases skip where the openssl CLI is missing."""

import random
import shutil
import threading
import time

import pytest

import ksched_tpu.cli as jcli
import ksched_tpu.cluster as jcluster
import ksched_tpu.costmodels as jcm
import ksched_tpu.utils as jutils
import ksched_tpu_torch.cli as tcli
import ksched_tpu_torch.cluster as tcluster
import ksched_tpu_torch.costmodels as tcm
import ksched_tpu_torch.utils as tutils

needs_openssl = pytest.mark.skipif(shutil.which("openssl") is None,
                                   reason="the TLS fake server needs the openssl CLI")


@pytest.fixture
def server():
    s = tcluster.FakeAPIServer().start()
    yield s
    s.stop()


# -- backoff --------------------------------------------------------------


def test_backoff_schedule_matches():
    """Seeded jitter: the same delays, the same budget, in both packages."""
    seqs = []
    for mod in (jutils, tutils):
        b = mod.ExpBackoff(base_s=0.1, max_s=1.0, max_retries=6, rng=random.Random(3))
        seq = [b.next_delay() for _ in range(8)]
        b.reset()
        seq.append(b.next_delay())
        seqs.append(seq + [b.delay_for(9)])
    assert seqs[0] == seqs[1]
    assert seqs[1][6] is None and seqs[1][7] is None and seqs[1][8] is not None
    with pytest.raises(ValueError, match="bad backoff parameters"):
        tutils.ExpBackoff(base_s=0)


# -- the synthetic channel --------------------------------------------------


def test_pod_batch_debounce_drains_queue():
    api = tcluster.SyntheticClusterAPI()
    for i in range(7):
        api.submit_pod(tcluster.PodEvent(pod_id=f"p{i}"))
    assert [p.pod_id for p in api.get_pod_batch(timeout_s=0.05)] == [f"p{i}" for i in range(7)]


def test_pod_batch_timer_resets_on_arrival():
    """A trickle slower than the quiet period still lands in ONE batch:
    each arrival resets the timer (client.go:153-193)."""
    api = tcluster.SyntheticClusterAPI()

    def trickle():
        for i in range(4):
            api.submit_pod(tcluster.PodEvent(pod_id=f"p{i}"))
            time.sleep(0.03)

    t = threading.Thread(target=trickle)
    t.start()
    batch = api.get_pod_batch(timeout_s=0.15)
    t.join()
    assert len(batch) == 4


def test_node_batch_window_and_close():
    api = tcluster.SyntheticClusterAPI()
    t0 = time.monotonic()
    assert api.get_node_batch(timeout_s=0.1) == []
    assert time.monotonic() - t0 < 1.0
    assert api.poll_pod_batch(0.05) == [] and not api.is_closed()
    api.close()
    assert api.get_pod_batch(timeout_s=0.05) == [] and api.is_closed()


def test_synthetic_channel_conserves_events_under_contention():
    """Many offerers vs one drainer vs close: every accepted offer is
    drained exactly once."""
    api = tcluster.SyntheticClusterAPI(pod_chan_size=64)
    per_producer, producers = 300, 4
    total = per_producer * producers
    accepted, lock = [], threading.Lock()

    def offerer(k):
        for i in range(per_producer):
            ev = tcluster.PodEvent(pod_id=f"p{k}_{i}")
            while not api.offer_pod(ev, timeout_s=0.02):
                pass
            with lock:
                accepted.append(ev.pod_id)

    threads = [threading.Thread(target=offerer, args=(k,), daemon=True)
               for k in range(producers)]
    for t in threads:
        t.start()
    drained = []
    while len(drained) < total:
        drained.extend(p.pod_id for p in api.get_pod_batch(timeout_s=0.05))
    for t in threads:
        t.join(timeout=5)
    api.close()
    assert sorted(drained) == sorted(accepted)
    assert len(set(drained)) == len(drained)


# -- the service on the synthetic channel ------------------------------------


def _service(pkg, machines=4, pus=2, max_tasks_per_pu=1):
    cli, cluster, cm, utils = pkg
    utils.seed_rng(5)
    api = cluster.SyntheticClusterAPI()
    kw = {"device": "cpu"} if cli is tcli else {}
    svc = cli.SchedulerService(api, max_tasks_per_pu=max_tasks_per_pu,
                               cost_model=cm.CostModelType.TRIVIAL, **kw)
    svc.init_topology(fake_machines=machines, pus_per_core=pus)
    return api, svc


PKGS = {"jax": (jcli, jcluster, jcm, jutils), "port": (tcli, tcluster, tcm, tutils)}


def _both(fn):
    out = {name: fn(pkg) for name, pkg in PKGS.items()}
    assert out["port"] == out["jax"]
    return out["port"]


def test_service_schedules_podgen_load():
    def run(pkg):
        api, svc = _service(pkg)
        pkg[0].podgen(api, 6)
        bound = svc.run_once(api.get_pod_batch(0.05))
        return bound, api.bindings()

    bound, bindings = _both(run)
    assert bound == 6 and len(bindings) == 6
    assert all(n.startswith("fake_node_") for n in bindings.values())


def test_service_binds_only_deltas_across_rounds():
    def run(pkg):
        api, svc = _service(pkg, machines=2)
        pkg[0].podgen(api, 2)
        svc.run_once(api.get_pod_batch(0.05))
        first = dict(api.bindings())
        for i in range(2):
            api.submit_pod(pkg[1].PodEvent(pod_id=f"late_{i}"))
        bound = svc.run_once(api.get_pod_batch(0.05))
        return first, bound, api.bindings()

    first, bound, bindings = _both(run)
    assert bound == 2
    assert dict(list(bindings.items())[: len(first)]) == first


def test_service_overload_leaves_surplus_unscheduled():
    def run(pkg):
        api, svc = _service(pkg, machines=2, pus=1)
        pkg[0].podgen(api, 5)
        return svc.run_once(api.get_pod_batch(0.05)), api.bindings()

    bound, bindings = _both(run)
    assert bound == 2 and len(bindings) == 2


def test_redelivered_pod_does_not_duplicate_task():
    """A re-surfaced pod keeps its task; its binding is re-emitted."""
    def run(pkg):
        api, svc = _service(pkg, machines=2)
        svc.run_once([pkg[1].PodEvent(pod_id="pod_x")])
        tid = svc.pod_to_task["pod_x"]
        emitted = svc.run_once([pkg[1].PodEvent(pod_id="pod_x")])
        assert svc.pod_to_task["pod_x"] == tid and tid in svc.old_bindings
        return len(svc.pod_to_task), emitted, api.bindings()

    n, emitted, _ = _both(run)
    assert n == 1 and emitted == 1


# -- HTTP: FakeAPIServer <- HTTPClusterAPI <- SchedulerService -------------


def test_watch_surfaces_pods_and_nodes(server):
    api = tcluster.HTTPClusterAPI(server.base_url, poll_interval_s=0.05)
    try:
        server.add_node("node_a", cores=2, pus_per_core=2)
        server.add_node("node_skip", unschedulable=True)
        server.create_pods(3)
        nodes = api.get_node_batch(timeout_s=0.3)
        assert [n.node_id for n in nodes] == ["node_a"]
        assert nodes[0].num_cores == 2 and nodes[0].pus_per_core == 2
        pods = api.get_pod_batch(timeout_s=0.3)
        assert sorted(p.pod_id for p in pods) == ["pod_0", "pod_1", "pod_2"]
    finally:
        api.close()


def test_binding_post_lands_and_pod_leaves_pending(server):
    api = tcluster.HTTPClusterAPI(server.base_url, poll_interval_s=0.05)
    try:
        server.create_pods(2)
        api.get_pod_batch(timeout_s=0.3)
        api.assign_bindings([tcluster.Binding("pod_0", "node_x")])
        assert server.bindings() == {"pod_0": "node_x"}
        assert server.pending_pods() == 1
    finally:
        api.close()


def test_seen_pods_reconciled_and_recreated_pod_resurfaces(server):
    api = tcluster.HTTPClusterAPI(server.base_url, poll_interval_s=0.05)
    try:
        server.create_pods(1)
        assert [p.pod_id for p in api.get_pod_batch(timeout_s=0.5)] == ["pod_0"]
        api.assign_bindings([tcluster.Binding("pod_0", "node_x")])
        deadline = time.monotonic() + 2
        while time.monotonic() < deadline and api._seen_pods:
            time.sleep(0.02)
        assert not api._seen_pods
        with server._state.lock:
            server._state.bindings.pop("pod_0")
        assert [p.pod_id for p in api.get_pod_batch(timeout_s=0.5)] == ["pod_0"]
    finally:
        api.close()


def _wait_bound(server, n, seconds=3.0):
    deadline = time.monotonic() + seconds
    while time.monotonic() < deadline and len(server.bindings()) < n:
        time.sleep(0.05)
    return server.bindings()


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_cli_one_shot_against_http_server(pkg):
    """ksched-tpu(-torch) --api-server URL --podgen N --one-shot: pods
    created through the server, scheduled, bindings POSTed back — the
    same bindings from both packages' CLIs against their own servers."""
    cli, cluster, _cm, utils = PKGS[pkg]
    utils.seed_rng(5)
    s = cluster.FakeAPIServer().start()
    try:
        for i in range(2):
            s.add_node(f"node_{i}", cores=1, pus_per_core=2)
        argv = ["--api-server", s.base_url, "--podgen", "4", "--one-shot",
                "--node-batch-timeout", "0.4", "--pod-batch-timeout", "0.3",
                "--max-tasks-per-pu", "1"]
        rc = cli.main(argv + (["--device", "cpu"] if pkg == "port" else []))
        got = _wait_bound(s, 4)
        assert rc == 0 and len(got) == 4 and s.pending_pods() == 0
    finally:
        s.stop()


def test_scheduler_service_end_to_end_over_http(server):
    for i in range(3):
        server.add_node(f"node_{i}", cores=1, pus_per_core=2)
    api = tcluster.HTTPClusterAPI(server.base_url, poll_interval_s=0.05)
    try:
        svc = tcli.SchedulerService(api, max_tasks_per_pu=1, device="cpu")
        svc.init_topology(node_batch_timeout_s=0.4)
        server.create_pods(5)
        svc.run(pod_batch_timeout_s=0.3, max_rounds=1)
        got = _wait_bound(server, 5)
        assert len(got) == 5 and all(v.startswith("node_") for v in got.values())
        assert server.pending_pods() == 0
    finally:
        api.close()


def _drain_and_bind(api, server, want, nodes, deadline_s=20.0):
    bound, i = 0, 0
    t_end = time.monotonic() + deadline_s
    while bound < want and time.monotonic() < t_end:
        batch = api.get_pod_batch(timeout_s=0.3)
        if batch:
            api.assign_bindings([tcluster.Binding(p.pod_id, nodes[(i + k) % len(nodes)])
                                 for k, p in enumerate(batch)])
            i += len(batch)
        bound = len(server.bindings())
    return bound


def test_http_adapter_stress_concurrent_producers_and_binder():
    """3 producer threads POST pods through the adapter while the main
    thread binds: every pod bound exactly once, client and server agree,
    the seen-set drains."""
    server = tcluster.FakeAPIServer().start()
    per_producer, producers = 25, 3
    total = per_producer * producers
    try:
        for i in range(4):
            server.add_node(f"node_{i}", cores=2, pus_per_core=2)
        api = tcluster.HTTPClusterAPI(server.base_url, poll_interval_s=0.02)
        try:
            nodes = [n.node_id for n in api.get_node_batch(timeout_s=2.0)]
            assert len(nodes) == 4

            def produce(k):
                for i in range(per_producer):
                    api.create_pod(f"pod_{k}_{i}", task_class=i % 4)

            threads = [threading.Thread(target=produce, args=(k,)) for k in range(producers)]
            for t in threads:
                t.start()
            bound = _drain_and_bind(api, server, total, nodes)
            for t in threads:
                t.join(timeout=5)
            assert bound == total
            assert api.bindings() == server.bindings()
            t_end = time.monotonic() + 5
            while time.monotonic() < t_end:
                with api._bindings_lock:
                    if not api._seen_pods:
                        break
                time.sleep(0.05)
            with api._bindings_lock:
                assert not api._seen_pods
        finally:
            api.close()
    finally:
        server.stop()


@needs_openssl
def test_tls_bearer_end_to_end():
    server = tcluster.FakeAPIServer(tls=True, bearer="s3cret-token").start()
    try:
        for i in range(2):
            server.add_node(f"node_{i}", cores=1, pus_per_core=2)
        server.create_pods(4)
        api = tcluster.HTTPClusterAPI(server.base_url, poll_interval_s=0.05,
                                      bearer_token="s3cret-token",
                                      ca_cert=server.ca_cert_path)
        try:
            assert server.base_url.startswith("https://")
            nodes = sorted(n.node_id for n in api.get_node_batch(timeout_s=2.0))
            assert nodes == ["node_0", "node_1"]
            assert _drain_and_bind(api, server, 4, nodes) == 4
            assert api.bindings() == server.bindings()
        finally:
            api.close()
    finally:
        server.stop()


@needs_openssl
def test_wrong_bearer_token_rejected():
    server = tcluster.FakeAPIServer(tls=True, bearer="right").start()
    try:
        server.add_node("node_0")
        server.create_pods(2)
        api = tcluster.HTTPClusterAPI(server.base_url, poll_interval_s=0.05,
                                      bearer_token="wrong", ca_cert=server.ca_cert_path)
        try:
            time.sleep(1.0)
            assert api._chan._pods.empty() and api._chan._nodes.empty()
            api.assign_bindings([tcluster.Binding("pod_0", "node_0")])
            assert server.bindings() == {} and api.bindings() == {}
        finally:
            api.close()
    finally:
        server.stop()
