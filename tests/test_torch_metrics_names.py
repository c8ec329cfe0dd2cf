"""Twins of the reference's `tests/test_metrics_names.py` (the Prometheus
series-name ratchet), run on the port's agent with `device="cpu"`.

The exposition reads three process-wide books (the metrics registry, the
transfer ledger, the HBM ledger), so whatever an earlier test in the same
worker booked would show in it. The fixture gives its agent fresh ones,
so these cases pass in any order that xdist runs files in;
`test_stray_site_booked_before_the_fixture_stays_out` shows it. The
speculative and chain-adoption rounds drive the port's coordinator and
view cache through `tests/torch_view_cases.py` `PORT`, as the reference
drives its own through `tests/test_spec.py` and
`tests/test_program_table.py`. The same `ALLOWED_LABELS`,
`ALLOWED_SITES` and required names hold.
"""
import time

import pytest

from nomad_tpu_torch import mock
# the frozen vocabularies of the reference's analysis/vocab.py: the port
# must expose the same names, labels and sites
from nomad_tpu.analysis.vocab import (ALLOWED_LABELS, ALLOWED_PREFIXES,
                                      ALLOWED_SITES, FSM_REQUIRED,
                                      PROM_REQUIRED, RAFT_REQUIRED)
from torch_chain_cases import one_torch_thread  # noqa: F401

REQUIRED = PROM_REQUIRED


def _wait(cond, timeout=20.0, every=0.05):
    dl = time.time() + timeout
    while time.time() < dl:
        if cond():
            return True
        time.sleep(every)
    return cond()






def _parse(text):
    """-> (names, label_names, site_values) from exposition text."""
    names, labels, sites = set(), set(), set()
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        series = line.split(" ")[0]
        if "{" in series:
            name, rest = series.split("{", 1)
            body = rest.rsplit("}", 1)[0]
            for pair in body.split(","):
                if not pair:
                    continue
                k, _, v = pair.partition("=")
                labels.add(k)
                if k == "site":
                    sites.add(v.strip('"'))
        else:
            name = series
        names.add(name)
    return names, labels, sites


def _strip_histo_suffix(name):
    for suf in ("_sum", "_count"):
        if name.endswith(suf):
            return name[: -len(suf)]
    return name


def _fresh_books(monkeypatch):
    """A new process-wide metrics registry, transfer ledger and HBM
    ledger for what is built after this, the old ones back when the test
    ends: the agent's exposition then holds only what its own flow
    booked, whatever ran before it in this process."""
    from nomad_tpu_torch.lib import flight, hbm, metrics, tracectx, transfer

    reg = metrics.MetricsRegistry()
    monkeypatch.setattr(metrics, "_default_registry", reg)
    monkeypatch.setattr(transfer, "_default_ledger",
                        transfer.TransferLedger())
    monkeypatch.setattr(hbm, "_default_hbm", hbm.HbmLedger())
    # the span store and the flight recorder mirror into the registry
    # they were built with
    monkeypatch.setattr(tracectx.default_spans(), "registry", reg)
    monkeypatch.setattr(flight.default_flight(), "registry", reg)


@pytest.fixture()
def loaded_agent(tmp_path, monkeypatch):
    """Dev agent driven through a BATCHED eval round (the fused
    coordinator dispatch) plus a filtered failure, an exhausted blocked
    eval, and a dc-pinned wave round (multi-lane wave dispatch) — the
    flow that populates every promised family."""
    # batch the worker BEFORE the server (Worker reads the env in init);
    # the pinned hold window makes each parked wave drain as ONE batch,
    # so the dc-pinned round reliably dispatches multi-lane
    monkeypatch.setenv("NOMAD_TPU_EVAL_BATCH", "4")
    monkeypatch.setenv("NOMAD_TPU_DRAIN_WINDOW_MS", "300")
    _fresh_books(monkeypatch)
    from nomad_tpu_torch.agent import Agent, AgentConfig
    from nomad_tpu_torch.api import NomadClient
    from nomad_tpu_torch.structs import Constraint

    a = Agent(AgentConfig(data_dir=str(tmp_path / "data"),
                          heartbeat_ttl=60.0), device="cpu")
    a.start()
    api = NomadClient(a.http_addr[0], a.http_addr[1])
    assert _wait(lambda: len(api.nodes()) == 1)

    def job(cpu=50, constraint=None, dc=None):
        j = mock.job()
        t = j.task_groups[0].tasks[0]
        t.driver = "mock_driver"
        t.config = {"run_for": 0.05}
        t.resources.cpu = cpu
        if constraint is not None:
            j.constraints.append(constraint)
        if dc is not None:
            j.datacenters = [dc]
        return j

    # clientless dc2/dc3 nodes: jobs pinned to different dcs have
    # DISJOINT footprints, so the pinned wave below drains into one
    # multi-lane wave dispatch (evals complete at plan apply; the
    # allocs never start, which the metrics flow doesn't need)
    for dc in ("dc2", "dc2", "dc3", "dc3"):
        a.server.state.upsert_node(mock.node(datacenter=dc))

    # park registrations while the broker is disabled, then restore —
    # each wave's pending evals drain as ONE worker batch (fused
    # dispatch). TWO waves: the second wave's dispatch pairs with the
    # first in the pipeline timeline (overlap/bubble histograms) and
    # adopts the first wave's device carry (view.carry_* counters) —
    # both promised families must be populated, not vacuously absent.
    s = a.server
    eval_ids = []
    for wave in range(3):
        s.broker.set_enabled(False)
        if wave == 2:
            # dc-pinned wave: two disjoint conflict groups in one drain
            # → a multi-lane wave dispatch (wave.* series non-vacuous)
            wave_ids = [api.register_job(job(dc=dc))
                        for dc in ("dc2", "dc3", "dc2", "dc3")]
        else:
            wave_ids = [api.register_job(job()) for _ in range(4)]
        if wave == 1:
            wave_ids.append(
                api.register_job(job(cpu=10**7)))  # exhausted → blocked
            wave_ids.append(api.register_job(job(
                constraint=Constraint("${attr.nope}", "x", "="))))  # filtered
        s.broker.set_enabled(True)
        s._restore_evals()
        for eid in wave_ids:
            ev = api.wait_for_eval(eid, timeout=30.0)
            assert ev is not None and ev.status == "complete"
        eval_ids.extend(wave_ids)

    # speculative-dispatch families, NON-vacuously: one
    # CERTIFIED and one ROLLED-BACK speculative dispatch, driven
    # deterministically at the coordinator level against a side
    # cluster with the agent server's registry — the exposition source
    # — so nomad_spec_* pins test real launch/certify/rollback flows,
    # not eagerly-created zeros.
    from torch_view_cases import PORT, dc_job, dc_mask, dc_nodes

    stack_mod = PORT.stack_mod

    monkeypatch.setenv("NOMAD_TPU_SPEC_ROLLBACK_MAX", "1.0")
    for conflict in (False, True):
        cl = PORT.cluster(dc_nodes())
        _c1, res1 = PORT.run_round(
            cl, [dc_job("dc1"), dc_job("dc2")],
            eval_ids=["m1", "m2"])
        coord2 = PORT.coordinator(s.metrics, ("m3", "m4"), {0: 0, 1: 1},
                                  {0: dc_mask(cl, "dc1"),
                                   1: dc_mask(cl, "dc2")})
        threads, _res2 = PORT.start_parked(
            cl, [dc_job("dc1", cpu=250),
                 dc_job("dc2", cpu=250)], coord2)
        assert coord2.try_spec_launch(cl)
        PORT.commit_round(cl, res1, ["m1", "m2"])
        if conflict:
            dc1_node = next(nid for nid in cl.row_of
                            if cl.nodes[nid].datacenter == "dc1")
            cl.upsert_alloc(PORT.alloc(dc1_node, job_id="foreign",
                                       cpu=123))
        coord2.run()
        for t in threads:
            t.join(30.0)
        stack_mod.spec_chain_reset(cl)

    # chain-carry adoption families, NON-vacuously: a
    # 3-deep certified chain whose next refresh ADOPTS the published
    # HEAD carry (view.chain_adopts/chain_rows,
    # spec.resync_bytes_saved — process registry, like view.carry_*)
    cl3 = PORT.cluster(dc_nodes())
    _r3, fin_res, fin_ids = PORT.drive_chain(cl3, monkeypatch, k=3,
                                             reg=s.metrics)
    PORT.commit_round(cl3, fin_res, fin_ids)
    stack_mod.TorchStack(cl3, device="cpu").device_arrays()
    # ...one delta-log ring WRAP mid-chain (certification can no
    # longer prove the interval → spec.chain_unprovable_wrap) whose
    # published carry the next refresh must then REJECT
    # (view.chain_rejects) — same unprovable tail
    monkeypatch.setenv("NOMAD_TPU_DELTA_LOG", "8")
    cl4 = PORT.cluster(dc_nodes())
    monkeypatch.delenv("NOMAD_TPU_DELTA_LOG")
    _r4, fin_res4, fin_ids4 = PORT.drive_chain(cl4, monkeypatch, k=1,
                                               reg=s.metrics)
    PORT.commit_round(cl4, fin_res4, fin_ids4)
    for _ in range(12):  # blow past the 8-slot ring
        cl4._log_hot(0)
        cl4.version += 1
    assert stack_mod.spec_chain_certify(cl4) is None
    stack_mod.TorchStack(cl4, device="cpu").device_arrays()

    # mesh-CA denial outcomes, NON-vacuously: one
    # identity rejection (unknown node) and one allocation-binding
    # rejection (verified node identity, but no live alloc of the
    # named service) — the nomad_connect_* pins are real deny flows
    with pytest.raises(PermissionError):
        s.connect_issue("svc-x", "no-such-node", "not-a-secret")
    n = a.client.node
    with pytest.raises(PermissionError):
        s.connect_issue("svc-never-scheduled", n.id, n.secret_id)
    yield a, api
    a.shutdown()


@pytest.fixture()
def stray_site():
    """Books a site outside `ALLOWED_SITES` in the process-wide transfer
    ledger and HBM ledger, as an earlier test in the same worker might;
    requested before `loaded_agent`, so it is booked first."""
    import torch

    from nomad_tpu_torch.lib.hbm import default_hbm
    from nomad_tpu_torch.lib.transfer import default_ledger

    site = "stray.site_from_an_earlier_test"
    assert site not in ALLOWED_SITES
    default_ledger().record(site, 64)
    buf = torch.zeros(16)
    default_hbm().track(site, buf)
    yield site, buf


class TestSeriesNameStability:
    def test_stray_site_booked_before_the_fixture_stays_out(
            self, stray_site, loaded_agent):
        from nomad_tpu_torch.lib.hbm import default_hbm
        from nomad_tpu_torch.lib.transfer import default_ledger

        site, _buf = stray_site
        a, api = loaded_agent
        _, labels, sites = _parse(api.metrics_prometheus())
        assert site not in sites
        assert sites <= ALLOWED_SITES, sites - ALLOWED_SITES
        assert labels <= ALLOWED_LABELS, labels - ALLOWED_LABELS
        # the agent's books are not the ones the stray site went into
        assert site not in default_ledger().snapshot()
        assert site not in default_hbm().snapshot()

    def test_every_promised_name_is_exposed(self, loaded_agent):
        a, api = loaded_agent
        names, _, _ = _parse(api.metrics_prometheus())
        missing = REQUIRED - names
        assert not missing, (
            f"promised series missing/renamed: {sorted(missing)} — if this "
            f"is a deliberate rename, update REQUIRED in the same PR")

    def test_no_series_outside_allowed_families(self, loaded_agent):
        a, api = loaded_agent
        names, _, _ = _parse(api.metrics_prometheus())
        stray = sorted(
            n for n in names
            if not any(n.startswith(p)
                       or _strip_histo_suffix(n).startswith(p)
                       for p in ALLOWED_PREFIXES))
        assert not stray, (
            f"series outside the frozen family taxonomy: {stray} — a new "
            f"family must be added to ALLOWED_PREFIXES deliberately")

    def test_label_names_and_site_values_pinned(self, loaded_agent):
        a, api = loaded_agent
        _, labels, sites = _parse(api.metrics_prometheus())
        assert labels <= ALLOWED_LABELS, labels - ALLOWED_LABELS
        assert sites <= ALLOWED_SITES, sites - ALLOWED_SITES
        # lint-side booking prefixes (hbm.track_cluster/lease) are NOT
        # legal label values — a bare prefix leaking into the
        # exposition must keep failing here
        from nomad_tpu.analysis.vocab import BOOKING_PREFIXES
        assert not (ALLOWED_SITES & BOOKING_PREFIXES)
        # the fused-dispatch sites must actually be present (the flow
        # above ran batched coordinator rounds on the device-resident
        # program-table transport)
        assert "select_batch.fetch" in sites
        assert "select_batch.table_insert" in sites
        assert "select_batch.dyn_rows" in sites
        # ...and the residency ledger must have booked the loop's
        # long-lived buffers (view slots, program table, carry)
        assert "stack.view_hot" in sites
        assert "program_table.i32" in sites
        assert "select_batch.carry" in sites

    def test_batched_flow_populated_pipeline(self, loaded_agent):
        """Guard the fixture itself: if the batched path silently stops
        batching, the pipeline/worker families would vanish from the
        exposition and the stability test would be vacuous."""
        a, api = loaded_agent
        snap = a.server.metrics.snapshot()
        assert snap["counters"].get("pipeline.dispatches", 0) >= 1
        assert any(k.startswith("worker.0.batch.")
                   for k in snap["counters"])
        # the dc-pinned wave actually dispatched multi-lane — without
        # this the wave.* pins above would be testing absence
        assert snap["counters"].get("wave.dispatches", 0) >= 1
        assert snap["histograms"]["wave.lanes"]["max"] >= 2
        # the speculative rounds drove one certified AND one
        # rolled-back dispatch — the nomad_spec_* pins are live flows
        assert snap["counters"].get("spec.launches", 0) >= 2
        assert snap["counters"].get("spec.certified", 0) >= 1
        assert snap["counters"].get("spec.rolled_back", 0) >= 1
        assert snap["counters"].get("spec.redispatch_programs", 0) >= 1
        assert snap["counters"].get("spec.wasted_kernel_ms", 0) > 0
        # the chain-adoption rounds drove one ADOPTED refresh, one
        # REJECTED carry, and one ring-wrap — the chain-adoption pins are
        # live flows (process registry, like the view.* family)
        from nomad_tpu_torch.lib.metrics import default_registry
        view = default_registry().counters(prefix="view.")
        assert view.get("chain_adopts", 0) >= 1
        assert view.get("chain_rows", 0) >= 1
        assert view.get("chain_rejects", 0) >= 1
        proc_spec = default_registry().counters(prefix="spec.")
        assert proc_spec.get("resync_bytes_saved", 0) > 0
        assert proc_spec.get("chain_unprovable_wrap", 0) >= 1
        # the connect denial series are live deny flows with DISTINCT
        # per-reason counters, not eagerly-created zeros
        assert snap["counters"].get("connect.issue_denied", 0) >= 2
        assert snap["counters"].get(
            "connect.issue_denied_identity", 0) >= 1
        assert snap["counters"].get(
            "connect.issue_denied_no_alloc", 0) >= 1

    def test_trace_and_slo_series_are_live(self, loaded_agent):
        """The ninth-layer families must be fed by real
        flows, not just pre-created at tracker init: every HTTP submit
        above minted an ingress span, and each placed alloc's
        pending→running flip recorded an SLO observation."""
        from nomad_tpu_torch.lib.tracectx import SLO_BANDS, default_spans

        a, api = loaded_agent
        # ingress spans were recorded for the submits the fixture drove
        assert default_spans().counts().get("http.submit", 0) >= 3
        # eval spans were bound at broker enqueue and emitted at ack
        assert default_spans().counts().get("eval", 0) >= 1
        # alloc start-latency observations land asynchronously as
        # client allocs flip to running
        assert _wait(lambda: a.server.metrics.snapshot()["counters"]
                     .get("slo.observations", 0) >= 1)
        names, _, _ = _parse(api.metrics_prometheus())
        assert "nomad_trace_spans" in names
        assert "nomad_slo_observations" in names
        # per-band attainment/budget gauges exist from first exposition
        # (dashboards need the full band matrix, not lazily-appearing
        # rows)
        for band in SLO_BANDS:
            assert f"nomad_slo_attainment_{band}" in names
            assert f"nomad_slo_budget_remaining_{band}" in names




    def test_event_stream_series_are_live(self, loaded_agent):
        """The tenth-layer families are fed by the real FSM
        apply flow, not eagerly-created zeros: every node/job/eval/
        alloc mutation above published a typed event, and the whole
        per-topic family is present from first exposition."""
        a, api = loaded_agent
        snap = a.server.metrics.snapshot()
        assert snap["counters"].get("events.published", 0) >= 1
        assert snap["counters"].get("events.topic.job", 0) >= 1
        assert snap["counters"].get("events.topic.eval", 0) >= 1
        assert snap["counters"].get("events.topic.alloc", 0) >= 1
        assert a.server.metrics.gauge("events.last_index").value >= 1
        names, _, _ = _parse(api.metrics_prometheus())
        for t in ("job", "eval", "alloc", "deployment", "node",
                  "plan"):
            assert f"nomad_events_topic_{t}" in names
        assert "nomad_events_published" in names
        assert "nomad_events_subscribers" in names
        assert "nomad_events_subscriber_evictions" in names
        assert "nomad_events_oldest_index" in names
        assert "nomad_events_last_index" in names


class TestControlPlaneSeries:
    """nomad_raft_* pinning + the flight-event type vocabulary,
    NON-vacuously: a 1-node ClusterServer drives a real leader
    transition (election → leadership.gained) and a delivery-limited
    nack drives broker.eval_failed — the control-plane fixture contract."""

    def test_raft_series_and_flight_vocabulary(self):
        from nomad_tpu_torch.lib.flight import FLIGHT_TYPES, default_flight
        from nomad_tpu_torch.server.broker import EvalBroker
        from nomad_tpu_torch.server.cluster import (ClusterServer,
                                              ClusterServerConfig)

        idx0 = default_flight().last_index()
        cs = ClusterServer(ClusterServerConfig(
            node_id="mx0", heartbeat_ttl=60.0, gc_interval=3600.0), device="cpu")
        cs.start()
        try:
            assert _wait(cs.is_leader, timeout=30.0)
            cs.call("node_register", mock.node())  # commit traffic
            # a malformed entry exercises apply_resilient's skip path
            #: committed on every replica, dropped by the
            # FSM identically — fsm.apply_skipped must tick
            cs.raft.apply({"op": "bogus_op", "args": []})
            names, labels, _ = _parse(cs.raft.metrics.prometheus())
            missing = (RAFT_REQUIRED | FSM_REQUIRED) - names
            assert not missing, (
                f"promised raft/fsm series missing/renamed: "
                f"{sorted(missing)}")
            stray = sorted(n for n in names
                           if not _strip_histo_suffix(n)
                           .startswith(("nomad_raft_", "nomad_fsm_")))
            assert not stray, stray
            assert labels <= ALLOWED_LABELS
            # the election IS a leadership transition — non-vacuous
            assert cs.raft.metrics.counter(
                "raft.leadership_gained").value >= 1
            assert cs.raft.metrics.histogram("raft.commit_ms").count >= 1
            # FSM outcome counters are live flows: node_register was
            # applied, the bogus op was skipped (never fatal)
            assert cs.raft.metrics.counter("fsm.applied").value >= 1
            assert _wait(lambda: cs.raft.metrics.counter(
                "fsm.apply_skipped").value >= 1, timeout=10.0)
        finally:
            cs.shutdown()
        # nacked-to-exhaustion eval → broker.eval_failed flight event
        b = EvalBroker(nack_timeout=0, delivery_limit=1)
        b.set_enabled(True)
        ev = mock.eval_()
        b.enqueue(ev)
        got, tok = b.dequeue([ev.type], timeout=1.0)
        b.nack(got.id, tok)
        b.shutdown()
        _, evs = default_flight().records_after(idx0)
        types = {e["type"] for e in evs}
        assert types <= FLIGHT_TYPES, types - FLIGHT_TYPES
        assert {"leadership.gained", "raft.term",
                "broker.eval_failed"} <= types
        # lifetime counts carry the same closed vocabulary
        assert set(default_flight().counts()) <= FLIGHT_TYPES
