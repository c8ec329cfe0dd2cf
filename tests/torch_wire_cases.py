"""One seeded op log in the reference's own wire trees, for the port's
FSM, WAL and region twins.

`op_log(tmp_dir)` performs a fixed series of writes on the reference's
`DurableStateStore` and returns what its WAL journaled: `{"op", "args"}`
entries exactly as the reference writes them to disk or to a Raft log
(`wal._encode_args`: plan results without embedded jobs, timestamps and
token ids minted by the caller). The series touches every table the FSM
can write: nodes, jobs and versions, evals (a blocked and a follow-up one),
plan results, client updates, deployments, the scheduler and autopilot
configurations, ACL policies and tokens and the bootstrap, CSI volumes with
claims and controller ops, service registrations, secrets, namespaces and
quotas, and deletes of each kind.

`replay(pkg, log)` applies a log through one package's FSM onto a fresh
store of that package with its event broker attached, and returns the
store.
"""
from __future__ import annotations

import copy
import random

from nomad_tpu import mock
from nomad_tpu.acl.tokens import ACLPolicy, ACLToken
from nomad_tpu.scheduler.util import SchedulerConfiguration
from nomad_tpu.server.wal import DurableStateStore, Wal
from nomad_tpu.structs.csi import CSIVolume
from nomad_tpu.structs.deployment import new_deployment
from nomad_tpu.structs.operator import AutopilotConfig, Namespace, QuotaSpec
from nomad_tpu.structs.plan import PlanResult
from nomad_tpu.structs.secrets import SecretEntry
from nomad_tpu.structs.service import ServiceRegistration
from nomad_tpu.synth import synth_node

#: leader-minted wall time that rides the entries
NOW = 1723.5

READ_RULES = 'namespace "default" { policy = "read" }'
WRITE_RULES = ('namespace "team-a" { policy = "write" }\n'
               'node { policy = "read" }')


def _writes(store, seed: int, n_nodes: int, n_allocs: int) -> None:
    rng = random.Random(seed)
    nodes = [synth_node(rng, i) for i in range(n_nodes)]
    for n in nodes:
        store.upsert_node(n)
    job = mock.job()
    job.task_groups[0].count = n_allocs
    store.upsert_job(job)
    job2 = copy.deepcopy(job)
    job2.version = 1
    job2.meta = {"rev": "2"}
    store.upsert_job(job2)
    ev = mock.eval_(job_id=job.id)
    store.upsert_eval(ev)
    store.upsert_eval(ev.create_blocked_eval({}, True, "", now=NOW))
    store.upsert_eval(ev.create_failed_follow_up_eval(30.0, now=NOW))

    placed = {}
    allocs = []
    for i in range(n_allocs):
        node = nodes[rng.randrange(n_nodes)]
        a = mock.alloc(job=job2, node_id=node.id, eval_id=ev.id,
                       name=f"{job.id}.web[{i}]")
        placed.setdefault(node.id, []).append(a)
        allocs.append(a)
    store.upsert_plan_results(None, PlanResult(node_allocation=placed))
    upd = copy.copy(allocs[0])
    upd.client_status = "running"
    store.update_alloc_from_client(upd)

    d = new_deployment(job2)
    store.upsert_deployment(d)
    store.mark_job_stable(job.namespace, job.id, 1)
    store.set_scheduler_config(
        SchedulerConfiguration(preemption_service_enabled=True))
    store.set_autopilot_config(AutopilotConfig(max_trailing_logs=99))

    store.upsert_acl_policy(ACLPolicy(name="readonly", rules=READ_RULES))
    store.upsert_acl_policy(ACLPolicy(name="team", rules=WRITE_RULES,
                                      description="team a"))
    store.upsert_acl_token(ACLToken(
        accessor_id="acc-1", secret_id="sec-1", name="reader",
        policies=["readonly"], create_time=NOW))
    store.upsert_acl_token(ACLToken(
        accessor_id="acc-2", secret_id="sec-2", name="team",
        policies=["team", "readonly"], create_time=NOW))
    store.acl_bootstrap(ACLToken(
        accessor_id="acc-boot", secret_id="sec-boot", name="Bootstrap",
        type="management", global_=True, create_time=NOW))
    store.delete_acl_token("acc-2")
    store.delete_acl_policy("team")

    store.upsert_csi_volume(CSIVolume(id="vol0", name="vol0",
                                      plugin_id="hostpath",
                                      controller_required=True))
    store.upsert_csi_volume(CSIVolume(id="vol1", name="vol1",
                                      plugin_id="hostpath"))
    store.csi_volume_claim("default", "vol0", allocs[0].id, "write")
    store.csi_volume_claim("default", "vol1", allocs[1].id, "read")
    store.csi_controller_request("default", "vol0", allocs[0].node_id,
                                 "publish")
    gen = store.csi_volume("default", "vol0").controller_pending[
        allocs[0].node_id]["gen"]
    store.csi_controller_done("default", "vol0", allocs[0].node_id,
                              "publish", {"dev": "/dev/vol0"}, "",
                              "ctrl-host", gen)
    store.csi_volume_release("default", "vol1", allocs[1].id)
    store.delete_csi_volume("default", "vol1")

    store.upsert_service_registrations([
        ServiceRegistration(id=f"_svc-{i}", service_name="web",
                            node_id=a.node_id, job_id=job.id,
                            alloc_id=a.id, port=20000 + i)
        for i, a in enumerate(allocs[:3])])
    store.delete_service_registrations_by_alloc(allocs[2].id)

    store.upsert_quota(QuotaSpec(name="q", cpu=5000, memory_mb=4096))
    store.upsert_namespace(Namespace(name="team-a", quota="q",
                                     description="team a"))
    store.upsert_namespace(Namespace(name="team-b"))
    store.delete_namespace("team-b")
    store.upsert_quota(QuotaSpec(name="gone", cpu=1))
    store.delete_quota("gone")
    store.upsert_secret(SecretEntry(namespace="team-a", path="db/creds",
                                    data={"user": "app", "pass": "x"}))
    store.upsert_secret(SecretEntry(namespace="team-a", path="db/creds",
                                    data={"user": "app", "pass": "y"}))
    store.upsert_secret(SecretEntry(path="tmp", data={"k": "v"}))
    store.delete_secret("default", "tmp")

    gone = mock.batch_job()
    store.upsert_job(gone)
    store.upsert_alloc(mock.alloc(job=gone, node_id=nodes[0].id))
    d2 = new_deployment(gone)
    store.upsert_deployment(d2)
    store.delete_deployment(d2.id)
    store.delete_job(gone.namespace, gone.id)
    store.delete_alloc(allocs[-1].id)
    store.delete_eval(ev.id)
    store.delete_node(nodes[-1].id)


def op_log(tmp_dir: str, seed: int = 14, n_nodes: int = 20,
           n_allocs: int = 30):
    """The journaled entries of the reference's writes (module docstring)."""
    wal = Wal(tmp_dir)
    store = DurableStateStore(wal, snapshot_threshold=1 << 30)
    _writes(store, seed, n_nodes, n_allocs)
    wal.close()
    snap, entries = Wal(tmp_dir).load()
    assert snap is None
    return [{"op": e["op"], "args": e["args"]} for e in entries]


def ops_of(log):
    return {e["op"] for e in log}


def replay(pkg: str, log, resilient: bool = False):
    """A fresh store of `pkg` ("port" or "reference"), the log applied
    through that package's FSM, its event broker attached."""
    if pkg == "port":
        from nomad_tpu_torch.server.event_broker import ClusterEventBroker
        from nomad_tpu_torch.server.fsm import FSM
        from nomad_tpu_torch.server.state import StateStore
    else:
        from nomad_tpu.server.event_broker import ClusterEventBroker
        from nomad_tpu.server.fsm import FSM
        from nomad_tpu.server.state import StateStore
    state = StateStore()
    state.event_broker = ClusterEventBroker()
    fsm = FSM(state)
    for entry in log:
        (fsm.apply_resilient if resilient else fsm.apply)(entry)
    return state


def fingerprints(pkg: str, state):
    """(state_fingerprint, events_fingerprint) by `pkg`'s own functions."""
    if pkg == "port":
        from nomad_tpu_torch.server.event_broker import events_fingerprint
        from nomad_tpu_torch.server.fsm import state_fingerprint
    else:
        from nomad_tpu.server.event_broker import events_fingerprint
        from nomad_tpu.server.fsm import state_fingerprint
    return (state_fingerprint(state),
            events_fingerprint(state.event_broker.buffered()))
