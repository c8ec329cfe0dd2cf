"""The port's copies do not drift from the reference package.

Every module of `nomad_tpu_torch/` that has a counterpart at the same path
in `nomad_tpu/` is either a byte-identical copy (its relative imports then
bind to the port's own modules) or named in `REWRITTEN` with what differs;
a module whose counterpart lies elsewhere is named in `ELSEWHERE`.
A copy edited by accident, or a rewrite left off the list, fails here.
"""
import re
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
PORT, REF = REPO / "nomad_tpu_torch", REPO / "nomad_tpu"

#: port modules that differ from their reference on purpose
REWRITTEN = {
    "__init__.py": "the port's own package docstring; it imports "
                   "nothing, so the client's children start without torch",
    "__main__.py": "its docstring names `python -m nomad_tpu_torch`",
    "agent/__init__.py": "Agent(config, device=None): the device resolved "
                         "first (a server and no card raise RuntimeError) "
                         "and passed to the Server it builds; no JAX "
                         "platform pin; its logger names are the port's",
    "agent/http.py": "job plan's Harness runs on the server's device",
    "cli.py": "usage names `python -m nomad_tpu_torch`; `agent -device` "
              "(the card by default, `cpu` for the CPU) in place of the "
              "reference's JAX_PLATFORMS=cpu, passed to Agent(device=)",
    "client/alloc_runner.py": "its three logger names are the port's",
    "client/devicemanager.py": "GpuDevicePlugin in place of the TPU "
                               "plugin: nvidia/gpu groups, reserved as "
                               "CUDA_ and NVIDIA_VISIBLE_DEVICES; the "
                               "device host child is the port's",
    "client/drivers/connect.py": "the proxy child is the port's "
                                 "connect_proxy",
    "client/drivers/executor_driver.py": "the executor child is the "
                                         "port's; no TPU-host path filter",
    "client/drivers/remote.py": "the driver host child is the port's",
    "client/fingerprint.py": "gpu_fingerprint (a bounded nvidia-smi "
                             "reading) in place of the JAX TPU probe",
    "lib/metrics.py": "its logger name is the port's",
    "lib/roofline.py": "the H100's datasheet peaks keyed by the CUDA "
                       "device name; kernel_cost counts the port's "
                       "kernels by the function they compute (torch has "
                       "no cost model); time_compiled syncs the card",
    "native/__init__.py": "builds its own copy of core.cpp into build/ "
                          "under a hash of source and flags, renamed into "
                          "place; no fallback: a failed build raises; "
                          "compiled_select reads a TorchStack",
    "plugins/device_host.py": "builtin plugins gpu and env; usage names "
                              "the port",
    "plugins/driver_host.py": "usage names the port",
    "plugins/executor.py": "the taskinit child is the port's; no TPU "
                           "tunnel variable to drop",
    "plugins/isolation.py": "the port's own cgroup parent",
    "server/deployments.py": "its logger name is the port's",
    "analysis/__init__.py": "the lazy package of the port's lint engine: "
                            "TORCH_RULES in place of JAX_RULES",
    "analysis/__main__.py": "prog `python -m nomad_tpu_torch.analysis`; "
                            "the port's default root and "
                            "lint_baseline_torch.json; --explain reads "
                            "tests/torch_lint_fixtures",
    "analysis/core.py": "paths anchored at nomad_tpu_torch; the port's "
                        "root and lint_baseline_torch.json; torch_rules "
                        "in place of jax_rules, no jit registry pass",
    "analysis/device_rules.py": "NLD01, NLD03 and NLD04 read torch "
                                "transfers, allocations and lane stacks "
                                "over the port's scopes; NLD02 left out "
                                "(torch has no donation)",
    "analysis/thread_rules.py": "the scope prefixes name the port",
    "kernels/__init__.py": "the port's kernel package",
    "kernels/placement.py": "PyTorch plain versions and CUDA wrappers; "
                            "sharded views route to kernels/shard.py",
    "lib/hbm.py": "torch tensors and torch.cuda memory stats; its logger "
                  "name is the port's; with no card visible the planner "
                  "falls back to an H100 80GB HBM3's total memory "
                  "(DEFAULT_HBM_BYTES), not a TPU's",
    "lib/trace.py": "comments naming the reference's issues",
    "lib/tracectx.py": "comments naming the reference's issues",
    "lib/transfer.py": "guard_scope counts; torch has no transfer guard",
    "parallel/__init__.py": "the mesh's names and the host padding",
    "parallel/mesh.py": "a grid of torch devices, K9 and the sharded "
                        "routes in place of GSPMD; shard_tensor, "
                        "route_rows",
    "kernels/preemption.py": "PyTorch plain version and CUDA wrapper (K3)",
    "scheduler/__init__.py": "the port's package docstring; TorchStack "
                             "and its kin loaded from the stack at first "
                             "use, so a CLI call decodes without torch",
    "scheduler/generic.py": "device=, TorchStack; the retry ranks on it",
    "scheduler/harness.py": "device=, passed to both schedulers",
    "scheduler/preemption.py": "the retry on torch tensors: four uploads",
    "scheduler/system.py": "device=, TorchStack, K2 under a view lease",
    "scheduler/stack.py": "TorchStack: per-device view cache, K7, leases; "
                          "a ShardedCluster under a mesh, K7 per shard; "
                          "explain=None defers to NOMAD_TPU_EXPLAIN "
                          "(explain_enabled) as in the reference",
    "server/broker.py": "comments naming the reference's issues",
    "server/cluster.py": "device=, resolved before any socket opens and "
                         "passed to every Server it builds; a new "
                         "leader commits a Raft barrier before its "
                         "subsystems start and serves no call until "
                         "they are up",
    "server/heartbeat.py": "one deadline heap and one thread for every "
                           "node's TTL, not a timer thread a node",
    "server/plan_apply.py": "comments naming the reference's issues",
    "server/program_table.py": "torch tables, the row-scatter insert",
    "server/select_batch.py": "CUDA-event outputs, leased fallbacks",
    "server/server.py": "device=; a mesh must lead on the server's device",
    "server/wal.py": "a comment naming the reference's issues",
    "server/worker.py": "schedulers take the server's device",
    "structs/alloc.py": "comments naming the reference's issues",
    "structs/codec.py": "registry of the port's own classes, ACL ones "
                        "included, by package-relative imports, built "
                        "whole under a lock and then published",
    "structs/evaluation.py": "comments naming the reference's issues",
    "structs/funcs.py": "a comment pointing at the port's kernel module",
    "structs/plan.py": "comments naming the reference's issues",
    "synth.py": "a comment naming the reference's issues",
    "tensor/cluster.py": "a comment naming the reference's issues",
}


#: port modules whose counterpart lies elsewhere in the repository
ELSEWHERE = {
    "entry.py": "__graft_entry__.py",
    "analysis/torch_rules.py": "nomad_tpu/analysis/jax_rules.py",
}


def _counterparts():
    return sorted(str(p.relative_to(PORT)) for p in PORT.rglob("*.py")
                  if (REF / p.relative_to(PORT)).is_file())


@pytest.mark.parametrize("rel", _counterparts())
def test_copy_is_identical_or_listed_as_rewritten(rel):
    same = (PORT / rel).read_bytes() == (REF / rel).read_bytes()
    if rel in REWRITTEN:
        assert not same, f"{rel} is identical again: drop it from REWRITTEN"
    else:
        assert same, f"{rel} differs from nomad_tpu/{rel} and is not " \
                     "listed in REWRITTEN"


def test_rewritten_list_names_existing_modules():
    missing = [rel for rel in REWRITTEN
               if not ((PORT / rel).is_file() and (REF / rel).is_file())]
    assert not missing, missing


@pytest.mark.parametrize("rel", sorted(ELSEWHERE))
def test_counterpart_elsewhere_exists_and_is_rewritten(rel):
    port, ref = PORT / rel, REPO / ELSEWHERE[rel]
    assert port.is_file() and ref.is_file()
    assert not (REF / rel).exists(), f"{rel} has a same-path counterpart"
    assert port.read_bytes() != ref.read_bytes()


def _reference_modules(*parts):
    return sorted(str(p.relative_to(REF)) for part in parts
                  for p in ((REF / part).rglob("*.py") if (REF / part).is_dir()
                            else [REF / part]))


@pytest.mark.parametrize("rel", _reference_modules(
    "client", "plugins", "api", "connect_proxy.py"))
def test_client_plugins_and_api_have_counterparts(rel):
    assert (PORT / rel).is_file(), f"nomad_tpu/{rel} has no port"


@pytest.mark.parametrize("rel", _reference_modules(
    "agent", "cli.py", "__main__.py"))
def test_agent_http_api_and_cli_have_counterparts(rel):
    assert (PORT / rel).is_file(), f"nomad_tpu/{rel} has no port"


@pytest.mark.parametrize("rel", _reference_modules("analysis"))
def test_lint_engine_has_counterparts(rel):
    elsewhere = {v: k for k, v in ELSEWHERE.items()}
    port = PORT / elsewhere.get(f"nomad_tpu/{rel}", rel)
    assert port.is_file(), f"nomad_tpu/{rel} has no port"


def test_only_the_modules_left_out_on_purpose_are_missing():
    """After the host core and the roofline, the reference's modules
    without a port at the same path are `analysis/jax_rules.py` (its
    counterpart is `analysis/torch_rules.py`) and `utils/` (the port's
    `utils.py` stands for it)."""
    missing = {str(p.relative_to(REF)) for p in REF.rglob("*.py")
               if not (PORT / p.relative_to(REF)).is_file()}
    left_out = {m for m in missing
                if m.startswith("utils/") or m == "analysis/jax_rules.py"}
    assert missing == left_out, sorted(missing - left_out)


def test_the_host_core_source_is_a_copy():
    """The port builds its own copy of the C++ host core, byte for byte
    the reference's `native/core.cpp`."""
    assert (PORT / "native" / "core.cpp").read_bytes() == \
        (REPO / "native" / "core.cpp").read_bytes()


#: `NOMAD_TPU_*` settings the reference reads and the port does not, each
#: with its reason
SETTINGS_DROPPED = {
    "NOMAD_TPU_NO_NATIVE": "the port's host core has no fallback: a "
                           "failed g++ build raises (native/__init__.py)",
    "NOMAD_TPU_SKIP_TPU_FINGERPRINT": "the TPU probe is gone; the GPU "
                                      "probe's switch is "
                                      "NOMAD_TPU_SKIP_GPU_FINGERPRINT",
    "NOMAD_TPU_TRANSFER_GUARD": "PyTorch has no transfer guard: the "
                                "port's guard_scope counts and forbids "
                                "nothing, at any level (lib/transfer.py)",
}

_SETTING = re.compile(rb"NOMAD_TPU_[A-Z0-9_]*[A-Z0-9]")


def _settings(root):
    found = set()
    for p in root.rglob("*.py"):
        found.update(m.decode() for m in _SETTING.findall(p.read_bytes()))
    return found


def test_the_port_reads_every_setting_the_reference_reads():
    """Every `NOMAD_TPU_*` name the reference reads is read by the port
    too, under the same name, but the ones dropped on purpose; and each
    of those is really gone from the port."""
    ref, port = _settings(REF), _settings(PORT)
    assert ref - port == set(SETTINGS_DROPPED), sorted(ref - port)
    assert not set(SETTINGS_DROPPED) & port
    assert "NOMAD_TPU_EXPLAIN" in port
