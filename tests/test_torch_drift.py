"""The port's copies do not drift from the reference package.

Every module of `nomad_tpu_torch/` that has a counterpart at the same path
in `nomad_tpu/` is either a byte-identical copy (its relative imports then
bind to the port's own modules) or named in `REWRITTEN` with what differs;
a module whose counterpart lies elsewhere is named in `ELSEWHERE`.
A copy edited by accident, or a rewrite left off the list, fails here.
"""
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
PORT, REF = REPO / "nomad_tpu_torch", REPO / "nomad_tpu"

#: port modules that differ from their reference on purpose
REWRITTEN = {
    "__init__.py": "the port's own package docstring",
    "analysis/__init__.py": "only the name sets, no lint engine",
    "analysis/vocab.py": "the four name sets the copies import",
    "kernels/__init__.py": "the port's kernel package",
    "kernels/placement.py": "PyTorch plain versions and CUDA wrappers; "
                            "sharded views route to kernels/shard.py",
    "lib/hbm.py": "torch tensors and torch.cuda memory stats",
    "lib/trace.py": "comments naming the reference's issues",
    "lib/tracectx.py": "comments naming the reference's issues",
    "lib/transfer.py": "guard_scope counts; torch has no transfer guard",
    "parallel/__init__.py": "the mesh's names and the host padding",
    "parallel/mesh.py": "a grid of torch devices, K9 and the sharded "
                        "routes in place of GSPMD; shard_tensor, "
                        "route_rows",
    "kernels/preemption.py": "PyTorch plain version and CUDA wrapper (K3)",
    "scheduler/__init__.py": "the port's package docstring, TorchStack",
    "scheduler/generic.py": "device=, TorchStack; the retry ranks on it",
    "scheduler/harness.py": "device=, passed to both schedulers",
    "scheduler/preemption.py": "the retry on torch tensors: four uploads",
    "scheduler/system.py": "device=, TorchStack, K2 under a view lease",
    "scheduler/stack.py": "TorchStack: per-device view cache, K7, leases; "
                          "a ShardedCluster under a mesh, K7 per shard",
    "server/broker.py": "comments naming the reference's issues",
    "server/cluster.py": "device=, resolved before any socket opens and "
                         "passed to every Server it builds",
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
                        "included, by package-relative imports",
    "structs/evaluation.py": "comments naming the reference's issues",
    "structs/funcs.py": "a comment pointing at the port's kernel module",
    "structs/network.py": "only the pure-Python first-fit",
    "structs/plan.py": "comments naming the reference's issues",
    "synth.py": "a comment naming the reference's issues",
    "tensor/cluster.py": "a comment naming the reference's issues",
}


#: port modules whose counterpart lies elsewhere in the repository
ELSEWHERE = {
    "entry.py": "__graft_entry__.py",
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
