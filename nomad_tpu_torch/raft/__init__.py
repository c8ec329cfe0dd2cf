"""Raft consensus (reference: hashicorp/raft v1.1.3 used at
`nomad/server.go:1198` setupRaft, transported over the dedicated RaftLayer
`nomad/raft_rpc.go:17`). Here the transport is the msgpack-RPC fabric
(`nomad_tpu.rpc`) and the replicated entries are the FSM ops of
`nomad_tpu/server/fsm.py` — the same stream the single-server WAL journals.
"""
from .raft import RaftNode, NotLeaderError

__all__ = ["RaftNode", "NotLeaderError"]
