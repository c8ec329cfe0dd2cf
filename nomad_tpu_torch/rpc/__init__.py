"""msgpack-RPC fabric (reference: `nomad/rpc.go` + `helper/pool/pool.go`).

The reference multiplexes msgpack-RPC over yamux on one TCP port with a
client-side connection pool; here each peer connection is a single TCP
stream carrying length-prefixed msgpack frames with seq-matched pipelined
requests (the pipelining gives what yamux streams gave the reference), and
`ConnPool` keeps one shared connection per address.
"""
from .transport import ConnPool, RpcClient, RpcError, RpcServer

__all__ = ["ConnPool", "RpcClient", "RpcError", "RpcServer"]
