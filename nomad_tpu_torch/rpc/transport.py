"""TCP transport: length-prefixed msgpack frames, seq-matched pipelining.

Behavioral reference: `nomad/rpc.go` (listener/dispatch :104,253),
`helper/pool/pool.go` (msgpack codecs :23-28, conn pool :130). Frames are
`uint32 big-endian length + msgpack body`:

  request : {"t": "req", "seq": N, "method": "Job.Register", "args": [...],
             "ctx": {"t": trace_id, "s": span_id, "p": parent}?}
  response: {"t": "res", "seq": N, "ok": bool, "result": ..., "error": str}

The optional `ctx` slot is distributed-trace context (lib/tracectx.py):
`RpcClient.call` injects a CHILD of the caller thread's current context
(recording the hop as an `rpc.forward` span), `RpcServer._handle_one`
restores it onto the handler thread, so a forwarded call re-injects it
on the next hop automatically. Peers without the slot interoperate —
absent or malformed context is simply no trace, never an error.

Handlers are registered by dotted method name exactly like the reference's
`<Endpoint>.<Method>` msgpack-RPC convention. The server answers requests
on a connection concurrently (one worker per request) so a slow RPC —
e.g. a blocking query — doesn't head-of-line-block Raft heartbeats sharing
the address (the reference gets this from yamux streams + goroutines).
"""
from __future__ import annotations

import socket
import struct
import threading
import time
from typing import Any, Callable, Dict, Optional, Tuple

import msgpack

from ..lib.metrics import MetricsRegistry, default_registry
from ..lib.tracectx import (TraceContext, current as trace_current,
                            default_spans, trace_enabled, use as trace_use)

_LEN = struct.Struct(">I")
MAX_FRAME = 64 * 1024 * 1024


class RpcError(Exception):
    """Remote handler raised; message carries the remote error string."""


def _read_exact(sock: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed")
        buf += chunk
    return buf


def read_frame(sock: socket.socket) -> Any:
    (length,) = _LEN.unpack(_read_exact(sock, 4))
    if length > MAX_FRAME:
        raise ConnectionError(f"frame too large: {length}")
    return msgpack.unpackb(_read_exact(sock, length), raw=False,
                           strict_map_key=False)


def write_frame(sock: socket.socket, obj: Any,
                lock: Optional[threading.Lock] = None) -> None:
    body = msgpack.packb(obj, use_bin_type=True)
    frame = _LEN.pack(len(body)) + body
    if lock is not None:
        with lock:
            sock.sendall(frame)
    else:
        sock.sendall(frame)


class RpcServer:
    """Listens on (host, port); dispatches requests to named handlers."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 tls=None) -> None:
        self._handlers: Dict[str, Callable] = {}
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(128)
        self.addr: Tuple[str, int] = self._sock.getsockname()
        # mTLS wrap of accepted conns (nomad/rpc.go:225-260 RpcTLS)
        self._tls_ctx = None
        if tls is not None and tls.enabled:
            from ..lib.tlsutil import server_context

            self._tls_ctx = server_context(tls)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def register(self, method: str, handler: Callable) -> None:
        self._handlers[method] = handler

    def register_endpoint(self, name: str, obj: Any,
                          wrap: Optional[Callable] = None) -> None:
        """Register every public method of `obj` as `Name.method`
        (the reference's per-noun endpoint structs, nomad/server.go
        setupRpcServer). `wrap(fn) -> fn` decorates each handler (e.g.
        activity tracking) without duplicating this scan at call sites."""
        for attr in dir(obj):
            if attr.startswith("_"):
                continue
            fn = getattr(obj, attr)
            if callable(fn):
                self.register(f"{name}.{attr}",
                              wrap(fn) if wrap is not None else fn)

    def start(self) -> None:
        self._thread = threading.Thread(target=self._accept_loop,
                                        name="rpc-accept", daemon=True)
        self._thread.start()

    def shutdown(self) -> None:
        self._stop.set()
        # shutdown() BEFORE close(): the accept thread is blocked inside
        # accept(2), which holds the socket open at the kernel — close()
        # alone neither wakes it nor frees the port, so a restarted agent
        # could never rebind its own address. SHUT_RDWR forces accept to
        # return, releasing the listener.
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            threading.Thread(target=self._serve_conn, args=(conn,),
                             daemon=True).start()

    def _serve_conn(self, conn: socket.socket) -> None:
        if self._tls_ctx is not None:
            # handshake in the per-connection thread with a deadline — a
            # stalled peer costs its own thread, never the accept loop
            try:
                conn.settimeout(10.0)
                conn = self._tls_ctx.wrap_socket(conn, server_side=True)
                conn.settimeout(None)
            except Exception:  # noqa: BLE001 — bad/slow handshake: drop
                try:
                    conn.close()
                except OSError:
                    pass
                return
        wlock = threading.Lock()
        try:
            while not self._stop.is_set():
                msg = read_frame(conn)
                threading.Thread(
                    target=self._handle_one, args=(conn, wlock, msg),
                    daemon=True,
                ).start()
        except (ConnectionError, OSError):
            pass
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def _handle_one(self, conn, wlock, msg) -> None:
        res = {"t": "res", "seq": msg.get("seq")}
        handler = self._handlers.get(msg.get("method", ""))
        # restore the caller's trace context onto this handler thread:
        # a forwarding handler's own pool.call then re-injects it on
        # the next hop with no per-endpoint plumbing
        ctx = TraceContext.from_wire(msg.get("ctx"))
        try:
            if handler is None:
                raise RpcError(f"unknown method {msg.get('method')!r}")
            with trace_use(ctx):
                result = handler(*msg.get("args", []))
            res["ok"] = True
            res["result"] = result
        except Exception as e:  # noqa: BLE001 — errors cross the wire
            res["ok"] = False
            res["error"] = f"{type(e).__name__}: {e}"
        try:
            write_frame(conn, res, wlock)
        except (ConnectionError, OSError):
            pass


class _Pending:
    __slots__ = ("event", "msg")

    def __init__(self) -> None:
        self.event = threading.Event()
        self.msg: Optional[dict] = None


class RpcClient:
    """One pipelined connection to a peer; thread-safe call()."""

    def __init__(self, host: str, port: int,
                 connect_timeout: float = 5.0, tls=None,
                 metrics: Optional[MetricsRegistry] = None) -> None:
        self.addr = (host, port)
        # transport telemetry lands in the process-global registry by
        # default (go-metrics global sink): clients are created deep in
        # pools where no server registry is in reach
        self.metrics = metrics if metrics is not None else default_registry()
        self._sock = socket.create_connection(self.addr,
                                              timeout=connect_timeout)
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        if tls is not None and tls.enabled:
            # wrap while connect_timeout still bounds the handshake
            from ..lib.tlsutil import client_context

            self._sock = client_context(tls).wrap_socket(self._sock)
        self._sock.settimeout(None)
        self._wlock = threading.Lock()
        self._plock = threading.Lock()
        self._pending: Dict[int, _Pending] = {}
        self._seq = 0
        self._closed = False
        self._reader = threading.Thread(target=self._read_loop,
                                        name="rpc-reader", daemon=True)
        self._reader.start()

    def _read_loop(self) -> None:
        try:
            while True:
                msg = read_frame(self._sock)
                with self._plock:
                    p = self._pending.pop(msg.get("seq"), None)
                if p is not None:
                    p.msg = msg
                    p.event.set()
        except (ConnectionError, OSError):
            self._fail_all()

    def _fail_all(self) -> None:
        self._closed = True
        with self._plock:
            pending, self._pending = self._pending, {}
        for p in pending.values():
            p.event.set()

    def call(self, method: str, *args: Any,
             timeout: Optional[float] = 10.0) -> Any:
        t0 = time.perf_counter()
        try:
            result = self._call(method, *args, timeout=timeout)
        except Exception:
            self.metrics.inc("rpc.client.errors")
            self.metrics.inc(f"rpc.client.errors.{method}")
            raise
        # request→response latency distribution, total + per-method
        # (method names are a bounded set — the endpoint registry)
        ms = (time.perf_counter() - t0) * 1e3
        self.metrics.add_sample("rpc.client.call_ms", ms)
        self.metrics.add_sample(f"rpc.client.method.{method}_ms", ms)
        return result

    def _call(self, method: str, *args: Any,
              timeout: Optional[float] = 10.0) -> Any:
        # the closed check lives under _plock WITH the registration:
        # checked outside, a teardown between check and register left a
        # _Pending nobody would ever fail — the caller then hung out
        # its full timeout (forever with timeout=None) on a connection
        # already known dead
        with self._plock:
            if self._closed:
                raise ConnectionError("client closed")
            self._seq += 1
            seq = self._seq
            p = _Pending()
            self._pending[seq] = p
        caller = trace_current()
        hop = None
        req = {"t": "req", "seq": seq, "method": method,
               "args": list(args)}
        if caller is not None and trace_enabled():
            hop = caller.child()
            req["ctx"] = hop.to_wire()
            hop_start = time.time()
        try:
            write_frame(self._sock, req, self._wlock)
        except (ConnectionError, OSError):
            self._fail_all()
            raise ConnectionError("send failed")
        try:
            if not p.event.wait(timeout):
                with self._plock:
                    self._pending.pop(seq, None)
                raise TimeoutError(f"rpc {method} timed out")
            if p.msg is None:
                raise ConnectionError("connection lost")
            if not p.msg.get("ok"):
                raise RpcError(p.msg.get("error", "unknown remote error"))
            return p.msg.get("result")
        finally:
            if hop is not None:
                # the hop span is the CLIENT's view of the forward
                # (request→response, queue + remote handler inclusive)
                default_spans().record(
                    "rpc.forward", trace_id=hop.trace_id,
                    span_id=hop.span_id,
                    parent_span_id=hop.parent_span_id,
                    start_unix=hop_start, end_unix=time.time(),
                    detail={"method": method,
                            "peer": f"{self.addr[0]}:{self.addr[1]}"})

    def close(self) -> None:
        # fail in-flight waiters DIRECTLY: relying on the reader thread
        # to notice the socket close and run _fail_all left a window
        # where a waiter slept out its timeout against a socket this
        # process itself had already discarded
        self._fail_all()
        try:
            self._sock.close()
        except OSError:
            pass


class ConnPool:
    """Shared RpcClient per address with reconnect-on-failure
    (helper/pool/pool.go:130)."""

    def __init__(self, tls=None,
                 metrics: Optional[MetricsRegistry] = None) -> None:
        self._lock = threading.Lock()
        self._conns: Dict[Tuple[str, int], RpcClient] = {}
        self._tls = tls
        self._metrics = metrics

    def _get(self, addr: Tuple[str, int]) -> RpcClient:
        with self._lock:
            c = self._conns.get(addr)
            if c is None or c._closed:
                c = RpcClient(addr[0], addr[1], tls=self._tls,
                              metrics=self._metrics)
                self._conns[addr] = c
            return c

    def call(self, addr: Tuple[str, int], method: str, *args: Any,
             timeout: Optional[float] = 10.0) -> Any:
        try:
            return self._get(tuple(addr)).call(method, *args, timeout=timeout)
        except (ConnectionError, OSError):
            # one reconnect attempt (pool.go reconnect semantics)
            with self._lock:
                self._conns.pop(tuple(addr), None)
            return self._get(tuple(addr)).call(method, *args, timeout=timeout)

    def close(self) -> None:
        with self._lock:
            for c in self._conns.values():
                c.close()
            self._conns.clear()
