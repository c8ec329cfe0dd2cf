"""Twins of the reference's `tests/test_transport.py` (RPC transport
error paths and the trace-context envelope), run on the port's
`rpc/transport.py`.

Pinned here: an in-flight call fails promptly when its client closes or
its peer dies, a teardown racing a burst of calls hangs nobody, the pool
evicts dead clients and redials once, remote errors cross the wire, and
the optional `ctx` envelope slot restores the caller's trace context
handler-side while tolerating garbage. Where the reference sleeps to
let a request reach the server, the twins wait (bounded) for the
handler to be entered.

`TestAgainstReference` puts the two packages on one wire: the port's
client against the reference's server and the reference's client
against the port's, and the frames each writes for the same message.
"""
import socket
import threading
import time

import pytest

from nomad_tpu_torch.lib.tracectx import (current as trace_current,
                                    default_spans, mint, use)
from nomad_tpu_torch.rpc.transport import (ConnPool, RpcClient, RpcError,
                                     RpcServer, read_frame, write_frame)

from torch_ops_cases import PORT, REF, mod


@pytest.fixture()
def server():
    srv = RpcServer()
    gate = threading.Event()
    seen = {}

    def echo(*args):
        seen["ctx"] = trace_current()
        return list(args)

    entered = threading.Semaphore(0)
    seen["entered"] = entered

    def block():
        entered.release()
        gate.wait(10.0)
        return "unblocked"

    def boom():
        raise ValueError("kaput")

    srv.register("Test.echo", echo)
    srv.register("Test.block", block)
    srv.register("Test.boom", boom)
    srv.start()
    yield srv, gate, seen
    gate.set()
    srv.shutdown()


class TestTeardownPromptness:
    def test_inflight_call_fails_promptly_on_close(self, server):
        """The headline bug: an in-flight call with timeout=None must
        raise as soon as close() runs, not hang forever."""
        srv, gate, seen = server
        c = RpcClient(*srv.addr)
        errs, done = [], threading.Event()

        def go():
            try:
                c.call("Test.block", timeout=None)
            except Exception as e:  # noqa: BLE001 — the error IS the test
                errs.append(e)
            done.set()

        threading.Thread(target=go, daemon=True).start()
        assert seen["entered"].acquire(timeout=5.0)   # the call is in
        t0 = time.time()
        c.close()
        assert done.wait(3.0), "in-flight call hung past close()"
        assert time.time() - t0 < 2.0
        assert errs and isinstance(errs[0], ConnectionError)

    def test_call_on_closed_client_raises_immediately(self, server):
        srv, _, _ = server
        c = RpcClient(*srv.addr)
        c.close()
        t0 = time.time()
        with pytest.raises(ConnectionError):
            c.call("Test.echo", 1, timeout=None)
        assert time.time() - t0 < 1.0, \
            "closed-client call slept instead of failing fast"

    def test_close_racing_many_calls_hangs_nobody(self, server):
        """Teardown concurrent with a burst of calls: every caller gets
        an exception (never a hang), pending map drains to empty."""
        srv, _, seen = server
        c = RpcClient(*srv.addr)
        results = []

        def go():
            try:
                results.append(("ok", c.call("Test.block", timeout=None)))
            except Exception as e:  # noqa: BLE001
                results.append(("err", type(e).__name__))

        threads = [threading.Thread(target=go, daemon=True)
                   for _ in range(8)]
        for t in threads:
            t.start()
        for _ in threads:      # every call reached the server
            assert seen["entered"].acquire(timeout=5.0)
        c.close()
        for t in threads:
            t.join(3.0)
        assert not any(t.is_alive() for t in threads), "caller hung"
        assert len(results) == 8
        assert all(kind == "err" for kind, _ in results)
        assert c._pending == {}

    def test_peer_death_fails_waiters(self, server):
        """The wire dying under us (peer crash, network cut) must fail
        the in-flight call via the reader thread, not let it sleep out
        its timeout."""
        srv, _, seen = server
        c = RpcClient(*srv.addr)
        errs, done = [], threading.Event()

        def go():
            try:
                c.call("Test.block", timeout=None)
            except Exception as e:  # noqa: BLE001
                errs.append(e)
            done.set()

        threading.Thread(target=go, daemon=True).start()
        assert seen["entered"].acquire(timeout=5.0)
        c._sock.shutdown(socket.SHUT_RDWR)  # cut the wire
        assert done.wait(3.0), "caller hung past peer death"
        assert errs and isinstance(errs[0], ConnectionError)
        c.close()


class TestRemoteErrors:
    def test_unknown_method_is_rpc_error(self, server):
        srv, _, _ = server
        c = RpcClient(*srv.addr)
        with pytest.raises(RpcError, match="unknown method"):
            c.call("Test.nope")
        c.close()

    def test_handler_exception_crosses_the_wire(self, server):
        srv, _, _ = server
        c = RpcClient(*srv.addr)
        with pytest.raises(RpcError, match="ValueError: kaput"):
            c.call("Test.boom")
        # the connection survives a handler error (pipelined, not fatal)
        assert c.call("Test.echo", "still-alive") == ["still-alive"]
        c.close()


class TestConnPool:
    def test_evicts_dead_client_and_redials(self, server):
        srv, _, _ = server
        pool = ConnPool()
        addr = tuple(srv.addr)
        assert pool.call(addr, "Test.echo", 1) == [1]
        first = pool._conns[addr]
        first.close()  # simulate the peer connection dying
        # next call must not be handed the corpse: evict + redial
        assert pool.call(addr, "Test.echo", 2) == [2]
        assert pool._conns[addr] is not first
        pool.close()

    def test_dead_server_single_redial_then_raises(self, server):
        """When the peer is gone for good, the pool makes exactly one
        reconnect attempt and then surfaces the error — it must not
        hand the caller the dead cached client, and must not retry
        forever either."""
        srv, _, _ = server
        pool = ConnPool()
        addr = tuple(srv.addr)
        assert pool.call(addr, "Test.echo", 1) == [1]
        srv.shutdown()
        pool._conns[addr].close()  # cached conn learns of the death
        with pytest.raises((ConnectionError, OSError)):
            pool.call(addr, "Test.echo", 2)
        pool.close()
        assert pool._conns == {}


class TestCtxEnvelope:
    def test_ctx_injected_and_restored_handler_side(self, server):
        srv, _, seen = server
        c = RpcClient(*srv.addr)
        with use(mint()):
            caller = trace_current()
            idx0 = default_spans().last_index()
            c.call("Test.echo", "x")
        got = seen["ctx"]
        assert got is not None
        assert got.trace_id == caller.trace_id
        # the handler runs under the HOP's context, a child of the
        # caller's span — a forwarding handler's own pool.call then
        # parents the next hop correctly with no extra plumbing
        assert got.parent_span_id == caller.span_id
        assert got.span_id != caller.span_id
        # the client recorded the hop as an rpc.forward span
        _, recs = default_spans().spans_after(idx0)
        fwd = [s for s in recs if s["name"] == "rpc.forward"
               and s["trace_id"] == caller.trace_id]
        assert len(fwd) == 1
        assert fwd[0]["span_id"] == got.span_id
        assert fwd[0]["detail"]["method"] == "Test.echo"
        assert fwd[0]["detail"]["peer"].endswith(str(srv.addr[1]))
        c.close()

    def test_no_ctx_outside_a_trace(self, server):
        srv, _, seen = server
        c = RpcClient(*srv.addr)
        idx0 = default_spans().last_index()
        c.call("Test.echo", "x")
        assert seen["ctx"] is None
        _, recs = default_spans().spans_after(idx0)
        assert [s for s in recs if s["name"] == "rpc.forward"] == []
        c.close()

    def test_kill_switch_suppresses_injection(self, server, monkeypatch):
        monkeypatch.setenv("NOMAD_TPU_TRACE", "0")
        srv, _, seen = server
        c = RpcClient(*srv.addr)
        idx0 = default_spans().last_index()
        with use(mint()):
            c.call("Test.echo", "x")
        assert seen["ctx"] is None
        _, recs = default_spans().spans_after(idx0)
        assert [s for s in recs if s["name"] == "rpc.forward"] == []
        c.close()

    def test_malformed_ctx_from_peer_is_tolerated(self, server):
        """A hand-rolled frame with a garbage ctx slot (old or hostile
        peer) must neither kill the serve loop nor poison the handler —
        it is simply no trace."""
        srv, _, seen = server
        for bad in ("garbage", 42, ["t"], {"t": 7, "s": None}, {}):
            s = socket.create_connection(srv.addr, timeout=5.0)
            try:
                write_frame(s, {"t": "req", "seq": 1,
                                "method": "Test.echo", "args": ["ping"],
                                "ctx": bad})
                res = read_frame(s)
            finally:
                s.close()
            assert res["ok"] is True and res["result"] == ["ping"]
            assert seen["ctx"] is None


# ---- the two packages on one wire -----------------------------------------


def _serve(pkg):
    srv = mod(pkg, "rpc.transport").RpcServer()
    srv.register("Test.echo", lambda *a: [pkg, *a])
    srv.register("Test.ctx", lambda: (lambda c: None if c is None else [
        c.trace_id, c.span_id])(mod(pkg, "lib.tracectx").current()))

    def boom():
        raise KeyError("gone")

    srv.register("Test.boom", boom)
    srv.start()
    return srv


class TestAgainstReference:
    @pytest.mark.parametrize("client,server_pkg", [(PORT, REF), (REF, PORT)])
    def test_cross_package_calls(self, client, server_pkg):
        tr = mod(client, "rpc.transport")
        tc = mod(client, "lib.tracectx")
        srv = _serve(server_pkg)
        c = tr.RpcClient(*srv.addr)
        try:
            msg = {"a": [1, 2.5, "x"], "b": None, "c": True}
            assert c.call("Test.echo", msg, 7) == [server_pkg, msg, 7]
            with pytest.raises(tr.RpcError, match="KeyError"):
                c.call("Test.boom")
            with pytest.raises(tr.RpcError, match="unknown method"):
                c.call("Test.nope")
            assert c.call("Test.ctx") is None
            ctx = tc.mint()
            with tc.use(ctx):
                got = c.call("Test.ctx")
            assert got is not None and got[0] == ctx.trace_id
        finally:
            c.close()
            srv.shutdown()

    @pytest.mark.parametrize("obj", [
        {"method": "Test.echo", "args": [1, "two", [3.0]], "id": 9},
        [None, True, {"nested": {"k": [1, 2]}}], "plain", 12345])
    def test_frames_equal_reference(self, obj):
        frames = {}
        for pkg in (REF, PORT):
            a, b = socket.socketpair()
            try:
                mod(pkg, "rpc.transport").write_frame(a, obj)
                a.shutdown(socket.SHUT_WR)
                data = b""
                while True:
                    chunk = b.recv(65536)
                    if not chunk:
                        break
                    data += chunk
                frames[pkg] = data
            finally:
                a.close()
                b.close()
        assert frames[PORT] == frames[REF]
        a, b = socket.socketpair()
        try:
            a.sendall(frames[REF])
            assert read_frame(b) == obj
        finally:
            a.close()
            b.close()
