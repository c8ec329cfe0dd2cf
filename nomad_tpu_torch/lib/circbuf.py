"""Fixed-size circular write buffer with asynchronous flush.

Behavioral reference: `lib/circbufwriter/writer.go` — writes never block the
producer; a background flusher drains the ring to the wrapped writer, and if
the producer overruns the ring the oldest bytes are dropped (the reference
wraps armon/circbuf the same way for command output capture).
"""
from __future__ import annotations

import threading
from typing import Callable, Optional


class CircBufWriter:
    def __init__(self, sink: Callable[[bytes], None], size: int = 64 * 1024,
                 flush_interval: float = 0.1) -> None:
        self._sink = sink
        self._size = size
        self._buf = bytearray()
        self._dropped = 0
        self._lock = threading.Lock()
        self._wake = threading.Event()
        self._closed = False
        self._err: Optional[BaseException] = None
        self._flush_interval = flush_interval
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def write(self, data: bytes) -> int:
        with self._lock:
            if self._closed:
                raise ValueError("write on closed CircBufWriter")
            self._buf.extend(data)
            overrun = len(self._buf) - self._size
            if overrun > 0:
                del self._buf[:overrun]
                self._dropped += overrun
        self._wake.set()
        return len(data)

    @property
    def dropped_bytes(self) -> int:
        with self._lock:
            return self._dropped

    def _drain(self) -> None:
        with self._lock:
            chunk, self._buf = bytes(self._buf), bytearray()
        if chunk:
            try:
                self._sink(chunk)
            except BaseException as e:  # surface on close, never block writer
                with self._lock:
                    self._err = e

    def _run(self) -> None:
        while True:
            self._wake.wait(self._flush_interval)
            self._wake.clear()
            self._drain()
            with self._lock:
                if self._closed and not self._buf:
                    return

    def close(self) -> None:
        """Stop accepting writes and wait for the flusher to drain. The final
        drain happens on the flusher thread only — the sink is never invoked
        from two threads. A sink hung past the timeout leaves the flusher
        running detached and raises."""
        with self._lock:
            self._closed = True
        self._wake.set()
        self._thread.join(timeout=5)
        if self._thread.is_alive():
            raise TimeoutError("CircBufWriter sink did not drain before close")
        with self._lock:
            if self._err is not None:
                raise self._err
