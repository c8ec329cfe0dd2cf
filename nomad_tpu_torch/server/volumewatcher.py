"""VolumeWatcher — release CSI volume claims as allocations terminate.

Behavioral reference: `nomad/volumewatcher/` (volumes_watcher.go :183 —
one watcher per claimed volume; volume_watcher.go :249 — when a claiming
alloc is terminal the claim is unpublished/released through the claim
RPCs). This build's watcher is one poll loop over the claimed-volume set
(the store is process-local; the per-volume goroutine fan-out collapses
to a scan), releasing claims whose alloc is gone or terminal.
"""
from __future__ import annotations

import threading
from typing import Optional

DEFAULT_POLL_INTERVAL = 0.1


class VolumeWatcher:
    def __init__(self, server, poll_interval: float = DEFAULT_POLL_INTERVAL):
        self.server = server
        self.poll_interval = poll_interval
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, name="volwatch",
                                        daemon=True)
        self._thread.start()

    def shutdown(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)

    def _run(self) -> None:
        while not self._stop.wait(self.poll_interval):
            try:
                self.tick()
            except Exception:
                import traceback

                traceback.print_exc()

    def tick(self) -> None:
        state = self.server.state
        for vol in state.csi_volumes():
            for alloc_id in list(vol.read_claims) + list(vol.write_claims):
                alloc = state.alloc_by_id(alloc_id)
                if alloc is None or alloc.terminal_status():
                    state.csi_volume_release(vol.namespace, vol.id,
                                             alloc_id)
            if vol.controller_required and vol.publish_contexts:
                # detach nodes that no live claim needs anymore
                # (volume_watcher.go:249 → ControllerUnpublishVolume)
                claimed_nodes = set()
                for alloc_id in (list(vol.read_claims)
                                 + list(vol.write_claims)):
                    a = state.alloc_by_id(alloc_id)
                    if a is not None and not a.terminal_status():
                        claimed_nodes.add(a.node_id)
                for node_id in list(vol.publish_contexts):
                    if node_id in claimed_nodes:
                        continue
                    ent = vol.controller_pending.get(node_id)
                    if ent is not None and ent.get("op") == "unpublish":
                        # already queued: re-requesting would be a no-op
                        # in the harness but the durable/raft stores
                        # journal EVERY csi_controller_request — at a
                        # 0.1s tick that's WAL churn forcing snapshot
                        # rewrites while a controller host is down
                        continue
                    state.csi_controller_request(
                        vol.namespace, vol.id, node_id, "unpublish")
