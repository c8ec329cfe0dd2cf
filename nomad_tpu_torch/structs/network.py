"""Network/port accounting.

Behavioral reference: `nomad/structs/network.go` — `NetworkIndex` :30,
`SetNode` :92, `AddAllocs` :144, `AssignPorts` :316, `AssignNetwork` :406,
dynamic range 20000–32000 (:11-15), precise vs stochastic pickers (:487,:529).

The used-port set is a numpy bool bitmap per IP (the tensor-friendly mirror of
reference `structs.Bitmap`, nomad/structs/bitmap.go:6). The tensorizer
(`tensor/cluster.py`) maintains the selection-time analog: a packed
union-across-IPs `u32[N, 2048]` bitmap plus a free-dynamic-port count per
node, consumed by the placement kernel's port mask; this NetworkIndex stays
the precise per-IP authority at offer time (scheduler/generic.py
allocated_resources fails the placement when no offer exists).
"""
from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from .resources import NetworkResource, Port

MIN_DYNAMIC_PORT = 20000   # reference network.go:12
MAX_DYNAMIC_PORT = 32000   # reference network.go:15
MAX_VALID_PORT = 65536
MAX_RAND_PORT_ATTEMPTS = 20  # reference network.go:19


@dataclass
class AllocatedPortMapping:
    label: str = ""
    value: int = 0
    to: int = 0
    host_ip: str = ""


def literal_port(label: str) -> int:
    """The literal-port form of a port label ("8080") — 0 unless the
    label is an ASCII-digit string naming a valid port (1-65535).
    Single source of truth for validate_connect, the task runner's
    connect-target resolution, and service registration: a label one
    surface accepts as a literal port must resolve the same everywhere."""
    if label and label.isascii() and label.isdigit():
        port = int(label)
        if 0 < port <= 65535:
            return port
    return 0


def parse_port_ranges(spec: str) -> List[int]:
    """Parse "80,443,10000-12000" into a port list (reference
    `structs.ParsePortRanges`, helper used by reserved host ports)."""
    out: List[int] = []
    if not spec:
        return out
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        if "-" in part:
            lo, hi = part.split("-", 1)
            out.extend(range(int(lo), int(hi) + 1))
        else:
            out.append(int(part))
    return out


class NetworkIndex:
    """Tracks used ports/bandwidth on one node (reference network.go:30)."""

    def __init__(self) -> None:
        self.avail_networks: List[NetworkResource] = []
        self.avail_bandwidth: Dict[str, int] = {}
        self.used_ports: Dict[str, np.ndarray] = {}   # ip -> bool[65536]
        self.used_bandwidth: Dict[str, int] = {}

    def _used_for(self, ip: str) -> np.ndarray:
        bm = self.used_ports.get(ip)
        if bm is None:
            bm = np.zeros(MAX_VALID_PORT, dtype=bool)
            self.used_ports[ip] = bm
        return bm

    def overcommitted(self) -> bool:
        """Reference `NetworkIndex.Overcommitted` (network.go:66)."""
        for device, used in self.used_bandwidth.items():
            avail = self.avail_bandwidth.get(device, 0)
            if used > avail:
                return True
        return False

    def set_node(self, node) -> bool:
        """Index a node's networks + reserved ports (reference network.go:92).
        Returns True on collision."""
        collide = False
        for n in node.node_resources.networks:
            if n.device:
                self.avail_networks.append(n)
                self.avail_bandwidth[n.device] = n.mbits
        # Node-reserved host ports apply to every IP (reference network.go:110-139)
        reserved = parse_port_ranges(node.reserved_resources.reserved_ports)
        for n in node.node_resources.networks:
            if not n.ip:
                continue
            bm = self._used_for(n.ip)
            for port in reserved:
                if port >= MAX_VALID_PORT:
                    collide = True
                    continue
                if bm[port]:
                    collide = True
                else:
                    bm[port] = True
        return collide

    def add_allocs(self, allocs) -> bool:
        """Index ports used by non-terminal allocs (reference network.go:144).
        Returns True on collision."""
        collide = False
        for alloc in allocs:
            # Server-terminal allocs no longer count (reference network.go:151
            # uses ServerTerminalStatus for filtering here)
            if alloc.server_terminal_status() or alloc.client_terminal_status():
                continue
            if alloc.allocated_resources is None:
                continue
            for tr in alloc.allocated_resources.tasks.values():
                for net in tr.networks:
                    if self.add_reserved(net):
                        collide = True
            for net in alloc.allocated_resources.shared.networks:
                if self.add_reserved(net):
                    collide = True
        return collide

    def add_reserved(self, net: NetworkResource) -> bool:
        """Reference `NetworkIndex.AddReserved` (network.go:203)."""
        collide = False
        if net.ip:
            bm = self._used_for(net.ip)
            for port in list(net.reserved_ports) + list(net.dynamic_ports):
                if port.value < 0 or port.value >= MAX_VALID_PORT:
                    collide = True
                    continue
                if bm[port.value]:
                    collide = True
                else:
                    bm[port.value] = True
        if net.device:
            self.used_bandwidth[net.device] = (
                self.used_bandwidth.get(net.device, 0) + net.mbits
            )
        return collide

    def yield_ip(self):
        """Iterate candidate (network, ip) pairs (reference network.go:292).
        v1 yields each network's configured IP; CIDR walking is host-side."""
        for n in self.avail_networks:
            if n.ip:
                yield n, n.ip

    def assign_network(
        self, ask: NetworkResource, deterministic: bool = True,
        rng: Optional[random.Random] = None,
    ) -> Tuple[Optional[NetworkResource], str]:
        """Find an IP + ports satisfying `ask` (reference network.go:406).

        Deterministic mode uses the precise first-fit picker for dynamic ports
        (reference getDynamicPortsPrecise, network.go:487) — the documented
        tie-breaking for parity; stochastic mode mirrors network.go:529.
        """
        err = "no networks available"
        for n, ip in self.yield_ip():
            avail_bw = self.avail_bandwidth.get(n.device, 0)
            used_bw = self.used_bandwidth.get(n.device, 0)
            if used_bw + ask.mbits > avail_bw:
                err = "bandwidth exceeded"
                continue
            used = self._used_for(ip)
            # Reserved ports must be free
            collision = False
            for port in ask.reserved_ports:
                if port.value < 0 or port.value >= MAX_VALID_PORT:
                    return None, f"invalid port {port.value} (out of range)"
                if used[port.value]:
                    collision = True
                    err = f"reserved port collision {port.label}={port.value}"
                    break
            if collision:
                continue
            # Dynamic ports
            reserved_vals = [p.value for p in ask.reserved_ports]
            n_dyn = len(ask.dynamic_ports)
            if deterministic:
                dyn, perr = self._dynamic_ports_precise(used, reserved_vals, n_dyn)
            else:
                # the rng is the CALLER's obligation: minted leader-side
                # (seeded from the plan/submit context) so a follower
                # replaying the same raft entry draws the same ports —
                # a fresh `random.Random()` here seeds from OS entropy
                # and diverges per replica (NLR02)
                if rng is None:
                    raise ValueError(
                        "assign_network(deterministic=False) requires a "
                        "caller-seeded rng — port draws must be "
                        "reproducible across replicas")
                dyn, perr = self._dynamic_ports_stochastic(
                    used, reserved_vals, n_dyn, rng
                )
                if perr:
                    dyn, perr = self._dynamic_ports_precise(used, reserved_vals, n_dyn)
            if perr:
                err = perr
                continue
            offer = NetworkResource(
                mode=ask.mode,
                device=n.device,
                ip=ip,
                mbits=ask.mbits,
                reserved_ports=[Port(p.label, p.value, p.to) for p in ask.reserved_ports],
                dynamic_ports=[
                    Port(p.label, v, p.to if p.to else v)
                    for p, v in zip(ask.dynamic_ports, dyn)
                ],
            )
            return offer, ""
        return None, err

    @staticmethod
    def _dynamic_ports_precise(
        used: np.ndarray, reserved: List[int], count: int
    ) -> Tuple[List[int], str]:
        """First `count` free ports in the dynamic range (reference
        getDynamicPortsPrecise, network.go:487 — but first-fit instead of the
        reference's random sample over the free set; deterministic by design).
        Runs in the C++ core when built (native/core.cpp
        nomad_first_fit_ports); the Python fallback is bit-identical."""
        if count == 0:
            return [], ""
        from ..native import first_fit_ports

        ports = first_fit_ports(used, MIN_DYNAMIC_PORT, MAX_DYNAMIC_PORT,
                                reserved, count)
        if not ports:
            return [], "dynamic port selection failed"
        return ports, ""

    @staticmethod
    def _dynamic_ports_stochastic(
        used: np.ndarray, reserved: List[int], count: int, rng: random.Random
    ) -> Tuple[List[int], str]:
        """Random-sample picker (reference getDynamicPortsStochastic,
        network.go:529): up to 20 attempts per port."""
        out: List[int] = []
        for _ in range(count):
            attempts = 0
            while True:
                attempts += 1
                if attempts > MAX_RAND_PORT_ATTEMPTS:
                    return [], "stochastic dynamic port selection failed"
                port = MIN_DYNAMIC_PORT + rng.randrange(
                    MAX_DYNAMIC_PORT - MIN_DYNAMIC_PORT
                )
                if used[port] or port in reserved or port in out:
                    continue
                out.append(port)
                break
        return out, ""
