"""Small shared network helpers."""
from __future__ import annotations

import socket


def routable_ip(default: str = "127.0.0.1") -> str:
    """This host's default-route source IP via the UDP-connect trick
    (no traffic is sent). Shared by the network fingerprinter and the
    agent's HTTP-advertise path so the two can never diverge."""
    try:
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        try:
            s.connect(("10.255.255.255", 1))
            return s.getsockname()[0]
        finally:
            s.close()
    except OSError:
        return default
