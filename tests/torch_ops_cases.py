"""Shared helpers for the port's twins of the operator-path tests
(explain, drain, deployments, periodic, GC, events, flight, the broker,
the coordinator, the scheduler, the structs and the `lib/` helpers).

A twin that compares runs one scenario function per package: it takes
the package's name (`REF` or `PORT`), builds what it needs through
`mod(pkg, ...)`, and returns comparable data. Objects that carry random
ids are built once, by the reference's mocks, and handed to the port
over the wire codec (`as_pkg`), so both packages see the same ids. The
port runs on the CPU (`device="cpu"`, the plain versions).
"""
from __future__ import annotations

import importlib
import time

from torch_sched_cases import wire

REF, PORT = "nomad_tpu", "nomad_tpu_torch"
PACKAGES = (REF, PORT)


def mod(pkg: str, name: str = ""):
    """`pkg.name`, imported."""
    return importlib.import_module(f"{pkg}.{name}" if name else pkg)


def dev(pkg: str) -> dict:
    """The device keyword a constructor of `pkg` takes: the port's
    entry points default to the card, the tests run them on the CPU."""
    return {"device": "cpu"} if pkg == PORT else {}


def as_pkg(pkg: str, obj):
    """A reference object as `pkg` sees it."""
    return obj if pkg == REF else wire(obj)


def server(pkg: str, **cfg):
    """An unstarted `Server` of `pkg` with `ServerConfig(**cfg)`."""
    s = mod(pkg, "server")
    return s.Server(s.ServerConfig(**cfg), **dev(pkg))


def run_both(scenario, *args, **kw):
    """(the reference's result, the port's) of `scenario(pkg, ...)`."""
    return scenario(REF, *args, **kw), scenario(PORT, *args, **kw)


def wait_for(cond, timeout: float = 10.0, every: float = 0.02):
    """Poll `cond` until it returns a true value or `timeout` passes;
    returns its last value."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        v = cond()
        if v:
            return v
        time.sleep(every)
    return cond()
