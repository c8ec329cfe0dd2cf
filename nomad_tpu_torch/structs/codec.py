"""Wire codec for the data-model structs.

Behavioral reference: the reference serializes `nomad/structs` with
msgpack codecs shared by the RPC fabric and the Raft log
(`helper/pool/pool.go:23-28` codec handles, `nomad/fsm.go:180` decode per
message type). Here every dataclass in this package self-registers
into a codec registry; `to_wire`/`from_wire` produce msgpack-ready trees
tagged with `__t` type markers so nested structs (Job inside Allocation,
DrainStrategy inside Node, ...) round-trip without per-type code.

Consumers: the WAL/FSM (server/fsm.py), the Raft transport, and the
msgpack-RPC fabric.
"""
from __future__ import annotations

import dataclasses
import importlib
import pkgutil
from typing import Any, Dict, Type

_TYPE_TAG = "__t"
_REGISTRY: Dict[str, Type] = {}


def _build_registry() -> None:
    from .. import structs as pkg

    for info in pkgutil.iter_modules(pkg.__path__):
        mod = importlib.import_module(f"{pkg.__name__}.{info.name}")
        for name in dir(mod):
            obj = getattr(mod, name)
            if (isinstance(obj, type) and dataclasses.is_dataclass(obj)
                    and obj.__module__ == mod.__name__):
                existing = _REGISTRY.get(obj.__name__)
                if existing is not None and existing is not obj:
                    raise RuntimeError(
                        f"duplicate struct name {obj.__name__} in registry"
                    )
                _REGISTRY[obj.__name__] = obj
    # Wire-visible dataclasses living outside the structs package
    from ..acl.policy import HostVolumeRule, NamespaceRule, Policy
    from ..acl.tokens import ACLPolicy, ACLToken
    from ..scheduler.util import SchedulerConfiguration

    for cls in (SchedulerConfiguration, ACLPolicy, ACLToken, Policy,
                NamespaceRule, HostVolumeRule):
        _REGISTRY[cls.__name__] = cls


def registry() -> Dict[str, Type]:
    if not _REGISTRY:
        _build_registry()
    return _REGISTRY


def to_wire(obj: Any) -> Any:
    """Struct tree → msgpack-ready tree (dicts/lists/scalars only)."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        out = {_TYPE_TAG: type(obj).__name__}
        for f in dataclasses.fields(obj):
            out[f.name] = to_wire(getattr(obj, f.name))
        return out
    if isinstance(obj, dict):
        return {k: to_wire(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [to_wire(v) for v in obj]
    if isinstance(obj, (str, int, float, bool, bytes)) or obj is None:
        return obj
    raise TypeError(f"unencodable type {type(obj).__name__}: {obj!r}")


def to_json_tree(tree: Any) -> Any:
    """Wire tree → JSON-safe tree (bytes become {"__b": base64}). The
    msgpack transports carry bytes natively; HTTP/JSON needs this bridge.
    Injective: user dicts that collide with the markers are wrapped in
    {"__bmap": ...} so decoding never misreads them."""
    import base64

    if isinstance(tree, bytes):
        return {"__b": base64.b64encode(tree).decode()}
    if isinstance(tree, dict):
        enc = {k: to_json_tree(v) for k, v in tree.items()}
        if set(tree) & {"__b", "__bmap"}:
            return {"__bmap": enc}
        return enc
    if isinstance(tree, (list, tuple)):
        return [to_json_tree(v) for v in tree]
    return tree


def from_json_tree(tree: Any) -> Any:
    import base64

    if isinstance(tree, dict):
        if set(tree) == {"__b"}:
            return base64.b64decode(tree["__b"])
        if set(tree) == {"__bmap"}:
            return {k: from_json_tree(v) for k, v in tree["__bmap"].items()}
        return {k: from_json_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [from_json_tree(v) for v in tree]
    return tree


def from_wire(tree: Any) -> Any:
    """Inverse of to_wire. Unknown fields are ignored (forward compat)."""
    if isinstance(tree, dict):
        tag = tree.get(_TYPE_TAG)
        if tag is not None:
            cls = registry().get(tag)
            if cls is None:
                raise KeyError(f"unknown struct type {tag!r}")
            names = {f.name for f in dataclasses.fields(cls)}
            kwargs = {k: from_wire(v) for k, v in tree.items()
                      if k != _TYPE_TAG and k in names}
            return cls(**kwargs)
        return {k: from_wire(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [from_wire(v) for v in tree]
    return tree
