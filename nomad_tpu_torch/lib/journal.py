"""Torn-tail-safe msgpack journal loader.

Shared by the FSM WAL (`server/wal.py`) and the Raft log journal
(`raft/raft.py`). Behavioral reference: raft-boltdb / BoltDB give the
reference atomic log appends (`go.mod:83-84`); a plain append-only file
needs explicit recovery: after a crash the tail may hold a torn
(partial) frame or garbage that still decodes as a msgpack value. Either
way the undecodable/invalid suffix must be truncated BEFORE the journal
is reopened for append — otherwise acknowledged post-crash entries land
after the garbage and are silently dropped on the next load.
"""
from __future__ import annotations

import os
from typing import Any, Callable, Dict, List, Optional

import msgpack


def load_journal(path: str,
                 validate: Optional[Callable[[Any], bool]] = None,
                 ) -> List[Dict[str, Any]]:
    """Decode all clean frames from `path`, truncating any torn/invalid
    tail in place. A frame is clean iff it decodes AND is a dict AND
    passes `validate` (when given); `clean_end` advances only past frames
    that fully validated, so a tail byte that happens to decode (e.g. a
    positive fixint) is still truncated."""
    records: List[Dict[str, Any]] = []
    clean_end = 0
    with open(path, "rb") as fh:
        unpacker = msgpack.Unpacker(fh, raw=False, strict_map_key=False)
        try:
            for rec in unpacker:
                if not isinstance(rec, dict):
                    break
                if validate is not None and not validate(rec):
                    break
                records.append(rec)
                clean_end = unpacker.tell()
        except Exception:
            pass  # undecodable frame: keep the validated prefix only
    if clean_end < os.path.getsize(path):
        with open(path, "r+b") as fh:
            fh.truncate(clean_end)
    return records
