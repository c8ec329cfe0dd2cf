"""Device-resident program table — the on-device half of `pack_params`.

Counterpart of the reference package's `server/program_table.py`: the
STATIC half of every compiled placement program (`kernels/placement.py
STATIC_FIELDS`: the constraint/affinity/spread LUT block, ask vector,
port asks — everything derived from the job spec alone) lives on the
device, one packed row per distinct program content, in three class
tables (i32/f32/u8). A dispatch then ships only each program's table row
index (the chain kernel reads its static fields in place) and the small
DYNAMIC rows; cold-miss static rows are inserted at commit.

Shape discipline: rows are only interchangeable if every program packs
at the SAME shapes, so the table owns running FLOOR dims for the
static-field shapes (`parallel/pad.py STATIC_DIMS`) — monotone,
bucketed, and ceilinged. A program past a ceiling falls back to the
packed transport for its whole dispatch; cap growth flushes the table
(generation bump).

Content addressing: a row key is the blake2b digest of the packed static
bytes, so a changed job spec is simply a NEW row; stale rows age out of
the LRU. Tables are per (cluster, device).

The insert (K8) is `kernels/rows.py` `table_insert`: the commit's row
indices and rows packed into one host buffer (`pack_insert`), one staged
copy and one launch of the hand-written kernel on a card, `index_copy` on
the CPU. As in the reference, an insert never writes the tables a
committed dispatch may still read: it returns new tables, so handles that
`commit` already returned stay valid.
"""
from __future__ import annotations

import hashlib
import os
import threading
import weakref
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np

import torch

from ..device import DeviceLike, resolve_device
from ..kernels.placement import (DYN_FIELDS, STATIC_FIELDS, TGParams,
                                 pack_param_rows_batch)
from ..kernels.rows import pack_insert, table_insert
from ..parallel.pad import STATIC_DIMS, pad_params, param_dims

#: per-dim ceilings for table residency: a program past any of these
#: would balloon every row in the table (caps are GLOBAL floors), so it
#: rides the legacy packed transport instead. v tracks the widest vocab
#: a program references — node.unique.id-style constraints exceed this
#: by design.
DIM_CEILINGS = {"v": 512, "c": 128, "a_n": 128, "s_n": 32, "dp_n": 32,
                "rp_n": 128}
#: dynamic-row ceilings: candidate restriction (reselect ships ~all
#: rows) is the one dyn dim that can approach the node count
DYN_CEILINGS = {"l_n": 512}

#: table row capacity (LRU-evicted); env-tunable for huge job fleets
TABLE_ROWS_ENV = "NOMAD_TPU_PROG_TABLE_ROWS"

class _Prep:
    """One dispatch's assembled transport (host side)."""

    __slots__ = ("gen", "rows", "dyn_i", "dyn_f", "dyn_u", "sspec",
                 "dspec", "m")

    def __init__(self, gen, rows, dyn_i, dyn_f, dyn_u, sspec, dspec, m):
        self.gen = gen
        self.rows = rows
        self.dyn_i = dyn_i
        self.dyn_f = dyn_f
        self.dyn_u = dyn_u
        self.sspec = sspec
        self.dspec = dspec
        self.m = m


class DeviceProgramTable:
    """Content-addressed device table of packed static program rows."""

    def __init__(self, capacity: Optional[int] = None,
                 device: DeviceLike = None) -> None:
        self.device = resolve_device(device)
        self._lock = threading.Lock()
        self.capacity = capacity or int(
            os.environ.get(TABLE_ROWS_ENV, "512"))
        #: running shape floors for the static dims; growth bumps `gen`
        #: and flushes the device tables
        self.caps: Dict[str, int] = {}
        self.gen = 0
        #: content digest → row index (LRU: recently used rows last)
        self._rows: "OrderedDict[bytes, int]" = OrderedDict()
        self._free: List[int] = []
        self._next_row = 0
        #: row → (si, sf, su) uploaded lazily at the next commit (a
        #: second prepare() hitting the same content before the first
        #: commit must still find real data on device)
        self._pending: Dict[int, Tuple[np.ndarray, np.ndarray,
                                       np.ndarray]] = {}
        self._widths = None          # (Li, Lf, Lu)
        self._ti = self._tf = self._tu = None
        #: inserts since construction (test/bench introspection)
        self.inserts = 0
        self.flushes = 0

    # ---- host side ----

    def prepare(self, params_list: List[TGParams]) -> Optional[_Prep]:
        """Pad the batch to the table's shape floors, resolve (or
        reserve) a table row per program, and pack the dynamic rows.
        Returns None when any program exceeds a residency ceiling — the
        caller then uses the legacy packed transport for the whole
        dispatch (programs must share one chain)."""
        need = param_dims(params_list)
        for k, ceil in DIM_CEILINGS.items():
            if need[k] > ceil:
                return None
        for k, ceil in DYN_CEILINGS.items():
            if need[k] > ceil:
                return None
        with self._lock:
            grown = False
            for k in STATIC_DIMS:
                if need[k] > self.caps.get(k, 0):
                    self.caps[k] = need[k]
                    grown = True
            if grown:
                self._flush_locked()
            padded, m = pad_params(params_list, dims=self.caps,
                                   need=need)
            # whole-batch row-major pack (one vectorized op per field,
            # not ~40 per program — the 256-wave host-pack floor); row
            # i of each class buffer is byte-identical to the program's
            # solo pack_param_rows output
            si_b, sf_b, su_b, sspec = pack_param_rows_batch(
                padded, STATIC_FIELDS)
            rows = np.empty(len(padded), dtype=np.int32)
            if self._widths is None:
                self._widths = (si_b.shape[1], sf_b.shape[1],
                                su_b.shape[1])
            for i in range(len(padded)):
                h = hashlib.blake2b(digest_size=16)
                h.update(si_b[i].tobytes())
                h.update(sf_b[i].tobytes())
                h.update(su_b[i].tobytes())
                key = h.digest()
                row = self._rows.get(key)
                if row is None:
                    row = self._alloc_row_locked()
                    if row is None:
                        return None  # capacity full of pending rows
                    self._rows[key] = row
                    self._pending[row] = (si_b[i], sf_b[i], su_b[i])
                    self.inserts += 1
                else:
                    self._rows.move_to_end(key)
                rows[i] = row
            dyn_i, dyn_f, dyn_u, dspec = pack_param_rows_batch(
                padded, DYN_FIELDS)
            return _Prep(self.gen, rows, dyn_i, dyn_f, dyn_u,
                         sspec, dspec, m)

    def _row_bytes(self) -> int:
        """Device bytes one table row spans across the three class
        tables (0 before the first commit sizes them)."""
        if self._widths is None:
            return 0
        li, lf, lu = self._widths
        return li * 4 + lf * 4 + lu

    def _alloc_row_locked(self) -> Optional[int]:
        if self._free:
            return self._free.pop()
        if self._next_row < self.capacity:
            r = self._next_row
            self._next_row += 1
            return r
        # LRU-evict the oldest non-pending row and reuse its slot (a
        # pending row's content is not on device yet — a prepare that
        # reserved it may still be pre-commit)
        for key, row in self._rows.items():
            if row not in self._pending:
                del self._rows[key]
                # residency: eviction reclaims the row's slot bytes for
                # the incoming program (the table buffers themselves
                # stay resident at fixed size)
                from ..lib.metrics import default_registry

                reg = default_registry()
                reg.inc("hbm.table_evictions")
                reg.inc("hbm.table_reclaimed_bytes", self._row_bytes())
                return row
        return None

    def _flush_locked(self) -> None:
        self.gen += 1
        self._rows.clear()
        self._free = []
        self._next_row = 0
        self._pending.clear()
        if self._ti is not None:
            # generation flush drops the device tables wholesale; count
            # the reclaimed bytes (the ledger bookings release with the
            # buffers themselves)
            from ..lib.metrics import default_registry

            default_registry().inc(
                "hbm.table_flush_bytes",
                self._ti.nbytes + self._tf.nbytes + self._tu.nbytes)
        self._ti = self._tf = self._tu = None
        self._widths = None
        self.flushes += 1

    # ---- device side (call inside the coordinator's guard scope) ----

    def commit(self, prep: _Prep, ledger) -> Optional[Tuple]:
        """Flush pending static-row inserts to the device tables and
        return the current (ti, tf, tu) handles plus the bytes uploaded
        and their transfer count. Returns None when `prep` predates a
        caps flush (the caller falls back to the packed transport for
        this dispatch). Every transfer is explicit and ledgered."""
        dev = self.device
        with self._lock:
            if prep.gen != self.gen:
                return None
            if self._ti is None:
                li, lf, lu = self._widths
                t = self.capacity
                self._ti = torch.zeros((t, li), dtype=torch.int32, device=dev)
                self._tf = torch.zeros((t, lf), dtype=torch.float32,
                                       device=dev)
                self._tu = torch.zeros((t, lu), dtype=torch.uint8, device=dev)
            nb = 0
            count = 0
            if self._pending:
                items = sorted(self._pending.items())
                self._pending.clear()
                idx = np.fromiter((r for r, _ in items), dtype=np.int32,
                                  count=len(items))
                ri = np.stack([v[0] for _, v in items])
                rf = np.stack([v[1] for _, v in items])
                ru = np.stack([v[2] for _, v in items])
                nb = idx.nbytes + ri.nbytes + rf.nbytes + ru.nbytes
                count = 4
                # K8: one packed buffer, one staged copy, one launch; new
                # tables, as the reference's non-donated insert returns
                with ledger.timed("select_batch.table_insert", nb,
                                  count=count):
                    self._ti, self._tf, self._tu = table_insert(
                        (self._ti, self._tf, self._tu),
                        pack_insert(idx, ri, rf, ru, dev))
            # residency: the per-dtype-class tables are the fixed device
            # cost of the table transport. Tracking is idempotent for
            # unchanged handles; an insert replaced them, so the new
            # buffers book here and the old ones release once outstanding
            # dispatches drop their references.
            from ..lib.hbm import default_hbm

            hbm = default_hbm()
            hbm.track("program_table.i32", self._ti)
            hbm.track("program_table.f32", self._tf)
            hbm.track("program_table.u8", self._tu)
            return self._ti, self._tf, self._tu, nb, count

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"rows": len(self._rows), "capacity": self.capacity,
                    "inserts": self.inserts, "flushes": self.flushes,
                    "gen": self.gen}


#: cluster object → {device: its program table} (the _DEV_CACHE
#: precedent: tables hold node-axis-shaped host masks, so they are
#: per-cluster; weak so a dead cluster frees its device rows)
_TABLES: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
_TABLES_LOCK = threading.Lock()


def table_for(cluster, device: DeviceLike = None) -> DeviceProgramTable:
    dev = resolve_device(device)
    with _TABLES_LOCK:
        per_dev = _TABLES.setdefault(cluster, {})
        t = per_dev.get(dev)
        if t is None:
            t = per_dev[dev] = DeviceProgramTable(device=dev)
        return t
