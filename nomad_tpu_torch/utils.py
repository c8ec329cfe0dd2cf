"""Shared shape/bucketing helpers used by the program compiler and the
program padder. The power-of-two bucketing policy lives here ONCE: the
per-eval compiler (`scheduler/stack.py`) and the padder (`parallel/pad.py`)
must agree, or identical programs pad to different shapes.
"""
from __future__ import annotations

import numpy as np


_uuid_rng = None


def fast_uuid() -> str:
    """RFC-4122-shaped v4 uuid from a userspace PRNG seeded once from
    os.urandom. uuid.uuid4() calls getrandom(2) per id — measured at
    ~8ms per call on the bench VM's kernel — and the scheduler mints
    several ids per evaluation (alloc ids, eval ids, broker tokens), so
    the syscall was ~70ms/eval of pure id generation. These ids need
    uniqueness, not cryptographic unpredictability."""
    import random as _random
    import uuid as _uuid

    global _uuid_rng
    rng = _uuid_rng
    if rng is None:
        import os as _os

        rng = _uuid_rng = _random.Random(
            int.from_bytes(_os.urandom(16), "big"))  # nomadlint: ok NLR02 the FSM's apply mints no id: replicated values carry theirs (tests/test_torch_fsm.py replays every op with fast_uuid raising); the reference's same call (nomad_tpu/utils/__init__.py:30) is hidden from its lint by the package layout
    # single C-level getrandbits call: atomic under the GIL
    return str(_uuid.UUID(int=rng.getrandbits(128), version=4))


def bucket(n: int, lo: int = 1) -> int:
    """Smallest power of two ≥ n (and ≥ lo)."""
    b = lo
    while b < n:
        b *= 2
    return b


def widen_lut(a: np.ndarray, v: int, fill) -> np.ndarray:
    """Widen a [*, V] LUT-style array to V=v columns, keeping the
    missing-token slot in the LAST column (kernels map token −1 → V−1)."""
    if a.shape[-1] == v:
        return a
    out = np.full(a.shape[:-1] + (v,), fill, dtype=a.dtype)
    out[..., : a.shape[-1] - 1] = a[..., : a.shape[-1] - 1]
    out[..., -1] = a[..., -1]
    return out
