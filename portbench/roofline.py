"""Peaks of the card and the least work of a chain dispatch.

The peaks are NVIDIA's H100 SXM data sheet's (700 W), keyed by a part of
`torch.cuda.get_device_name`: fp32 FLOP/s of the CUDA cores (the
placement kernels do scalar f32 and int32 work, no matrix product) and
HBM bytes/s. A card held below its power limit runs under them; the
traced run prints the limit. On another card the roofline share is not
reported.

`chain_floor` is a frozen copy of the counts of
`nomad_tpu_torch/lib/roofline.py` (`_io`, `_combine`, `_onchip_ops`,
`_chain_cost`) at commit 09e5296, cut to what the harness knows of a
dispatch without reading the program's tensors: the rows N, the resource
columns R, the programs in it, their steps M and their hard constraints.
What it cannot see (the attribute columns of affinities and spreads, port
words, the programs' own table fields, the explain terms) is left out,
so the count is a floor: a share computed from it reads low, never high.
"""
from __future__ import annotations

from typing import Optional, Tuple

#: name substring -> (fp32 FLOP/s, HBM bytes/s)
PEAKS = (("H100 80GB HBM3", (67e12, 3.35e12)),)


def peaks(kind: str) -> Optional[Tuple[float, float]]:
    for sub, p in PEAKS:
        if sub.lower() in kind.lower():
            return p
    return None


def chain_floor(n: int, r: int, programs: int, m: int,
                constraints: int) -> Tuple[float, float]:
    """(bytes, operations) at the least of one chain dispatch of
    `programs` programs of `m` steps over an `n`-row view: the view's
    capacity, use, node_ok, dyn_free and constraint columns read once;
    every program's per-step outputs and nodes_feasible, and the final
    carry, written once; per program every row's fit, score prefix and
    constraint lookups once, and per row and step the compare, divide,
    prefix add and bit test."""
    view_in = n * r * 4 * 2 + n * (1 + 4) + n * constraints * 4
    out = programs * (m * 12 + 4) + n * r * 4 + n * 4
    row = 2 * r + 40 + constraints
    ops = programs * (n * row + n * m * 5)
    return float(view_in + out), float(ops)
