"""A cell cut to a size a CPU test run holds, driven through the whole
harness on the port's plain (CPU) kernels."""
from __future__ import annotations

import copy

from portbench import harness

CELL = "batch-5k.wide"


def small(cell: str = CELL):
    _entry, config, workload = harness.load_cell(cell)
    config, workload = copy.deepcopy(config), copy.deepcopy(workload)
    config["nodes"] = 300
    workload.update(jobs_running=4, backlog=8, warmup_evals=8)
    config["running_allocs"] = 3000 + 4 * config["job"]["count"]
    return config, workload


def run_small(seed: int = 2**31 + 7, seconds: float = 4.0, trace=False,
              control=False, cell: str = CELL):
    config, workload = small(cell)
    return harness.run_cell(cell, seed, seconds, trace, device="cpu",
                            need_card=False, config=config,
                            workload=workload, control=control)
