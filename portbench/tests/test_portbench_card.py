"""On the card: one short run of each cell, correct, with the contract's
line (`python -m pytest portbench/tests -m cuda` on a machine with one)."""
from __future__ import annotations

import pytest

from portbench import harness


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in
                                  harness.manifest()["workloads"]])
def test_cell_runs_correct_on_the_card(card, cell):
    out = harness.run_cell(cell, 2**31 + 11, 5.0, False)
    assert out["correct"], out["checks"]
    assert out["device"]["platform"] == "gpu"
