"""The control on the card: every cell at the tiny size of ``tiny.py``, run
by the program one precision down (TF32 on for its fp32 products), must come
out not correct. Skipped without a CUDA card; on the card:
``python -m pytest benchmark/tests -m card``. At the cells' own sizes the
same control runs through ``benchmark/readings.py --control``."""

from __future__ import annotations

import sys
import time
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from tiny import tiny_root  # noqa: E402

from benchmark.harness.core import run_cell  # noqa: E402
from benchmark.harness.spec import cell_names, resolve  # noqa: E402

CELLS = cell_names(ROOT)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(card, tmp_path, cell):
    root = tiny_root(tmp_path)
    for control in (False, True):
        result, lines = run_cell(resolve(root, cell), 2**31 + 5, 2.0, False, card,
                                 time.time(), control=control, out=lambda line: None)
        assert result["correct"] is not control, lines
