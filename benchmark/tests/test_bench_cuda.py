"""Short traced runs of every one-card cell on the card: correct, with every
per-layer metric that BENCHMARK.json gives the cell. Skips without a card.

    python3 -m pytest benchmark/tests -m cuda
"""

import json
from pathlib import Path

import pytest

from benchmark import run

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())
         ["workloads"] if w["chips"] == 1]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_a_short_traced_run_on_the_card(name):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = run.run_cell(name, 2**31 + 101, 1.0, True)
    assert out["correct"] is True, out["checks"]
    assert set(out["metrics"]) == set(run.cell_metrics(name, "per_layer"))
    assert 0.0 < out["device"]["busy_s"] <= out["device"]["window_s"]
    assert out["device"]["platform"] == "gpu"
