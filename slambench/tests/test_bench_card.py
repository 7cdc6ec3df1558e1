"""The harness on the card: one short run of each cell comes out correct,
and the control at the cell's own size does not. Needs a CUDA card
(``-m cuda``); skips without one."""

from __future__ import annotations

import json

import pytest
import torch

from slambench import check, control, spec

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels have no CPU mode")
    return torch.device("cuda")


def _cells():
    bench = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
    return [w["name"] for w in bench["workloads"]]


@pytest.mark.parametrize("name", _cells())
def test_cell_correct_and_control_not(card, name):
    cell = spec.load_cell(name)
    r = control.readings(cell, 2 ** 31 + 99, 1.0, card)
    limits = {**check.LIMITS, **cell.config.get("limits", {})}
    assert all(r["program"][k] <= lim for k, lim in limits.items())
    assert not all(r["control"][k] <= lim for k, lim in limits.items())
