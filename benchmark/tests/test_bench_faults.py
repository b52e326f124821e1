"""The comparison that decides ``correct`` catches the faults a cell can
have.  Each test drives a whole run of a cell at a tiny size on the CPU
(the harness's look for a card is skipped), with the timed path broken
underneath by a fault of ``benchmark/faults.py``, and judges it by the
cell's committed limits: a sound run comes out correct, and no broken one
does.

The faults: an optimiser step that returns its state unchanged, an answer
altered where it is produced, and on the pyramid its two host steps
broken (nearest-pixel resize, no colour matching).  The cells run one
image on one card, so no batch is halved and no exchange between cards
can be left out."""

from __future__ import annotations

import os

import pytest
import torch

from benchmark import faults, harness
from benchmark.instrument import patched

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CASES = []
for w in harness.benchmark_spec(ROOT)["workloads"]:
    kind = harness.load_cell(ROOT, w["name"])["traffic"]["runner"]
    for fault in (None, "unchanged", "altered") + (("nearest_resize", "no_matching") if kind == "pyramid" else ()):
        CASES.append((w["name"], fault))


def tiny(name: str) -> dict:
    cell = harness.load_cell(ROOT, name)
    t = cell["traffic"]
    if t["runner"] == "pyramid":
        t.update(sizes=[64, 96], iters=[60, 40], content_hw=[96, 96], style_hw=[80, 80], warmup_iters=1)
    else:
        t.update(hw=[96, 96] if cell["config"]["arch"] == "nin" else [64, 64], iters=30, warmup_iters=1)
    return cell


@pytest.mark.parametrize("name,fault", CASES, ids=[f"{n}-{f or 'sound'}" for n, f in CASES])
def test_fault_comes_out_not_correct(name, fault):
    torch.set_num_threads(min(4, torch.get_num_threads()))
    cell = tiny(name)
    with patched(*(faults.patches(fault) if fault else [])):
        _, numbers = harness.run(cell, 2**31 + 99, 0.1, False, "cpu")
    correct, compared = harness.verdict(cell, numbers)
    assert correct is (fault is None), compared


def test_a_fault_no_file_names_is_refused():
    with pytest.raises(KeyError, match="no_such_fault"):
        faults.patches("no_such_fault")
