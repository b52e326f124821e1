"""The comparison that decides ``correct`` catches the faults a cell can
have.  Each test drives a whole run of a cell at a tiny size on the CPU
(the harness's look for a card is skipped), with the timed path broken
underneath by a fault of ``benchmark/faults.py``, and judges it by the
cell's committed limits: a sound run comes out correct, and no broken one
does.

A cell's faults are ``faults.names(cell)``: on the Gram-style cells an
optimiser step that returns its state unchanged, an answer altered where
it is produced, and on the pyramid its two host steps broken
(nearest-pixel resize, no colour matching); on a cell of another judge,
that judge's ``FAULTS`` and the shared ones it names.  The tiny size is
the runner's own ``tiny(traffic, config)``; a runner without one fails
here at collection.  The cells run one image on one card, so no batch is
halved and no exchange between cards can be left out."""

from __future__ import annotations

import os

import pytest
import torch

from benchmark import faults, harness
from benchmark.instrument import patched

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CASES = []
for w in harness.benchmark_spec(ROOT)["workloads"]:
    cell = harness.load_cell(ROOT, w["name"])
    if not callable(getattr(harness.runner(cell["traffic"]), "tiny", None)):
        raise RuntimeError(f"benchmark/runners/{cell['traffic']['runner']}.py (cell {w['name']}) has no "
                           "tiny(traffic, config): the fault tests would run its full-size mix on the CPU")
    CASES += [(w["name"], fault) for fault in (None,) + faults.names(cell)]


def tiny(name: str) -> dict:
    cell = harness.load_cell(ROOT, name)
    cell["traffic"] = harness.runner(cell["traffic"]).tiny(cell["traffic"], cell["config"])
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
