"""The control on a card, at a size a test run holds: the reference in the
program's place one precision lower is the program's own TF32 path
(``precision="high"``), and it has to come out not correct where the
program as configured (f32, TF32 off) comes out correct.  Run on a card:

    python -m pytest -m cuda benchmark/tests/test_bench_control_cuda.py
"""

from __future__ import annotations

import os

import pytest
import torch

from benchmark import harness

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SMALL = {"vgg19.pyramid": {"sizes": [256, 512], "iters": [6, 4], "content_hw": [512, 512], "style_hw": [384, 384]},
         "nin.9088": {"hw": [1024, 1024], "iters": 4},
         "vgg19.2048": {"hw": [512, 512], "iters": 4}}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the control is TF32 on the card's tensor cores")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("precision", [None, "high"], ids=["as-configured", "control-tf32"])
@pytest.mark.parametrize("name", sorted(SMALL))
def test_control_is_not_correct(card, name, precision):
    cell = harness.load_cell(ROOT, name)
    cell["traffic"].update(SMALL[name], warmup_iters=1)
    try:
        _, numbers = harness.run(cell, 2**31 + 7, 0.1, False, card, precision)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    correct, compared = harness.verdict(cell, numbers)
    assert correct is (precision is None), compared
