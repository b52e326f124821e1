"""Judge ``style``: the Gram-style reference (``check.judge``) over each
scale the runner hands over, with the feature net's weights made again
from the seed (``inputs.make_weights`` from ``reference/nets.TABLES``).
Its faults are ``faults.py``'s own."""

from __future__ import annotations

from .. import check
from ..inputs import make_weights

NUMBERS = ("loss_gap", "step_gap", "answer_gap", "last_gap", "host_gap")
REQUIRED = ("loss_gap",)


def judge(cell: dict, runner_answer: list, seed: int, device) -> dict:
    weights = make_weights(cell["config"]["arch"], seed, device)
    numbers = check.judge(cell["config"], weights, runner_answer, device, int(cell["check"]["compare_iters"]),
                          int(cell["check"].get("step_iters", 0)))
    numbers["rows"] = numbers.pop("per_scale")
    return numbers
