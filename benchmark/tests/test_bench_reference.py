"""The plain reference against the port at a tiny size on the CPU: the
loss terms of the first steps and the pastiche after one step of each
optimiser; and the ``style`` judge against a direct ``check.judge``
call, on every cell it judges."""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch

from benchmark import check, harness, inputs
from benchmark.reference import style as ref

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

VGG = {"arch": "vgg19", "content_layers": ["relu4_2"],
       "style_layers": ["relu1_1", "relu2_1", "relu3_1", "relu4_1", "relu5_1"],
       "content_weight": 5, "style_weight": 100, "tv_weight": 0.001, "learning_rate": 1, "lbfgs_history": 100}
NIN = {"arch": "nin", "content_layers": ["relu8"], "style_layers": ["relu1", "relu3", "relu5", "relu7", "relu9", "relu11"],
       "content_weight": 5, "style_weight": 100, "tv_weight": 0.001, "learning_rate": 1}


def port_engine(cfg: dict, optimizer: str, seed: int):
    from maua_style_tpu_torch.engine import StyleEngine
    from maua_style_tpu_torch.losses import LossConfig
    from maua_style_tpu_torch.models import select_model

    loss = LossConfig(content_layers=tuple(cfg["content_layers"]), style_layers=tuple(cfg["style_layers"]),
                      content_weight=cfg["content_weight"], style_weight=cfg["style_weight"], tv_weight=cfg["tv_weight"])
    return StyleEngine(select_model(cfg["arch"]), inputs.make_weights(cfg["arch"], seed, "cpu"), loss,
                       optimizer=optimizer, learning_rate=cfg["learning_rate"], lbfgs_history=100, device="cpu",
                       precision="highest")


@pytest.mark.parametrize("cfg,optimizer,side", [(VGG, "lbfgs", 40), (VGG, "adam", 40), (NIN, "adam", 96)],
                         ids=["vgg19-lbfgs", "vgg19-adam", "nin-adam"])
def test_reference_follows_the_port(cfg, optimizer, side):
    torch.manual_seed(0)
    seed = 2**31 + 5
    content = inputs.caffe_array(inputs.image_u8(side, side, seed, 1, "cpu"))
    style = inputs.caffe_array(inputs.image_u8(side, side, seed, 2, "cpu"))
    init = inputs.random_init(side, side, seed, "cpu")
    engine = port_engine(cfg, optimizer, seed)
    one = engine.optimize(content, [style], init, 1)
    engine.optimize(content, [style], init, 3)
    log = engine.last_loss_log

    obj = ref.Objective({**cfg, "optimizer": optimizer}, inputs.make_weights(cfg["arch"], seed, "cpu"),
                        ref.nchw(content, "cpu"), ref.nchw(style, "cpu"))
    ref_log, _ = ref.optimise(obj, ref.nchw(init, "cpu"), 3, optimizer, cfg["learning_rate"], 100)
    _, ref_one = ref.optimise(obj, ref.nchw(init, "cpu"), 1, optimizer, cfg["learning_rate"], 100)
    n = ref_log.shape[1]
    np.testing.assert_allclose(log[:, :n], ref_log, rtol=1e-4)
    assert not log[:, n:].any()  # the temporal column of an image run
    ref_one = ref_one.permute(0, 2, 3, 1).numpy()
    step = np.abs(ref_one - init).max()
    assert step > 0
    # Adam's first step is g / (|g| + 1e-8): where g is float noise it may
    # flip, so a few elements may differ by up to two steps
    apart = np.abs(one - ref_one)
    assert (apart > 1e-4 * step).mean() <= 1e-3 and apart.max() <= 2 * step


TINY = {"pyramid": {"sizes": [64, 96], "iters": [4, 3], "content_hw": [96, 96], "style_hw": [80, 80]},
        "scale": {"iters": 4}}


STYLE_CELLS = [w["name"] for w in harness.benchmark_spec(ROOT)["workloads"]
               if harness.judge_name(harness.load_cell(ROOT, w["name"])) == "style"]


@pytest.mark.parametrize("name", STYLE_CELLS)
def test_style_judge_returns_what_check_judge_returns(name, tmp_path):
    torch.set_num_threads(min(4, torch.get_num_threads()))
    cell = harness.load_cell(ROOT, name)
    t = cell["traffic"]
    t.update(TINY[t["runner"]], warmup_iters=1)
    if t["runner"] == "scale":
        t["hw"] = [96, 96] if cell["config"]["arch"] == "nin" else [64, 64]
    seed = 2**31 + 21
    rn = harness.runner(t).Runner(cell, seed, "cpu", str(tmp_path))
    scales = rn.reference_scales(rn.unit(0)["answer"])
    got = harness.judge_module("style").judge(cell, scales, seed, "cpu")
    want = check.judge(cell["config"], inputs.make_weights(cell["config"]["arch"], seed, "cpu"), scales, "cpu",
                       int(cell["check"]["compare_iters"]), int(cell["check"].get("step_iters", 0)))
    assert set(got) == set(want) - {"per_scale"} | {"rows"}
    assert got["rows"] == want["per_scale"]
    assert {k: v for k, v in got.items() if k != "rows"} == {k: v for k, v in want.items() if k != "per_scale"}
