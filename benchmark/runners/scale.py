"""Runner ``scale``: calls of ``StyleEngine.optimize`` at one size, one
after another, on one engine, with the same seeded content, style and
random init.

Set-up builds the engine from the seeded weights (made on the device),
makes the inputs on the device and brings them to the host arrays the
entry takes, and warms the shapes with one call of ``warmup_iters``
iterations.  A unit is one call of ``iters`` iterations; its answer is
the call's result and loss log, and where the cell's check asks for it
(``last_step``) the optimiser's update of the call's last step
(``instrument.LastUpdate``)."""

from __future__ import annotations

import gc

import torch

from .. import flops, inputs
from ..instrument import LastUpdate, labelled, patched


def tiny(traffic: dict, config: dict) -> dict:
    """The mix cut to a size the CPU tests run in seconds."""
    return {**traffic, "hw": [96, 96] if config["arch"] == "nin" else [64, 64], "iters": 30, "warmup_iters": 1}


class Runner:
    def __init__(self, cell: dict, seed: int, device, workdir: str, precision: str | None = None, warm: bool = True):
        from maua_style_tpu_torch.engine import StyleEngine
        from maua_style_tpu_torch.losses import LossConfig
        from maua_style_tpu_torch.models import select_model

        self.cfg, self.traffic, self.seed = cell["config"], cell["traffic"], int(seed)
        self.device = torch.device(device)
        cfg, t = self.cfg, self.traffic
        h, w = t["hw"]
        loss_cfg = LossConfig(content_layers=tuple(cfg["content_layers"]), style_layers=tuple(cfg["style_layers"]),
                              content_weight=float(cfg["content_weight"]), style_weight=float(cfg["style_weight"]),
                              tv_weight=float(cfg["tv_weight"]))
        self.engine = StyleEngine(select_model(cfg["arch"]), inputs.make_weights(cfg["arch"], seed, self.device), loss_cfg,
                                  optimizer=cfg["optimizer"], learning_rate=float(cfg["learning_rate"]),
                                  lbfgs_history=int(cfg.get("lbfgs_history", 100)),
                                  lbfgs_method=cfg.get("lbfgs_method", "compact"),
                                  precision=precision or cfg["precision"], device=self.device)
        self.content = inputs.caffe_array(inputs.image_u8(h, w, seed, 1, self.device))
        self.style = inputs.caffe_array(inputs.image_u8(h, w, seed, 2, self.device))
        self.init = inputs.random_init(h, w, seed, self.device)
        self.last = LastUpdate() if cell["check"].get("last_step") else None
        if warm:
            self.engine.optimize(self.content, [self.style], self.init, t["warmup_iters"])

    def host_spans(self) -> list:
        from maua_style_tpu_torch.engine import optimize

        return [(optimize, "to_nchw", labelled("copy_in")), (optimize, "to_nhwc", labelled("copy_out"))]

    def unit(self, index: int) -> dict:
        iters = int(self.traffic["iters"])
        with patched(*(self.last.hooks() if self.last else [])):
            out = self.engine.optimize(self.content, [self.style], self.init, iters)
        answer = {"iters": iters, "init": self.init, "out": out, "log": self.engine.last_loss_log}
        if self.last:
            answer["last_update"] = self.last.take()
        h, w = self.traffic["hw"]
        return {
            "images": 1,
            "iters": iters,
            "mp_iters": h * w * iters / 1e6,
            "flops": iters * flops.iteration_flops(self.cfg, h, w),
            "answer": [answer],
        }

    def release(self) -> None:
        """Frees the engine (its weights and cached targets) before the
        reference runs."""
        self.engine = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference_scales(self, answer: list) -> list:
        return [{**answer[0], "content": self.content, "style": self.style}]

