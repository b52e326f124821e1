"""Runner ``pyramid``: whole images of the img_img pyramid through the CLI's
entry, ``maua_style_tpu_torch.style.main``, one after another, each into a
fresh output directory.

Set-up writes the seeded weights as a ``.pth`` file and the seeded content
and style as PNGs into the run's work directory, and warms every scale's
shapes with one pyramid of ``warmup_iters`` iterations a scale.  A unit is
one image.  Its answer is each scale's ``StyleEngine.optimize`` call as
the CLI made it (content, style, init, result, loss log), recorded by a
wrapper from this file.  The reference follows the program scale by
scale from what it optimised from, and besides works each scale's
content, style and (after the first scale) init out again from the PNGs
and the program's previous result, with its own resize and colour
matching, for ``check.host_gap``."""

from __future__ import annotations

import math
import os

import torch
from PIL import Image

from .. import flops, inputs
from ..reference import nets
from ..reference import style as ref
from ..instrument import labelled, patched

# faults.py's faults in the CLI's host steps, which only this runner drives;
# a style-judge cell of it is held to them beside the engine's two
STYLE_FAULTS = ("nearest_resize", "no_matching")


def tiny(traffic: dict, config: dict) -> dict:
    """The mix cut to a size the CPU tests run in seconds: two scales."""
    return {**traffic, "sizes": [64, 96], "iters": [60, 40], "content_hw": [96, 96], "style_hw": [80, 80],
            "warmup_iters": 1}


class Runner:
    def __init__(self, cell: dict, seed: int, device, workdir: str, precision: str | None = None, warm: bool = True):
        from maua_style_tpu_torch.engine import StyleEngine

        self.cfg, self.traffic, self.seed = cell["config"], cell["traffic"], int(seed)
        self.device, self.dir = torch.device(device), workdir
        self.precision = precision or self.cfg["precision"]
        self.engine_cls = StyleEngine
        cfg, t = self.cfg, self.traffic
        weights = inputs.make_weights(cfg["arch"], seed, self.device)
        convs = [name for kind, name, *_ in nets.TABLES[cfg["arch"]] if kind == "conv"]
        sd = {}
        for i, name in enumerate(convs):
            sd[f"features.{i}.weight"] = weights[f"{name}.weight"].cpu()
            sd[f"features.{i}.bias"] = weights[f"{name}.bias"].cpu()
        torch.save(sd, os.path.join(workdir, f"{cfg['arch']}.pth"))
        del weights, sd
        self.content_u8 = inputs.image_u8(*t["content_hw"], seed, 1, self.device).permute(1, 2, 0).cpu().numpy()
        self.style_u8 = inputs.image_u8(*t["style_hw"], seed, 2, self.device).permute(1, 2, 0).cpu().numpy()
        Image.fromarray(self.content_u8).save(os.path.join(workdir, "content.png"))
        Image.fromarray(self.style_u8).save(os.path.join(workdir, "style.png"))
        if warm:
            self._main([t["warmup_iters"]] * len(t["sizes"]), "warmup")

    def _argv(self, iters, out: str) -> list[str]:
        cfg, t = self.cfg, self.traffic
        return [
            "--content", "content.png", "--style", "style.png", "--output_dir", out,
            "--image_sizes", ",".join(map(str, t["sizes"])), "--num_iters", ",".join(map(str, iters)),
            "--model_file", f"{cfg['arch']}.pth",
            "--content_layers", ",".join(cfg["content_layers"]), "--style_layers", ",".join(cfg["style_layers"]),
            "--content_weight", str(cfg["content_weight"]), "--style_weight", str(cfg["style_weight"]),
            "--tv_weight", str(cfg["tv_weight"]), "--optimizer", cfg["optimizer"],
            "--learning_rate", str(cfg["learning_rate"]), "--lbfgs_num_correction", str(cfg["lbfgs_history"]),
            "--lbfgs_method", cfg.get("lbfgs_method", "compact"),
            "--precision", self.precision, "--compute_dtype", cfg["compute_dtype"],
            "--seed", str(self.seed % 2**32), "--gpu", "c" if self.device.type == "cpu" else "0",
        ]

    def _main(self, iters, out: str):
        from maua_style_tpu_torch import style

        here = os.getcwd()
        os.chdir(self.dir)  # the CLI's paths are the work directory's, relative
        try:
            style.main(self._argv(iters, out))
        finally:
            os.chdir(here)

    def host_spans(self) -> list:
        """(obj, name, wrapper) of the host steps a traced run names."""
        from maua_style_tpu_torch import io as mio
        from maua_style_tpu_torch.pipelines import img_img

        return [(img_img, "build_engine", labelled("build_engine")),
                (img_img, "match_histogram", labelled("match_histogram")),
                (img_img, "resize_bilinear_np", labelled("resize")),
                (img_img, "scale_styles", labelled("scale_styles")),
                (mio, "save_tensor_to_file", labelled("save")),
                (mio, "preprocess", labelled("load")),
                (mio, "process_style_images", labelled("load"))]

    def unit(self, index: int) -> dict:
        scales = []

        def record(fn, engine, content, styles, init, num_iters, **kw):
            out = fn(engine, content, styles, init, num_iters, **kw)
            scales.append({"iters": int(num_iters), "content": content, "style": styles[0], "init": init, "out": out,
                           "log": engine.last_loss_log})
            return out

        with patched((self.engine_cls, "optimize", record)):
            self._main(self.traffic["iters"], f"image{index}")
        hws = [s["out"].shape[1:3] for s in scales]
        return {
            "images": 1,
            "iters": sum(s["iters"] for s in scales),
            "mp_iters": sum(h * w * s["iters"] / 1e6 for (h, w), s in zip(hws, scales)),
            "flops": sum(s["iters"] * flops.iteration_flops(self.cfg, h, w) for (h, w), s in zip(hws, scales)),
            "answer": scales,
        }

    def release(self) -> None:
        """Nothing of the program outlives a unit: the CLI builds its
        engines per scale."""

    def reference_scales(self, answer: list) -> list:
        """Each recorded scale, with the reference's own content, style and
        init beside it (``host``)."""
        style_big = ref.preprocess(self.style_u8)
        content_big = ref.match_colors(ref.preprocess(self.content_u8), style_big)
        h0, w0 = content_big.shape[1:3]
        out = []
        for s, (size, rec) in enumerate(zip(self.traffic["sizes"], answer)):
            content = ref.resize(content_big, scale=size / max(h0, w0))
            h, w = content.shape[1:3]
            factor = math.sqrt(h * w / (style_big.shape[1] * style_big.shape[2]))
            style_s = ref.resize(style_big, scale=factor)
            init = None  # the first scale's is the CLI's own random draw
            if s > 0:
                prev = ref.match_colors(answer[s - 1]["out"], style_big)
                init = ref.match_colors(ref.resize(prev, size=(h, w)), style_big)
            out.append({**rec, "host": {"content": content, "style": style_s, "init": init, "style_big": style_big}})
        return out
