"""CLIP weights into the port (JAX counterpart:
maua_style_tpu/models/clip/convert.py), ViT and ResNet backbones.

- ``clip_params_from_jax``: the JAX package's parameter tree (numpy
  leaves) -> a state dict with OpenAI's keys; convolutions go from HWIO to
  OIHW, the linear weights are torch-shaped already.  A tree whose visual
  tower has an ``attnpool`` is a ResNet's (``layer{n}`` lists of blocks,
  BatchNorms as ``g``/``b``/``mean``/``var``).
- ``load_clip_npz``: the JAX package's ``.npz`` (flattened ``a/b/0/c``
  keys) -> that tree.
- ``config_from_state_dict`` / ``resnet_config_from_state_dict``: the JAX
  package's config inference from an OpenAI state dict (layer counts,
  widths; heads = width / 64 for a ViT, width / 2 for a ResNet; the
  resolution from the positional embedding).
- ``clip_from_state_dict``: an OpenAI state dict (or the converted JAX
  tree) -> a ``CLIP`` or ``CLIPResNet`` module, through ``load_state_dict``.
"""

from __future__ import annotations

import re

import numpy as np
import torch

from .model import CLIP, CLIPConfig
from .resnet import CLIPResNet, ResNetConfig

# keys of an OpenAI checkpoint that the port's module does not hold
_OPENAI_EXTRA = ("logit_scale", "input_resolution", "context_length", "vocab_size")


def _tensor(v) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.detach().to("cpu", torch.float32)
    return torch.from_numpy(np.asarray(v, np.float32).copy())


def _text_config(sd) -> dict:
    text_width = sd["ln_final.weight"].shape[0]
    return dict(
        embed_dim=sd["text_projection"].shape[1],
        text_width=text_width,
        text_heads=text_width // 64,
        text_layers=len({k.split(".")[2] for k in sd if k.startswith("transformer.resblocks.")}),
        vocab_size=sd["token_embedding.weight"].shape[0],
        context_length=sd["positional_embedding"].shape[0],
    )


def config_from_state_dict(sd) -> CLIPConfig:
    """The JAX package's inference (convert.py:21-43), on OpenAI's keys."""
    vision_width, _, _, patch = sd["visual.conv1.weight"].shape
    grid = int(np.sqrt(sd["visual.positional_embedding"].shape[0] - 1))
    return CLIPConfig(
        image_resolution=grid * patch,
        patch_size=patch,
        vision_width=vision_width,
        vision_layers=len({k.split(".")[3] for k in sd if k.startswith("visual.transformer.resblocks.")}),
        vision_heads=vision_width // 64,
        **_text_config(sd),
    )


def resnet_config_from_state_dict(sd) -> tuple[ResNetConfig, CLIPConfig]:
    """The JAX package's ResNet inference (convert.py:84-104): blocks per
    stage, width = 2 x the stem's first conv, the embedding width from
    ``c_proj``, the resolution from the attention pool's positional
    embedding, heads = width / 2; and the text tower's config."""
    width = sd["visual.conv1.weight"].shape[0] * 2
    spacial = int(np.sqrt(sd["visual.attnpool.positional_embedding"].shape[0] - 1))
    rn = ResNetConfig(
        layers=tuple(len({k.split(".")[2] for k in sd if k.startswith(f"visual.layer{s + 1}.")}) for s in range(4)),
        width=width,
        embed_dim=sd["visual.attnpool.c_proj.weight"].shape[0],
        image_resolution=spacial * 32,
        heads=width // 2,
    )
    return rn, CLIPConfig(image_resolution=rn.image_resolution, **_text_config(sd))


def _resnet_visual(sd: dict, v: dict) -> None:
    """The JAX package's ResNet visual tree -> OpenAI's ``visual.*`` keys."""

    def conv(key: str, p: dict) -> None:
        sd[key + ".weight"] = _tensor(p["w"]).permute(3, 2, 0, 1).contiguous()  # HWIO -> OIHW

    def bn(key: str, p: dict) -> None:
        for ours, theirs in (("weight", "g"), ("bias", "b"), ("running_mean", "mean"), ("running_var", "var")):
            sd[f"{key}.{ours}"] = _tensor(p[theirs])

    for i in (1, 2, 3):
        conv(f"visual.conv{i}", v[f"conv{i}"])
        bn(f"visual.bn{i}", v[f"bn{i}"])
    for stage in range(1, 5):
        for bi, blk in enumerate(v[f"layer{stage}"]):
            pre = f"visual.layer{stage}.{bi}"
            for i in (1, 2, 3):
                conv(f"{pre}.conv{i}", blk[f"conv{i}"])
                bn(f"{pre}.bn{i}", blk[f"bn{i}"])
            if "downsample" in blk:
                conv(pre + ".downsample.0", blk["downsample"]["conv"])
                bn(pre + ".downsample.1", blk["downsample"]["bn"])
    p = v["attnpool"]
    sd["visual.attnpool.positional_embedding"] = _tensor(p["positional_embedding"])
    for name in ("q", "k", "v", "c"):
        sd[f"visual.attnpool.{name}_proj.weight"] = _tensor(p[f"{name}_w"])
        sd[f"visual.attnpool.{name}_proj.bias"] = _tensor(p[f"{name}_b"])


def clip_params_from_jax(tree: dict) -> dict[str, torch.Tensor]:
    """The JAX package's ``{"visual", "text"}`` tree, ViT or ResNet ->
    OpenAI-keyed state dict (float32 CPU tensors)."""
    sd: dict[str, torch.Tensor] = {}

    def ln(key: str, p: dict) -> None:
        sd[key + ".weight"], sd[key + ".bias"] = _tensor(p["g"]), _tensor(p["b"])

    def blocks(prefix: str, blks: list) -> None:
        for i, p in enumerate(blks):
            key = f"{prefix}.resblocks.{i}"
            ln(key + ".ln_1", p["ln_1"])
            ln(key + ".ln_2", p["ln_2"])
            sd[key + ".attn.in_proj_weight"] = _tensor(p["attn"]["in_w"])
            sd[key + ".attn.in_proj_bias"] = _tensor(p["attn"]["in_b"])
            sd[key + ".attn.out_proj.weight"] = _tensor(p["attn"]["out_w"])
            sd[key + ".attn.out_proj.bias"] = _tensor(p["attn"]["out_b"])
            for name in ("fc", "proj"):
                sd[f"{key}.mlp.c_{name}.weight"] = _tensor(p[f"mlp_{name}_w"])
                sd[f"{key}.mlp.c_{name}.bias"] = _tensor(p[f"mlp_{name}_b"])

    v, t = tree["visual"], tree["text"]
    if "attnpool" in v:
        _resnet_visual(sd, v)
    else:
        sd["visual.conv1.weight"] = _tensor(v["conv1_w"]).permute(3, 2, 0, 1).contiguous()  # HWIO -> OIHW
        sd["visual.class_embedding"] = _tensor(v["class_embedding"])
        sd["visual.positional_embedding"] = _tensor(v["positional_embedding"])
        ln("visual.ln_pre", v["ln_pre"])
        ln("visual.ln_post", v["ln_post"])
        sd["visual.proj"] = _tensor(v["proj"])
        blocks("visual.transformer", v["blocks"])
    sd["token_embedding.weight"] = _tensor(t["token_embedding"])
    sd["positional_embedding"] = _tensor(t["positional_embedding"])
    ln("ln_final", t["ln_final"])
    sd["text_projection"] = _tensor(t["text_projection"])
    blocks("transformer", t["blocks"])
    return sd


def _downsample_keys(sd: dict) -> dict:
    """A shortcut stored as ``downsample.1`` (conv) / ``downsample.2`` (BN)
    moves to OpenAI's ``.0`` / ``.1``, block by block, as the JAX
    converter accepts both (resnet.py:192-196)."""
    shifted = {m.group(1) for k in sd if (m := re.match(r"(visual\.layer\d+\.\d+)\.downsample\.1\.weight$", k))
               and m.group(1) + ".downsample.0.weight" not in sd}
    out = {}
    for k, v in sd.items():
        m = re.match(r"(visual\.layer\d+\.\d+)\.downsample\.(\d+)\.(.*)$", k)
        if m and m.group(1) in shifted:
            k = f"{m.group(1)}.downsample.{int(m.group(2)) - 1}.{m.group(3)}"
        out[k] = v
    return out


def clip_from_state_dict(sd, cfg: CLIPConfig | None = None) -> CLIP:
    """A ``CLIP`` holding an OpenAI ViT state dict, or a ``CLIPResNet``
    holding a ResNet one (``visual.attnpool.*`` keys); ``logit_scale``, the
    TorchScript archive's size entries and the BatchNorms'
    ``num_batches_tracked`` are dropped.  The config is inferred (a ViT's
    unless given).  Every parameter of the module must be in ``sd``."""
    sd = {k: _tensor(v) for k, v in sd.items() if k not in _OPENAI_EXTRA and not k.endswith(".num_batches_tracked")}
    if any(k.startswith("visual.attnpool.") for k in sd):
        sd = _downsample_keys(sd)
        model = CLIPResNet(*resnet_config_from_state_dict(sd))
    else:
        model = CLIP(cfg or config_from_state_dict(sd))
    model.load_state_dict(sd, strict=True)
    return model


def load_clip_npz(path: str) -> dict:
    """The JAX package's ``.npz`` -> its nested parameter tree (numpy
    leaves; digit-keyed levels become lists)."""
    root: dict = {}
    with np.load(path) as data:
        for key in data.files:
            parts = key.split("/")
            node = root
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = np.asarray(data[key])

    def listify(node):
        if isinstance(node, dict):
            keys = list(node.keys())
            if keys and all(k.isdigit() for k in keys):
                return [listify(node[str(i)]) for i in range(len(keys))]
            return {k: listify(v) for k, v in node.items()}
        return node

    return listify(root)


__all__ = ["clip_params_from_jax", "clip_from_state_dict", "config_from_state_dict", "resnet_config_from_state_dict",
           "load_clip_npz"]
