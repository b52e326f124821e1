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
- ``clip_tree_from_state_dict`` / ``save_clip_npz`` / ``main``: an OpenAI
  ``.pt`` -> the JAX package's tree and ``.npz``, the file its converter
  writes from the same checkpoint::

    python -m maua_style_tpu_torch.models.clip.convert ViT-B-32.pt modelzoo/clip_vitb32.npz
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


def clip_tree_from_state_dict(sd) -> dict:
    """An OpenAI state dict, ViT or ResNet (``visual.attnpool.*`` keys) ->
    the JAX package's ``{"visual", "text"}`` tree of float32 arrays, as its
    converters build it (JAX convert.py:21-137, resnet.py:160-207)."""

    def a(key: str) -> np.ndarray:
        return _tensor(sd[key]).numpy()

    def hwio(key: str) -> np.ndarray:
        return np.transpose(a(key), (2, 3, 1, 0))  # OIHW -> HWIO

    def ln(prefix: str) -> dict:
        return {"g": a(prefix + ".weight"), "b": a(prefix + ".bias")}

    def blocks(prefix: str) -> list:
        depth = prefix.count(".") + 2
        n = len({k.split(".")[depth] for k in sd if k.startswith(prefix + ".resblocks.")})
        return [{
            "ln_1": ln(f"{prefix}.resblocks.{i}.ln_1"),
            "ln_2": ln(f"{prefix}.resblocks.{i}.ln_2"),
            "attn": {
                "in_w": a(f"{prefix}.resblocks.{i}.attn.in_proj_weight"),
                "in_b": a(f"{prefix}.resblocks.{i}.attn.in_proj_bias"),
                "out_w": a(f"{prefix}.resblocks.{i}.attn.out_proj.weight"),
                "out_b": a(f"{prefix}.resblocks.{i}.attn.out_proj.bias"),
            },
            **{f"mlp_{m}_{t}": a(f"{prefix}.resblocks.{i}.mlp.c_{m}.{w}")
               for m in ("fc", "proj") for t, w in (("w", "weight"), ("b", "bias"))},
        } for i in range(n)]

    text = {
        "token_embedding": a("token_embedding.weight"),
        "positional_embedding": a("positional_embedding"),
        "ln_final": ln("ln_final"),
        "text_projection": a("text_projection"),
        "blocks": blocks("transformer"),
    }
    if not any(k.startswith("visual.attnpool.") for k in sd):
        visual = {
            "conv1_w": hwio("visual.conv1.weight"),
            "class_embedding": a("visual.class_embedding"),
            "positional_embedding": a("visual.positional_embedding"),
            "ln_pre": ln("visual.ln_pre"),
            "ln_post": ln("visual.ln_post"),
            "proj": a("visual.proj"),
            "blocks": blocks("visual.transformer"),
        }
        return {"visual": visual, "text": text}

    def conv(prefix: str) -> dict:
        return {"w": hwio(prefix + ".weight")}

    def bn(prefix: str) -> dict:
        return {"g": a(prefix + ".weight"), "b": a(prefix + ".bias"), "mean": a(prefix + ".running_mean"),
                "var": a(prefix + ".running_var")}

    visual: dict = {}
    for i in (1, 2, 3):
        visual[f"conv{i}"], visual[f"bn{i}"] = conv(f"visual.conv{i}"), bn(f"visual.bn{i}")
    for stage in range(1, 5):
        layer, bi = [], 0
        while f"visual.layer{stage}.{bi}.conv1.weight" in sd:
            pre = f"visual.layer{stage}.{bi}"
            blk = {f"{kind}{i}": fn(f"{pre}.{kind}{i}") for i in (1, 2, 3) for kind, fn in (("conv", conv), ("bn", bn))}
            # the shortcut's conv and BatchNorm: OpenAI's downsample.0 / .1,
            # or .1 / .2 where the pool holds index 0
            if pre + ".downsample.0.weight" in sd:
                blk["downsample"] = {"conv": conv(pre + ".downsample.0"), "bn": bn(pre + ".downsample.1")}
            elif pre + ".downsample.1.weight" in sd:
                blk["downsample"] = {"conv": conv(pre + ".downsample.1"), "bn": bn(pre + ".downsample.2")}
            layer.append(blk)
            bi += 1
        visual[f"layer{stage}"] = layer
    visual["attnpool"] = {"positional_embedding": a("visual.attnpool.positional_embedding"),
                          **{f"{n}_{t}": a(f"visual.attnpool.{n}_proj.{w}")
                             for n in ("q", "k", "v", "c") for t, w in (("w", "weight"), ("b", "bias"))}}
    return {"visual": visual, "text": text}


def save_clip_npz(tree: dict, path: str) -> None:
    """A parameter tree -> the JAX package's ``.npz`` (``a/b/0/c`` keys)."""
    flat = {}

    def walk(prefix, node):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(f"{prefix}/{k}" if prefix else k, v)
        elif isinstance(node, list):
            for i, v in enumerate(node):
                walk(f"{prefix}/{i}", v)
        else:
            flat[prefix] = np.asarray(node)

    walk("", tree)
    np.savez(path, **flat)


def main(argv=None) -> None:
    import argparse

    ap = argparse.ArgumentParser(description="Convert an OpenAI CLIP .pt to .npz")
    ap.add_argument("src")
    ap.add_argument("dst")
    args = ap.parse_args(argv)
    obj = torch.load(args.src, map_location="cpu", weights_only=False)
    sd = obj.state_dict() if hasattr(obj, "state_dict") else obj
    save_clip_npz(clip_tree_from_state_dict(sd), args.dst)
    kind = "ResNet" if any(k.startswith("visual.attnpool.") for k in sd) else "ViT"
    print(f"wrote {args.dst} ({kind} backbone)")


if __name__ == "__main__":
    main()


__all__ = ["clip_params_from_jax", "clip_from_state_dict", "config_from_state_dict", "resnet_config_from_state_dict",
           "load_clip_npz", "clip_tree_from_state_dict", "save_clip_npz"]
