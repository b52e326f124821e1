"""CLIP weights into the port (JAX counterpart:
maua_style_tpu/models/clip/convert.py), ViT backbones only.

- ``clip_params_from_jax``: the JAX package's parameter tree (numpy
  leaves) -> a state dict with OpenAI's keys; the patch conv goes from
  HWIO to OIHW, the linear weights are torch-shaped already.
- ``load_clip_npz``: the JAX package's ``.npz`` (flattened ``a/b/0/c``
  keys) -> that tree.
- ``config_from_state_dict``: the JAX package's config inference from an
  OpenAI state dict (layer counts, widths, heads = width / 64).
- ``clip_from_state_dict``: an OpenAI ViT state dict (or the converted JAX
  tree) -> a ``CLIP`` module, through ``load_state_dict``.

The ResNet backbones' converter waits for ROADMAP item 14.
"""

from __future__ import annotations

import numpy as np
import torch

from .model import CLIP, CLIPConfig

# keys of an OpenAI checkpoint that the port's module does not hold
_OPENAI_EXTRA = ("logit_scale", "input_resolution", "context_length", "vocab_size")


def _tensor(v) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.detach().to("cpu", torch.float32)
    return torch.from_numpy(np.asarray(v, np.float32).copy())


def config_from_state_dict(sd) -> CLIPConfig:
    """The JAX package's inference (convert.py:21-43), on OpenAI's keys."""
    vision_width, _, _, patch = sd["visual.conv1.weight"].shape
    grid = int(np.sqrt(sd["visual.positional_embedding"].shape[0] - 1))
    text_width = sd["ln_final.weight"].shape[0]
    return CLIPConfig(
        image_resolution=grid * patch,
        patch_size=patch,
        vision_width=vision_width,
        vision_layers=len({k.split(".")[3] for k in sd if k.startswith("visual.transformer.resblocks.")}),
        vision_heads=vision_width // 64,
        embed_dim=sd["text_projection"].shape[1],
        text_width=text_width,
        text_heads=text_width // 64,
        text_layers=len({k.split(".")[2] for k in sd if k.startswith("transformer.resblocks.")}),
        vocab_size=sd["token_embedding.weight"].shape[0],
        context_length=sd["positional_embedding"].shape[0],
    )


def clip_params_from_jax(tree: dict) -> dict[str, torch.Tensor]:
    """The JAX package's ``{"visual", "text"}`` ViT tree -> OpenAI-keyed
    state dict (float32 CPU tensors)."""
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


def clip_from_state_dict(sd, cfg: CLIPConfig | None = None) -> CLIP:
    """A ``CLIP`` holding an OpenAI ViT state dict (``logit_scale`` and the
    TorchScript archive's size entries are dropped); the config is
    inferred unless given.  Every parameter of the module must be in ``sd``."""
    sd = {k: _tensor(v) for k, v in sd.items() if k not in _OPENAI_EXTRA}
    if any(k.startswith("visual.attnpool.") for k in sd):
        raise NotImplementedError("CLIP ResNet checkpoints are not ported yet (ROADMAP item 14)")
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


__all__ = ["clip_params_from_jax", "clip_from_state_dict", "config_from_state_dict", "load_clip_npz"]
