"""Model zoo: arch definitions + checkpoint loading (JAX counterpart:
maua_style_tpu/models/registry.py; reference: models.py:135-347).

VGG-19, VGG-16 and its finetuned variants (sod / fcn32s / nyud), the
channel-pruned VGG-16 ("prune") and NIN, with the reference's canonical
layer names.  Checkpoints are ``.npz`` files in the JAX package's HWIO
format or torch ``.pth`` state dicts; ``load_params`` returns a state dict
for ``Extractor``.
"""

from __future__ import annotations

import os

import torch

from .extractor import ExtractorSpec, Layer, init_params

# channel progressions (reference models.py:135-139); "P" = 2x2 pool
CHANNEL_LIST = {
    "vgg16p": [24, 22, "P", 41, 51, "P", 108, 89, 111, "P", 184, 276, 228, "P", 512, 512, 512, "P"],
    "vgg16": [64, 64, "P", 128, 128, "P", 256, 256, 256, "P", 512, 512, 512, "P", 512, 512, 512, "P"],
    "vgg19": [64, 64, "P", 128, 128, "P", 256, 256, 256, 256, "P", 512, 512, 512, 512, "P", 512, 512, 512, 512, "P"],
}

MODEL_NAMES = ("vgg19", "vgg16", "sod", "fcn32s", "nyud", "prune", "nin")


def _vgg_spec(arch: str, channels, pooling: str) -> ExtractorSpec:
    layers = []
    block, idx = 1, 1
    for c in channels:
        if c == "P":
            kind = "maxpool" if pooling == "max" else "avgpool"
            layers.append(Layer(kind, f"pool{block}", kernel=(2, 2), stride=(2, 2)))
            block += 1
            idx = 1
        else:
            layers.append(Layer("conv", f"conv{block}_{idx}", out_ch=c, kernel=(3, 3), stride=(1, 1), pad=(1, 1)))
            layers.append(Layer("relu", f"relu{block}_{idx}"))
            idx += 1
    return ExtractorSpec(arch, tuple(layers))


def _nin_spec(pooling: str) -> ExtractorSpec:
    pk = "maxpool" if pooling == "max" else "avgpool"

    def conv(name, out_ch, k, s=1, p=0):
        return Layer("conv", name, out_ch=out_ch, kernel=(k, k), stride=(s, s), pad=(p, p))

    def pool(name):
        return Layer(pk, name, kernel=(3, 3), stride=(2, 2), ceil_mode=True)

    # reference models.py:74-113 with names from nin_dict (models.py:140-171)
    layers = (
        conv("conv1", 96, 11, s=4),
        Layer("relu", "relu1"),
        conv("cccp1", 96, 1),
        Layer("relu", "relu2"),
        conv("cccp2", 96, 1),
        Layer("relu", "relu3"),
        pool("pool1"),
        conv("conv2", 256, 5, p=2),
        Layer("relu", "relu4"),
        conv("cccp3", 256, 1),
        Layer("relu", "relu5"),
        conv("cccp4", 256, 1),
        Layer("relu", "relu6"),
        pool("pool2"),
        conv("conv3", 384, 3, p=1),
        Layer("relu", "relu7"),
        conv("cccp5", 384, 1),
        Layer("relu", "relu8"),
        conv("cccp6", 384, 1),
        Layer("relu", "relu9"),
        pool("pool3"),
        Layer("drop", "drop"),
        conv("conv4-1024", 1024, 3, p=1),
        Layer("relu", "relu10"),
        conv("cccp7-1024", 1024, 1),
        Layer("relu", "relu11"),
        conv("cccp8-1024", 1000, 1),
        Layer("relu", "relu12"),
        Layer("avgpool", "pool4", kernel=(6, 6), stride=(1, 1), ceil_mode=True),
        Layer("softmax", "softmax"),
    )
    return ExtractorSpec("nin", layers)


def select_model(model_file: str, pooling: str = "max") -> ExtractorSpec:
    """Arch spec from a model name or checkpoint path (reference models.py:246-347)."""
    mf = str(model_file).lower()
    if "prun" in mf:
        return _vgg_spec("prune", CHANNEL_LIST["vgg16p"], pooling)
    if any(k in mf for k in ("nyud", "fcn32s", "sod", "vgg16")):
        arch = next(k for k in ("nyud", "fcn32s", "sod", "vgg16") if k in mf)
        return _vgg_spec(arch, CHANNEL_LIST["vgg16"], pooling)
    if "vgg19" in mf or "vgg" in mf:
        return _vgg_spec("vgg19", CHANNEL_LIST["vgg19"], pooling)
    if "nin" in mf:
        return _nin_spec(pooling)
    raise ValueError(f"Model architecture not recognized: {model_file}")


def allow_random_weights(flag: bool | None = None) -> bool:
    """Random-init fallback policy: an explicit ``flag`` wins; otherwise the
    ``MAUA_ALLOW_RANDOM_WEIGHTS`` env var."""
    if flag is not None:
        return bool(flag)
    return os.environ.get("MAUA_ALLOW_RANDOM_WEIGHTS", "") not in ("", "0")


def load_params(
    spec: ExtractorSpec,
    model_file: str | None = None,
    seed: int = 0,
    strict: bool = True,
    allow_random: bool | None = None,
) -> dict[str, torch.Tensor]:
    """State dict for a spec.

    Resolution order: explicit .npz / .pth path -> modelzoo/{arch}.npz ->
    modelzoo/{arch}.pth.  A missing checkpoint is an error unless
    ``allow_random`` (``--allow_random_weights``) opts into the seeded
    random init.
    """
    candidates = []
    if model_file and os.path.exists(str(model_file)):
        candidates.append(str(model_file))
    candidates += [f"modelzoo/{spec.arch}.npz", f"modelzoo/{spec.arch}.pth"]
    for path in candidates:
        if os.path.exists(path):
            if path.endswith(".npz"):
                from .convert import load_npz_params

                return load_npz_params(spec, path, strict=strict)
            if path.endswith((".pth", ".pt")):
                from .convert import load_torch_state_dict

                return load_torch_state_dict(spec, path, strict=strict)
    if not allow_random_weights(allow_random):
        raise FileNotFoundError(
            f"No checkpoint for feature net '{spec.arch}' (searched {candidates}).\n"
            f"Put the reference's torch weights at modelzoo/{spec.arch}.pth, or convert them once with:\n"
            f"    python -m maua_style_tpu_torch.models.convert <{spec.arch}.pth> modelzoo/{spec.arch}.npz\n"
            f"or pass --allow_random_weights to run with deterministic random "
            f"weights (outputs will be meaningless; for tests/smoke only)."
        )
    print(
        f"Warning: no checkpoint found for {spec.arch} "
        f"(searched {candidates}); using deterministic random init."
    )
    return init_params(spec, seed=seed)


__all__ = ["select_model", "load_params", "allow_random_weights", "MODEL_NAMES", "CHANNEL_LIST"]
