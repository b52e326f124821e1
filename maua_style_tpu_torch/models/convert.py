"""Carrying weights across (JAX counterpart: maua_style_tpu/models/convert.py).

- ``params_from_jax``: the JAX package's ``{name: {"w": HWIO, "b": (O,)}}``
  parameter dict -> an ``Extractor`` state dict (OIHW).
- ``load_npz_params`` / ``save_npz_params``: the JAX package's ``.npz``
  format (``{name}/w`` HWIO, ``{name}/b``), so one file serves both.
- ``load_torch_state_dict``: the reference's ``features.N.weight`` state
  dicts, mapped onto the spec's conv layers in order.

Convert a reference ``.pth`` once with::

    python -m maua_style_tpu_torch.models.convert modelzoo/vgg19.pth modelzoo/vgg19.npz
"""

from __future__ import annotations

import numpy as np
import torch

from .extractor import ExtractorSpec


def params_from_jax(params: dict[str, dict[str, np.ndarray]]) -> dict[str, torch.Tensor]:
    """HWIO/bias parameter dict -> OIHW state dict (float32, on the CPU)."""
    sd = {}
    for name, p in params.items():
        w = np.asarray(p["w"], np.float32)
        sd[f"{name}.weight"] = torch.from_numpy(np.ascontiguousarray(np.transpose(w, (3, 2, 0, 1))))
        sd[f"{name}.bias"] = torch.from_numpy(np.array(p["b"], np.float32))
    return sd


def _check_shape(spec_layer, w: torch.Tensor, strict: bool) -> None:
    if strict and (w.shape[0], w.shape[2], w.shape[3]) != (spec_layer.out_ch, *spec_layer.kernel):
        raise ValueError(f"shape mismatch at {spec_layer.name}: ckpt {tuple(w.shape)} vs spec "
                         f"({spec_layer.out_ch}, *, {spec_layer.kernel[0]}, {spec_layer.kernel[1]})")


def load_torch_state_dict(spec: ExtractorSpec, path_or_sd, strict: bool = True) -> dict[str, torch.Tensor]:
    """Map ``features.N.weight/bias`` entries (OIHW) onto the spec's convs in order."""
    if isinstance(path_or_sd, (str, bytes)):
        sd = torch.load(path_or_sd, map_location="cpu", weights_only=True)
    else:
        sd = path_or_sd
    weights: dict[int, dict[str, torch.Tensor]] = {}
    for key, val in sd.items():
        if not key.startswith("features.") or not key.endswith((".weight", ".bias")):
            continue
        idx = int(key.split(".")[1])
        weights.setdefault(idx, {})[key.split(".")[-1]] = torch.as_tensor(val).detach().float().cpu()
    conv_arrays = [weights[i] for i in sorted(weights) if "weight" in weights[i] and weights[i]["weight"].ndim == 4]

    conv_layers = spec.conv_layers
    if strict and len(conv_arrays) < len(conv_layers):
        raise ValueError(f"checkpoint has {len(conv_arrays)} conv layers, spec {spec.arch} needs {len(conv_layers)}")
    out = {}
    for layer, entry in zip(conv_layers, conv_arrays):
        w = entry["weight"].contiguous()
        _check_shape(layer, w, strict)
        out[f"{layer.name}.weight"] = w
        out[f"{layer.name}.bias"] = entry.get("bias", torch.zeros(w.shape[0]))
    return out


def save_npz_params(state_dict: dict[str, torch.Tensor], path: str) -> None:
    """State dict -> the JAX package's HWIO ``.npz`` format."""
    flat = {}
    for key, val in state_dict.items():
        name, kind = key.rsplit(".", 1)
        arr = val.detach().float().cpu().numpy()
        if kind == "weight":
            flat[f"{name}/w"] = np.transpose(arr, (2, 3, 1, 0))
        else:
            flat[f"{name}/b"] = arr
    np.savez(path, **flat)


def load_npz_params(spec: ExtractorSpec, path: str, strict: bool = True) -> dict[str, torch.Tensor]:
    with np.load(path) as data:
        params = {}
        for layer in spec.conv_layers:
            wk, bk = f"{layer.name}/w", f"{layer.name}/b"
            if wk not in data:
                if strict:
                    raise ValueError(f"missing {wk} in {path}")
                continue
            params[layer.name] = {"w": data[wk], "b": data[bk]}
    sd = params_from_jax(params)
    for layer in spec.conv_layers:
        if f"{layer.name}.weight" in sd:
            _check_shape(layer, sd[f"{layer.name}.weight"], strict)
    return sd


def main(argv=None) -> None:
    import argparse

    from .registry import select_model

    ap = argparse.ArgumentParser(description="Convert a torch .pth feature-net checkpoint to .npz")
    ap.add_argument("src")
    ap.add_argument("dst")
    ap.add_argument("--arch", default=None, help="arch name; inferred from src filename if omitted")
    ap.add_argument("--pooling", default="max", choices=["max", "avg"])
    args = ap.parse_args(argv)
    spec = select_model(args.arch or args.src, args.pooling)
    sd = load_torch_state_dict(spec, args.src)
    save_npz_params(sd, args.dst)
    print(f"wrote {args.dst} ({len(sd) // 2} conv layers, arch {spec.arch})")


if __name__ == "__main__":
    main()
