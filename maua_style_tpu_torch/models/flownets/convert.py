"""Flow-net weights carried across (JAX counterparts:
maua_style_tpu/models/flownets/convert.py, ``convert_pwc_torch`` at
pwc.py:134, ``convert_spynet_torch`` at spynet.py:84, and
``assign_by_shape`` for UnFlow and LiteFlowNet).

- ``flow_params_from_jax(name, params)``: the JAX nets' ``{layer: {"w", "b"}}``
  dicts (numpy) -> the port module's state dict.  Convs are HWIO -> OIHW;
  deconvs are stored ``(k, k, out, in)`` in the JAX package and go to
  torch's ``ConvTranspose2d`` ``(in, out, k, k)`` with no spatial flip (the
  JAX forward flips instead): both are ``transpose(3, 2, 0, 1)``.
- ``load_npz(path)``: ``modelzoo/{name}.npz`` in the JAX layout
  (``{layer}/w``, ``{layer}/b``), so one file feeds both packages.
- ``flow_params_from_torch(name, state_dict)``: a sniklaus
  pytorch-{spynet,pwc} state dict, renamed as the JAX converters rename it,
  with every weight's shape checked against the layout; for UnFlow and
  LiteFlowNet, ``assign_by_shape``: each layout entry takes the first
  unused 4-D weight of its shape in the state dict's insertion order
  (kernel-4 entries, the deconvs, read as ``(in, out, k, k)``), and a
  layer left without one fails with the list of unmatched layers.
"""

from __future__ import annotations

import re

import numpy as np
import torch


def _layout(name: str):
    if name == "spynet":
        from .spynet import layout
    elif name == "pwc":
        from .pwc import layout
    elif name == "unflow":
        from .unflow import layout
    elif name == "liteflownet":
        from .liteflownet import layout
    else:
        raise ValueError(f"unknown flow net {name!r}")
    return layout()


def _key(layer: str) -> str:
    return "convs." + layer.replace("/", "_")


def flow_params_from_jax(name: str, params: dict) -> dict[str, torch.Tensor]:
    sd = {}
    for layer, _cin, _cout, _k in _layout(name):
        p = params[layer]
        w = np.asarray(p["w"], np.float32)
        sd[_key(layer) + ".weight"] = torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1)))
        sd[_key(layer) + ".bias"] = torch.from_numpy(np.array(p["b"], np.float32))
    return sd


def load_npz(path: str) -> dict:
    params: dict = {}
    with np.load(path) as data:
        for key in data.files:
            layer, kind = key.rsplit("/", 1)
            params.setdefault(layer, {})[kind] = data[key]
    return params


def _spynet_names(state_dict) -> dict[str, tuple[str, np.ndarray]]:
    """sniklaus netBasic modules: sequential conv indices 0, 2, 4, 6, 8 of
    level L -> level{L}/conv1..conv5."""
    out = {}
    for key in state_dict:
        m = re.search(r"(?:module)?[Bb]asic\.?(\d+).*?(\d+)\.weight$", key)
        if m:
            out[f"level{int(m.group(1))}/conv{int(m.group(2)) // 2 + 1}"] = key
    return out


def _pwc_names(state_dict) -> dict[str, str]:
    """sniklaus pytorch-pwc (``module*`` or ``net*`` spelling): netExtractor,
    the netTwo..netSix decoders, netRefiner.  Decoder(L) owns the
    upsamplers it applies to decoder L+1's outputs: ``netFiv.netUpfeat`` is
    dec6/upfeat."""
    lvl_names = {"Six": 6, "Fiv": 5, "Fou": 4, "Thr": 3, "Two": 2, "One": 1}
    dense_names = {"One": 1, "Two": 2, "Thr": 3, "Fou": 4, "Fiv": 5}
    out = {}
    for key in state_dict:
        k = key.replace("module", "net")
        if m := re.match(r"netExtractor\.net(\w\w\w)\.(\d+)\.weight$", k):
            out[f"ext{lvl_names[m.group(1)]}/conv{int(m.group(2)) // 2 + 1}"] = key
        elif (m := re.match(r"net(\w\w\w)\.net(One|Two|Thr|Fou|Fiv|Six)\.(\d+)\.weight$", k)) and m.group(1) in lvl_names:
            part = m.group(2)
            out[f"dec{lvl_names[m.group(1)]}/" + (f"conv{dense_names[part]}" if part in dense_names else "flow")] = key
        elif (m := re.match(r"net(\w\w\w)\.netUp(flow|feat)\.weight$", k)) and m.group(1) in lvl_names:
            out[f"dec{lvl_names[m.group(1)] + 1}/up{m.group(2)}"] = key
        elif m := re.match(r"netRefiner\.netMain\.(\d+)\.weight$", k):
            out[f"ctx/conv{int(m.group(1)) // 2 + 1}"] = key
    return out


def _ordered_convs(state_dict) -> list[tuple[str, torch.Tensor]]:
    """(key, weight) for every 4-D weight, in insertion order."""
    out = []
    for key, w in state_dict.items():
        if key.endswith("weight") and torch.as_tensor(w).dim() == 4:
            out.append((key, torch.as_tensor(w).detach().float().cpu()))
    return out


def assign_by_shape(layout, state_dict) -> dict[str, torch.Tensor]:
    """Map an insertion-ordered torch state dict onto a ``(name, cin, cout,
    k)`` layout by weight shape (see the module docstring)."""
    entries = _ordered_convs(state_dict)
    used = [False] * len(entries)
    sd, missing = {}, []
    for layer, cin, cout, k in layout:
        want = (cin, cout, k, k) if k == 4 else (cout, cin, k, k)
        for i, (key, w) in enumerate(entries):
            if used[i] or tuple(w.shape) != want:
                continue
            used[i] = True
            bias_key = key[: -len("weight")] + "bias"
            b = state_dict[bias_key] if bias_key in state_dict else torch.zeros(cout)
            sd[_key(layer) + ".weight"] = w.contiguous()
            sd[_key(layer) + ".bias"] = torch.as_tensor(b).detach().float().cpu()
            break
        else:
            missing.append((layer, want))
    if missing:
        leftover = [(key, tuple(w.shape)) for (key, w), u in zip(entries, used) if not u]
        raise ValueError(f"checkpoint does not match the expected architecture; unmatched layers: {missing}; "
                         f"unconsumed checkpoint tensors: {leftover[:10]}")
    return sd


def flow_params_from_torch(name: str, state_dict) -> dict[str, torch.Tensor]:
    if hasattr(state_dict, "items") and "state_dict" in state_dict:
        state_dict = state_dict["state_dict"]
    if name in ("unflow", "liteflownet"):
        return assign_by_shape(_layout(name), state_dict)
    names = _spynet_names(state_dict) if name == "spynet" else _pwc_names(state_dict)
    sd = {}
    missing = []
    for layer, cin, cout, k in _layout(name):
        key = names.get(layer)
        if key is None:
            missing.append(layer)
            continue
        w = torch.as_tensor(state_dict[key]).detach().float().cpu()
        want = (cin, cout, k, k) if k == 4 else (cout, cin, k, k)  # ConvTranspose2d stores (in, out, k, k)
        if tuple(w.shape) != want:
            raise ValueError(f"{name} checkpoint drift: {key} has shape {tuple(w.shape)}, {layer} expects {want}")
        bias_key = key[: -len("weight")] + "bias"
        b = state_dict[bias_key] if bias_key in state_dict else torch.zeros(cout)
        sd[_key(layer) + ".weight"] = w.contiguous()
        sd[_key(layer) + ".bias"] = torch.as_tensor(b).detach().float().cpu()
    if missing:
        raise ValueError(f"{name} checkpoint did not cover layers: {missing}")
    return sd


__all__ = ["flow_params_from_jax", "flow_params_from_torch", "assign_by_shape", "load_npz"]
