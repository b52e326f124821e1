"""Plain feature nets of the benchmark's configurations: frozen layer tables
of VGG-19 (Simonyan & Zisserman, arXiv:1409.1556, as the Caffe conversion
names its layers) and of Network in Network (Lin et al., arXiv:1312.4400,
the ImageNet model with the Caffe conversion's layer names), and their
forward pass in plain ``torch.nn.functional`` calls.

A table row is (kind, name, out_channels, kernel, stride, pad).  VGG-19's
pools are 2x2 max pools with stride 2 that drop a ragged edge; NIN's are
3x3 max pools with stride 2 in ceil mode, whose last window may hang over
the edge but never starts past it (``F.max_pool2d(ceil_mode=True)``).
Nothing here imports the program under test.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _vgg19() -> tuple:
    rows, block = [], 1
    for widths in ((64, 64), (128, 128), (256, 256, 256, 256), (512, 512, 512, 512), (512, 512, 512, 512)):
        for i, c in enumerate(widths, 1):
            rows.append(("conv", f"conv{block}_{i}", c, 3, 1, 1))
            rows.append(("relu", f"relu{block}_{i}", 0, 0, 0, 0))
        rows.append(("pool", f"pool{block}", 0, 2, 2, 0))
        block += 1
    return tuple(rows)


def _nin() -> tuple:
    def conv(name, c, k, s=1, p=0):
        return ("conv", name, c, k, s, p)

    def relu(name):
        return ("relu", name, 0, 0, 0, 0)

    def pool(name):
        return ("pool", name, 0, 3, 2, 0)

    return (
        conv("conv1", 96, 11, s=4), relu("relu1"), conv("cccp1", 96, 1), relu("relu2"), conv("cccp2", 96, 1),
        relu("relu3"), pool("pool1"),
        conv("conv2", 256, 5, p=2), relu("relu4"), conv("cccp3", 256, 1), relu("relu5"), conv("cccp4", 256, 1),
        relu("relu6"), pool("pool2"),
        conv("conv3", 384, 3, p=1), relu("relu7"), conv("cccp5", 384, 1), relu("relu8"), conv("cccp6", 384, 1),
        relu("relu9"), pool("pool3"),
        conv("conv4-1024", 1024, 3, p=1), relu("relu10"), conv("cccp7-1024", 1024, 1), relu("relu11"),
        conv("cccp8-1024", 1000, 1), relu("relu12"),
    )


TABLES = {"vgg19": _vgg19(), "nin": _nin()}
# pools in ceil mode (NIN), else floor mode (VGG-19)
CEIL_POOLS = {"vgg19": False, "nin": True}


def truncated(arch: str, wanted) -> tuple:
    """The table cut after the deepest of the ``wanted`` layers."""
    rows = TABLES[arch]
    names = [r[1] for r in rows]
    missing = set(wanted) - set(names)
    if missing:
        raise ValueError(f"{arch} has no layers {sorted(missing)}")
    return rows[: max(names.index(n) for n in wanted) + 1]


def _walk(arch: str, wanted, h: int, w: int):
    """Each layer up to the deepest wanted one, with its input channels and
    output size: (kind, name, cin, cout, k, h_out, w_out)."""
    in_ch, ceil = 3, CEIL_POOLS[arch]
    for kind, name, c, k, s, p in truncated(arch, wanted):
        cin = in_ch
        if kind == "conv":
            h, w, in_ch = (h + 2 * p - k) // s + 1, (w + 2 * p - k) // s + 1, c
        elif kind == "pool":
            h, w = pool_len(h, k, s, ceil), pool_len(w, k, s, ceil)
        yield kind, name, cin, in_ch, k, h, w


def conv_shapes(arch: str, wanted, h: int, w: int) -> list[tuple]:
    """(name, cin, cout, k, h_out, w_out) of every convolution up to the
    deepest wanted layer, for an h x w input."""
    return [(name, cin, cout, k, ho, wo) for kind, name, cin, cout, k, ho, wo in _walk(arch, wanted, h, w)
            if kind == "conv"]


def layer_sizes(arch: str, wanted, h: int, w: int) -> dict[str, tuple[int, int, int]]:
    """(C, H, W) of each wanted layer's activation for an h x w input."""
    return {name: (cout, ho, wo) for _, name, _, cout, _, ho, wo in _walk(arch, wanted, h, w) if name in wanted}


def pool_len(n: int, k: int, s: int, ceil: bool) -> int:
    """Output length of a pool: floor mode, or ceil mode without a window
    that starts past the input (torch's rule)."""
    if not ceil:
        return (n - k) // s + 1
    out = -(-(n - k) // s) + 1
    return out - 1 if (out - 1) * s >= n else out


def forward(arch: str, weights: dict, x: torch.Tensor, wanted) -> dict[str, torch.Tensor]:
    """Activations {name: (B, C, H, W)} of the wanted layers of an NCHW
    image batch; ``weights`` maps ``{conv}.weight`` (OIHW) and ``{conv}.bias``."""
    ceil = CEIL_POOLS[arch]
    acts, left = {}, set(wanted)
    for kind, name, _, k, s, p in truncated(arch, wanted):
        if kind == "conv":
            x = F.conv2d(x, weights[f"{name}.weight"], weights[f"{name}.bias"], stride=s, padding=p)
        elif kind == "relu":
            x = F.relu(x)
        else:
            x = F.max_pool2d(x, k, s, ceil_mode=ceil)
        if name in left:
            acts[name] = x
            left.discard(name)
    return acts
