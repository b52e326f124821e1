"""The device mesh and its sharding policy (JAX counterpart:
maua_style_tpu/parallel/mesh.py).

A ``Mesh`` names axes over a list of ``torch.device``s, one process driving
them all, as JAX's single controller drives its mesh.  A device may repeat
(``[cpu, cpu]``, ``[cuda:0, cuda:0]``): one device then stands in for
several, as JAX's virtual CPU devices do, and the code runs exactly as it
would on distinct cards.

Axes: "space" cuts a pastiche's rows into bands (``parallel/spatial.py``;
img_img, vid_img's frames and img_vid's windows), "frames" shares a stacked
batch of independent frames out to the rows of the mesh (vid_img's first
pass, ``StyleEngine.optimize_frames``) and an img_vid window's frames
(``window_shares``), each row one frames index and all its other devices
(``mesh_rows``; ``row_mesh``: the row as a mesh of its own); "tensor" cuts
every layer's channels into shares (``channel_shares``), each share's
column of bands on its own devices (``mesh_grid``: a band × share grid of
a row), on every path but the banded decoder.
"""

from __future__ import annotations

import itertools
import math
from dataclasses import dataclass
from typing import NamedTuple, Sequence

import torch

# the NCHW dim each axis shards (JAX's NHWC policy: frames 0, space 1, tensor 3)
_DIMS = {"frames": 0, "tensor": 1, "space": 2}


@dataclass(frozen=True)
class Mesh:
    """``devices`` laid out row-major over ``axes``, ((name, size), ...)."""

    devices: tuple[torch.device, ...]
    axes: tuple[tuple[str, int], ...]

    def __post_init__(self):
        if math.prod(s for _, s in self.axes) != len(self.devices):
            raise ValueError(f"mesh axes {self.axes} do not hold {len(self.devices)} devices")

    @property
    def shape(self) -> dict[str, int]:
        return dict(self.axes)

    def size(self, axis: str) -> int:
        """The axis's size, 1 where the mesh has no such axis."""
        return self.shape.get(axis, 1)


def build_mesh(devices: Sequence, axes: Sequence[tuple[str, int]] | None = None) -> Mesh:
    """A mesh over the first devices that ``axes`` spans (ordered (axis,
    size) pairs; default every device on "space")."""
    devices = [torch.device(d) for d in devices]
    if axes is None:
        axes = [("space", len(devices))]
    n = math.prod(s for _, s in axes)
    if n > len(devices):
        raise ValueError(f"mesh {list(axes)} needs {n} devices, {len(devices)} given")
    return Mesh(tuple(devices[:n]), tuple((str(a), int(s)) for a, s in axes))


class Sharding(NamedTuple):
    """A pastiche's plan: the mesh, and for each NCHW dim the axis that
    shards it (or None)."""

    mesh: Mesh
    spec: tuple[str | None, str | None, str | None, str | None]


def sharding_for(mesh: Mesh | None) -> Sharding | None:
    """The plan for a (B, C, H, W) pastiche on ``mesh``, or None on one
    device: "frames" shards B, "space" H, "tensor" C; an axis of size 1
    shards nothing.  The engine reads its paths from this plan."""
    if mesh is None or len(mesh.devices) < 2:
        return None
    spec: list = [None] * 4
    for axis, size in mesh.axes:
        if axis in _DIMS and size > 1:
            spec[_DIMS[axis]] = axis
    return Sharding(mesh, tuple(spec))


def pastiche_sharding_for(args) -> Sharding | None:
    """``sharding_for`` the mesh of parsed args (``args.devices``,
    ``args.mesh_shape``), or None on one device."""
    devices = getattr(args, "devices", None)
    if not devices or len(devices) < 2:
        return None
    return sharding_for(build_mesh(devices, getattr(args, "mesh_shape", None)))


def mesh_rows(mesh: Mesh) -> list[tuple[torch.device, ...]]:
    """The mesh's devices grouped by "frames" index: one row per index, each
    row its "space" devices in order (the row-major layout read for either
    axis order); one row of every device without a "frames" axis."""
    names = [a for a, _ in mesh.axes]
    if "frames" not in names:
        return [tuple(mesh.devices)]
    sizes = [s for _, s in mesh.axes]
    strides = [math.prod(sizes[i + 1 :]) for i in range(len(sizes))]
    f = names.index("frames")
    others = [i for i in range(len(sizes)) if i != f]
    return [tuple(mesh.devices[r * strides[f] + sum(j * strides[i] for i, j in zip(others, idx))]
                  for idx in itertools.product(*(range(sizes[i]) for i in others)))
            for r in range(sizes[f])]


def mesh_grid(mesh: Mesh) -> list[tuple[torch.device, ...]]:
    """The first "frames" row's devices as a (band, share) grid: ``grid[i][t]``
    holds band i ("space" index i) of channel share t ("tensor" index t),
    read row-major for any axis order; one band without a "space" axis, one
    share without a "tensor" axis.  Unlike ``mesh_rows``, which flattens
    every axis but "frames" into one row, it never reads a "tensor" device
    as a band."""
    sizes = mesh.shape
    strides = {a: math.prod(s for _, s in mesh.axes[i + 1 :]) for i, (a, _) in enumerate(mesh.axes)}
    return [tuple(mesh.devices[i * strides.get("space", 0) + t * strides.get("tensor", 0)]
                  for t in range(sizes.get("tensor", 1)))
            for i in range(sizes.get("space", 1))]


def channel_shares(channels: int, shares: int) -> list[slice]:
    """``channels`` cut into ``shares`` contiguous shares, as even as possible
    with the larger shares first (3 on tensor:2 give 2 + 1, 64 on tensor:3
    22 + 21 + 21), as JAX's GSPMD splits an uneven channel dim.  Past the
    last channel the shares are empty (3 on tensor:4 give 1 + 1 + 1 + 0),
    as GSPMD's padding leaves the last devices nothing: every consumer of
    a piece does nothing for an empty one."""
    return _even_cuts(channels, shares)


def _even_cuts(n: int, k: int) -> list[slice]:
    """range(n) cut into k contiguous slices, as even as possible, the
    larger first; some are empty where n < k."""
    per, extra = divmod(n, k)
    out, start = [], 0
    for i in range(k):
        size = per + (i < extra)
        out.append(slice(start, start + size))
        start += size
    return out


def row_mesh(mesh: Mesh, row: Sequence) -> Mesh:
    """One row of ``mesh_rows(mesh)`` as a mesh of its own: its devices over
    the mesh's axes but "frames", in order (a row holds them row-major), so
    a row of frames:2,tensor:2 is a tensor:2 mesh and never a row of
    bands."""
    return Mesh(tuple(torch.device(d) for d in row), tuple((a, s) for a, s in mesh.axes if a != "frames"))


def frame_shards(sharding: Sharding | None, batch: int) -> list[tuple[tuple[torch.device, ...], slice]] | None:
    """A stacked batch of ``batch`` independent frames split over the plan's
    "frames" axis: (row, frames) per row of the mesh (``mesh_rows``: one
    device, or a row of "space" bands), or None where the plan does not
    shard frames or the axis does not divide the batch (JAX's rule,
    engine/optimize.py:763-770: such a chunk runs on the first row)."""
    if sharding is None or sharding.spec[_DIMS["frames"]] != "frames":
        return None
    n = sharding.mesh.size("frames")
    if batch % n:
        return None
    per = batch // n
    return [(row, slice(i * per, (i + 1) * per)) for i, row in enumerate(mesh_rows(sharding.mesh))]


def window_shares(sharding: Sharding, t_w: int) -> list[tuple[tuple[torch.device, ...], slice]]:
    """An img_vid window's ``t_w`` frames cut into contiguous shares in
    window order, (row, frames) per row of the mesh (``mesh_rows``), as even
    as possible with the larger shares first: 9 frames on frames:2 give 5 +
    4.  Unlike ``frame_shards`` an undividable window is still shared out,
    as JAX's GSPMD pads an uneven frames dim and shards it.  A share is
    empty only where ``t_w`` is smaller than the axis (its row then sits
    idle); without a "frames" axis the one share is every frame on the
    mesh's one row."""
    rows = mesh_rows(sharding.mesh) if sharding.spec[_DIMS["frames"]] == "frames" else mesh_rows(sharding.mesh)[:1]
    return list(zip(rows, _even_cuts(t_w, len(rows))))


__all__ = ["Mesh", "Sharding", "build_mesh", "sharding_for", "pastiche_sharding_for", "mesh_rows", "mesh_grid",
           "channel_shares", "row_mesh", "frame_shards", "window_shares"]
