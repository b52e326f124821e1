"""The "space" axis: a pastiche cut into horizontal bands, one per device,
run through the feature net band by band (JAX shards H under GSPMD,
parallel/mesh.py's policy; PyTorch has no such partitioner, so the halo
exchange is written out here).

- **Bands.** A (1, C, H, W) image is cut at rows that are multiples of the
  product of the pool strides up to the deepest wanted layer (16 for
  VGG-19 up to relu5_1), so every 2x2/2 pool window lies inside one band
  and each band's rows stay a whole block at every depth.  The ragged
  bottom that a floor-mode pool drops (``models/extractor._pool``) falls in
  the last band, where the whole image drops it too.
- **Halo exchange.** A 3x3/1 convolution reads one row across each band
  boundary: ``halo_pad`` copies the neighbours' edge rows to this band's
  device (forward) and sends their gradient back into those rows
  (backward).  Zero padding stays at the image's true top and bottom.
- **Which models.** Specs whose layers keep the boundaries aligned:
  stride-1 convolutions padded (k - 1) / 2 in H, and floor-mode pools whose
  kernel equals their stride: VGG-19, VGG-16 and the VGG-16 variants
  (prune, sod, nyud, fcn32s).  Any other (NIN: an 11x11/4 convolution and
  3x3/2 pools) raises ``NotImplementedError``.

The optimiser state of a banded pastiche is kept band by band (lists of
tensors, ``engine/lbfgs.py``); ``split_rows`` and ``gather_rows`` move a
pastiche-sized tensor, or a state's, between the whole layout and bands,
and a ``WindowLayout`` an img_vid window's, whose frames are also shared
out to the rows of a "frames" axis (``parallel.window_shares``): one piece
per share and band.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch
import torch.nn.functional as F

from ..models.extractor import ExtractorSpec

UNSUPPORTED = "ROADMAP item 18k"


def band_alignment(spec: ExtractorSpec) -> int:
    """The product of the pool strides in H of a (truncated) spec; raises
    ``NotImplementedError`` where a layer would move a band boundary."""
    align = 1
    for layer in spec.layers:
        if layer.kind == "conv":
            k, s, pad = layer.kernel[0], layer.stride[0], layer.pad[0]
            if s != 1 or k % 2 == 0 or pad != k // 2:
                raise NotImplementedError(
                    f"{spec.arch}'s {layer.name} ({k}x{layer.kernel[1]}/{s}, pad {pad}) moves band boundaries: "
                    f"a 'space' mesh supports stride-1 'same' convolutions only ({UNSUPPORTED})"
                )
        elif layer.kind in ("maxpool", "avgpool"):
            if layer.kernel != layer.stride or layer.ceil_mode:
                raise NotImplementedError(
                    f"{spec.arch}'s {layer.name} ({layer.kernel}/{layer.stride}) overlaps band boundaries: "
                    f"a 'space' mesh supports pools whose kernel equals their stride ({UNSUPPORTED})"
                )
            align *= layer.stride[0]
    return align


def band_rows(height: int, bands: int, align: int) -> list[int]:
    """The bands' heights: boundaries at multiples of ``align`` nearest the
    even split, every band at least ``align`` rows (one row at the deepest
    pool), the ragged remainder in the last."""
    cuts = [0] + [round(i * height / bands / align) * align for i in range(1, bands)] + [height]
    heights = [b - a for a, b in zip(cuts, cuts[1:])]
    if min(heights) < align:
        raise ValueError(f"{height} rows do not make {bands} bands of at least {align} rows")
    return heights


class _HaloPad(torch.autograd.Function):
    """(x, above, below) -> x with ``halo`` rows of each neighbour's edge
    stacked on top and bottom (zeros where there is no neighbour), on x's
    device.  The backward returns the interior's gradient to x and each
    halo's gradient to its neighbour's edge rows, on the neighbour's
    device."""

    @staticmethod
    def forward(ctx, x, above, below, halo: int):
        ctx.halo = halo
        ctx.neighbours = (None if above is None else (above.shape, above.device),
                          None if below is None else (below.shape, below.device))
        zeros = x.new_zeros((*x.shape[:2], halo, x.shape[3]))
        top = zeros if above is None else above[:, :, -halo:].to(x.device)
        bottom = zeros if below is None else below[:, :, :halo].to(x.device)
        return torch.cat([top, x, bottom], dim=2)

    @staticmethod
    def backward(ctx, g):
        h = ctx.halo
        grads = [g[:, :, h:-h]]
        for (nb, rows, edge) in ((ctx.neighbours[0], g[:, :, :h], slice(-h, None)),
                                 (ctx.neighbours[1], g[:, :, -h:], slice(None, h))):
            if nb is None:
                grads.append(None)
                continue
            shape, device = nb
            gn = torch.zeros(shape, dtype=g.dtype, device=device)
            gn[:, :, edge] = rows.to(device)
            grads.append(gn)
        return (*grads, None)


def halo_pad(x: torch.Tensor, above: torch.Tensor | None, below: torch.Tensor | None, halo: int) -> torch.Tensor:
    """Band ``x`` with ``halo`` rows of its neighbours above and below
    (None: the image's edge, zero rows)."""
    return _HaloPad.apply(x, above, below, halo)


def banded_forward(extractors: Sequence, bands: Sequence[torch.Tensor], wanted: Sequence[str]) -> dict[str, list]:
    """The feature net over bands: ``extractors[i]`` (an ``Extractor`` on
    band i's device; the same module where devices repeat) runs band i,
    and each 'same' convolution first takes its halo rows from the
    neighbours.  Returns {layer: [band activations]} for ``wanted``."""
    def conv(layer, xs):
        halo, n = layer.pad[0], len(xs)
        if halo:
            xs = [halo_pad(x, xs[i - 1] if i else None, xs[i + 1] if i + 1 < n else None, halo)
                  for i, x in enumerate(xs)]
        convs = [e.get_submodule(layer.name) for e in extractors]
        return [F.conv2d(x, c.weight, c.bias, c.stride, (0, c.padding[1])) for x, c in zip(xs, convs)]

    return extractors[0](list(bands), wanted, conv=conv)

def split_rows(x: torch.Tensor, heights: Sequence[int], devices: Sequence, channels: int, width: int) -> list:
    """A pastiche-sized tensor cut into bands on ``devices``: an image
    (..., C, H, W), or a flat vector (..., C·H·W) in NCHW order (the
    L-BFGS state), each band in the same form and its own storage."""
    height = sum(heights)
    image = x.dim() >= 3 and tuple(x.shape[-3:]) == (channels, height, width)
    lead = x.shape[:-3] if image else x.shape[:-1]
    rows = x.reshape(*lead, channels, height, width)
    out, start = [], 0
    for h, dev in zip(heights, devices):
        part = rows[..., start : start + h, :].to(dev)
        out.append(part.contiguous() if image else part.reshape(*lead, channels * h * width))
        start += h
    return out


def gather_rows(pieces: Sequence[torch.Tensor], heights: Sequence[int], device, channels: int,
                width: int) -> torch.Tensor:
    """``split_rows``'s inverse: bands back to one tensor on ``device``."""
    image = tuple(pieces[0].shape[-3:]) == (channels, heights[0], width)
    lead = pieces[0].shape[:-3] if image else pieces[0].shape[:-1]
    whole = torch.cat([p.reshape(*lead, channels, h, width).to(device) for p, h in zip(pieces, heights)], dim=-2)
    return whole if image else whole.reshape(*lead, -1)


class WindowLayout(NamedTuple):
    """An img_vid window of ``frames`` frames on a mesh: ``shares``, (row,
    frames) per non-empty share of ``parallel.window_shares``, each share's
    frames cut into row bands of ``heights``, band j on ``row[j]``.  A
    window-sized tensor is one piece per share and band, share-major."""

    shares: list
    heights: list[int]
    channels: int
    width: int

    @property
    def frames(self) -> int:
        return self.shares[-1][1].stop

    def split(self, x: torch.Tensor) -> list:
        """A window-sized (T, C, H, W) image or flat (..., T·C·H·W) vector
        in NCHW order -> its pieces, each in the same form and its own
        storage."""
        image = x.dim() == 4 and tuple(x.shape[1:]) == (self.channels, sum(self.heights), self.width)
        out = []
        for row, part in self.shares:
            if image:
                out += split_rows(x[part], self.heights, row, self.channels, self.width)
            else:
                frames = x.reshape(*x.shape[:-1], self.frames, -1)[..., part, :]
                out += [b.reshape(*b.shape[:-2], -1)
                        for b in split_rows(frames, self.heights, row, self.channels, self.width)]
        return out

    def gather(self, pieces: Sequence[torch.Tensor], device) -> torch.Tensor:
        """``split``'s inverse: the pieces back to one tensor on ``device``."""
        image = pieces[0].dim() == 4 and tuple(pieces[0].shape[1:]) == (self.channels, self.heights[0], self.width)
        out = []
        for (_, part), own in zip(self.shares, self.by_share(pieces)):
            if not image:  # each band's flat (..., T_i·C·h·W) as (..., T_i, C·h·W)
                own = [p.reshape(*p.shape[:-1], part.stop - part.start, -1) for p in own]
            out.append(gather_rows(own, self.heights, device, self.channels, self.width))
        return torch.cat(out) if image else torch.cat(out, dim=-2).flatten(-2)

    def by_share(self, pieces: Sequence) -> list[list]:
        """The pieces grouped by share, each group in band order."""
        n = len(self.heights)
        return [list(pieces[i * n : (i + 1) * n]) for i in range(len(self.shares))]

    def frozen_cut(self, frozen: tuple[int, int] | None) -> list[tuple[int, int]]:
        """Under img_vid's frozen split ``(fo, eo)`` (the window's first fo
        and last eo frames never move), each share's frozen frames at its
        start and at its end."""
        fo, eo = frozen or (0, 0)
        out = []
        for _, part in self.shares:
            n = part.stop - part.start
            a = min(max(fo - part.start, 0), n)
            out.append((a, min(max(part.stop - (self.frames - eo), 0), n - a)))
        return out

    def moving(self, pieces: Sequence[torch.Tensor], frozen: tuple[int, int] | None) -> list:
        """The pieces' frames that move under the frozen split (every frame
        without one), in piece order; a share whose frames are all frozen
        has none."""
        return [b[a : b.shape[0] - e] for share, (a, e) in zip(self.by_share(pieces), self.frozen_cut(frozen))
                for b in share if b.shape[0] > a + e]


def level_heights(heights: Sequence[int], stride: int) -> list[int]:
    """Band heights after pools of total stride ``stride`` (floor mode: the
    ragged rows of the last band drop)."""
    total = sum(heights) // stride
    inner = [h // stride for h in heights[:-1]]
    return inner + [total - sum(inner)]


def sum_on(device, values: Sequence[torch.Tensor]) -> torch.Tensor:
    """Per-band partial values summed on ``device``, in band order."""
    out = values[0].to(device)
    for v in values[1:]:
        out = out + v.to(device)
    return out


__all__ = ["band_alignment", "band_rows", "halo_pad", "banded_forward", "split_rows", "gather_rows",
           "WindowLayout", "level_heights", "sum_on"]
