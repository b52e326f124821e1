"""The "space" axis: a pastiche cut into horizontal bands, one per device,
run through the feature net band by band (JAX shards H under GSPMD,
parallel/mesh.py's policy; PyTorch has no such partitioner, so the halo
exchange is written out here).

- **Geometry.** A convolution or pool of kernel k, stride s and top pad p
  (``band_geometry``) maps the input rows [s·a, s·b) that a band owns to
  the output rows [a, b), reading p rows of the band above and k − s − p
  of the band below: 1 and 1 for VGG's 3x3/1 convolutions, none for its
  2x2/2 pools; 0 and 7 for NIN's 11x11/4 conv1, 2 and 2 for its 5x5
  conv2, 0 and 1 for its 3x3/2 ceil-mode pools.
- **Bands.** A (1, C, H, W) image is cut at rows that are multiples of the
  product of the strides up to the deepest wanted layer
  (``band_alignment``: 16 for VGG-19 up to relu5_1, 32 for NIN up to
  relu11), so every inner band owns a whole block at every depth and
  yields exactly as many rows as the whole image gives it.  The image's
  edges are the whole image's: zero rows where a convolution pads, none
  where it does not, and ``models/extractor.pool_layer``'s ceil-mode
  windows and floor-mode crop at the bottom, which falls in the last band
  (its rows, the whole image's rest, are what remains at each depth).
  ``band_rows`` checks every band at every depth and moves a cut that
  would empty the ragged last band.
- **The VQGAN decoder** (``banded_decode``) runs on bands through the
  hooks of ``models/vqgan.Hooks``: its 3x3 convolutions read a row of each
  neighbour (``conv_bands``), its GroupNorms reduce their statistics over
  the bands (``group_norm_bands``), and its attention gathers every band's
  keys and values.
- **Halo exchange.** ``halo_pad`` copies the neighbours' edge rows to this
  band's device (forward) and sends their gradient back into those rows
  (backward).
- **Channel shares** (the "tensor" axis, ``parallel.mesh_grid``): each band
  is further cut into contiguous channel shares (``channel_shares``), one
  piece per (band, share), share-major.  A convolution splits its
  contraction dim as JAX's GSPMD does (``conv_pieces``): each piece
  convolves its own input channels with their slice of the weights, band
  i's partial outputs are summed on each output share's device (a
  reduce-scatter), and the bias is added once, after the sum; ReLUs and
  pools act on each piece, and each share's column of bands exchanges halo
  rows.  A share past the last channel (3 channels on tensor:4) is empty:
  it convolves, pools and sums nothing.

The optimiser state of a banded pastiche is kept band by band (lists of
tensors, ``engine/lbfgs.py``); ``split_rows`` and ``gather_rows`` move a
pastiche-sized tensor, or a state's, between the whole layout and bands,
``split_pieces`` and ``gather_pieces`` between it and (band, share)
pieces, and a ``WindowLayout`` an img_vid window's, whose frames are also
shared out to the rows of a "frames" axis (``parallel.window_shares``):
one piece per frame share, channel share and band.
"""

from __future__ import annotations

import copy
import math
from typing import NamedTuple, Sequence

import torch
import torch.nn.functional as F

from ..models.extractor import ExtractorSpec, Layer, pool_layer, pool_out_len
from ..models.vqgan import Hooks
from .mesh import channel_shares, mesh_grid, sharding_for


class BandStep(NamedTuple):
    """A convolution or pool layer's rows (its H dimension)."""

    layer: Layer
    kernel: int
    stride: int
    pad: int  # zero rows at the image's top and bottom; pools pad none (``pool_layer``'s edges)

    @property
    def above(self) -> int:
        """Rows read from the band above (zero rows at the image's top)."""
        return self.pad

    @property
    def below(self) -> int:
        """Rows read from the band below."""
        return self.kernel - self.stride - self.pad

    def rows_out(self, rows: int) -> int:
        """The whole image's output rows for ``rows`` input rows."""
        if self.layer.kind == "conv":
            return (rows + 2 * self.pad - self.kernel) // self.stride + 1
        return pool_out_len(rows, self.kernel, self.stride, self.layer.ceil_mode)


def band_step(layer: Layer) -> BandStep:
    """A conv or pool layer's ``BandStep``."""
    pad = layer.pad[0] if layer.kind == "conv" else 0
    return BandStep(layer, layer.kernel[0], layer.stride[0], pad)


def band_geometry(spec: ExtractorSpec) -> list[BandStep]:
    """The ``BandStep`` of each convolution and pool of a (truncated) spec."""
    return [band_step(l) for l in spec.layers if l.kind in ("conv", "maxpool", "avgpool")]


def band_alignment(spec: ExtractorSpec) -> int:
    """The product of the strides in H of a (truncated) spec: the rows a band
    boundary is a multiple of."""
    return math.prod(st.stride for st in band_geometry(spec))


def _levels(heights: Sequence[int], steps: Sequence[BandStep]):
    """For each step: (the step, its input's band heights, its output's).
    Inner bands yield rows / stride; the last band the whole image's rest."""
    hs = list(heights)
    for st in steps:
        inner = [h // st.stride for h in hs[:-1]]
        out = inner + [st.rows_out(sum(hs)) - sum(inner)]
        yield st, hs, out
        hs = out


def _fits(heights: Sequence[int], steps: Sequence[BandStep]) -> bool:
    """Every band keeps a row at every step, and holds the rows its
    neighbours read from it."""
    n = len(heights)
    for st, hin, hout in _levels(heights, steps):
        if min(hout) < 1:
            return False
        if any(hin[i] < st.below for i in range(1, n)) or any(hin[i] < st.above for i in range(n - 1)):
            return False
    return True


def band_rows(height: int, bands: int, align: int, spec: ExtractorSpec | None = None) -> list[int]:
    """The bands' heights: boundaries at multiples of ``align`` nearest the
    even split, every band at least ``align`` rows, the ragged remainder in
    the last.  With ``spec``, every band must keep a row and hold its
    neighbours' halo at every layer (``_fits``); where the ragged last band
    does not (NIN's empties at pool3 for some heights), its boundary moves
    up a block at a time.  Raises ``ValueError`` where no cut does."""
    cuts = [0] + [round(i * height / bands / align) * align for i in range(1, bands)] + [height]
    steps = band_geometry(spec) if spec is not None else []
    while True:
        heights = [b - a for a, b in zip(cuts, cuts[1:])]
        if min(heights) < align:
            what = f" that each keep a row at every layer of {spec.arch}" if spec is not None else ""
            raise ValueError(f"{height} rows do not make {bands} bands of at least {align} rows{what}")
        if _fits(heights, steps):
            return heights
        cuts[-2] -= align  # one more block for the last band, pushing earlier cuts as needed
        for i in range(len(cuts) - 2, 1, -1):
            cuts[i - 1] = min(cuts[i - 1], cuts[i] - align)


def level_heights(heights: Sequence[int], spec: ExtractorSpec, layer: str) -> list[int]:
    """The bands' heights at ``layer``'s output for bands of ``heights``
    input rows (``_levels``: each layer's rows, ceil-mode pools included)."""
    names = [l.name for l in spec.layers]
    steps = band_geometry(ExtractorSpec(spec.arch, spec.layers[: names.index(layer) + 1], spec.in_ch))
    return [list(heights), *(out for _, _, out in _levels(heights, steps))][-1]


class _HaloPad(torch.autograd.Function):
    """(x, above, below) -> x with ``top`` rows of the band above and
    ``bottom`` rows of the band below stacked on (zeros where there is no
    neighbour), on x's device.  The backward returns the interior's
    gradient to x and each halo's gradient to its neighbour's edge rows, on
    the neighbour's device."""

    @staticmethod
    def forward(ctx, x, above, below, top: int, bottom: int):
        ctx.rows = (top, bottom)
        # each neighbour's (shape, device, the edge rows this band reads)
        ctx.neighbours = (None if above is None or not top else (above.shape, above.device,
                                                                 slice(above.shape[2] - top, None)),
                          None if below is None or not bottom else (below.shape, below.device, slice(0, bottom)))

        def zeros(n):
            return x.new_zeros((*x.shape[:2], n, x.shape[3]))

        up = zeros(top) if above is None else above[:, :, above.shape[2] - top :].to(x.device)
        down = zeros(bottom) if below is None else below[:, :, :bottom].to(x.device)
        return torch.cat([up, x, down], dim=2)

    @staticmethod
    def backward(ctx, g):
        top, bottom = ctx.rows
        h = g.shape[2]
        grads = [g[:, :, top : h - bottom]]
        for nb, rows in ((ctx.neighbours[0], g[:, :, :top]), (ctx.neighbours[1], g[:, :, h - bottom :])):
            if nb is None:
                grads.append(None)
                continue
            shape, device, edge = nb
            gn = torch.zeros(shape, dtype=g.dtype, device=device)
            gn[:, :, edge] = rows.to(device)
            grads.append(gn)
        return (*grads, None, None)


def halo_pad(x: torch.Tensor, above: torch.Tensor | None, below: torch.Tensor | None, top: int,
             bottom: int) -> torch.Tensor:
    """Band ``x`` with ``top`` rows of its neighbour above and ``bottom``
    of its neighbour below (None: the image's edge, zero rows)."""
    return _HaloPad.apply(x, above, below, top, bottom)


def with_halo(xs: Sequence[torch.Tensor], above: int, below: int, edge: int) -> list[torch.Tensor]:
    """Each band of ``xs`` with the rows a layer reads across its
    boundaries: ``above`` rows on top (zeros at the image's top), ``below``
    rows of the band below, or at the image's bottom ``edge`` zero rows
    (the layer's own padding)."""
    n = len(xs)
    if not (above or below or edge):
        return list(xs)
    return [halo_pad(x, xs[i - 1] if i else None, xs[i + 1] if i + 1 < n else None, above,
                     below if i + 1 < n else edge) for i, x in enumerate(xs)]


def conv_bands(convs: Sequence, xs: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """A convolution over bands: ``convs[i]`` (the layer's ``nn.Conv2d`` on
    band i's device) runs band i with the rows it reads across its
    boundaries (``with_halo``; its own padding at the image's edges) and
    pads only W."""
    c = convs[0]
    k, s, p = c.kernel_size[0], c.stride[0], c.padding[0]
    return [F.conv2d(x, m.weight, m.bias, m.stride, (0, m.padding[1]))
            for x, m in zip(with_halo(xs, p, k - s - p, p), convs)]


def columns(pieces: Sequence, shares: int) -> list[list]:
    """(band, share) pieces, share-major, grouped by channel share: each
    share's column of bands, in band order."""
    n = len(pieces) // shares
    return [list(pieces[t * n : (t + 1) * n]) for t in range(shares)]


def share_weight(conv, ch: slice) -> torch.Tensor:
    """``conv``'s weights for the input channels ``ch``, W[:, ch], as a
    contiguous copy kept on the module (one per device: each device has its
    own module) and made again once the weights change."""
    w = conv.weight
    stamp = (w.data_ptr(), w._version)
    cache = conv.__dict__.setdefault("_share_weights", {})
    key = (ch.start, ch.stop)
    if key not in cache or cache[key][0] != stamp:
        cache[key] = (stamp, w[:, ch].contiguous())
    return cache[key][1]


def conv_pieces(convs: Sequence, xs: Sequence[torch.Tensor], shares: int) -> list[torch.Tensor]:
    """A convolution over (band, share) pieces, share-major (piece t·n + i:
    band i of input share t; ``convs[k]`` the layer's ``nn.Conv2d`` on
    piece k's device), split over its contraction dim as GSPMD splits it:
    each piece convolves its own input channels with W[:, share]
    (``share_weight``) on its device, without bias, after its share's
    column of bands exchanged halo rows (``with_halo``; one band pads
    itself); band i's partial outputs are then summed, output share by
    output share, on that share's device (a reduce-scatter), and the bias
    added once, after the sum.  An empty input share (``channel_shares``
    past the last channel) convolves nothing, and an empty output share
    gets an empty (B, 0, h, W) piece, with no sum and no bias.  Returns the
    output's pieces, share-major."""
    n = len(xs) // shares
    c = convs[0]
    k, s, p = c.kernel_size[0], c.stride[0], c.padding[0]
    ins, outs = channel_shares(c.in_channels, shares), channel_shares(c.out_channels, shares)
    live = [t for t, ch in enumerate(ins) if ch.stop > ch.start]
    cols = columns(xs, shares)
    pad = c.padding
    if n > 1:
        cols = [with_halo(col, p, k - s - p, p) if t in live else col for t, col in enumerate(cols)]
        pad = (0, c.padding[1])
    partial = {t: [F.conv2d(x, share_weight(convs[t * n + i], ins[t]), None, c.stride, pad)
                   for i, x in enumerate(cols[t])] for t in live}
    out = []
    for u, ch in enumerate(outs):
        for i in range(n):
            m = convs[u * n + i]
            if ch.stop == ch.start:
                y = partial[live[0]][i]
                out.append(y.new_empty((y.shape[0], 0, *y.shape[2:]), device=m.weight.device))
                continue
            y = sum_on(m.weight.device, [partial[t][i][:, ch] for t in live])
            out.append(y if m.bias is None else y + m.bias[ch][:, None, None])
    return out


def banded_forward(extractors: Sequence, bands: Sequence[torch.Tensor], wanted: Sequence[str],
                   shares: int = 1) -> dict[str, list]:
    """The feature net over bands: ``extractors[i]`` (an ``Extractor`` on
    band i's device; the same module where devices repeat) runs band i,
    and each convolution and pool first takes its halo rows from the
    neighbours (``with_halo``).  With ``shares`` > 1 ("tensor") ``bands``
    are (band, share) pieces, share-major, each a share of the channels:
    the convolutions are ``conv_pieces``, each share's column of bands
    exchanges its own halo rows, and an empty share's pieces stay empty.
    Returns {layer: [band (or piece) activations]} for ``wanted``."""
    def conv(layer, xs):
        convs = [e.get_submodule(layer.name) for e in extractors]
        return conv_bands(convs, xs) if shares == 1 else conv_pieces(convs, xs, shares)

    def pool(layer, xs):
        st = band_step(layer)
        cols = columns(xs, shares)
        outs = [[pool_layer(x, layer) for x in with_halo(col, st.above, st.below, st.pad)] if col[0].shape[1] else None
                for col in cols]
        live = next(o for o in outs if o is not None)  # an empty share's bands: empty, at a live share's rows
        return [y for col, o in zip(cols, outs)
                for y in (o or [x.new_empty((x.shape[0], 0, *y.shape[2:])) for x, y in zip(col, live)])]

    return extractors[0](list(bands), wanted, conv=conv, pool=pool)


def group_norm_bands(norms: Sequence, xs: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """``nn.GroupNorm`` of an image cut into bands (``norms[i]`` on band i's
    device): each band's per-group sums reduced on the first band's device,
    the mean sent back, then the squared deviations likewise (nn.GroupNorm's
    two-pass biased variance), then each band normalised with its affine."""
    dev, g = xs[0].device, norms[0].num_groups

    def grouped(x):
        return x.reshape(x.shape[0], g, -1)

    count = sum(grouped(x).shape[2] for x in xs)
    mean = sum_on(dev, [grouped(x).sum(2) for x in xs]) / count
    var = sum_on(dev, [torch.square(grouped(x) - mean.to(x.device)[..., None]).sum(2) for x in xs]) / count
    out = []
    for m, x in zip(norms, xs):
        mu, v = mean.to(x.device)[..., None], var.to(x.device)[..., None]
        y = ((grouped(x) - mu) * torch.rsqrt(v + m.eps)).reshape(x.shape)
        out.append(y * m.weight[:, None, None] + m.bias[:, None, None])
    return out


def _device_of(model: torch.nn.Module) -> torch.device:
    return next(model.parameters()).device


def replica(model: torch.nn.Module, device) -> torch.nn.Module:
    """``model`` on ``device``: itself where its weights are, else a copy
    kept on the model and made again once its weights have changed in
    place (``load_state_dict``)."""
    device = torch.device(device)
    if device == _device_of(model):
        return model
    stamp = tuple(p._version for p in model.parameters())
    cache = model.__dict__.setdefault("_replicas", {})
    if device not in cache or cache[device][0] != stamp:
        cache[device] = (stamp, copy.deepcopy(model).to(device))
    return cache[device][1]


def banded_decode(vqgan, z: torch.Tensor, mesh) -> torch.Tensor:
    """``VQGAN.decode`` of a (B, D, h, w) z on a mesh's "space" axis (the
    first "frames" row's devices where there is a "frames" axis too): z cut
    into row bands, one per device (``band_rows``, alignment 1: the decoder
    has no strided layer), decoded band by band through ``conv_bands`` and
    ``group_norm_bands`` (the attention already gathers every band's keys),
    the image gathered on the first device.  The gradient reaches every band
    of z.  Without a "space" axis the whole decode; a "tensor" axis raises:
    no JAX path decodes on a mesh (its clip CLIs run on one device), so no
    reference splits the decoder's channels."""
    plan = sharding_for(mesh)
    _, tensor_axis, space_axis, _ = plan.spec if plan else (None,) * 4
    if tensor_axis:
        raise NotImplementedError(f"mesh {mesh.axes}: the 'tensor' axis is ROADMAP item 18e, the style engine's "
                                  "channel split; no JAX path decodes on a mesh, so the banded decoder does not split "
                                  "channels")
    if not space_axis:
        return vqgan.decode(z)
    devices = [row[0] for row in mesh_grid(mesh)]
    _, d, h, w = z.shape
    bands = split_rows(z, band_rows(h, len(devices), 1), devices, d, w)
    roots = ("post_quant_conv", "decoder")  # what decoding reads (not the encoder, nor the codebook)
    where = {m: (r, n) for r in roots for n, m in getattr(vqgan, r).named_modules()}
    copies = {r: [replica(getattr(vqgan, r), dev) for dev in devices] for r in roots}

    def on(f):  # a hook with each band's copy of the module
        def hook(m, xs):
            r, n = where[m]
            return f([c.get_submodule(n) for c in copies[r]], xs)

        return hook

    xs = vqgan.decode(bands, Hooks(conv=on(conv_bands), norm=on(group_norm_bands)))
    return torch.cat([x.to(devices[0]) for x in xs], dim=2)


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


def split_pieces(x: torch.Tensor, heights: Sequence[int], grid: Sequence[Sequence], channels: int,
                 width: int) -> list:
    """A pastiche-sized tensor (an image or a flat NCHW vector, as
    ``split_rows`` takes) cut into (band, share) pieces on a grid
    (``parallel.mesh_grid``: ``grid[i][t]`` band i of share t), share-major:
    share t (``channel_shares``) cut into row bands on its column of the
    grid; with one share, ``split_rows``."""
    shares = channel_shares(channels, len(grid[0]))
    if len(shares) == 1:
        return split_rows(x, heights, [row[0] for row in grid], channels, width)
    height = sum(heights)
    image = x.dim() >= 3 and tuple(x.shape[-3:]) == (channels, height, width)
    lead = x.shape[:-3] if image else x.shape[:-1]
    whole = x.reshape(*lead, channels, height, width)
    out = []
    for t, ch in enumerate(shares):
        bands = split_rows(whole[..., ch, :, :], heights, [row[t] for row in grid], ch.stop - ch.start, width)
        out += bands if image else [b.reshape(*lead, -1) for b in bands]
    return out


def gather_pieces(pieces: Sequence[torch.Tensor], heights: Sequence[int], shares: int, device, channels: int,
                  width: int) -> torch.Tensor:
    """``split_pieces``' inverse: the pieces of ``shares`` channel shares
    back to one tensor on ``device``."""
    if shares == 1:
        return gather_rows(pieces, heights, device, channels, width)
    chs = channel_shares(channels, shares)
    image = pieces[0].dim() >= 3 and tuple(pieces[0].shape[-3:]) == (chs[0].stop, heights[0], width)
    lead = pieces[0].shape[:-3] if image else pieces[0].shape[:-1]
    whole = torch.cat([gather_rows([p.reshape(*lead, ch.stop - ch.start, h, width) for p, h in zip(col, heights)],
                                   heights, device, ch.stop - ch.start, width)
                       for col, ch in zip(columns(pieces, shares), chs)], dim=-3)
    return whole if image else whole.reshape(*lead, -1)


def split_bands_shared(x: torch.Tensor, heights: Sequence[int], grid: Sequence[Sequence], channels: int,
                       width: int) -> list:
    """A tensor that every channel share reads whole (vid_img's (1, 1, H, W)
    reliability weights, which multiply every channel of the pastiche): its
    row bands, band i copied to each share's device of the grid, in
    ``split_pieces``' piece order (share-major)."""
    bands = split_rows(x, heights, [row[0] for row in grid], channels, width)
    return [b.to(row[t]) for t in range(len(grid[0])) for b, row in zip(bands, grid)]


class WindowLayout(NamedTuple):
    """An img_vid window of ``frames`` frames on a mesh: ``shares``, (row,
    frames) per non-empty share of ``parallel.window_shares``, each share's
    frames cut into row bands of ``heights`` and channel shares on its
    row's (band, share) grid (``grids``: ``parallel.mesh_grid`` of each
    row; None: each row's devices are its bands, one channel share).  A
    window-sized tensor is one piece per (frame share i, channel share t,
    band j), on ``grids[i][j][t]``: frame-share-major, each frame share's
    pieces share-major as ``split_pieces`` cuts them."""

    shares: list
    heights: list[int]
    channels: int
    width: int
    grids: list | None = None

    @property
    def frames(self) -> int:
        return self.shares[-1][1].stop

    @property
    def tensor(self) -> int:
        """The channel shares of each frame share."""
        return len(self.grids[0][0]) if self.grids else 1

    def grid(self, i: int) -> list:
        """Frame share i's (band, share) grid."""
        return self.grids[i] if self.grids else [(d,) for d in self.shares[i][0]]

    def devices(self) -> list[list]:
        """Each frame share's pieces' devices, in piece order."""
        return [[g[j][t] for t in range(self.tensor) for j in range(len(g))]
                for g in map(self.grid, range(len(self.shares)))]

    def split(self, x: torch.Tensor) -> list:
        """A window-sized (T, C, H, W) image or flat (..., T·C·H·W) vector
        in NCHW order -> its pieces, each in the same form and its own
        storage."""
        image = x.dim() == 4 and tuple(x.shape[1:]) == (self.channels, sum(self.heights), self.width)
        out = []
        for i, (_, part) in enumerate(self.shares):
            if image:
                out += split_pieces(x[part], self.heights, self.grid(i), self.channels, self.width)
            else:
                frames = x.reshape(*x.shape[:-1], self.frames, -1)[..., part, :]
                out += [b.reshape(*b.shape[:-2], -1)
                        for b in split_pieces(frames, self.heights, self.grid(i), self.channels, self.width)]
        return out

    def gather(self, pieces: Sequence[torch.Tensor], device) -> torch.Tensor:
        """``split``'s inverse: the pieces back to one tensor on ``device``."""
        first = channel_shares(self.channels, self.tensor)[0].stop
        image = pieces[0].dim() == 4 and tuple(pieces[0].shape[1:]) == (first, self.heights[0], self.width)
        out = []
        for (_, part), own in zip(self.shares, self.by_share(pieces)):
            if not image:  # each piece's flat (..., T_i·C_t·h·W) as (..., T_i, C_t·h·W)
                own = [p.reshape(*p.shape[:-1], part.stop - part.start, -1) for p in own]
            out.append(gather_pieces(own, self.heights, self.tensor, device, self.channels, self.width))
        return torch.cat(out) if image else torch.cat(out, dim=-2).flatten(-2)

    def by_share(self, pieces: Sequence) -> list[list]:
        """The pieces grouped by frame share, each group in piece order."""
        n = len(self.heights) * self.tensor
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


def sum_on(device, values: Sequence[torch.Tensor]) -> torch.Tensor:
    """Per-band partial values summed on ``device``, in band order."""
    out = values[0].to(device)
    for v in values[1:]:
        out = out + v.to(device)
    return out


__all__ = ["BandStep", "band_step", "band_geometry", "band_alignment", "band_rows", "level_heights", "halo_pad",
           "with_halo", "conv_bands", "columns", "share_weight", "conv_pieces", "banded_forward", "group_norm_bands", "replica",
           "banded_decode", "split_rows", "gather_rows", "split_pieces", "gather_pieces", "split_bands_shared",
           "WindowLayout", "sum_on"]
