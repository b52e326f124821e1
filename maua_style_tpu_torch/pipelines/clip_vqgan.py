"""CLIP-guided VQGAN synthesis (JAX counterpart:
maua_style_tpu/pipelines/clip_vqgan.py; reference clip_vqgan.py, after
Crowson).

A VQGAN latent z is optimised with Adam (lr 0.05) so that CLIP embeddings
of ``cutn`` random cutouts of the decoded image approach the content and
style images' cutout embeddings and move along the text directions
(+style_text, −content_text), by spherical distances.  Each iteration, in
eager PyTorch: quantize (straight through), decode, clamp-with-grad,
cutouts, normalise, the CLIP image tower, the spherical terms, backward,
Adam, and z clamped to the codebook's per-channel range.  The loss terms
are read back once a chunk (``save_every`` iterations), not once an
iteration.

Divergences from the reference, as in the JAX package: masks are resampled
to the latent grid; cutout sizes are stratified (``ops/cutouts.py``).  The
cutouts' random numbers come from one ``ops.cutouts.CutoutDraws``, in this
order: the content's cutouts, each style image's, then one call an
iteration.

Host layout at the API: (1, H, W, 3) RGB in [0, 1]; NCHW inside.  Runs on
CUDA device 0 unless the caller asks for the CPU (``device="cpu"``,
``--gpu c``), in float32 with TF32 off.

Usage: python -m maua_style_tpu_torch.pipelines.clip_vqgan --content random \\
    --style_text "an oil painting" --allow_random_weights [--gpu c]
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..engine.lbfgs import Adam
from ..engine.optimize import resolve_device, to_nchw, to_nhwc
from ..models import vqgan as vq
from ..models.conv_plans import apply_precision
from ..models.clip import CLIP, RESNET_CONFIGS, VIT_B32, CLIPResNet, init_clip, init_clip_resnet, tokenize
from ..models.clip.convert import clip_from_state_dict, clip_params_from_jax, load_clip_npz
from ..models.clip.model import CLIP_MEAN, CLIP_STD
from ..models.registry import allow_random_weights
from ..ops.cutouts import CutoutDraws, make_cutouts
from ..ops.grads import clamp_with_grad, replace_grad, spherical_dist
from ..ops.resize import resize_bilinear


def size_to_fit(size, max_dim, scale_up=False):
    """(w, h) scaled to fit max_dim (reference clip_vqgan.py:222-231)."""
    w, h = size
    if not scale_up and max(h, w) <= max_dim:
        return w, h
    new_w, new_h = max_dim, max_dim
    if h > w:
        new_w = round(max_dim * w / h)
    else:
        new_h = round(max_dim * h / w)
    return new_w, new_h


# the CLIP backbones with a download source (``io/download.SOURCES``)
CLIP_SOURCES = {"ViT-B/32": "clip_vitb32", "RN50": "clip_rn50"}
# the CLIs' guard on a mesh: JAX's clip CLIs run on its default device and
# never shard; the banded decoder is a model property (spatial.banded_decode)
ONE_DEVICE = "JAX's CLI runs on one device (parallel/spatial.banded_decode decodes on a mesh)"


def download_names(clip_backbone: str, vqgan_dir: str) -> list[str]:
    """What ``--download_weights`` provisions: the backbone's CLIP
    checkpoint where it has a source, the BPE vocabulary, and the VQGAN
    checkpoint when ``vqgan_dir`` names one.  RN101 and RN50x4 have no
    source: ``_load_clip`` then names the checkpoint that stays missing.
    (JAX's CLI asks for RN50's file for RN50x4 and ViT-B/32's for RN101,
    neither of which those backbones read.)"""
    from ..io.download import SOURCES

    names = [CLIP_SOURCES[clip_backbone]] if clip_backbone in CLIP_SOURCES else []
    return names + ["bpe_vocab"] + ([vqgan_dir] if vqgan_dir in SOURCES else [])


def _missing_clip_checkpoint(candidates, backbone: str = "ViT-B/32") -> None:
    """Missing CLIP weights are an error unless random weights are allowed."""
    if not allow_random_weights(None):
        nosource = "" if backbone in CLIP_SOURCES else (
            f"--download_weights has no source for {backbone}: convert its OpenAI checkpoint to {candidates[0]}.\n")
        raise FileNotFoundError(
            f"No CLIP checkpoint (searched {list(candidates)}).\n{nosource}"
            f"Convert the OpenAI .pt once with:\n"
            f"    python -m maua_style_tpu.models.clip.convert <clip.pt> {candidates[0]}\n"
            f"or pass --allow_random_weights to run with deterministic random "
            f"weights (outputs will be meaningless; for tests/smoke only)."
        )


def _load_clip(clip_backbone: str) -> CLIP:
    """ViT-B/32 from ``modelzoo/clip_vitb32.npz`` or ``clip-vit-b-32.npz``,
    a ResNet backbone from ``modelzoo/clip_{rn50,rn101,rn50x4}.npz`` (the
    JAX package's converted trees, read at the backbone's config), else an
    error unless random weights are allowed."""
    if clip_backbone in RESNET_CONFIGS:
        path = f"modelzoo/clip_{clip_backbone.lower()}.npz"
        if os.path.exists(path):
            model = CLIPResNet.from_backbone(clip_backbone)
            model.load_state_dict(clip_params_from_jax(load_clip_npz(path)))
            return model
        _missing_clip_checkpoint((path,), clip_backbone)
        print(f"Warning: no CLIP checkpoint ({path}); using deterministic random init.")
        return init_clip_resnet(clip_backbone)
    if clip_backbone != "ViT-B/32":
        raise NotImplementedError(f"CLIP backbone {clip_backbone!r} not implemented; use ViT-B/32, RN50, RN101 or RN50x4")
    candidates = ("modelzoo/clip_vitb32.npz", "modelzoo/clip-vit-b-32.npz")
    for cand in candidates:
        if os.path.exists(cand):
            return clip_from_state_dict(clip_params_from_jax(load_clip_npz(cand)), VIT_B32)
    _missing_clip_checkpoint(candidates)
    print("Warning: no CLIP checkpoint (modelzoo/clip_vitb32.npz); using deterministic random init.")
    return init_clip(VIT_B32)


class ClipVQGANEngine:
    """The VQGAN and CLIP models and the optimisation loop: the reference's
    load_models + optimize / optimize_cached (clip_vqgan.py:391-431,
    566-601).  ``draws`` (default ``CutoutDraws(seed)``) supplies every
    cutout's phase and offsets."""

    def __init__(
        self,
        vqgan_dir: str = "imagenet_16384",
        clip_backbone: str = "ViT-B/32",
        cutn: int = 64,
        learning_rate: float = 0.05,
        seed: int = 0,
        device=None,
        draws: CutoutDraws | None = None,
    ):
        self.device = resolve_device(device)
        apply_precision("highest")  # f32 products and convolutions, no TF32
        self.vqgan = vq.load_vqgan(vqgan_dir, seed).to(self.device).eval().requires_grad_(False)
        self.vq_cfg = self.vqgan.cfg
        self.clip = _load_clip(clip_backbone).to(self.device).eval().requires_grad_(False)
        self.cut_size = self.clip.input_resolution
        self.cutn = cutn
        self.res = self.vq_cfg.downsample_factor
        self.learning_rate = learning_rate
        codebook = self.vqgan.codebook
        self.z_min = codebook.min(dim=0).values.view(1, -1, 1, 1)
        self.z_max = codebook.max(dim=0).values.view(1, -1, 1, 1)
        self.mean = torch.as_tensor(CLIP_MEAN, device=self.device).view(1, 3, 1, 1)
        self.std = torch.as_tensor(CLIP_STD, device=self.device).view(1, 3, 1, 1)
        self.draws = CutoutDraws(seed) if draws is None else draws
        self.target_embeds = None  # [from_embed, to_embed, style_embeds] cache for optimize_cached

    # -- pieces of an iteration ----------------------------------------------

    def embed_cutouts(self, img01: torch.Tensor) -> torch.Tensor:
        """(1, 3, H, W) in [0, 1] -> (cutn, embed_dim); one cutout draw."""
        cuts = make_cutouts(img01, self.cut_size, self.cutn, self.draws)
        return self.clip.encode_image((cuts - self.mean) / self.std)

    def encode_z(self, img01: torch.Tensor) -> torch.Tensor:
        """(1, 3, H, W) in [0, 1] -> the quantised latent (1, D, H/f, W/f)."""
        with torch.no_grad():
            return self.vqgan.quantize_st(self.vqgan.encode(img01 * 2.0 - 1.0))

    def synth(self, z: torch.Tensor) -> torch.Tensor:
        """Latent -> image (1, 3, H, W) in [0, 1]: quantize, decode,
        clamp-with-grad."""
        out = self.vqgan.decode(self.vqgan.quantize_st(z))
        return clamp_with_grad((out + 1.0) / 2.0, 0.0, 1.0)

    def loss_terms(self, z, mask, targets, weights) -> torch.Tensor:
        """The 3 + n_styles weighted terms of one iteration: content, each
        style, from (weight −text_weight; 0 without a content text), to.
        ``targets``: (content, from, to, [style, ...]) embeddings;
        ``weights``: (content, style, text)."""
        content_embed, from_embed, to_embed, style_embeds = targets
        content_weight, style_weight, text_weight = weights
        z_eff = replace_grad(z, z * mask) if mask is not None else z
        out_embeds = self.embed_cutouts(self.synth(z_eff))
        zero = out_embeds.new_zeros(())
        terms = [spherical_dist(out_embeds, content_embed).mean() * content_weight]
        terms += [spherical_dist(out_embeds, s).mean() * style_weight for s in style_embeds]
        terms.append(spherical_dist(out_embeds, from_embed).mean() * -text_weight if from_embed is not None else zero)
        terms.append(spherical_dist(out_embeds, to_embed).mean() * text_weight if to_embed is not None else zero)
        return torch.stack(terms)

    def step(self, z, adam: Adam, opt_state: dict, mask, targets, weights):
        """One iteration: the terms' gradient with respect to z, an Adam
        step, z clamped to the codebook's per-channel range.  Returns (z,
        opt_state, terms), all on the device."""
        z_leaf = z.detach().requires_grad_(True)
        terms = self.loss_terms(z_leaf, mask, targets, weights)
        (grad,) = torch.autograd.grad(terms.sum(), z_leaf)
        with torch.no_grad():
            upd, opt_state = adam.update(grad, opt_state)
            z = torch.clamp(z + upd, self.z_min, self.z_max)
        return z, opt_state, terms.detach()

    # -- target embedding ------------------------------------------------------

    def embed_image(self, img01: np.ndarray) -> torch.Tensor:
        """(1, H, W, 3) [0, 1] -> (cutn, embed_dim) cutout embeddings."""
        with torch.no_grad():
            return self.embed_cutouts(to_nchw(img01, self.device))

    def embed_text(self, text: str | None):
        if text is None:
            return None
        with torch.no_grad():
            return self.clip.encode_text(tokenize(text))

    def style_targets(self, styles, content_text, style_text):
        style_embeds = [self.embed_image(s) for s in styles] if styles else None
        return [self.embed_text(content_text), self.embed_text(style_text), style_embeds]

    update_styles = style_targets

    # -- public API ------------------------------------------------------------

    def optimize(
        self,
        init: np.ndarray,
        content: np.ndarray,
        styles: list[np.ndarray] | None,
        mask: np.ndarray | None,
        content_text: str | None,
        style_text: str | None,
        content_weight: float = 1.0,
        style_weight: float = 1.0,
        text_weight: float = 1.0,
        iterations: int = 500,
        save_every: int = 0,
        save_callback=None,
        target_embeds=None,
    ) -> np.ndarray:
        """Images are (1, H, W, 3) RGB in [0, 1]; the sides are resized down
        to multiples of the VQGAN's factor.  Returns the synthesised image
        in the same format (reference clip_vqgan.py:525-563); the loss
        terms of every iteration land in ``last_loss_log``."""
        h, w = init.shape[1:3]
        side = ((h // self.res) * self.res, (w // self.res) * self.res)
        init_t = resize_bilinear(to_nchw(init, self.device), size=side)
        content_t = resize_bilinear(to_nchw(content, self.device), size=side)

        with torch.no_grad():
            content_embed = self.embed_cutouts(content_t)
        if target_embeds is None:
            style_embeds = [self.embed_image(s) for s in styles] if styles else []
            from_embed, to_embed = self.embed_text(content_text), self.embed_text(style_text)
        else:
            from_embed, to_embed, style_embeds = target_embeds
            style_embeds = style_embeds or []
        mask_t = None
        if mask is not None:
            mask_t = resize_bilinear(to_nchw(mask, self.device), size=(side[0] // self.res, side[1] // self.res))

        z = self.encode_z(init_t)
        adam = Adam(self.learning_rate)
        opt_state = adam.init(z)
        targets = (content_embed, from_embed, to_embed, style_embeds)
        weights = (content_weight, style_weight, text_weight)
        chunk = iterations if save_every <= 0 else save_every
        losses_log, pending = [], []
        out = None
        for it in range(iterations):
            z, opt_state, terms = self.step(z, adam, opt_state, mask_t, targets, weights)
            pending.append(terms)
            done = it + 1
            if done % chunk and done != iterations:
                continue
            losses_log.append(torch.stack(pending).cpu().numpy())
            pending.clear()
            with torch.no_grad():
                out = to_nhwc(self.synth(z))
            if save_callback is not None and done < iterations:
                save_callback(out, done)

        self.last_loss_log = np.concatenate(losses_log, axis=0)
        if save_callback is not None:
            save_callback(out, iterations)
        return out

    def optimize_cached(self, init, content, styles, mask, content_text, style_text,
                        content_weight, style_weight, text_weight, iterations) -> np.ndarray:
        """Per-frame variant reusing cached style and text targets
        (reference clip_vqgan.py:566-601)."""
        if self.target_embeds is None:
            self.target_embeds = self.style_targets(styles, content_text, style_text)
        return self.optimize(
            init, content, None, mask, None, None,
            content_weight, style_weight, text_weight, iterations,
            target_embeds=self.target_embeds,
        )


_ENGINE: ClipVQGANEngine | None = None


def get_engine(vqgan_dir: str, clip_backbone: str, device=None) -> ClipVQGANEngine:
    """One engine per process (the reference's module-level models)."""
    global _ENGINE
    if _ENGINE is None:
        _ENGINE = ClipVQGANEngine(vqgan_dir, clip_backbone, device=device)
    return _ENGINE


def main(argv=None):
    """Standalone CLI (reference clip_vqgan.py:604-685)."""
    import argparse
    from pathlib import Path

    from PIL import Image

    from ..config import single_device

    # fmt: off
    parser = argparse.ArgumentParser("clip_vqgan")
    parser.add_argument("--content", type=str)
    parser.add_argument("--content_text", type=str)
    parser.add_argument("--style_text", type=str)
    parser.add_argument("--style", type=str, default=None)
    parser.add_argument("--image_size", default=256, type=int)
    parser.add_argument("--text_weight", default=1.0, type=float)
    parser.add_argument("--style_weight", default=1.0, type=float)
    parser.add_argument("--content_weight", default=1.0, type=float)
    parser.add_argument("--vqgan_dir", type=str, default="imagenet_16384")
    parser.add_argument("--clip_backbone", type=str, default="ViT-B/32")
    parser.add_argument("--out_dir", default="./output/")
    parser.add_argument("--mask_path", type=str)
    parser.add_argument("--invert_mask", action="store_true")
    parser.add_argument("--force_square", action="store_true")
    parser.add_argument("--iterations", default=500, type=int)
    parser.add_argument("--seed", default=-1, type=int)
    parser.add_argument("--allow_random_weights", action="store_true",
                        help="proceed with deterministic random weights when checkpoints are missing")
    parser.add_argument("--download_weights", action="store_true",
                        help="self-provision missing CLIP/VQGAN checkpoints + BPE vocab (needs network access)")
    parser.add_argument("--gpu", type=str, default="0", help="CUDA device id '0', or 'c' for the CPU")
    # fmt: on
    args = parser.parse_args(argv)

    if args.allow_random_weights:
        os.environ["MAUA_ALLOW_RANDOM_WEIGHTS"] = "1"
    if args.download_weights:
        from ..io.download import ensure_weights

        ensure_weights(download_names(args.clip_backbone, args.vqgan_dir))
    device = single_device(args, "clip_vqgan", ONE_DEVICE)

    if args.seed >= 0:
        np.random.seed(args.seed)

    out_name = (
        "-".join(
            [Path(args.content).stem]
            + (args.content_text.split() if args.content_text else [])
            + ([Path(args.style).stem] if args.style is not None else [])
            + (args.style_text.split() if args.style_text else [])
            + [Path(args.vqgan_dir).stem]
        ).lower()
        + ".jpg"
    )

    def load01(path, max_dim, force_square=False, scale_up=True):
        img = Image.open(path).convert("RGB")
        if force_square:
            img = img.resize((max_dim, max_dim), Image.LANCZOS)
        else:
            sx, sy = size_to_fit(img.size, max_dim, scale_up)
            img = img.resize((sx, sy), Image.LANCZOS)
        return np.asarray(img, np.float32)[None] / 255.0

    styles = None
    if args.style is not None:
        styles = [load01(s, args.image_size) for s in args.style.split(",")]

    if args.content == "random":
        init = np.random.rand(1, args.image_size, args.image_size, 3).astype(np.float32)
    else:
        init = load01(args.content, args.image_size, args.force_square)

    mask = None
    if args.mask_path:
        pil = Image.open(args.mask_path)
        if "A" in pil.getbands():
            pil = pil.getchannel("A")
        elif "L" in pil.getbands():
            pil = pil.getchannel("L")
        else:
            raise RuntimeError("Mask must have an alpha channel or be one channel")
        mask = np.asarray(pil, np.float32)[None, :, :, None] / 255.0
        if args.invert_mask:
            mask = 1 - mask

    os.makedirs(args.out_dir, exist_ok=True)
    # --seed seeds the cutout draws and the random init (-1 = a random seed)
    engine = ClipVQGANEngine(
        args.vqgan_dir,
        args.clip_backbone,
        seed=args.seed if args.seed >= 0 else int(np.random.randint(2**31)),
        device=device,
    )

    def save(img, i):
        Image.fromarray((np.clip(img[0], 0, 1) * 255).astype(np.uint8)).save(args.out_dir + "/" + out_name)
        log = getattr(engine, "last_loss_log", None)
        if log is not None:
            print(f"i: {i}, loss: {log[-1].sum():g} [{', '.join(f'{v:g}' for v in log[-1])}]")

    out = engine.optimize(
        init=init,
        content=init.copy(),
        styles=styles,
        mask=mask,
        content_text=args.content_text,
        style_text=args.style_text,
        content_weight=args.content_weight,
        style_weight=args.style_weight,
        text_weight=args.text_weight,
        iterations=args.iterations,
        save_every=50,
        save_callback=save,
    )
    save(out, args.iterations)
    print(f"saved {args.out_dir}/{out_name}")


if __name__ == "__main__":
    main()
