"""Weight provisioning (JAX counterpart: maua_style_tpu/io/download.py;
reference models.py:255-347, the flow submodules' weights,
clip_vqgan.py:160-201 ``maybe_download_vqgan`` and utils.py:57-67
``download``).

By default a missing checkpoint is an error naming the convert command.
With network access, ``--download_weights`` fetches the raw artifacts into
``modelzoo/`` with a progress meter and converts them through the port's
converters to the ``.npz`` the loaders read first, the same file the JAX
package's converters write, so both packages share one model zoo.

CLI::

    python -m maua_style_tpu_torch.io.download vgg19 spynet clip_vitb32
    python -m maua_style_tpu_torch.io.download --list
"""

from __future__ import annotations

import os
import re
import urllib.request

MODELZOO = "modelzoo"


def download(url: str, output_path: str, progress: bool = True) -> str:
    """Fetch ``url`` to ``output_path`` with a byte-progress meter
    (reference utils.py:57-67, a plain reporthook in place of tqdm)."""
    os.makedirs(os.path.dirname(output_path) or ".", exist_ok=True)
    last = [-1]

    def hook(blocks: int, block_size: int, total: int) -> None:
        if not progress:
            return
        done = blocks * block_size
        pct = int(done * 100 / total) if total > 0 else -1
        if pct != last[0]:
            last[0] = pct
            end = "\n" if (total > 0 and done >= total) else "\r"
            human = f"{done / 1e6:.1f}MB" + (f"/{total / 1e6:.1f}MB {pct}%" if total > 0 else "")
            print(f"  {os.path.basename(output_path)}: {human}", end=end, flush=True)

    tmp = output_path + ".part"
    urllib.request.urlretrieve(url, filename=tmp, reporthook=hook)
    os.replace(tmp, output_path)
    return output_path


def download_drive(file_id: str, output_path: str) -> str:
    """A Google Drive file (the reference fetches its finetuned VGGs with
    gdown, models.py:255-288), following the confirm token of Drive's
    virus-scan page for large files."""
    base = f"https://drive.google.com/uc?export=download&id={file_id}"
    with urllib.request.urlopen(urllib.request.Request(base)) as resp:
        if "text/html" not in resp.headers.get("Content-Type", ""):
            os.makedirs(os.path.dirname(output_path) or ".", exist_ok=True)
            with open(output_path, "wb") as f:
                while chunk := resp.read(1 << 20):
                    f.write(chunk)
            return output_path
        html = resp.read().decode("utf-8", "replace")
    m = re.search(r"confirm=([0-9A-Za-z_-]+)", html)
    return download(f"{base}&confirm={m.group(1) if m else 't'}", output_path)


# --- converters -------------------------------------------------------------


def _convert_feature_net(raw: str, name: str) -> None:
    from ..models.convert import main as convert_main

    convert_main([raw, f"{MODELZOO}/{name}.npz", "--arch", name])


def _convert_flow(raw: str, name: str) -> None:
    from ..models.flownets.convert import main as convert_main

    convert_main([name, raw])


def _convert_clip(raw: str, name: str) -> None:
    from ..models.clip.convert import main as convert_main

    convert_main([raw, f"{MODELZOO}/{name}.npz"])


def _convert_none(raw: str, name: str) -> None:  # .ckpt converts on load; the vocabulary is data
    pass


_CLIP_BASE = "https://openaipublic.azureedge.net/clip/models"
_SNIKLAUS = "http://content.sniklaus.com/github"
_VQGAN_MIRROR = "http://mirror.io.community/blob/vqgan"

# name -> (raw file in modelzoo/, source, converter): the reference's URLs
# (models.py:255-347, clip_vqgan.py:160-201) and the openai/CLIP and
# sniklaus release URLs its submodules fetch
SOURCES: dict[str, tuple[str, str, object]] = {
    "vgg19": ("vgg19.pth", "https://web.eecs.umich.edu/~justincj/models/vgg19-d01eb7cb.pth", _convert_feature_net),
    "vgg16": ("vgg16.pth", "https://web.eecs.umich.edu/~justincj/models/vgg16-00b39a1b.pth", _convert_feature_net),
    "nin": ("nin.pth", "https://raw.githubusercontent.com/ProGamerGov/pytorch-nin/master/nin_imagenet.pth", _convert_feature_net),
    "prune": ("vgg16-prune.pth", "drive:1aaNqJ5D2A-vev3IZFv6dSkovuA3XwYsq", _convert_feature_net),
    "nyud": ("nyud-fcn32s-color-heavy.pth", "drive:1MKj6Dntzh7t45PxM4I0ixWaQtisAg9hy", _convert_feature_net),
    "fcn32s": ("fcn32s-heavy-pascal.pth", "drive:1bcAnvfMuuEbJqjaVWIUCD9HUgD1fvxI_", _convert_feature_net),
    "sod": ("vgg16-sod.pth", "drive:1EU-F9ugeIeTO9ay4PinzsBXgEuCYBu0Z", _convert_feature_net),
    "spynet": ("spynet.pytorch", f"{_SNIKLAUS}/pytorch-spynet/network-sintel-final.pytorch", _convert_flow),
    "pwc": ("pwc.pytorch", f"{_SNIKLAUS}/pytorch-pwc/network-default.pytorch", _convert_flow),
    "liteflownet": ("liteflownet.pytorch", f"{_SNIKLAUS}/pytorch-liteflownet/network-default.pytorch", _convert_flow),
    "unflow": ("unflow.pytorch", f"{_SNIKLAUS}/pytorch-unflow/network-css.pytorch", _convert_flow),
    "clip_vitb32": ("ViT-B-32.pt", f"{_CLIP_BASE}/40d365715913c9da98579312b702a82c18be219cc2a73407c4526f58eba950af/ViT-B-32.pt", _convert_clip),
    "clip_rn50": ("RN50.pt", f"{_CLIP_BASE}/afeb0e10f9e5a86da6080e35cf09123aca3b358a0c3e3b6c78a7b63bc04b6762/RN50.pt", _convert_clip),
    "bpe_vocab": ("bpe_simple_vocab_16e6.txt.gz", "https://github.com/openai/CLIP/raw/main/clip/bpe_simple_vocab_16e6.txt.gz", _convert_none),
    # taming checkpoints convert on load (models/vqgan.load_vqgan)
    "imagenet_1024": ("imagenet_1024.ckpt", f"{_VQGAN_MIRROR}/vqgan_imagenet_f16_1024.ckpt", _convert_none),
    "imagenet_16384": ("imagenet_16384.ckpt", f"{_VQGAN_MIRROR}/vqgan_imagenet_f16_16384.ckpt", _convert_none),
    "wikiart_1024": ("wikiart_1024.ckpt", f"{_VQGAN_MIRROR}/wikiart.ckpt", _convert_none),
    "wikiart_16384": ("wikiart_16384.ckpt", f"{_VQGAN_MIRROR}/wikiart_16384.ckpt", _convert_none),
    "coco": ("coco.ckpt", "https://dl.nmkd.de/ai/clip/coco/coco.ckpt", _convert_none),
}


def ensure_weights(names, enabled: bool = True) -> list[str]:
    """Provision each named artifact: converted already -> nothing; raw file
    present -> convert it; otherwise download and convert (when
    ``enabled``; else a missing file stays the loaders' error).  Returns
    the names that were fetched or converted."""
    done = []
    if names:
        os.makedirs(MODELZOO, exist_ok=True)
    for name in names:
        if name not in SOURCES:
            raise ValueError(f"unknown weight artifact {name!r}; known: {sorted(SOURCES)}")
        raw_name, source, convert = SOURCES[name]
        raw = f"{MODELZOO}/{raw_name}"
        if os.path.exists(f"{MODELZOO}/{name}.npz") or (convert is _convert_none and os.path.exists(raw)):
            continue
        if not os.path.exists(raw):
            if not enabled:
                continue
            print(f"Downloading {name} from {source}")
            if source.startswith("drive:"):
                download_drive(source[len("drive:"):], raw)
            else:
                download(source, raw)
        convert(raw, name)
        done.append(name)
    return done


def names_for_args(args) -> list[str]:
    """The artifacts a style-CLI run needs: the feature net and, for
    vid_img, its flow nets."""
    names = []
    mf = str(getattr(args, "model_file", "")).lower()
    for key in ("prune", "nyud", "fcn32s", "sod", "vgg19", "vgg16", "nin"):
        if key in mf:
            names.append(key)
            break
    if getattr(args, "transfer_type", "") == "vid_img":
        flow = getattr(args, "flow_models", []) or []
        if isinstance(flow, str):  # the CLI's comma list
            flow = flow.split(",")
        names += [m for m in flow if m in SOURCES]
    return names


def main(argv=None) -> None:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("names", nargs="*", help="artifact names (see --list)")
    ap.add_argument("--list", action="store_true", help="print known artifacts and sources")
    args = ap.parse_args(argv)
    if args.list or not args.names:
        for name, (raw, source, _) in SOURCES.items():
            print(f"{name:16s} -> modelzoo/{raw}   [{source}]")
        return
    done = ensure_weights(args.names)
    print(f"provisioned: {done or 'nothing (all present)'}")


if __name__ == "__main__":
    main()
